"""The port's version, the JAX package's ``version.py`` counterpart."""

__version__ = "0.1.0"
