"""pop2_tpu_torch — the PyTorch/CUDA port of the ocean dynamical core.

A second package beside the JAX package, with the same module names so a
reader finds each counterpart. Plain tensor code is PyTorch; the hot
kernels of the step (tridiagonal sweep, tracer tendency, momentum forcing,
and GM's slopes, chain, flux assembly and transition-layer search) are
hand-written CUDA C++ under ``csrc/``, built at first use with ``nvcc`` and
bound through ``ctypes`` (``_cuda_build.py``).

Entry point: ``Model(get_config(...))`` runs on ``cuda`` by default and
raises without a GPU; pass ``device="cpu"`` for the plain PyTorch path.
"""

from pop2_tpu_torch.config import ModelConfig, get_config  # noqa: F401

__all__ = ["ModelConfig", "get_config"]
