"""Input and output of the port: exact-restart checkpoints
(``restart.py``)."""
