"""Carrying state across: NumPy dictionaries <-> the port's State/Forcing.

The JAX package's ``State`` and ``Forcing`` have the same leaf names as the
port's. Handing their leaves over as a dict of NumPy arrays keyed by field
name lets both packages step from identical inputs (the parity tests do
this) without either importing the other.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import numpy as np
import torch

from pop2_tpu_torch.config import ModelConfig
from pop2_tpu_torch.forcing import Forcing
from pop2_tpu_torch.grid import resolve_device
from pop2_tpu_torch.state import State


def _from_numpy(cls, fields: Mapping[str, np.ndarray], cfg: ModelConfig,
                device):
    names = [f.name for f in dataclasses.fields(cls)]
    missing = [n for n in names if n not in fields]
    if missing:
        raise KeyError(f"{cls.__name__} fields missing: {missing}")
    dt = cfg.torch_dtype
    device = resolve_device(device)
    return cls(**{n: torch.tensor(np.asarray(fields[n])).to(
        device=device, dtype=dt) for n in names})


def state_from_numpy(fields: Mapping[str, np.ndarray], cfg: ModelConfig,
                     device="cuda") -> State:
    """A ``State`` on ``device`` (the GPU unless the caller asks for the
    CPU; no GPU raises) in the config's dtype from a dict of NumPy arrays
    keyed by field name; extra keys are ignored."""
    return _from_numpy(State, fields, cfg, device)


def forcing_from_numpy(fields: Mapping[str, np.ndarray], cfg: ModelConfig,
                       device="cuda") -> Forcing:
    """A ``Forcing`` on ``device`` (default as ``state_from_numpy``) from a
    dict of NumPy arrays; keys the port does not carry (the JAX package's
    optional forcing fields) are ignored."""
    return _from_numpy(Forcing, fields, cfg, device)


def state_to_numpy(state) -> Dict[str, np.ndarray]:
    """Every tensor leaf of a ``State`` (or ``Forcing``) as a NumPy array."""
    return {name: t.detach().cpu().numpy() for name, t in state.leaves()}
