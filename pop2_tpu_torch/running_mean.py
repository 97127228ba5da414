"""Generic exponential running-mean service.

Reference: ``source/running_mean_mod.F90`` — named variables with a
timescale, updated each step as X <- (1 - dt/tau) X + (dt/tau) x, with
restart save/restore of the accumulators. The registry lives on the host;
its values are tensors on the device of whatever the caller defines them
with, updated there without a read of the device.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


class RunningMeans:
    """Registry of named running means (running_mean_define_var :214,
    update :175, get :295)."""

    def __init__(self, dt_seconds: float):
        self.dt = float(dt_seconds)
        self.timescales: Dict[str, float] = {}
        self.values: Dict[str, torch.Tensor] = {}

    def define(self, name: str, timescale_seconds: float, init_value):
        """A new mean, starting at ``init_value`` (a tensor keeps its dtype
        and device; host data becomes a CPU tensor)."""
        self.timescales[name] = float(timescale_seconds)
        self.values[name] = torch.as_tensor(init_value)

    def update(self, name: str, sample) -> torch.Tensor:
        """One-step exponential update; returns the new mean."""
        tau = self.timescales[name]
        w = min(self.dt / tau, 1.0)
        old = self.values[name]
        new = (1.0 - w) * old + w * torch.as_tensor(sample,
                                                    device=old.device)
        self.values[name] = new
        return new

    def get(self, name: str) -> torch.Tensor:
        return self.values[name]

    def save(self) -> Dict[str, np.ndarray]:
        """Accumulator checkpoint (running_mean write/read restart), host
        NumPy."""
        return {k: v.detach().cpu().numpy() for k, v in self.values.items()}

    def restore(self, data: Dict[str, np.ndarray]) -> None:
        """Values of a checkpoint, each onto the dtype and device of the
        mean it replaces; names not defined here are ignored."""
        for k, v in data.items():
            if k in self.values:
                old = self.values[k]
                self.values[k] = torch.as_tensor(
                    np.asarray(v), dtype=old.dtype, device=old.device)
