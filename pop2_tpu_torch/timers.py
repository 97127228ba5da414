"""Hierarchical wall-clock timers.

The port's copy of the JAX package's ``timers.py``. Reference:
``source/timers.F90`` — named timers with start/stop and a final
max/min/avg table (:874). Device work is asynchronous, so a timed section
that names its result (``sync_on``: a tensor, a ``TensorTree`` or a sequence
of them) synchronizes the devices that hold it before stopping. Section
names mirror the reference's instrumentation points (TOTAL / STEP /
BAROCLINIC / BAROTROPIC / 3D-UPDATE / OUTPUT).
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict

import torch


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        return [obj]
    if hasattr(obj, "leaves"):
        return [t for _, t in obj.leaves()]
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in _tensors(o)]
    return []


def synchronize(obj) -> None:
    """Wait for the work that produces ``obj``'s tensors
    (``jax.block_until_ready``'s role): each CUDA device that holds one is
    synchronized; CPU tensors are ready already."""
    for dev in {t.device for t in _tensors(obj) if t.is_cuda}:
        torch.cuda.synchronize(dev)


class Timer:
    __slots__ = ("name", "total", "count", "tmin", "tmax", "_start")

    def __init__(self, name: str):
        self.name = name
        self.total = 0.0
        self.count = 0
        self.tmin = float("inf")
        self.tmax = 0.0
        self._start = None

    def start(self):
        self._start = time.perf_counter()

    def stop(self, sync_on=None):
        if sync_on is not None:
            synchronize(sync_on)
        dt = time.perf_counter() - self._start
        self.total += dt
        self.count += 1
        self.tmin = min(self.tmin, dt)
        self.tmax = max(self.tmax, dt)
        return dt


class Timers:
    """Registry of named timers (get_timer/timer_start/timer_stop,
    source/timers.F90:217-551)."""

    def __init__(self):
        self._timers: Dict[str, Timer] = {}

    def get(self, name: str) -> Timer:
        if name not in self._timers:
            self._timers[name] = Timer(name)
        return self._timers[name]

    @contextmanager
    def section(self, name: str, sync_on=None):
        t = self.get(name)
        t.start()
        try:
            yield t
        finally:
            t.stop(sync_on)

    def print_all(self) -> str:
        """Final timing table (timer_print_all, source/timers.F90:874)."""
        lines = ["Timer                    calls      total(s)     "
                 "avg(s)       min(s)       max(s)"]
        for t in self._timers.values():
            if t.count == 0:
                continue
            lines.append(
                f"{t.name:<22s} {t.count:8d} {t.total:12.4f} "
                f"{t.total / t.count:12.6f} {t.tmin:12.6f} {t.tmax:12.6f}")
        return "\n".join(lines)
