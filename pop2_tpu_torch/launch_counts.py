"""Whose launches a kernel wrapper counts.

Each wrapper module keeps plain counters: ``launches``, the mode counters
its ``MODE_COUNTERS`` names, and thomas's ``launches_by_nr``. A caller
resets and reads them. A block of a one-process mesh
(``parallel.mesh.LocalMesh``) runs in a thread of its own, and while it
runs (``counting``) its wrappers count into that block's ``Counts`` in
place of the module globals: each block reads as the whole domain's
launches do, as a rank's do in a process of its own, and the threads never
race on a module global.
"""

from __future__ import annotations

import contextlib
import sys
import threading
from collections import Counter
from typing import Optional

_local = threading.local()


class Counts:
    """One block's counters: {(wrapper module name, counter name): n} and
    thomas's launches by right-hand sides."""

    def __init__(self):
        self.values: Counter = Counter()
        self.by_nr: Counter = Counter()

    def get(self, module, name: str = "launches") -> int:
        return self.values[(module.__name__, name)]

    def reset(self) -> None:
        self.values.clear()
        self.by_nr.clear()


def active() -> Optional[Counts]:
    """The counters this thread counts into (None: the module globals)."""
    return getattr(_local, "counts", None)


@contextlib.contextmanager
def counting(counts: Optional[Counts]):
    """Count this thread's launches into ``counts`` (None: the module
    globals) while the enclosed code runs."""
    prev, _local.counts = active(), counts
    try:
        yield counts
    finally:
        _local.counts = prev


def add(module_name: str, name: str = "launches", n: int = 1) -> None:
    """Count ``n`` on counter ``name`` of the wrapper module
    ``module_name``."""
    counts = active()
    if counts is None:
        mod = sys.modules[module_name]
        setattr(mod, name, getattr(mod, name) + n)
    else:
        counts.values[(module_name, name)] += n


def add_by_nr(nr: int) -> None:
    """Count a thomas launch of ``nr`` right-hand sides."""
    counts = active()
    if counts is None:
        sys.modules["pop2_tpu_torch.tridiag_cuda"].launches_by_nr[nr] += 1
    else:
        counts.by_nr[nr] += 1


def snapshot(modules) -> tuple:
    """({(module name, counter): n}, launches by right-hand sides) of this
    thread's counters over ``modules`` (each's ``launches`` and
    ``MODE_COUNTERS``)."""
    counts = active()
    keys = [(mod, name) for mod in modules
            for name in ("launches",) + tuple(getattr(mod, "MODE_COUNTERS",
                                                      ()))]
    if counts is None:
        tridiag = sys.modules["pop2_tpu_torch.tridiag_cuda"]
        return ({(mod.__name__, name): getattr(mod, name)
                 for mod, name in keys}, Counter(tridiag.launches_by_nr))
    return ({(mod.__name__, name): counts.values[(mod.__name__, name)]
             for mod, name in keys}, Counter(counts.by_nr))


def restore(snap, counts: Optional[Counts] = None) -> None:
    """Set the counters to ``snap`` (``snapshot``'s), in ``counts`` or
    this thread's."""
    values, by_nr = snap
    counts = counts if counts is not None else active()
    if counts is None:
        for (module_name, name), n in values.items():
            setattr(sys.modules[module_name], name, n)
        tridiag = sys.modules["pop2_tpu_torch.tridiag_cuda"]
        tridiag.launches_by_nr.clear()
        tridiag.launches_by_nr.update(by_nr)
        return
    for key, n in values.items():
        counts.values[key] = n
    counts.by_nr.clear()
    counts.by_nr.update(by_nr)


def delta(before, after) -> tuple:
    """What was counted between two snapshots: ({key: n}, by_nr)."""
    return ({k: n - before[0][k] for k, n in after[0].items()
             if n != before[0][k]}, after[1] - before[1])


def add_delta(d, counts: Optional[Counts] = None) -> None:
    """Count ``delta``'s launches again, into ``counts`` or this
    thread's."""
    values, by_nr = d
    counts = counts if counts is not None else active()
    if counts is None:
        for (module_name, name), n in values.items():
            mod = sys.modules[module_name]
            setattr(mod, name, getattr(mod, name) + n)
        sys.modules["pop2_tpu_torch.tridiag_cuda"].launches_by_nr.update(
            by_nr)
    else:
        counts.values.update(values)
        counts.by_nr.update(by_nr)
