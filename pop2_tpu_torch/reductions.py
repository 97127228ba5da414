"""Global reductions.

The reference's ``b4b_flag`` switches ``global_sum`` to a fixed-order sum
that gives identical bits on every decomposition
(``mpi/global_reductions.F90:134,599``). On one GPU there is one
decomposition, so this slice carries the plain sum only; the reproducible
fixed-point path belongs with the multi-GPU work (ROADMAP.md Queue 1
item 12) and ``b4b=True`` raises until then.
"""

from __future__ import annotations

import torch

__all__ = ["global_sum"]


def global_sum(x, b4b: bool = False, axis=None):
    """Masked-field global sum. ``axis=None`` sums everything; otherwise sums
    the given axes (per-tracer sums keep the leading tracer axis)."""
    if b4b:
        raise NotImplementedError(
            "b4b reproducible sums are not ported yet "
            "(ROADMAP.md Queue 1 item 12)")
    if axis is None:
        return torch.sum(x)
    return torch.sum(x, dim=axis)
