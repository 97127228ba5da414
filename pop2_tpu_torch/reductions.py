"""Global reductions, with an optional bit-for-bit reproducible mode.

The reference's ``b4b_flag`` switches ``global_sum`` to a fixed-order sum
that gives identical bits on every decomposition
(``mpi/global_reductions.F90:134,599``). The port carries the JAX package's
cure (``pop2_tpu/reductions.py:37-88``): each value is split into three
30-bit integer limbs below the power-of-two ceiling of the global absolute
maximum; the int64 sums of the limbs are exact, so they have the same bits
in any order, and the fixed three-term float combine comes after them. The
scale here is formed from ``frexp`` (the same power of two as the JAX
package's floor(log2) + 1, without the logarithm's rounding), so a sum has
the same bits on any decomposition and on the CPU or the card. Values below
max * 2^-90 are dropped, far below one float64 ulp of the largest element.

Under a decomposition (``parallel.mesh.scope``) a sum is the block's local
sum and an all-reduce: for ``b4b`` an all-reduce MAX of the absmax, then an
int64 all-reduce SUM of the three limb sums (the combine after both);
otherwise the local ``torch.sum`` and a float all-reduce SUM. Every rank
gets the same bits, so every rank decides alike on them. A global sum sums
the horizontal axes (and may sum others with them).
"""

from __future__ import annotations

import torch

from pop2_tpu_torch.parallel import mesh as _mesh

__all__ = ["global_sum", "global_max", "slab_total"]

_P = 30  # bits per limb
_S1 = float(2 ** _P)
_S2 = float(2 ** (2 * _P))
_S3 = float(2 ** (3 * _P))


def _decomp():
    d = _mesh.active()
    return d if d is not None and d.comm is not None else None


def _axes(x, axis):
    if axis is None:
        return tuple(range(x.dim()))
    axes = axis if isinstance(axis, tuple) else (axis,)
    return tuple(a % x.dim() for a in axes)


def _b4b_sum(x, axes, d=None):
    """Order-independent fixed-point sum of ``x`` over ``axes``; with a
    decomposition ``d`` over every block."""
    absmax = torch.max(torch.abs(x))  # max is exact in any order
    if d is not None:
        absmax = d.comm.all_reduce(absmax, "max")
    one = torch.ones((), dtype=x.dtype, device=x.device)
    safe = torch.where(absmax > 0, absmax, one)
    # the power of two 2^e with 2^(e-1) <= safe < 2^e, as
    # 2^(floor(log2(safe)) + 1) of the JAX package
    _, ex = torch.frexp(safe)
    scale = torch.where(absmax > 0, torch.ldexp(one, ex), one)
    y = x / scale  # |y| <= 1, exact

    r1 = torch.round(y * _S1)
    y = y - r1 / _S1
    r2 = torch.round(y * _S2)
    y = y - r2 / _S2
    r3 = torch.round(y * _S3)

    s = torch.stack([torch.sum(r.to(torch.int64), dim=axes)
                     for r in (r1, r2, r3)])
    if d is not None:
        s = d.comm.all_reduce(s, "sum")
    # int64 -> float rounds only past 2^53 (value-deterministic all the
    # same); the combine order is a fixed three-term expression
    return (s[0].to(x.dtype) / _S1 + s[1].to(x.dtype) / _S2
            + s[2].to(x.dtype) / _S3) * scale


def global_sum(x, b4b: bool = False, axis=None):
    """Masked-field global sum. ``b4b=True`` selects the reproducible
    fixed-point path (identical bits on any decomposition); the default is
    the straight ``torch.sum``. ``axis=None`` sums everything; otherwise
    sums the given axes (per-tracer sums keep the leading tracer axis)."""
    d = _decomp()
    axes = _axes(x, axis)
    if d is not None and not {x.dim() - 2, x.dim() - 1} <= set(axes):
        raise ValueError(f"a global sum over axes {axes} of a field of "
                         f"{x.dim()} dimensions keeps a horizontal axis")
    if b4b:
        return _b4b_sum(x, axes, d)
    out = torch.sum(x) if axis is None else torch.sum(x, dim=axis)
    if d is not None:
        out = d.comm.all_reduce(out, "sum")
    return out


def global_max(x):
    """The largest value of ``x`` over every block (exact in any order)."""
    out = torch.max(x)
    d = _decomp()
    if d is not None:
        out = d.comm.all_reduce(out, "max")
    return out


def slab_total(t):
    """``t``, this block's partial sums (of any shape), summed over every
    block; ``t`` itself on the whole domain."""
    d = _decomp()
    return d.comm.all_reduce(t, "sum") if d is not None else t
