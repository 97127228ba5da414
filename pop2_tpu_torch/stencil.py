"""B-grid shift and stencil operators on torch tensors.

Fields are global dense tensors shaped ``(..., ny, nx)`` and neighbour access
is a shift: closed boundaries shift in zeros (the reference's
``fillValue = 0`` halo updates), cyclic boundaries are ``torch.roll``. On a
tripole grid the northward shifts of ``BC`` fill the ghost rows from the fold
(``tripole.py``), which needs the field's location and kind; the south edge
of a tripole grid is closed.

Index convention: element ``[j, i]`` is the T-point (i,j) of the reference;
the U-point ``[j, i]`` is the NE corner of T-cell ``[j, i]`` (Arakawa B-grid).

Operators: 4-point divergence/gradient/curl (source/operators.F90:49,126,199),
T<->U-grid area-weighted averaging (source/grid.F90:3297-3420).
"""

from __future__ import annotations

import torch

from pop2_tpu_torch.tripole import fold_rows, shift_n_tripole

__all__ = [
    "shift_e", "shift_w", "shift_n", "shift_s",
    "shift_ne", "shift_nw", "shift_se", "shift_sw", "BC",
    "div", "grad", "zcurl", "tgrid_to_ugrid", "ugrid_to_tgrid",
]


def _shift(f, sign: int, dim: int, bc: str):
    """Value at index+sign along ``dim``; zeros enter at a closed edge."""
    if bc == "cyclic":
        return torch.roll(f, -sign, dims=dim)
    if bc == "tripole":
        if sign > 0:
            raise NotImplementedError(
                "northward shifts on tripole grids need the field's "
                "location and kind; use BC.n / BC.nn / BC.n_partner")
        bc = "closed"  # the south edge of a tripole grid is closed
    if bc != "closed":
        raise ValueError(f"unknown boundary {bc!r}")
    n = f.shape[dim]
    edge = torch.zeros_like(f.narrow(dim, 0, 1))
    if sign > 0:
        return torch.cat([f.narrow(dim, 1, n - 1), edge], dim=dim)
    return torch.cat([edge, f.narrow(dim, 0, n - 1)], dim=dim)


def shift_e(f, bc_ew: str = "cyclic"):
    """f[j, i+1]."""
    return _shift(f, +1, -1, bc_ew)


def shift_w(f, bc_ew: str = "cyclic"):
    """f[j, i-1]."""
    return _shift(f, -1, -1, bc_ew)


def shift_n(f, bc_ns: str = "closed"):
    """f[j+1, i]."""
    return _shift(f, +1, -2, bc_ns)


def shift_s(f, bc_ns: str = "closed"):
    """f[j-1, i]."""
    return _shift(f, -1, -2, bc_ns)


def shift_ne(f, bc_ew: str = "cyclic", bc_ns: str = "closed"):
    return shift_n(shift_e(f, bc_ew), bc_ns)


def shift_nw(f, bc_ew: str = "cyclic", bc_ns: str = "closed"):
    return shift_n(shift_w(f, bc_ew), bc_ns)


def shift_se(f, bc_ew: str = "cyclic", bc_ns: str = "closed"):
    return shift_s(shift_e(f, bc_ew), bc_ns)


def shift_sw(f, bc_ew: str = "cyclic", bc_ns: str = "closed"):
    return shift_s(shift_w(f, bc_ew), bc_ns)


class BC:
    """Lightweight boundary-condition bundle used by all stencil ops.

    Northward shifts take the field's horizontal location and kind, which
    select the tripole fold (mpi/POP_HaloMod.F90:1961-2050); they are
    ignored on closed and cyclic edges. Southward and east-west shifts
    never cross the fold."""

    __slots__ = ("ew", "ns")

    def __init__(self, ew: str = "cyclic", ns: str = "closed"):
        self.ew = ew
        self.ns = ns

    def e(self, f):
        return shift_e(f, self.ew)

    def w(self, f):
        return shift_w(f, self.ew)

    def n(self, f, loc: str = "center", kind: str = "scalar"):
        if self.ns == "tripole":
            return shift_n_tripole(f, 1, loc, kind)
        return shift_n(f, self.ns)

    def nn(self, f, loc: str = "center", kind: str = "scalar"):
        """Distance-2 northward shift (value at j+2)."""
        if self.ns == "tripole":
            return shift_n_tripole(f, 2, loc, kind)
        return shift_n(shift_n(f, self.ns), self.ns)

    def n_partner(self, f, partner, loc: str = "center",
                  kind: str = "scalar"):
        """Northward shift of a south-face field whose tripole ghost row is
        the fold of its north-face counterpart ``partner`` (the faces swap
        under the 180-degree fold, as in the reference's ghost-row
        evaluation of SLY(:,j+1,jsouth) in hmix_gm.F90). Equals ``n(f)`` on
        closed and cyclic edges."""
        if self.ns != "tripole":
            return shift_n(f, self.ns)
        return torch.cat([f.narrow(-2, 1, f.shape[-2] - 1),
                          fold_rows(partner, 1, loc, kind).unsqueeze(-2)],
                         dim=-2)

    def s(self, f):
        return shift_s(f, self.ns)

    def ne(self, f, loc: str = "center", kind: str = "scalar"):
        # fold first, then shift east: the ghost-cell indexing
        return shift_e(self.n(f, loc, kind), self.ew)

    def nw(self, f, loc: str = "center", kind: str = "scalar"):
        return shift_w(self.n(f, loc, kind), self.ew)

    def se(self, f):
        return shift_s(shift_e(f, self.ew), self.ns)

    def sw(self, f):
        return shift_s(shift_w(f, self.ew), self.ns)

    def __eq__(self, other):
        return (isinstance(other, BC) and self.ew == other.ew
                and self.ns == other.ns)

    def __hash__(self):
        return hash((self.ew, self.ns))


def _masked(mask, x):
    return torch.where(mask, x, torch.zeros_like(x))


def div(ux, uy, dxu, dyu, mask_t, bc: BC):
    """Divergence (times T-cell area) at T points of a U-point vector field:
    the T-point (i,j) gathers the 4 surrounding U-points
    (source/operators.F90:99-114)."""
    a = ux * dyu
    b = uy * dxu
    out = 0.5 * (a + bc.s(a) - bc.w(a) - bc.sw(a)
                 + b + bc.w(b) - bc.s(b) - bc.sw(b))
    return _masked(mask_t, out)


def grad(f, dxur, dyur, mask_u, bc: BC):
    """Gradient at U points of a T-point field
    (source/operators.F90:178-187). Returns (gradx, grady)."""
    f_ne = bc.ne(f)
    f_e = bc.e(f)
    f_n = bc.n(f)
    gx = dxur * 0.5 * (f_ne - f - f_n + f_e)
    gy = dyur * 0.5 * (f_ne - f + f_n - f_e)
    return _masked(mask_u, gx), _masked(mask_u, gy)


def zcurl(ux, uy, dxu, dyu, mask_t, bc: BC):
    """z-component of curl (times T-cell area) at T points
    (source/operators.F90:254-265)."""
    a = ux * dxu
    b = uy * dyu
    out = 0.5 * (b + bc.s(b) - bc.w(b) - bc.sw(b)
                 - a - bc.w(a) + bc.s(a) + bc.sw(a))
    return _masked(mask_t, out)


def tgrid_to_ugrid(f_t, au0, aun, aue, aune, bc: BC):
    """Area-weighted 4-point average from T points to U points
    (source/grid.F90:3403-3412)."""
    return (au0 * f_t + aun * bc.n(f_t) + aue * bc.e(f_t)
            + aune * bc.ne(f_t))


def ugrid_to_tgrid(f_u, bc: BC):
    """Simple 4-point average from U points to T points
    (source/grid.F90:3297-3355 with p25 weights)."""
    return 0.25 * (f_u + bc.s(f_u) + bc.w(f_u) + bc.sw(f_u))
