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

Under a decomposition (``parallel.mesh.scope``) a field is a block: a
shift takes what lies past the block's edges from its neighbours: alone,
only the rows and columns it reads (``tripole.window``, one exchange a
shift); ``BC.halo`` fetches the halo (``Decomposition.halo``: rows,
columns and corners) of several fields in one, handed to the shifts as
``rows=``. Every rank joins every exchange, so even the
blocks at the global edges call it. The global south edge and a closed
north or east-west edge keep their zeros, a cyclic one wraps through the
ranks, and the fold fills the north ghost rows on the top row of blocks
from the mirror block's rows. On a (py, 1) mesh an east-west shift stays
local (the block holds every column).
"""

from __future__ import annotations

import torch

from pop2_tpu_torch.parallel import mesh as _mesh
from pop2_tpu_torch.tripole import (fold_rows, folded, shift_n_tripole,
                                   window)

__all__ = [
    "shift_e", "shift_w", "shift_n", "shift_s",
    "shift_ne", "shift_nw", "shift_se", "shift_sw", "BC",
    "div", "grad", "zcurl", "tgrid_to_ugrid", "ugrid_to_tgrid",
]


def _decomposed():
    """The active decomposition over ranks, or None."""
    d = _mesh.active()
    return d if d is not None and d.comm is not None else None


def _block_shift(f, dj: int, di: int, rows=None, fold=None, partner=None):
    """f[j + dj, i + di] on the active block, from its halo (``rows``, a
    ``mesh.Halo`` of f, where given, else the shift's window fetched now,
    ``tripole.window``); ``fold``, (loc, kind): the fold's ghost rows past
    the global north edge of a northward shift (from ``partner``'s strip
    where given)."""
    if rows is None:
        return window(f, dj, di, fold)
    x = (folded(rows, *fold, partner=partner)
         if fold is not None and dj > 0 else rows.ext)
    dep = rows.depth
    return x[..., dep + dj:dep + dj + f.shape[-2],
             dep + di:dep + di + f.shape[-1]]


def _shift(f, sign: int, dim: int, bc: str, rows=None):
    """Value at index+sign along ``dim``; zeros enter at a closed edge.
    ``rows``: ``BC.halo``'s ``mesh.Halo`` of ``f`` (a shift under a
    decomposition then exchanges nothing)."""
    if bc == "tripole":
        if sign > 0:
            raise NotImplementedError(
                "northward shifts on tripole grids need the field's "
                "location and kind; use BC.n / BC.nn / BC.n_partner")
        bc = "closed"  # the south edge of a tripole grid is closed
    if bc not in ("closed", "cyclic"):
        raise ValueError(f"unknown boundary {bc!r}")
    ydim = dim % f.dim() == f.dim() - 2
    d = _decomposed()
    if d is not None and (ydim or d.px > 1 or rows is not None):
        if not ydim and (bc == "cyclic") != d.cyclic:
            raise ValueError(f"an east-west shift with a {bc} edge on a "
                             f"mesh whose edge is "
                             f"{'cyclic' if d.cyclic else 'closed'}")
        return _block_shift(f, sign if ydim else 0, 0 if ydim else sign,
                            rows)
    if bc == "cyclic":
        return torch.roll(f, -sign, dims=dim)
    n = f.shape[dim]
    edge = torch.zeros_like(f.narrow(dim, 0, 1))
    if sign > 0:
        return torch.cat([f.narrow(dim, 1, n - 1), edge], dim=dim)
    strip = _mesh.fold_top(n) if ydim else n
    if strip < n:  # a kernel's strip plane: the south edge lies above it
        return torch.cat([edge, f.narrow(dim, 0, strip - 1), edge,
                          f.narrow(dim, strip, n - strip - 1)], dim=dim)
    return torch.cat([edge, f.narrow(dim, 0, n - 1)], dim=dim)


def shift_e(f, bc_ew: str = "cyclic", rows=None):
    """f[j, i+1]."""
    return _shift(f, +1, -1, bc_ew, rows)


def shift_w(f, bc_ew: str = "cyclic", rows=None):
    """f[j, i-1]."""
    return _shift(f, -1, -1, bc_ew, rows)


def shift_n(f, bc_ns: str = "closed", rows=None):
    """f[j+1, i]."""
    return _shift(f, +1, -2, bc_ns, rows)


def shift_s(f, bc_ns: str = "closed", rows=None):
    """f[j-1, i]."""
    return _shift(f, -1, -2, bc_ns, rows)


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

    def e(self, f, rows=None):
        return shift_e(f, self.ew, rows)

    def w(self, f, rows=None):
        return shift_w(f, self.ew, rows)

    def n(self, f, loc: str = "center", kind: str = "scalar", rows=None):
        if self.ns == "tripole":
            return shift_n_tripole(f, 1, loc, kind, rows)
        return shift_n(f, self.ns, rows)

    def nn(self, f, loc: str = "center", kind: str = "scalar"):
        """Distance-2 northward shift (value at j+2)."""
        if self.ns == "tripole":
            return shift_n_tripole(f, 2, loc, kind)
        if _decomposed() is not None:
            return _block_shift(f, 2, 0)
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
        d = _decomposed()
        if d is not None:
            hf, hp = d.halo([f, partner])
            return _block_shift(f, 1, 0, hf, (loc, kind), partner=hp)
        ghost = fold_rows(partner, 1, loc, kind).unsqueeze(-2)
        return torch.cat([f.narrow(-2, 1, f.shape[-2] - 1), ghost], dim=-2)

    def s(self, f, rows=None):
        return shift_s(f, self.ns, rows)

    @staticmethod
    def halo(fields):
        """For each of ``fields`` (tensors, or None) its ``mesh.Halo`` of
        depth 1 (its block's neighbouring rows, columns and corners, and
        the fold's strip on the top row of blocks), all fetched in one
        exchange; None for a None field and for every field on the whole
        domain. A distance-1 shift of a field given its halo (``rows=``)
        exchanges nothing: a stencil of several shifts pays one exchange,
        not one a shift."""
        d = _decomposed()
        if d is None:
            return [None] * len(fields)
        got = iter(d.halo([f for f in fields if f is not None]))
        return [None if f is None else next(got) for f in fields]

    def _fold(self, loc, kind):
        return (loc, kind) if self.ns == "tripole" else None

    def ne(self, f, loc: str = "center", kind: str = "scalar", rows=None):
        if _decomposed() is not None:
            return _block_shift(f, 1, 1, rows, self._fold(loc, kind))
        # fold first, then shift east: the ghost-cell indexing
        return shift_e(self.n(f, loc, kind, rows), self.ew)

    def nw(self, f, loc: str = "center", kind: str = "scalar", rows=None):
        if _decomposed() is not None:
            return _block_shift(f, 1, -1, rows, self._fold(loc, kind))
        return shift_w(self.n(f, loc, kind, rows), self.ew)

    def se(self, f, rows=None):
        if _decomposed() is not None:
            return _block_shift(f, -1, 1, rows)
        return shift_e(shift_s(f, self.ns, rows), self.ew)

    def sw(self, f, rows=None):
        if _decomposed() is not None:
            return _block_shift(f, -1, -1, rows)
        return shift_w(shift_s(f, self.ns, rows), self.ew)

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
