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

Under a decomposition (``parallel.mesh.scope``) a field is a y slab: a
north-south shift takes its missing rows from the neighbouring slab, one
exchange a shift (``Decomposition.halo_rows``; ``BC.halo`` fetches the
rows of several shifts in one), and every rank joins every exchange, so
even the slabs at the global edges call it. The global south
edge and a closed north edge keep their zeros; the fold fills the north
ghost rows on the top slab only. East-west shifts are unchanged.
"""

from __future__ import annotations

import torch

from pop2_tpu_torch.parallel import mesh as _mesh
from pop2_tpu_torch.tripole import fold_rows, shift_n_tripole

__all__ = [
    "shift_e", "shift_w", "shift_n", "shift_s",
    "shift_ne", "shift_nw", "shift_se", "shift_sw", "BC",
    "div", "grad", "zcurl", "tgrid_to_ugrid", "ugrid_to_tgrid",
]


def _shift(f, sign: int, dim: int, bc: str, rows=None):
    """Value at index+sign along ``dim``; zeros enter at a closed edge.
    ``rows``: ``BC.halo``'s pair for ``f`` (a y shift under a
    decomposition then takes its edge row from it and exchanges nothing)."""
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
    if dim % f.dim() == f.dim() - 2 and _decomposed():
        edge = (_north_rows(f, 1, rows=rows) if sign > 0
                else _south_rows(f, 1, rows=rows))
    else:
        edge = torch.zeros_like(f.narrow(dim, 0, 1))
    if sign > 0:
        return torch.cat([f.narrow(dim, 1, n - 1), edge], dim=dim)
    return torch.cat([edge, f.narrow(dim, 0, n - 1)], dim=dim)


def _decomposed() -> bool:
    d = _mesh.active()
    return d is not None and d.comm is not None


def _north_rows(f, dist: int, fold=None, rows=None):
    """The ``dist`` rows past the slab's north edge: the north neighbour's
    first rows (from ``rows``, ``BC.halo``'s pair, where given, else
    exchanged now, every slab joining), or at the global north edge
    ``fold(f)`` (the tripole's ghost rows) or zeros."""
    if rows is None:
        _, north = _mesh.active().halo_rows([f], 0, dist)
        north = north[0] if north is not None else None
    else:
        north = rows[1]
    if north is not None:
        return north
    if fold is not None:
        return fold(f)
    return torch.zeros_like(f.narrow(-2, 0, dist))


def _south_rows(f, dist: int, rows=None):
    """The ``dist`` rows past the slab's south edge: the south neighbour's
    last rows (from ``rows`` where given), or zeros at the global south
    edge."""
    if rows is None:
        south, _ = _mesh.active().halo_rows([f], dist, 0)
        south = south[0] if south is not None else None
    else:
        south = rows[0]
    if south is not None:
        return south
    return torch.zeros_like(f.narrow(-2, 0, dist))


def shift_e(f, bc_ew: str = "cyclic"):
    """f[j, i+1]."""
    return _shift(f, +1, -1, bc_ew)


def shift_w(f, bc_ew: str = "cyclic"):
    """f[j, i-1]."""
    return _shift(f, -1, -1, bc_ew)


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

    def e(self, f):
        return shift_e(f, self.ew)

    def w(self, f):
        return shift_w(f, self.ew)

    def n(self, f, loc: str = "center", kind: str = "scalar", rows=None):
        if self.ns == "tripole":
            return shift_n_tripole(f, 1, loc, kind, rows)
        return shift_n(f, self.ns, rows)

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
        if _decomposed():
            ghost = _north_rows(f, 1, lambda _: fold_rows(
                partner, 1, loc, kind).unsqueeze(-2))
        else:
            ghost = fold_rows(partner, 1, loc, kind).unsqueeze(-2)
        return torch.cat([f.narrow(-2, 1, f.shape[-2] - 1), ghost], dim=-2)

    def s(self, f, rows=None):
        return shift_s(f, self.ns, rows)

    @staticmethod
    def halo(fields):
        """For each of ``fields`` (tensors, or None), the rows just past its
        slab's south and north edges, (south, north), each None at a global
        edge, all fetched from the neighbouring slabs in one exchange; None
        for a None field and for every field on the whole domain. A
        distance-1 shift of a field given its pair (``rows=``) exchanges
        nothing: a stencil of several shifts pays one exchange, not one a
        shift."""
        d = _mesh.active()
        if d is None or d.comm is None:
            return [None] * len(fields)
        some = [f for f in fields if f is not None]
        south, north = d.halo_rows(some, 1, 1)
        out, i = [], 0
        for f in fields:
            if f is None:
                out.append(None)
                continue
            out.append((south[i] if south is not None else None,
                        north[i] if north is not None else None))
            i += 1
        return out

    def ne(self, f, loc: str = "center", kind: str = "scalar", rows=None):
        # fold first, then shift east: the ghost-cell indexing
        return shift_e(self.n(f, loc, kind, rows), self.ew)

    def nw(self, f, loc: str = "center", kind: str = "scalar", rows=None):
        return shift_w(self.n(f, loc, kind, rows), self.ew)

    def se(self, f, rows=None):
        # south first, so ``rows`` (f's own) serve; the two commute
        return shift_e(shift_s(f, self.ns, rows), self.ew)

    def sw(self, f, rows=None):
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
