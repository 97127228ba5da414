"""Tripole northern-boundary fold on torch tensors.

Reference: ``mpi/POP_HaloMod.F90`` — the tripole branch fills the northern
ghost rows with index-reversed (and, for vector fields, sign-flipped) copies
of the top physical rows (:1961-2050). The map depends on where the field
lives on the B-grid cell (1-based indices):

  location    i-mapping         j-mapping (ghost n = 1..halo)
  center      i -> nx+1-i       ghost row ny+n  <- phys row ny+1-n
  NE corner   i -> nx-i         ghost row ny+n  <- phys row ny-n
  E face      i -> nx-i         ghost row ny+n  <- phys row ny+1-n
  N face      i -> nx+1-i       ghost row ny+n  <- phys row ny-n

For corner and N-face fields the top physical row lies on the fold itself:
each point coincides with its mirror, so the pair is made symmetric by
averaging magnitudes (:1977-1986). Vector fields flip sign (isign = -1,
:1936-1956).

The fold is an index map here; the CUDA kernels apply the same map to the
north ghost row of their tiles (``csrc/common.cuh``, ``fold_slot``).

Under a decomposition (``parallel.mesh.scope``) the fold acts on the top
slab only, which holds the global top rows; the other slabs take the rows
past their north edge from their neighbour (``shift_n_tripole``) and leave
their top row alone (``enforce_top_symmetry``).
"""

from __future__ import annotations

import numpy as np
import torch

from pop2_tpu_torch.parallel import mesh as _mesh

__all__ = ["fold_rows", "shift_n_tripole", "enforce_top_symmetry",
           "reduction_weights"]


def _rev_center(row):
    """i -> nx+1-i (1-based): 0-based i -> nx-1-i."""
    return torch.flip(row, dims=(-1,))


def _rev_corner(row):
    """i -> nx-i (1-based): 0-based i -> nx-2-i, with i = nx-1 -> nx-1 (the
    reference's iSrc == 0 -> nxGlobal wrap)."""
    return torch.roll(torch.flip(row, dims=(-1,)), -1, dims=-1)


def fold_rows(f, n: int, loc: str = "center", kind: str = "scalar"):
    """Value of ghost row ny-1+n (0-based; n = 1..halo) under the fold.
    f: (..., ny, nx); returns (..., nx)."""
    ny = f.shape[-2]
    if loc == "center":
        out = _rev_center(f[..., ny - n, :])
    elif loc == "necorner":
        out = _rev_corner(f[..., ny - 1 - n, :])
    elif loc == "eface":
        out = _rev_corner(f[..., ny - n, :])
    elif loc == "nface":
        out = _rev_center(f[..., ny - 1 - n, :])
    else:
        raise ValueError(f"unknown location {loc}")
    return -out if kind == "vector" else out


def shift_n_tripole(f, dist: int = 1, loc: str = "center",
                    kind: str = "scalar", rows=None):
    """f shifted so that result[j] = f[j+dist], the northern ghost values
    from the fold; dist in {1, 2}. Under a decomposition the slabs below
    the top take their neighbour's rows: from ``rows`` (``stencil.BC.halo``'s
    pair for f, distance 1) where given, else exchanged now (every slab
    joins the exchange)."""
    kept = [f.narrow(-2, dist, f.shape[-2] - dist)]
    d = _mesh.active()
    if d is not None and d.comm is not None:
        if rows is not None:
            north = rows[1]
        else:
            _, north = d.halo_rows([f], 0, dist)
            north = north[0] if north is not None else None
        if north is not None:
            return torch.cat(kept + [north], dim=-2)
    kept += [fold_rows(f, n, loc, kind).unsqueeze(-2)
             for n in range(1, dist + 1)]
    return torch.cat(kept, dim=-2)


def enforce_top_symmetry(f, loc: str = "necorner", kind: str = "vector"):
    """Make the degenerate top row of a corner or N-face field symmetric
    (mpi/POP_HaloMod.F90:1977-1986): a point and its fold partner both get
    the mean of their magnitudes, each with the partner's sign (times
    isign for vectors). Other locations are returned as they are, and so
    is every slab but the top one of a decomposition."""
    d = _mesh.active()
    if d is not None and not d.top:
        return f
    if loc == "necorner":
        partner = _rev_corner(f[..., -1, :])
    elif loc == "nface":
        partner = _rev_center(f[..., -1, :])
    else:
        return f
    sign = -1.0 if kind == "vector" else 1.0
    top = f[..., -1, :]
    newtop = sign * torch.sign(partner) * (
        0.5 * (torch.abs(top) + torch.abs(partner)))
    return torch.cat([f.narrow(-2, 0, f.shape[-2] - 1),
                      newtop.unsqueeze(-2)], dim=-2)


def reduction_weights(ny: int, nx: int, loc: str = "center", dtype=None,
                      device=None):
    """Weights for global sums on a tripole grid: for corner and N-face
    fields the top row is redundant past the first half of the domain
    (mpi/global_reductions.F90:226-240) and weighs zero there."""
    w = np.ones((ny, nx))
    if loc in ("necorner", "nface"):
        w[-1, nx // 2:] = 0.0
    return torch.as_tensor(w, dtype=dtype, device=device)
