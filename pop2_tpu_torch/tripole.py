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
north ghost row of their tiles (``csrc/common.cuh``, ``fold_point``).

Under a decomposition (``parallel.mesh.scope``) the fold acts on the top
row of blocks, which holds the global top rows; the other blocks take the
rows past their north edge from their neighbours (``shift_n_tripole``) and
leave their top row alone (``enforce_top_symmetry``). A top-row block's
partner columns nx-1-i lie on its mirror block (and one column beside it
for the corner map): they come in the halo's strip (``mesh.Halo``), the
top rows over the mirrors of the block's extended columns, from which
``strip_fold`` forms the ghost rows in the block's column order. Inside a
kernel call on a top-row block of an x decomposition the plane's first
rows are such a strip, and ``fold_rows`` reads the fold's rows there
(``mesh.fold_top``).
"""

from __future__ import annotations

import numpy as np
import torch

from pop2_tpu_torch.parallel import mesh as _mesh

__all__ = ["fold_rows", "strip_fold", "shift_n_tripole",
           "enforce_top_symmetry", "reduction_weights"]


def _rev_center(row):
    """i -> nx+1-i (1-based): 0-based i -> nx-1-i."""
    return torch.flip(row, dims=(-1,))


def _rev_corner(row):
    """i -> nx-i (1-based): 0-based i -> nx-2-i, with i = nx-1 -> nx-1 (the
    reference's iSrc == 0 -> nxGlobal wrap)."""
    return torch.roll(torch.flip(row, dims=(-1,)), -1, dims=-1)


def fold_rows(f, n: int, loc: str = "center", kind: str = "scalar"):
    """Value of ghost row ny-1+n (0-based; n = 1..halo) under the fold.
    f: (..., ny, nx); returns (..., nx). Inside a kernel call on a strip
    plane the fold's top row is the strip's (``mesh.fold_top``)."""
    ny = _mesh.fold_top(f.shape[-2])
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


def strip_fold(strip, n: int, loc: str = "center", kind: str = "scalar"):
    """Ghost row n (1..depth) of a block's extended columns [i0 - depth,
    i1 + depth) from its halo's strip (``mesh.Halo``: the top rows over
    global columns nx - i1 - depth - 1 ..., natural order): the strip's
    row and columns reversed, the corner map's one column further west.
    strip: (..., FOLD_ROWS, cols + 2 depth + 1); returns (..., cols + 2
    depth)."""
    rows = strip.shape[-2]
    if loc == "center":
        out = strip[..., rows - n, 1:]
    elif loc == "necorner":
        out = strip[..., rows - 1 - n, :-1]
    elif loc == "eface":
        out = strip[..., rows - n, :-1]
    elif loc == "nface":
        out = strip[..., rows - 1 - n, 1:]
    else:
        raise ValueError(f"unknown location {loc}")
    out = torch.flip(out, dims=(-1,))
    return -out if kind == "vector" else out


def _ghost_rows(strip, depth: int, n: int, loc: str, kind: str):
    """Ghost rows 1..n of the active block's extended columns [i0 - depth,
    i1 + depth) from a strip of the fold's top rows (``strip_fold``), zero
    past a closed east-west edge."""
    d = _mesh.active()
    ghost = torch.stack([strip_fold(strip, k, loc, kind)
                         for k in range(1, n + 1)], dim=-2)
    if not d.cyclic:
        g = torch.arange(d.i0 - depth, d.i1 + depth, device=ghost.device)
        ghost = torch.where((g >= 0) & (g < d.nx), ghost,
                            torch.zeros_like(ghost))
    return ghost


def folded(halo, loc: str = "center", kind: str = "scalar", partner=None):
    """``halo.ext`` (a ``mesh.Halo`` of the active decomposition's block)
    with its rows past the global north edge the fold's ghost rows where the
    block holds the fold (from ``partner``'s strip where given: the ghost
    row of a field that folds from its counterpart, ``BC.n_partner``); the
    columns past a closed east-west edge stay zero."""
    if halo.strip is None:
        return halo.ext
    depth = halo.depth
    src = partner if partner is not None else halo
    ghost = _ghost_rows(src.strip, depth, depth, loc, kind)
    keep = halo.ext.shape[-2] - depth
    return torch.cat([halo.ext.narrow(-2, 0, keep), ghost], dim=-2)


def window(f, dj: int, di: int, fold=None):
    """f[j + dj, i + di] on the active block: only the rows and columns
    the shift reads past the block's edges are fetched from their owners,
    in one exchange every block joins; zero past a closed edge and the
    global south edge. ``fold``, (loc, kind): the rows past the global north
    edge are the fold's ghost rows on the top row of a tripole grid, from
    the mirror block's strip fetched in the same exchange."""
    d = _mesh.active()
    depth = max(abs(dj), abs(di))
    strip = fold is not None and dj > 0

    def regions(b):
        win = [(b.j0 + dj, b.j1 + dj, b.i0 + di, b.i1 + di, b.cyclic)]
        return win + ([b.strip_region(depth, _mesh.FOLD_ROWS)]
                      if strip and b.fold else [])
    got = d.fetch([f], regions, ("shift", dj, di, strip))
    win = got[0][0]
    if strip and d.fold:
        rows, cols = f.shape[-2:]
        ghost = _ghost_rows(got[1][0], depth, dj, *fold)
        win = torch.cat([win.narrow(-2, 0, rows - dj),
                         ghost[..., depth + di:depth + di + cols]], dim=-2)
    return win


def shift_n_tripole(f, dist: int = 1, loc: str = "center",
                    kind: str = "scalar", rows=None):
    """f shifted so that result[j] = f[j+dist], the northern ghost values
    from the fold; dist in {1, 2}. Under a decomposition from the block's
    halo (``rows``, a ``mesh.Halo`` of f of depth >= dist, where given, else
    the shift's ``window`` fetched now, every block joining the exchange),
    the fold's ghost rows formed on the top row of blocks."""
    d = _mesh.active()
    if d is not None and d.comm is not None:
        if rows is None:
            return window(f, dist, 0, (loc, kind))
        x = folded(rows, loc, kind)
        return x[..., rows.depth + dist:rows.depth + dist + f.shape[-2],
                 rows.depth:rows.depth + f.shape[-1]]
    kept = [f.narrow(-2, dist, f.shape[-2] - dist)]
    kept += [fold_rows(f, n, loc, kind).unsqueeze(-2)
             for n in range(1, dist + 1)]
    return torch.cat(kept, dim=-2)


def enforce_top_symmetry(f, loc: str = "necorner", kind: str = "vector"):
    """Make the degenerate top row of a corner or N-face field symmetric
    (mpi/POP_HaloMod.F90:1977-1986): a point and its fold partner both get
    the mean of their magnitudes, each with the partner's sign (times
    isign for vectors). Other locations are returned as they are, and so
    is every block below the top row of a decomposition; a top-row block
    takes its partners from the mirror block (an exchange every block
    joins)."""
    if loc == "necorner":
        rev = _rev_corner
    elif loc == "nface":
        rev = _rev_center
    else:
        return f
    d = _mesh.active()
    if d is not None and d.comm is not None:
        got = d.fetch([f], lambda b: [b.strip_region(0, 1)] if b.top
                      else [], "top row")
        if not d.top:
            return f
        partner = strip_fold(got[0][0], 0, loc)  # the top row itself
    else:
        partner = rev(f[..., -1, :])
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
    (mpi/global_reductions.F90:226-240) and weighs zero there, in global
    columns: under a decomposition the active block's share of them."""
    d = _mesh.active()
    if d is not None:  # (ny, nx) the block's: the weights of its columns
        ny, nx = d.ny, d.nx
    w = np.ones((ny, nx))
    if loc in ("necorner", "nface"):
        w[-1, nx // 2:] = 0.0
    w = torch.as_tensor(w, dtype=dtype, device=device)
    return d.slab(w) if d is not None else w
