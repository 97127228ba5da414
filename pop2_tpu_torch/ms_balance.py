"""Marginal-seas freshwater balancing.

Reference: ``source/ms_balance.F90`` — marginal seas that exchange no
resolved flow with the open ocean accumulate net freshwater imbalance;
``ms_balancing`` (:339-520) moves each region's area-integrated net
freshwater flux to prescribed distribution points (area-weighted
fractions) in the adjacent open ocean, so both the marginal sea and the
global budget stay balanced. Regions are static masks here (the reference
derives them from REGION_MASK and a distribution-point list), built on the
host once (``build_region``) and kept on the device; each step's balancing
is a global sum a region. On a block grid of a decomposition
(``parallel.mesh``) a region is built on the whole domain (its points are
global (j, i)) and cut to the block, and the balancing's sums run over every
block."""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from pop2_tpu_torch.config import ModelConfig
from pop2_tpu_torch.grid import Grid
from pop2_tpu_torch.parallel import mesh as pmesh
from pop2_tpu_torch.reductions import global_sum


class MSRegion(NamedTuple):
    ms_mask: torch.Tensor      # (ny, nx) 1 inside the marginal sea
    dist_frac: torch.Tensor    # (ny, nx) distribution fractions (sum 1)
    ms_area: torch.Tensor      # scalar


def build_region(grid: Grid, ms_mask, dist_points: Sequence[Tuple[int,
                                                                  int]]):
    """dist_points: list of (j, i) open-ocean points; fractions are
    proportional to their cell areas (init_ms_balance :40-335). Host
    NumPy in float64, the region's tensors in the grid's dtype on its
    device. On a block grid ``ms_mask`` is the whole domain's or the
    block's."""
    like = grid.TAREA
    d = pmesh.of_grid(grid)

    def host(t):
        if d is not None and d.comm is not None:
            from pop2_tpu_torch.parallel import multihost
            return multihost.to_host_replicated(torch.as_tensor(
                t, device=like.device), d).astype(np.float64)
        return np.asarray(torch.as_tensor(t).detach().double().cpu())
    ms = host(ms_mask) * host(grid.RCALCT)
    tarea = host(grid.TAREA)
    frac = np.zeros_like(ms)
    tot = sum(tarea[j, i] for (j, i) in dist_points)
    for (j, i) in dist_points:
        frac[j, i] = tarea[j, i] / tot

    def dev(a):
        t = torch.as_tensor(a, dtype=like.dtype, device=like.device)
        return d.slab(t) if d is not None else t
    return MSRegion(ms_mask=dev(ms), dist_frac=dev(frac),
                    ms_area=dev((ms * tarea).sum()))


def ms_balancing(cfg: ModelConfig, grid: Grid, flux,
                 regions: Sequence[MSRegion]):
    """Rebalance a surface freshwater-type flux (per-area units): remove
    each region's net area integral uniformly inside the region and add it
    at the distribution points. Globally conserving by construction."""
    out = flux
    for reg in regions:
        with pmesh.grid_scope(grid):
            net = global_sum(flux * grid.TAREA * reg.ms_mask,
                             b4b=cfg.b4b)  # flux*cm^2
        out = out - reg.ms_mask * net / reg.ms_area \
            + reg.dist_frac * net / grid.TAREA
    return out
