"""Seeded sample inputs with production-shaped isopycnal slopes, for checks
of the GM/Redi path: the CPU tests hand them to this package and to its
reference, the GPU smoke test to the kernels and their plain versions."""

from __future__ import annotations

import numpy as np
import torch

from pop2_tpu_torch import gm


def stratified_tracers(kmask_t, zt, tlat, nt, seed, dtype=np.float64,
                       noise=0.1):
    """(nt, km, ny, nx) NumPy tracers with a stratified T/S profile (warm
    surface, e-folding over 800 m, a meridional gradient and seeded noise of
    ``noise`` K), so that the isopycnal slopes are production-shaped, points
    on the vertical-density-difference clamp included; further tracers are
    1 + noise. Masked to ocean."""
    rng = np.random.RandomState(seed)
    mask = np.asarray(kmask_t)
    km, ny, nx = mask.shape
    zt, lat = np.asarray(zt, np.float64), np.asarray(tlat, np.float64)
    tprof = 2.0 + 16.0 * np.exp(-zt / 8.0e4)
    fields = [
        tprof[:, None, None] + 1.5 * np.cos(2 * lat)[None]
        + noise * rng.randn(km, ny, nx),
        0.0347 + 5.0e-5 * np.sin(3 * lat)[None]
        + 2.0e-4 * noise * rng.randn(km, ny, nx)]
    for _ in range(nt - 2):
        fields.append(1.0 + 2.0 * noise * rng.randn(km, ny, nx))
    return (np.stack(fields) * mask).astype(dtype)


def grid_tracers(cfg, grid, seed, noise=0.1):
    """``stratified_tracers`` on a grid of this package, as a tensor of the
    config's dtype on the grid's device."""
    tracers = stratified_tracers(
        grid.kmask_t.cpu().numpy(), grid.vgrid.zt.double().cpu().numpy(),
        grid.TLAT.double().cpu().numpy(), cfg.nt, seed, noise=noise)
    return torch.as_tensor(tracers).to(device=grid.KMT.device,
                                       dtype=cfg.torch_dtype)


def flux_operands(cfg, grid, bc, ts_range, tmix, levels=(2, 5)):
    """Production-shaped operands of the flux assembly, in its argument
    order (tx, ty, tz, slx, sly, sf_slx, sf_sly, kisop, hor_diff): slopes of
    the tracers ``tmix``, tapered diffusivities under a boundary layer that
    deepens towards the equator from level ``levels[0]`` to ``levels[1]``
    (0-based), a streamfunction with 0.8 of the isopycnal diffusivity."""
    km = cfg.km
    vg = grid.vgrid
    shallow, deep = vg.zt[levels[0]], vg.zt[levels[1]]
    tx, ty, tz, slx, sly = gm._slopes(cfg, grid, bc, ts_range, tmix)
    sla = gm._sla(cfg, grid, slx, sly)
    hblt = ((shallow + (deep - shallow)
             * (0.5 + 0.5 * torch.cos(2 * grid.TLAT))) * (grid.KMT > 0))
    tap_isop, tap_thic = gm._tapers(cfg, grid, sla, hblt)
    kisop = tap_isop * cfg.gm_ah_bolus
    kthic = tap_thic * (0.8 * cfg.gm_ah_bolus)
    hor_diff = torch.where(vg.zt.reshape(1, km, 1, 1) <= hblt,
                           cfg.gm_ah_bkg_srfbl * (1.0 - tap_isop), 0.0)
    in_mask = grid.kmask_t[None, None]
    dz = vg.dz.reshape(km, 1, 1)
    sf_slx = torch.where(in_mask, kthic[None] * slx * dz, 0.0)
    sf_sly = torch.where(in_mask, kthic[None] * sly * dz, 0.0)
    return tuple(t.contiguous() for t in (tx, ty, tz, slx, sly, sf_slx,
                                          sf_sly, kisop, hor_diff))
