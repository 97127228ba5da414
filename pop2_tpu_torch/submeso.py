"""Submesoscale mixed-layer eddy parameterization (Fox-Kemper et al.), plain
PyTorch.

Reference: ``source/mix_submeso.F90``: an overturning streamfunction
Psi ~ Ce H^2 mu(z) (grad_H b)_ML / |f| restratifies the mixed layer, applied
as a skew flux with GM's quarter-cell structure (submeso_sf :341-772,
submeso_flux :779-1008); the density and tracer face differences are GM's
(hmix_gm_submeso_share.F90, ``gm.face_density_diffs``).

The streamfunction is a dense (2 faces, 2 halves, km, ny, nx) tensor; the
reference's masked integrals down the mixed layer are weight fields. It
factors into 2-D amplitudes times the vertical shape mu(z) of each quarter
cell (``amplitudes``, ``sf_from_amps``): that is how the GM chain kernel
takes it (``gm_chain_cuda``, its ``with_sm`` mode), adding mu(z) times the
amplitude to the merged GM streamfunction, since the skew flux is linear in
the streamfunction.
"""

from __future__ import annotations

import math

import torch

from pop2_tpu_torch import constants as const
from pop2_tpu_torch import gm as gm_mod
from pop2_tpu_torch.config import ModelConfig
from pop2_tpu_torch.grid import Grid
from pop2_tpu_torch.stencil import BC


def _ml_layer_weights(grid: Grid, ml):
    """Thickness of each layer inside the mixed layer: dz(k) for layers
    wholly inside, ml - zw(k-1) for the layer holding its base
    (submeso_sf :435-466)."""
    zw = grid.vgrid.zw
    zw_top = torch.cat([torch.zeros_like(zw[:1]), zw[:-1]])
    zwk, zwt = zw[:, None, None], zw_top[:, None, None]
    dz = grid.vgrid.dz[:, None, None]
    full = ml[None] > zwk
    partial = (ml[None] <= zwk) & (ml[None] > zwt)
    return torch.where(full, dz, torch.where(partial, ml[None] - zwt, 0.0))


def _mixed_layer(grid: Grid, hmxl):
    """The mixed-layer depth the scheme uses: hmxl, at least zw(1), and
    zw(1) on land or without one."""
    zw0 = grid.vgrid.zw[0]
    ocean = grid.KMT > 0
    ml = hmxl if hmxl is not None else zw0.expand(grid.HT.shape)
    return torch.where(ocean, torch.clamp(ml, min=zw0), zw0)


def _gradients(cfg: ModelConfig, grid: Grid, bc: BC, ts_range, tmix, ml):
    """(bx, by, ts, hls): the mixed-layer averages of the horizontal
    buoyancy gradients across the east/west and north/south faces (2, ny,
    nx) each, the time scale 1/sqrt(f^2 + 1/tau^2) and the horizontal
    length scale (submeso_sf :400-546)."""
    km = cfg.km
    vg = grid.vgrid
    zt, dzw = vg.zt, vg.dzw
    ocean = grid.KMT > 0

    # only T and S enter the density differences
    _, _, _, rx, ry, rz_ktp_raw, _ = gm_mod.face_density_diffs(
        cfg, grid, bc, ts_range, tmix[:2])
    rz_save = torch.clamp(rz_ktp_raw, max=0.0)   # RZ_SAVE (share :398)

    w = _ml_layer_weights(grid, ml)
    bx = -const.GRAV * torch.sum(rx * w[None], dim=1) / ml[None]
    by = -const.GRAV * torch.sum(ry * w[None], dim=1) / ml[None]
    bx = torch.where(ocean[None], bx, 0.0)
    by = torch.where(ocean[None], by, 0.0)

    # time scale (init_submeso :267-269)
    ts = 1.0 / torch.sqrt(grid.FCORT ** 2
                          + 1.0 / cfg.submeso_timescale ** 2)

    if cfg.submeso_const_hls:
        hls = torch.where(ocean, cfg.submeso_hor_length_scale, 0.0)
    else:
        # deformation-radius-like scales (submeso_sf :483-546)
        w1 = torch.sqrt(0.5 * ((bx[0] ** 2 + bx[1] ** 2) / grid.DXT ** 2
                               + (by[0] ** 2 + by[1] ** 2) / grid.DYT ** 2))
        w1 = w1 * ml * ts ** 2
        # the integral of N through the mixed layer: for k = 2..km the
        # weight dzw(k-1) while ml > zt(k), a quadratic partial weight in
        # the layer holding the base
        ztk, ztkm1 = zt[1:, None, None], zt[:-1, None, None]
        dzwk = dzw[1:km, None, None]
        full = ml[None] > ztk
        partial = (ml[None] <= ztk) & (ml[None] >= ztkm1)
        w3 = torch.where(full, dzwk, torch.where(
            partial, (ml[None] - ztkm1) ** 2 / dzwk, 0.0))
        w2 = torch.sum(torch.sqrt(torch.clamp(-rz_save[1:] * w3, min=0.0)),
                       dim=0)
        w2 = math.sqrt(const.GRAV) * w2 * ts
        hls = torch.where(ocean, torch.clamp(torch.maximum(w1, w2),
                                             min=cfg.submeso_hor_length_scale),
                          0.0)
    return bx, by, ts, hls


def _grid_scales(cfg: ModelConfig, grid: Grid):
    return (torch.clamp(grid.DXT, max=cfg.submeso_max_grid_scale),
            torch.clamp(grid.DYT, max=cfg.submeso_max_grid_scale))


def _ref_depths(grid: Grid):
    """(2 halves, km, 1, 1): the middle of the top and the bottom quarter of
    each cell, where the vertical shape is evaluated."""
    vg = grid.vgrid
    return torch.stack([vg.zt - 0.25 * vg.dz,
                        vg.zt + 0.25 * vg.dz])[:, :, None, None]


def vertical_shape(rd, ml):
    """The Fox-Kemper vertical shape mu(z) at depths ``rd`` in a mixed
    layer of depth ``ml``: (1 - w)(1 + 5/21 w), w = (1 - 2 z/ml)^2."""
    w3 = (1.0 - 2.0 * rd / ml) ** 2
    return (1.0 - w3) * (1.0 + (5.0 / 21.0) * w3)


def _amplitudes_hls(cfg: ModelConfig, grid: Grid, bc: BC, ts_range, tmix,
                    hmxl):
    """(``amplitudes``, HLS): Psi = Ce ml^2 mu(z) T / HLS grad_b per quarter
    cell (submeso_sf :551-596) without its vertical shape mu(z)."""
    ml = _mixed_layer(grid, hmxl)
    bx, by, ts, hls = _gradients(cfg, grid, bc, ts_range, tmix, ml)
    hls_safe = torch.where(hls > 0.0, hls, 1.0)
    amp = cfg.submeso_efficiency * ml ** 2 * ts / hls_safe
    amp = torch.where(grid.KMT > 0, amp, 0.0)
    cdx, cdy = _grid_scales(cfg, grid)
    return torch.stack([amp * bx[0] * cdx, amp * bx[1] * cdx,
                        amp * by[0] * cdy, amp * by[1] * cdy, ml]), hls


def amplitudes(cfg: ModelConfig, grid: Grid, bc: BC, ts_range, tmix,
               hmxl=None):
    """(5, ny, nx): the streamfunction amplitudes of the east, west, north
    and south faces and the mixed-layer depth, such that a quarter cell's
    streamfunction is amplitude x mu(z) where its reference depth lies in
    the mixed layer (``gm_chain_pallas._submeso_amps`` of the JAX package,
    the operand of the chain kernel's ``with_sm`` mode)."""
    return _amplitudes_hls(cfg, grid, bc, ts_range, tmix, hmxl)[0]


def streamfunction(cfg: ModelConfig, grid: Grid, bc: BC, ts_range, tmix,
                   hmxl=None):
    """SF_SUBM_X/Y, shape (2 faces, 2 halves, km, ny, nx), and the
    horizontal length scale HLS (submeso_sf :341-772)."""
    amps, hls = _amplitudes_hls(cfg, grid, bc, ts_range, tmix, hmxl)
    return (*sf_from_amps(grid, amps), hls)


def sf_from_amps(grid: Grid, amps):
    """(sfx, sfy) of shape (2 faces, 2 halves, km, ny, nx) from the
    ``amplitudes``: amplitude x mu(z) where a quarter cell's reference depth
    lies in the mixed layer and in the column."""
    km = grid.vgrid.dz.shape[0]
    ml = amps[4]
    kidx = torch.arange(1, km + 1, device=ml.device)[:, None, None]
    rd = _ref_depths(grid)
    active = (rd < ml) & (kidx <= grid.KMT[None])[None]
    ml_safe = torch.where(ml > 0.0, ml, 1.0)
    mu = torch.where(active, vertical_shape(rd, ml_safe), 0.0)
    sfx = torch.stack([mu * amps[0], mu * amps[1]])
    sfy = torch.stack([mu * amps[2], mu * amps[3]])
    return sfx, sfy


def gtk(cfg: ModelConfig, grid: Grid, bc: BC, sfx, sfy, tx, ty, tz):
    """Skew-flux divergence of the submesoscale streamfunction for all
    tracers (submeso_flux :779-1008). Returns (nt, km, ny, nx)."""
    km = cfg.km
    kidx = torch.arange(1, km + 1, device=tx.device)[:, None, None]
    # HYX = HTE/HUS, HXY = HTN/HUW (source/grid.F90 stencil metrics)
    hyx = grid.HTE / grid.HUS
    hxy = grid.HTN / grid.HUW
    in_c = kidx <= grid.KMT[None]
    cx = torch.where(in_c & (kidx <= grid.KMTE[None]), 0.25 * hyx, 0.0)
    cy = torch.where(in_c & (kidx <= grid.KMTN[None]), 0.25 * hxy, 0.0)
    km_mask = (kidx < grid.KMT[None]).to(cx.dtype)

    def kp1(f):
        return torch.cat([f[:, 1:], f[:, -1:]], dim=1)

    tz_kp1, tx_kp1, ty_kp1 = kp1(tz), kp1(tx), kp1(ty)

    fx = cx[None] * (sfx[0, 0][None] * tz + sfx[0, 1][None] * tz_kp1
                     + bc.e(sfx[1, 0])[None] * bc.e(tz)
                     + bc.e(sfx[1, 1])[None] * bc.e(tz_kp1))
    fy = cy[None] * (sfy[0, 0][None] * tz + sfy[0, 1][None] * tz_kp1
                     + bc.n_partner(sfy[1, 0], sfy[0, 0],
                                    "center", "vector")[None] * bc.n(tz)
                     + bc.n_partner(sfy[1, 1], sfy[0, 1],
                                    "center", "vector")[None]
                     * bc.n(tz_kp1))

    hyxw, hxys = bc.w(hyx), bc.s(hxy)

    def top_below(sf):
        """The top-half streamfunction of the level below, zero under the
        last level: (face, km, ny, nx)."""
        return torch.cat([sf[:, 0, 1:], torch.zeros_like(sf[:, 0, :1])],
                         dim=1)

    def cross(sl_x, sl_y, txl, tyl):
        return (sl_x[0] * hyx * txl + sl_y[0] * hxy * tyl
                + sl_x[1] * hyxw * bc.w(txl) + sl_y[1] * hxys * bc.s(tyl))

    work = (cross(sfx[:, 1], sfy[:, 1], tx, ty)
            + cross(top_below(sfx), top_below(sfy), tx_kp1, ty_kp1))
    fz = -km_mask[None] * 0.25 * work
    fz[:, -1] = 0.0
    fz_top = torch.cat([torch.zeros_like(fz[:, :1]), fz[:, :-1]], dim=1)

    out = ((fx - bc.w(fx) + fy - bc.s(fy) + fz_top - fz)
           * grid.vgrid.dzr[None, :, None, None] * grid.TAREA_R)
    return torch.where(grid.kmask_t[None], out, 0.0)


def submeso_tendency(cfg: ModelConfig, grid: Grid, bc: BC, ts_range, tmix,
                     hmxl=None):
    """The submesoscale tracer tendency (streamfunction and flux) and the
    horizontal length scale."""
    sfx, sfy, hls = streamfunction(cfg, grid, bc, ts_range, tmix, hmxl)
    tx, ty, tz = gm_mod.tracer_diffs(cfg, grid, bc, tmix)
    return gtk(cfg, grid, bc, sfx, sfy, tx, ty, tz), hls
