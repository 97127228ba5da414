"""Estuary virtual-salt-flux parameterization (river runoff) and the estuary
box model's exchange circulation.

Reference: ``source/estuary_vsf_mod.F90`` — with ``lvsf_river`` the virtual
salt flux of river runoff uses the LOCAL surface salinity instead of the
constant reference salinity, plus a globally-uniform correction so the
global salt budget matches the reference-salinity formulation
(set_estuary_vsf_forcing; vsf_river_correction). Under ``lestuary_exch``
the estuary box model (EBM, estuary_box_model :979-1187) sets an exchange
flow at every river point that redistributes tracers between an upper and
a lower layer (set_estuary_exch_circ :645-755).

Everything a step runs is elementwise on the device. The layers' per-level
weights are host NumPy from the vertical grid (``exchange_layer_weights``),
made once and kept on the grid's device (``device_layer_weights``), so a
captured step never copies them from the host. The box model's scalar
parameters stay Python floats.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pop2_tpu_torch import constants as const
from pop2_tpu_torch.config import ModelConfig
from pop2_tpu_torch.grid import Grid
from pop2_tpu_torch.parallel import mesh as pmesh
from pop2_tpu_torch.reductions import global_sum


def river_vsf(cfg: ModelConfig, grid: Grid, roff_f, s_surface):
    """Virtual salt flux of river water using local salinity.

    roff_f: (ny, nx) river runoff (kg freshwater/m^2/s, positive into
    ocean); s_surface: (ny, nx) model surface salinity (msu).
    Returns the STF_S contribution (msu cm/s): local-salinity flux plus
    the uniform correction term (estuary_vsf_mod.F90
    set_estuary_vsf_forcing).
    """
    r = grid.RCALCT
    # local-salinity virtual salt flux: fresh water dilutes at S_local
    flux_loc = -roff_f * const.FWFLUX_FACTOR_SALT * s_surface \
        * const.SALT_TO_PPT * r
    # reference-salinity flux (the standard salinity_factor form)
    flux_ref = roff_f * const.SALINITY_FACTOR * r
    with pmesh.grid_scope(grid):  # on a block grid, over every block
        correction = global_sum((flux_ref - flux_loc) * grid.TAREA * r,
                                b4b=cfg.b4b) / grid.area_t
    return flux_loc + correction * r


# ---------------------------------------------------------------------------
# Estuary box model (EBM) exchange circulation
# (estuary_box_model, source/estuary_vsf_mod.F90:979-1187;
#  set_estuary_exch_circ :645-755)
# ---------------------------------------------------------------------------

BETA_S = 7.7e-4     # saline contraction (1/ppt) (:1081)
SCHMIDT_EBM = 2.2   # estuarine Schmidt number (:1082)


def _sqrt(x):
    return torch.sqrt(x) if isinstance(x, torch.Tensor) else math.sqrt(x)


def cbrt(x: torch.Tensor) -> torch.Tensor:
    """The real cube root with its sign, sign(x) |x|^(1/3) (torch has no
    ``cbrt``)."""
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def cubic_discriminant(b, c, d):
    """(p, q, disc) of x^3 + b x^2 + c x + d = 0 in depressed form
    t^3 + p t + q (x = t - b/3): three real roots where disc <= 0, one
    where disc > 0."""
    p = c - b * b / 3.0
    q = 2.0 * b ** 3 / 27.0 - b * c / 3.0 + d
    disc = (q / 2.0) ** 2 + (p / 3.0) ** 3
    return p, q, disc


def _cubic_neg_real_root(b, c, d):
    """Vectorized real roots of x^3 + b x^2 + c x + d = 0, returning the
    (physically unique) negative real root, 0 where none exists — the
    whole-field replacement for the reference's cubsolve + root scan
    (:1112-1131). Uses the trigonometric method for three real roots and
    Cardano for one."""
    p, q, disc = cubic_discriminant(b, c, d)
    shift = -b / 3.0

    # three-real-roots branch (disc <= 0): t_k = 2 sqrt(-p/3) cos(...)
    pm = torch.clamp(p, max=-1.0e-30)
    m = 2.0 * torch.sqrt(-pm / 3.0)
    arg = torch.clamp(3.0 * q / (pm * m), -1.0, 1.0)
    theta = torch.arccos(arg) / 3.0
    two_pi_3 = 2.0 * math.pi / 3.0
    roots3 = [m * torch.cos(theta - k * two_pi_3) + shift for k in range(3)]

    # single-real-root branch (disc > 0): Cardano
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    u = cbrt(-q / 2.0 + sq)
    v = cbrt(-q / 2.0 - sq)
    root1 = u + v + shift

    out = torch.zeros_like(b)
    for r in roots3:
        cand = torch.where((disc <= 0.0) & (r < 0.0), r, 0.0)
        out = torch.where(out == 0.0, cand, out)  # first negative real root
    out = torch.where((disc > 0.0) & (root1 < 0.0), root1, out)
    return out


def ebm_coefficients(q_river, tide_amp, s_lower, w_h, h, a1, a2, h0):
    """The box model's nondimensional state and the normalized cubic in
    the lower-layer velocity (:1083-1111): (r0, c_wave, s_l, b/a, c/a,
    d/a). ``q_river`` and ``s_lower`` are tensors; the other arguments
    tensors or Python floats."""
    g = const.GRAV / 100.0
    s_l = torch.clamp(s_lower, min=1.0e-3)
    qr = torch.clamp(q_river, min=1.0e-6)

    u_t = -tide_amp * _sqrt(g / h)
    u_r = qr / (w_h * h * (1.0 - h0))
    c_wave = torch.sqrt(BETA_S * s_l * g * h)
    ur0 = u_r / c_wave
    ut0 = u_t / c_wave
    r0 = ur0 * (1.0 - h0)
    t0 = ut0 * (1.0 - h0) / math.pi

    mix = (SCHMIDT_EBM ** 2 * r0) ** (-1.0 / 3.0)
    a = -h0 ** 3
    b = 2.0 * h0 ** 2 * ((2.0 - h0) * r0 - a2 * t0)
    c = (0.096 * a1 * h0 * mix * r0
         - h0 * ((2.0 - h0) * r0 * (r0 - 2.0 * a2 * t0)
                 + a2 ** 2 * t0 ** 2))
    d = -0.048 * a1 * mix * r0 * (r0 - 2.0 * a2 * t0)
    return r0, c_wave, s_l, b / a, c / a, d / a


def ebm_solve(q_river, tide_amp, s_lower, w_h, h, a1, a2, h0):
    """Vectorized estuary box model (Sun et al. 2017 EBMv2.4;
    estuary_box_model :979-1187). Inputs broadcastable 2-D fields (or
    Python floats for all but ``q_river`` and ``s_lower``) in MKS/ppt like
    the reference's scalars: q_river m^3/s, tide_amp m, s_lower ppt,
    w_h/h m. Returns (q_upper, q_lower, s_upper): m^3/s, m^3/s (negative
    = inflow at depth), ppt."""
    active = (s_lower > 0.0) & (q_river > 0.0)
    r0, c_wave, s_l, b, c, d = ebm_coefficients(
        q_river, tide_amp, s_lower, w_h, h, a1, a2, h0)

    ul0 = _cubic_neg_real_root(b, c, d)
    uu0 = r0 / (1.0 - h0) - h0 / (1.0 - h0) * ul0
    q_l = ul0 * h0 * h * w_h * c_wave
    q_u = uu0 * (1.0 - h0) * h * w_h * c_wave
    s_u = torch.where(q_u != 0.0,
                      -q_l * s_l / torch.where(q_u != 0.0, q_u, 1.0), 0.0)
    zero = torch.zeros_like(q_u)
    return (torch.where(active, q_u,
                        torch.where(q_river > 0.0, q_river, 0.0)),
            torch.where(active, q_l, zero),
            torch.where(active, s_u, zero))


def exchange_layer_weights(cfg: ModelConfig, grid: Grid,
                           h_upper_cm: float, h_lower_cm: float):
    """Static per-level overlap weights of the EBM upper/lower layers with
    the model levels (set_estuary_exch_circ :676-706), host NumPy. Returns
    (w_up, w_lo), each (km,) summing to 1 over the layer."""
    zw = grid.vgrid.zw.detach().double().cpu().numpy()
    ztop = np.concatenate([[0.0], zw[:-1]])
    z1 = h_upper_cm
    z2 = h_upper_cm + h_lower_cm
    w_up = np.clip(np.minimum(zw, z1) - ztop, 0.0, None) / z1
    w_lo = np.clip(np.minimum(zw, z2) - np.maximum(ztop, z1), 0.0,
                   None) / h_lower_cm
    return w_up, w_lo


def device_layer_weights(cfg: ModelConfig, grid: Grid, dtype):
    """``exchange_layer_weights`` at the config's layer depths as (km,)
    tensors of ``dtype`` on the grid's device: made on the host the first
    time and kept on the grid object (a step reads them without a copy
    from the host)."""
    cache = grid.__dict__.setdefault("_estuary_weights", {})
    key = (cfg.est_h_upper, cfg.est_h_lower, dtype)
    if key not in cache:
        cache[key] = tuple(
            torch.as_tensor(w, dtype=dtype, device=grid.KMT.device)
            for w in exchange_layer_weights(cfg, grid, cfg.est_h_upper,
                                            cfg.est_h_lower))
    return cache[key]


def exchange_circulation(cfg: ModelConfig, grid: Grid, tracer_cur, roff_f,
                         w_up, w_lo, want_flux: bool = False):
    """Tracer tendency of the EBM exchange circulation (nt, km, ny, nx):
    Q_lower draws lower-layer ocean water into the estuary and Q_upper
    returns it mixed with river water — a vertical redistribution with flux
    FLUX_EXCH_INTRF = -Q_l (T_lower - T_upper_out) / TAREA across the layer
    interface (:727-738), applied conservatively: source in the upper
    layer, sink in the lower layer.

    roff_f: (ny, nx) river runoff (kg/m^2/s); w_up/w_lo: (km,) from
    exchange_layer_weights (host arrays) or ``device_layer_weights``.
    """
    km = cfg.km
    w_up_j, w_lo_j = (torch.as_tensor(w, dtype=tracer_cur.dtype,
                                      device=tracer_cur.device
                                      ).reshape(km, 1, 1)
                      for w in (w_up, w_lo))

    # layer-average tracers (ppt handled internally in msu — unit factors
    # cancel in the difference/redistribution)
    t_up = torch.sum(tracer_cur * w_up_j[None], dim=1)
    t_lo = torch.sum(tracer_cur * w_lo_j[None], dim=1)

    # EBM per point, MKS: Q_river m^3/s from kg/m^2/s runoff over the cell
    # (:663: fwmass_to_fwflux*ROFF_F*TAREA*1e-6)
    q_river = roff_f * const.FWMASS_TO_FWFLUX * grid.TAREA * 1.0e-6
    s_lower_ppt = t_lo[1] * const.SALT_TO_PPT
    q_u, q_l, s_u = ebm_solve(
        q_river, cfg.est_tide_amp, s_lower_ppt, cfg.est_mouth_width,
        cfg.est_mouth_depth, cfg.est_length_a1, cfg.est_tidal_pump_a2,
        cfg.est_lower_depth_ratio)

    # upper-layer outflow tracer: salinity from the EBM, others unchanged
    t_out = torch.cat([t_up[:1], (s_u * const.PPT_TO_SALT)[None], t_up[2:]])

    # interface flux, tracer * cm/s (:733-738); Q_l < 0 so flux > 0 moves
    # tracer upward (lower -> upper)
    flux = -q_l[None] * 1.0e6 * (t_lo - t_out) * grid.TAREA_R * grid.RCALCT

    # conservative redistribution: gain spread over the upper layer, loss
    # over the lower layer (column integral of src vanishes)
    dz3 = grid.vgrid.dz.reshape(km, 1, 1)
    h_up_cm = torch.sum(w_up_j * dz3, dim=0)
    h_lo_cm = torch.sum(w_lo_j * dz3, dim=0)
    src = flux[:, None] * (w_up_j[None] / torch.clamp(h_up_cm, min=1.0)
                           - w_lo_j[None] / torch.clamp(h_lo_cm, min=1.0))
    src = torch.where(grid.kmask_t[None], src, 0.0)
    if want_flux:
        # (src, FLUX_EXCH_INTRF) — the interface flux is the
        # T/S_FLUX_EXCH_INTRF tavg field (estuary_vsf_mod.F90:740-751)
        return src, flux
    return src
