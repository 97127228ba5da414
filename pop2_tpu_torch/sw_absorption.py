"""Penetrating shortwave absorption (plain PyTorch).

Reference: ``source/sw_absorption.F90`` — the Jerlov water-type
double-exponential transmission (:786-805) and its per-level profile
(:364-369), the tracer source ``add_sw_absorb`` (:818-905), and the
chlorophyll-dependent variant (Ohlmann 2003, Table 1a :135-217; transmission
Trans(z) = A1 exp(-B1 z) + A2 exp(-B2 z), a 400-entry log-chl table in the
reference :640-718). As in the JAX package the A/B coefficients are
interpolated in log-chl on the (ny, nx) chlorophyll field and the
transmission is evaluated in closed form.
"""

from __future__ import annotations

import numpy as np
import torch

from pop2_tpu_torch import constants as const
from pop2_tpu_torch.config import ModelConfig
from pop2_tpu_torch.grid import Grid

# Jerlov water types I, IA, IB, II, III (source/sw_absorption.F90:786-788)
RFAC = np.array([0.58, 0.62, 0.67, 0.77, 0.78])
DEPTH1 = np.array([0.35, 0.60, 1.00, 1.50, 1.40])
DEPTH2 = np.array([23.0, 20.0, 17.0, 14.0, 7.90])
DEPTH_CUTOFF = -200.0  # meters


def sw_absorb_frac(depth_cm, water_type: int):
    """Transmission fraction at the depths of the tensor ``depth_cm``
    (source/sw_absorption.F90:796-805): the Jerlov profile, and KPP's
    radiative term of the boundary-layer depth (vmix_kpp.F90:2387-2402,
    2715-2720)."""
    i = water_type - 1
    z = -depth_cm * const.MPERCM
    frac = (float(RFAC[i]) * torch.exp(z / float(DEPTH1[i]))
            + (1.0 - float(RFAC[i])) * torch.exp(z / float(DEPTH2[i])))
    return torch.where(z < DEPTH_CUTOFF, 0.0, frac)


def absorb_profile(cfg: ModelConfig, grid: Grid) -> torch.Tensor:
    """Per-interface Jerlov transmission sw_absorb(0:km)
    (source/sw_absorption.F90:364-369): 1 at the surface, 0 below km."""
    km = cfg.km
    zw = grid.vgrid.zw.double().cpu()
    prof = torch.zeros(km + 1, dtype=torch.float64)
    prof[0] = 1.0
    prof[1:km] = sw_absorb_frac(zw[:km - 1], cfg.jerlov_water_type)
    return prof.to(device=grid.vgrid.zw.device, dtype=cfg.torch_dtype)


def add_sw_absorb(cfg: ModelConfig, grid: Grid, ft, shf_qsw, sw_absorb):
    """ft with the penetrative shortwave heating added to the temperature
    tendency (source/sw_absorption.F90:875-898): an interior layer absorbs
    the transmission difference, the local bottom layer everything that
    reached it. ``sw_absorb``: the per-interface transmission, (km+1,) for
    the Jerlov profile or (km+1, ny, nx) for the chlorophyll one."""
    km = cfg.km
    work = torch.clamp(shf_qsw, min=0.0)
    kidx = torch.arange(1, km + 1, dtype=torch.int32,
                        device=ft.device).reshape(km, 1, 1)
    dzr = grid.vgrid.dzr.reshape(km, 1, 1)
    if sw_absorb.dim() == 1:
        sw_absorb = sw_absorb.reshape(km + 1, 1, 1)
    frac_interior = sw_absorb[:-1] - sw_absorb[1:]
    frac_bottom = sw_absorb[:-1]
    frac = torch.where(kidx < grid.KMT[None], frac_interior, frac_bottom)
    src = torch.where(kidx <= grid.KMT[None], work[None] * frac * dzr, 0.0)
    out = ft.clone()
    out[0] += src
    return out


# -- chlorophyll-dependent transmission (Ohlmann 2003, Table 1a;
#    source/sw_absorption.F90:135-217) ---------------------------------------

CHLCNC = np.array([
    0.001, 0.005, 0.01, 0.02, 0.03, 0.05, 0.10, 0.15, 0.20, 0.25, 0.30,
    0.35, 0.40, 0.45, 0.50, 0.60, 0.70, 0.80, 0.90, 1.00, 1.50, 2.00,
    2.50, 3.00, 4.00, 5.00, 6.00, 7.00, 8.00, 9.00, 10.00])
A_1 = np.array([
    0.4421, 0.4451, 0.4488, 0.4563, 0.4622, 0.4715, 0.4877, 0.4993,
    0.5084, 0.5159, 0.5223, 0.5278, 0.5326, 0.5369, 0.5408, 0.5474,
    0.5529, 0.5576, 0.5615, 0.5649, 0.5757, 0.5802, 0.5808, 0.5788,
    0.56965, 0.55638, 0.54091, 0.52442, 0.50766, 0.49110, 0.47505])
A_2 = np.array([
    0.2981, 0.2963, 0.2940, 0.2894, 0.2858, 0.2800, 0.2703, 0.2628,
    0.2571, 0.2523, 0.2481, 0.2444, 0.2411, 0.2382, 0.2356, 0.2309,
    0.2269, 0.2235, 0.2206, 0.2181, 0.2106, 0.2089, 0.2113, 0.2167,
    0.23357, 0.25504, 0.27829, 0.30274, 0.32698, 0.35056, 0.37303])
B_1 = np.array([
    0.0287, 0.0301, 0.0319, 0.0355, 0.0384, 0.0434, 0.0532, 0.0612,
    0.0681, 0.0743, 0.0800, 0.0853, 0.0902, 0.0949, 0.0993, 0.1077,
    0.1154, 0.1227, 0.1294, 0.1359, 0.1640, 0.1876, 0.2082, 0.2264,
    0.25808, 0.28498, 0.30844, 0.32932, 0.34817, 0.36540, 0.38132])
B_2 = np.array([
    0.3192, 0.3243, 0.3306, 0.3433, 0.3537, 0.3705, 0.4031, 0.4262,
    0.4456, 0.4621, 0.4763, 0.4889, 0.4999, 0.5100, 0.5191, 0.5347,
    0.5477, 0.5588, 0.5682, 0.5764, 0.6042, 0.6206, 0.6324, 0.6425,
    0.66172, 0.68144, 0.70086, 0.72144, 0.74178, 0.76190, 0.78155])

MAXARG = 35.0  # exp-underflow guard (source/sw_absorption.F90:703)


def _interp(x, xp, fp):
    """Piecewise-linear interpolation of the table (xp, fp) at x inside
    [xp[0], xp[-1]] (numpy.interp's formula)."""
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1,
                    xp.numel() - 1)
    x0, f0 = xp[i - 1], fp[i - 1]
    return f0 + ((x - x0) / (xp[i] - x0)) * (fp[i] - f0)


def _tables(grid: Grid, like):
    """(log CHLCNC, A_1, A_2, B_1, B_2) on ``like``'s device and dtype,
    made once and kept on the grid: a copy from the host at every step
    would synchronize."""
    hit = grid.__dict__.get("_chl_tables")
    if hit is None or hit[0].dtype != like.dtype \
            or hit[0].device != like.device:
        hit = tuple(torch.as_tensor(a).to(device=like.device,
                                          dtype=like.dtype)
                    for a in (np.log(CHLCNC), A_1, A_2, B_1, B_2))
        grid.__dict__["_chl_tables"] = hit
    return hit


def chl_coeffs(grid: Grid, chl):
    """Ohlmann (2003) double-exponential coefficients (a1, a2, b1, b2)
    interpolated in log-chl for a surface chlorophyll field
    (sw_absorption.F90:640-718)."""
    logc = torch.log(torch.clamp(chl, float(CHLCNC[0]), float(CHLCNC[-1])))
    logtab, *tabs = _tables(grid, logc)
    return tuple(_interp(logc, logtab, t) for t in tabs)


def chl_trans_at(coeffs, depth_cm):
    """Trans(z) = A1 exp(-B1 z) + A2 exp(-B2 z) at (broadcastable) depths
    in cm (sw_trans_chl, sw_absorption.F90:730-780)."""
    a1, a2, b1, b2 = coeffs
    z_m = depth_cm * const.MPERCM
    return (a1 * torch.exp(-torch.clamp(b1 * z_m, max=MAXARG))
            + a2 * torch.exp(-torch.clamp(b2 * z_m, max=MAXARG)))


def chl_transmission(cfg: ModelConfig, grid: Grid, chl) -> torch.Tensor:
    """Per-interface transmission (km+1, ny, nx) of a surface chlorophyll
    field (mg/m^3), evaluated at the layer bottoms; 1 at the top interface
    (the non-penetrating fraction heats the surface layer, as the Jerlov
    profile does) and 0 below the last."""
    km = cfg.km
    a1, a2, b1, b2 = chl_coeffs(grid, chl)
    zw = grid.vgrid.zw[:km - 1].reshape(km - 1, 1, 1)
    tr = chl_trans_at((a1[None], a2[None], b1[None], b2[None]), zw)
    return torch.cat([torch.ones_like(tr[:1]), tr, torch.zeros_like(tr[:1])],
                     dim=0)
