"""Vertical mixing: coefficients (constant / Richardson / KPP), explicit
vertical diffusion terms, and convective adjustment (plain PyTorch).

Reference: ``source/vertical_mix.F90`` (dispatch, vdifft :691, vdiffu :853,
convad :1888), ``source/vmix_const.F90``, ``source/vmix_rich.F90:179-414``,
``source/vmix_kpp.F90`` (``kpp.py``). All routines are whole-column
vectorized over (km, ny, nx) — the reference's per-level calls with carried
top-flux state become shifted-tensor expressions.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from pop2_tpu_torch import constants as const
from pop2_tpu_torch import eos, kpp
from pop2_tpu_torch.advect import _below
from pop2_tpu_torch.config import ModelConfig
from pop2_tpu_torch.grid import Grid, thickness_t, thickness_u
from pop2_tpu_torch.stencil import BC, tgrid_to_ugrid, ugrid_to_tgrid

EPS = 1.0e-10


class VmixCoeffs(NamedTuple):
    vdc: torch.Tensor   # (2, km, ny, nx) tracer diffusivity at layer bottoms
    #                     class 0: temperature, class 1: salinity/others
    vvc: torch.Tensor   # (km, ny, nx) momentum viscosity at layer bottoms
    kpp: Optional[kpp.KPPOut] = None  # under vmix='kpp': ghat, hblt, hmxl


def vmix_coeffs(cfg: ModelConfig, grid: Grid, bc: BC, tmix, umix, vmix_,
                rhomix, forcing=None, kpp_statics=None,
                chl=None, ucur=None, vcur=None) -> VmixCoeffs:
    """Dispatch to the chosen scheme (source/vertical_mix.F90:518-667).
    KPP takes the surface ``forcing``, its statics (``kpp.build_statics``),
    the chlorophyll field of the shortwave absorption and the current
    velocities (the 'blke' NIW energy)."""
    if cfg.vmix == "const":
        return _coeffs_const(cfg, grid)
    if cfg.vmix == "rich":
        return _coeffs_rich(cfg, grid, bc, tmix, umix, vmix_, rhomix)
    if cfg.vmix == "kpp":
        out = kpp.kpp_coeffs(
            cfg, grid, bc, kpp_statics, tmix, umix, vmix_, forcing.stf,
            forcing.shf_qsw, forcing.smft, cfg.convect_diff,
            cfg.convect_visc, chl=chl, tidal_lnc=forcing.tidal_lnc,
            rhomix=rhomix, ucur=ucur, vcur=vcur)
        return VmixCoeffs(vdc=out.vdc, vvc=out.vvc, kpp=out)
    raise NotImplementedError(f"vmix scheme {cfg.vmix!r}")


def _coeffs_const(cfg: ModelConfig, grid: Grid) -> VmixCoeffs:
    """Uniform background coefficients (source/vmix_const.F90)."""
    dt = cfg.torch_dtype
    vdc = grid.kmask_t.to(dt) * cfg.const_vdc
    vvc = grid.kmask_u.to(dt) * cfg.const_vvc
    return VmixCoeffs(vdc=torch.stack([vdc, vdc]), vvc=vvc)


def _coeffs_rich(cfg: ModelConfig, grid: Grid, bc: BC, tmix, umix, vmix_,
                 rhomix) -> VmixCoeffs:
    """Pacanowski-Philander Richardson-number mixing
    (source/vmix_rich.F90:179-414), with the diffusion form of convection:
    coefficients capped at convect_diff/convect_visc where unstable."""
    km = cfg.km
    kp1 = torch.clamp(torch.arange(km, device=umix.device) + 1, max=km - 1)

    # velocities averaged to T points at every level
    ut = ugrid_to_tgrid(umix, bc)
    vt = ugrid_to_tgrid(vmix_, bc)
    dU2 = (ut - ut[kp1]) ** 2 + (vt - vt[kp1]) ** 2 + EPS

    # density of level-k water adiabatically displaced to level k+1
    rhok_disp = eos.state(cfg, grid.vgrid.pressz[kp1], tmix[0], tmix[1],
                          fit=eos.fit_rows(grid.vgrid.poly, "down"))
    drho = rhok_disp - rhomix[kp1]

    dzw_k = grid.vgrid.dzw[1:km + 1].reshape(km, 1, 1)
    rich = -const.GRAV * dzw_k * drho / dU2
    interior_t = grid.kmask_t & _below(grid.kmask_t)  # k < KMT
    rich = torch.where(interior_t, rich, 0.0)

    critnu_t = cfg.convect_diff
    fac = 1.0 / (1.0 + 5.0 * torch.clamp(rich, min=0.0))
    vdc = torch.clamp(cfg.bckgrnd_vdc
                      + (cfg.bckgrnd_vvc + cfg.rich_mix * fac ** 2) * fac,
                      max=critnu_t)
    vdc = torch.where(rich < 0.0, critnu_t, vdc)
    vdc = torch.where(interior_t, vdc, 0.0)

    richu = tgrid_to_ugrid(rich, grid.AU0, grid.AUN, grid.AUE, grid.AUNE, bc)
    interior_u = grid.kmask_u & _below(grid.kmask_u)  # k < KMU
    richu = torch.where(interior_u, richu, 0.0)
    critnu_u = cfg.convect_visc
    facu = 1.0 / (1.0 + 5.0 * torch.clamp(richu, min=0.0))
    vvc = torch.clamp(cfg.bckgrnd_vvc + cfg.rich_mix * facu ** 2,
                      max=critnu_u)
    vvc = torch.where(richu < 0.0, critnu_u, vvc)
    vvc = torch.where(interior_u, vvc, 0.0)

    return VmixCoeffs(vdc=torch.stack([vdc, vdc]), vvc=vvc)


def vdifft(cfg: ModelConfig, grid: Grid, vdc, told, stf):
    """Explicit vertical tracer diffusion D_V(T_old)
    (source/vertical_mix.F90:691-847), all (nt, km, ny, nx) at once.

    vdc: (2, km, ny, nx); tracer n uses class min(n, 1).
    told: (nt, km, ny, nx); stf: (nt, ny, nx) surface fluxes.
    Returns (nt, km, ny, nx) tendency.
    """
    nt = told.shape[0]
    mt2 = torch.clamp(torch.arange(nt, device=told.device),
                      max=vdc.shape[0] - 1)
    vdc_n = vdc[mt2]  # (nt, km, ny, nx)

    t_kp1 = torch.cat([told[:, 1:], told[:, -1:]], dim=1)
    dzt = thickness_t(cfg, grid)
    dzt_kp1 = torch.cat([dzt[1:], dzt[-1:]], dim=0)
    dzwr_k = (1.0 / (0.5 * (dzt + dzt_kp1)))[None]
    below = _below(grid.kmask_t)[None]  # k < KMT, broadcast over tracers
    vtfb = torch.where(below, vdc_n * (told - t_kp1) * dzwr_k, 0.0)

    sfc_flux = torch.where(grid.kmask_t[0][None], stf, 0.0)[:, None]
    vtf = torch.cat([sfc_flux, vtfb[:, :-1]], dim=1)
    return torch.where(grid.kmask_t[None], (vtf - vtfb) / dzt[None], 0.0)


def dzwr2(grid: Grid) -> torch.Tensor:
    """(km,) 1/(1/2 (dz_k + dz_k+1)), the bottom level's own thickness below
    it: ``vdifft``'s and ``vdiffu``'s dzwr_k under 1-D layer thickness, an
    operand of the tracer and momentum kernels. Built at the first call on a
    ``Grid`` object and kept on it; a ``replace``d or moved grid is a new
    object and gets its own."""
    hit = grid.__dict__.get("_dzwr2")
    if hit is None:
        dz = grid.vgrid.dz
        hit = 1.0 / (0.5 * (dz + torch.cat([dz[1:], dz[-1:]])))
        grid.__dict__["_dzwr2"] = hit
    return hit


def depth_accel(cfg: ModelConfig, grid: Grid):
    """The (km,) factors dttxcel of the tracer timestep under depth
    acceleration (``laccel``), the top level's 1, or None without it
    (source/time_management.F90:975-1009). Built at the first call on a
    ``Grid`` object and kept on it with the factors it was built from."""
    tm = cfg.time
    if not (tm.laccel and tm.dttxcel is not None):
        return None
    key = (tuple(tm.dttxcel), cfg.torch_dtype)
    hit = grid.__dict__.get("_dttxcel")
    if hit is None or hit[0] != key:
        if len(tm.dttxcel) != cfg.km:
            raise ValueError(
                f"dttxcel has {len(tm.dttxcel)} levels, need {cfg.km}")
        xcel = torch.tensor((1.0,) + tuple(tm.dttxcel[1:]),
                            dtype=cfg.torch_dtype, device=grid.KMT.device)
        hit = (key, xcel)
        grid.__dict__["_dttxcel"] = hit
    return hit[1]


def vdiffu(cfg: ModelConfig, grid: Grid, vvc, uold, vold, smf):
    """Explicit vertical momentum diffusion with wind-stress top BC and
    quadratic bottom drag (source/vertical_mix.F90:853-1026).

    smf: (2, ny, nx) surface momentum flux. Returns (du, dv)."""
    km = uold.shape[0]
    u_kp1 = torch.cat([uold[1:], uold[-1:]], dim=0)
    v_kp1 = torch.cat([vold[1:], vold[-1:]], dim=0)
    dzu = thickness_u(cfg, grid)
    dzu_kp1 = torch.cat([dzu[1:], dzu[-1:]], dim=0)
    dzwr_k = 1.0 / (0.5 * (dzu + dzu_kp1))
    vufb = vvc * (uold - u_kp1) * dzwr_k
    vvfb = vvc * (vold - v_kp1) * dzwr_k

    # quadratic bottom drag at k == KMU (source/vertical_mix.F90:975-983)
    kidx = torch.arange(1, km + 1, dtype=torch.int32,
                        device=uold.device).reshape(km, 1, 1)
    at_bottom = kidx == grid.KMU[None]
    vmag = cfg.bottom_drag * torch.sqrt(uold ** 2 + vold ** 2)
    vufb = torch.where(at_bottom, vmag * uold, vufb)
    vvfb = torch.where(at_bottom, vmag * vold, vvfb)

    sfc_u = torch.where(grid.kmask_u[0], smf[0], 0.0)[None]
    sfc_v = torch.where(grid.kmask_u[0], smf[1], 0.0)[None]
    vuf = torch.cat([sfc_u, vufb[:-1]], dim=0)
    vvf = torch.cat([sfc_v, vvfb[:-1]], dim=0)
    du = torch.where(grid.kmask_u, (vuf - vufb) / dzu, 0.0)
    dv = torch.where(grid.kmask_u, (vvf - vvfb) / dzu, 0.0)
    return du, dv


def convad(cfg: ModelConfig, grid: Grid, tnew):
    """Full convective adjustment by pairwise mixing of unstable adjacent
    levels (source/vertical_mix.F90:1888-2027). Only active for
    convection_type='adjustment'; the 'diffusion' form lives in the vmix
    coefficient schemes. Under depth acceleration the pairs mix by
    dz/dttxcel (source/time_management.F90:1003-1009). Returns adjusted
    tracers (nt, km, ny, nx)."""
    if cfg.convection_type != "adjustment":
        return tnew
    km = cfg.km
    dz = grid.vgrid.dz
    xcel = depth_accel(cfg, grid)
    if xcel is not None:
        dz = dz / xcel
    pressz, poly = grid.vgrid.pressz, grid.vgrid.poly
    tnew = tnew.clone()  # levels are updated in place below

    for _ in range(cfg.nconvad):
        for ks in (0, 1):
            for k in range(ks, km - 1, 2):
                # density of level k displaced to k+1 vs in-situ at k+1
                fit = eos.fit_rows(poly, k + 1)
                rhok = eos.state_at_level(cfg, pressz[k + 1], tnew[0, k],
                                          tnew[1, k], fit=fit)
                rhokp = eos.state_at_level(cfg, pressz[k + 1],
                                           tnew[0, k + 1], tnew[1, k + 1],
                                           fit=fit)
                unstable = ((rhok > rhokp) & grid.kmask_t[k + 1])[None]
                w = 1.0 / (dz[k] + dz[k + 1])
                mixed = w * (dz[k] * tnew[:, k] + dz[k + 1] * tnew[:, k + 1])
                tnew[:, k] = torch.where(unstable, mixed, tnew[:, k])
                tnew[:, k + 1] = torch.where(unstable, mixed, tnew[:, k + 1])
    return tnew
