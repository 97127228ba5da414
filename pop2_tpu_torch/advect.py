"""Advection of momentum and tracers (plain PyTorch).

Reference: ``source/advection.F90`` — flux velocities ``comp_flux_vel``
(:1970), centered tracer advection ``advt_centered`` (:2139), momentum
advection with metric terms ``advu`` (:1127). The reference's k-sequential
carry of the vertical velocity becomes a masked ``cumsum`` over the whole
column, and all levels/tracers are computed at once. These functions are the
plain versions the CUDA tracer and momentum kernels are held against; the
upwind3 and lw_lim schemes are later slices (ROADMAP.md Queue 1 items 5, 11).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pop2_tpu_torch.config import ModelConfig
from pop2_tpu_torch.grid import Grid, thickness_t, thickness_u
from pop2_tpu_torch.stencil import BC


class FluxVel(NamedTuple):
    """Tracer flux velocities across T-cell faces and vertical velocity."""
    ute: torch.Tensor   # (km, ny, nx) east-face volume flux velocity
    utw: torch.Tensor
    vtn: torch.Tensor   # north face
    vts: torch.Tensor
    wtk: torch.Tensor   # (km, ny, nx) vertical velocity at TOP of each T box
    wtkb: torch.Tensor  # (km, ny, nx) vertical velocity at BOTTOM of T box


def _below(kmask):
    """k < KMT (resp. KMU): the level below is still ocean."""
    return torch.cat([kmask[1:], torch.zeros_like(kmask[:1])])


def comp_flux_vel(cfg: ModelConfig, grid: Grid, bc: BC, uvel, vvel,
                  dh) -> FluxVel:
    """Flux velocities across T-cell faces and w from continuity
    (source/advection.F90:2066-2127), all levels at once.

    The surface boundary condition is w = DH (d(eta)/dt - F_w) for the
    variable-thickness surface layer. For k < KMT,
    WTKB_k = DH + sum_{m<=k} dz_m * FC_m, which equals the reference's
    per-level recurrence because masking can only first apply at k = KMT.
    """
    dzu = thickness_u(cfg, grid)
    a = uvel * grid.DYU * dzu
    b = vvel * grid.DXU * dzu
    ute = 0.5 * (a + bc.s(a))
    utw = bc.w(ute)
    vtn = 0.5 * (b + bc.w(b))
    vts = bc.s(vtn)

    fc = (vtn - vts + ute - utw) * grid.TAREA_R
    wtkb = dh[None] + torch.cumsum(fc, dim=0)
    wtkb = torch.where(_below(grid.kmask_t), wtkb, 0.0)
    wtk = torch.cat([dh[None].expand_as(wtkb[:1]), wtkb[:-1]], dim=0)
    return FluxVel(ute=ute, utw=utw, vtn=vtn, vts=vts, wtk=wtk, wtkb=wtkb)


def advt_centered(cfg: ModelConfig, grid: Grid, bc: BC, fv: FluxVel, trcr):
    """Centered tracer advection L(T) (source/advection.F90:2139-2306) for
    all tracers and levels: flux-form horizontal + centered vertical.

    trcr: (nt, km, ny, nx) tracers at current time.
    Returns L(T), (nt, km, ny, nx) — the caller subtracts it from FT.
    """
    dzt = thickness_t(cfg, grid)
    ute, vtn = fv.ute[None], fv.vtn[None]
    uts = fv.vts[None]
    utw = fv.utw[None]
    cc = vtn - uts + ute - utw
    ltk = 0.5 * (cc * trcr
                 + vtn * bc.n(trcr) - uts * bc.s(trcr)
                 + ute * bc.e(trcr) - utw * bc.w(trcr)) \
        * grid.TAREA_R / dzt[None]

    # vertical advection (source/advection.F90:2266-2301); for the
    # variable-thickness surface layer there is no advection through the
    # surface at k=1
    dz2r = 0.5 / dzt[None]
    t_km1 = torch.cat([trcr[:, :1], trcr[:, :-1]], dim=1)
    t_kp1 = torch.cat([trcr[:, 1:], trcr[:, -1:]], dim=1)
    top = fv.wtk[None] * (t_km1 + trcr)
    if cfg.sfc_layer != "varthick":
        top0 = 2.0 * fv.wtk[0][None] * trcr[:, 0]
    else:
        top0 = torch.zeros_like(trcr[:, 0])
    top = torch.cat([top0[:, None], top[:, 1:]], dim=1)
    bot = fv.wtkb[None] * (trcr + t_kp1)
    bot = torch.cat([bot[:, :-1], torch.zeros_like(bot[:, -1:])], dim=1)
    return ltk + dz2r * (top - bot)


def advt(cfg: ModelConfig, grid: Grid, bc: BC, fv: FluxVel, trcr):
    """Dispatch on cfg.tadvect (source/advection.F90:1640-1960)."""
    if cfg.tadvect == "centered":
        return advt_centered(cfg, grid, bc, fv, trcr)
    raise NotImplementedError(
        f"tadvect={cfg.tadvect!r} is not ported yet (ROADMAP.md Queue 1 "
        "items 5, 11)")


def advu(cfg: ModelConfig, grid: Grid, bc: BC, uvel, vvel, dhu):
    """Momentum advection L(U), L(V) with metric terms
    (source/advection.F90:1127-1570), all levels at once.

    Returns (luk, lvk), each (km, ny, nx), masked to zero on land.
    """
    dzu = thickness_u(cfg, grid)
    a = uvel * grid.DYU * dzu
    b = vvel * grid.DXU * dzu
    # 4-point averages of T-face fluxes onto U-cell faces, thickness-
    # weighted (source/advection.F90:1245-1339)
    uuw = (0.25 * (a + bc.w(a))
           + 0.125 * (bc.s(a) + bc.sw(a) + bc.n(a) + bc.nw(a)))
    uue = bc.e(uuw)
    vus = (0.25 * (b + bc.s(b))
           + 0.125 * (bc.w(b) + bc.sw(b) + bc.e(b) + bc.se(b)))
    vun = bc.n(vus)

    # vertical velocity at U-box bottoms by continuity, integrated from the
    # surface value DHU (source/advection.F90:1345-1357)
    fc = (vun - vus + uue - uuw) * grid.UAREA_R
    wukb = dhu[None] + torch.cumsum(fc, dim=0)
    wuk = torch.cat([dhu[None].expand_as(wukb[:1]), wukb[:-1]], dim=0)

    cc = vun - vus + uue - uuw
    luk = 0.5 * (cc * uvel + vun * bc.n(uvel) - vus * bc.s(uvel)
                 + uue * bc.e(uvel) - uuw * bc.w(uvel)) \
        * grid.UAREA_R / dzu
    lvk = 0.5 * (cc * vvel + vun * bc.n(vvel) - vus * bc.s(vvel)
                 + uue * bc.e(vvel) - uuw * bc.w(vvel)) \
        * grid.UAREA_R / dzu

    # vertical advection through top/bottom of U box
    # (source/advection.F90:1439-1471)
    dzr = 1.0 / dzu
    dz2r = 0.5 / dzu
    u_km1 = torch.cat([uvel[:1], uvel[:-1]], dim=0)
    v_km1 = torch.cat([vvel[:1], vvel[:-1]], dim=0)
    u_kp1 = torch.cat([uvel[1:], uvel[-1:]], dim=0)
    v_kp1 = torch.cat([vvel[1:], vvel[-1:]], dim=0)

    top_u = dz2r * wuk * (u_km1 + uvel)
    top_v = dz2r * wuk * (v_km1 + vvel)
    top_u = torch.cat([(dzr[0] * wuk[0] * uvel[0])[None], top_u[1:]])
    top_v = torch.cat([(dzr[0] * wuk[0] * vvel[0])[None], top_v[1:]])
    bot_u = dz2r * wukb * (uvel + u_kp1)
    bot_v = dz2r * wukb * (vvel + v_kp1)
    bot_u = torch.cat([bot_u[:-1], torch.zeros_like(bot_u[-1:])])
    bot_v = torch.cat([bot_v[:-1], torch.zeros_like(bot_v[-1:])])
    luk = luk + top_u - bot_u
    lvk = lvk + top_v - bot_v

    # metric terms (source/advection.F90:1479-1491)
    luk = luk + uvel * vvel * grid.KYU - vvel ** 2 * grid.KXU
    lvk = lvk + uvel * vvel * grid.KXU - uvel ** 2 * grid.KYU

    return (torch.where(grid.kmask_u, luk, 0.0),
            torch.where(grid.kmask_u, lvk, 0.0))
