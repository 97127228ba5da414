"""Advection of momentum and tracers (plain PyTorch).

Reference: ``source/advection.F90`` — flux velocities ``comp_flux_vel``
(:1970), centered tracer advection ``advt_centered`` (:2139), third-order
upwind (QUICKEST) tracer advection ``advt_upwind3`` (:2313), momentum
advection with metric terms ``advu`` (:1127). The reference's k-sequential
carry of the vertical velocity becomes a masked ``cumsum`` over the whole
column, and all levels/tracers are computed at once. These functions are the
plain versions the CUDA tracer and momentum kernels are held against; the
lw_lim scheme is a later slice (ROADMAP.md Queue 1 item 11).
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
    if cfg.tadvect == "upwind3":
        return advt_upwind3(cfg, grid, bc, fv, trcr)
    raise NotImplementedError(
        f"tadvect={cfg.tadvect!r} is not ported yet (ROADMAP.md Queue 1 "
        "item 11)")


# ---------------------------------------------------------------------------
# 3rd-order upwind (QUICKEST) tracer advection
# (source/advection.F90:2313-2677; coefficients :420-562)
# ---------------------------------------------------------------------------

def upwind3_vert_coeffs(dz):
    """Vertical QUICKEST interpolation coefficients
    (source/advection.F90:448-486): six (km,) tensors talfzp, tbetzp,
    tgamzp, talfzm, tbetzm, tdelzm."""
    km = dz.shape[0]
    dzc = torch.cat([dz[:1], dz, dz[-1:]])  # dzc(0..km+1)
    d_k = dz
    d_kp1 = torch.cat([dz[1:], dz[-1:]])
    d_km1 = dzc[:km]          # dzc(k-1)
    d_kp2 = dzc[2:km + 2]     # dzc(k+2)

    talfzp = d_k * (2 * d_k + d_km1) / ((d_k + d_kp1)
                                        * (d_km1 + 2 * d_k + d_kp1))
    tbetzp = d_kp1 * (2 * d_k + d_km1) / ((d_k + d_kp1) * (d_k + d_km1))
    tgamzp = -(d_k * d_kp1) / ((d_k + d_km1) * (d_kp1 + d_km1 + 2 * d_k))
    tbetzp[0] += tgamzp[0]
    tgamzp[0] = 0.0
    talfzp[km - 1] = 0.0
    tbetzp[km - 1] = 0.0
    tgamzp[km - 1] = 0.0

    talfzm = d_k * (2 * d_kp1 + d_kp2) / ((d_k + d_kp1) * (d_kp1 + d_kp2))
    tbetzm = d_kp1 * (2 * d_kp1 + d_kp2) / ((d_k + d_kp1)
                                            * (d_k + d_kp2 + 2 * d_kp1))
    tdelzm = -(d_k * d_kp1) / ((d_kp1 + d_kp2) * (d_k + d_kp2 + 2 * d_kp1))
    if km >= 2:
        talfzm[km - 2] += tdelzm[km - 2]
        tdelzm[km - 2] = 0.0
    talfzm[km - 1] = 0.0
    tbetzm[km - 1] = 0.0
    tdelzm[km - 1] = 0.0
    return talfzp, tbetzp, tgamzp, talfzm, tbetzm, tdelzm


def upwind3_vert(grid: Grid):
    """``upwind3_vert_coeffs`` of the grid's dz, built once a grid object
    and kept on it: the coefficients' end values are set level by level,
    and such an assignment copies its value from the host, which a captured
    step (the tavg fields of ``graphs.CapturedStep``) cannot do."""
    hit = grid.__dict__.get("_upwind3_vert")
    if hit is None:
        hit = upwind3_vert_coeffs(grid.vgrid.dz)
        grid.__dict__["_upwind3_vert"] = hit
    return hit


def upwind3_horiz_coeffs(dc, dw, de, de2):
    """Face interpolation coefficients along one direction
    (source/advection.F90:510-551): dc, dw, de, de2 are the cell widths at
    i, i-1, i+1, i+2. Widths shifted in across a closed edge are zero; they
    are clamped so the coefficients of land rows stay finite (masked out of
    the result anyway). Returns alfp, betp, gamp, alfm, betm, delm."""
    tiny = 1.0e-20
    dc = torch.clamp(dc, min=tiny)
    dw = torch.clamp(dw, min=tiny)
    de = torch.clamp(de, min=tiny)
    de2 = torch.clamp(de2, min=tiny)
    alfp = dc * (2 * dc + dw) / ((dc + de) * (dw + 2 * dc + de))
    betp = de * (2 * dc + dw) / ((dc + dw) * (dc + de))
    gamp = -(dc * de) / ((dc + dw) * (dw + 2 * dc + de))
    alfm = dc * (2 * de + de2) / ((dc + de) * (de + de2))
    betm = de * (2 * de + de2) / ((dc + de) * (dc + 2 * de + de2))
    delm = -(dc * de) / ((de2 + de) * (dc + 2 * de + de2))
    return alfp, betp, gamp, alfm, betm, delm


def upwind3_planes(grid: Grid, bc: BC):
    """The 2-D coefficient planes of upwind3, each (ny, nx): the east-face
    set alfxp..delxm, the north-face set alfyp..delym (the fold of DYT on
    a tripole grid included), and the bottom levels two columns east and
    two rows north."""
    x = upwind3_horiz_coeffs(grid.DXT, bc.w(grid.DXT), bc.e(grid.DXT),
                             bc.e(bc.e(grid.DXT)))
    y = upwind3_horiz_coeffs(grid.DYT, bc.s(grid.DYT), bc.n(grid.DYT),
                             bc.nn(grid.DYT))
    kmtee = bc.e(bc.e(grid.KMT))
    kmtnn = bc.nn(grid.KMT)
    return x, y, kmtee, kmtnn


def advt_upwind3(cfg: ModelConfig, grid: Grid, bc: BC, fv: FluxVel, trcr):
    """Third-order upwind tracer advection L(T) for all tracers and levels
    (source/advection.F90:2313-2677). Next to land the stencil degrades to
    lower order: the missing point's weight folds into the others."""
    km = cfg.km
    kidx = torch.arange(1, km + 1, dtype=torch.int32,
                        device=trcr.device).reshape(km, 1, 1)
    ((alfxp, betxp, gamxp, alfxm, betxm, delxm),
     (alfyp, betyp, gamyp, alfym, betym, delym),
     kmtee, kmtnn) = upwind3_planes(grid, bc)

    def faceval(X, c_pos, mask_up1, mask_dn1, mask_up2,
                alfp, betp, gamp, alfm, betm, delm, sh_p1, sh_m1, sh_p2):
        """Upwind-biased face value of X (nt, km, ny, nx); c_pos: the flux
        through the face is positive; the masks set the stencil's width."""
        ap = torch.where(mask_up1, alfp, 0.0)
        work = torch.where(mask_up1, betp, betp + alfp)
        bp = torch.where(mask_dn1, work, work + gamp)
        gp = torch.where(mask_dn1, gamp, 0.0)
        am = torch.where(mask_up2, alfm, alfm + delm)
        dm = torch.where(mask_up2, delm, 0.0)
        bm = betm
        plus = ap * sh_p1(X) + bp * X + gp * sh_m1(X)
        minus = am * sh_p1(X) + bm * X + dm * sh_p2(X)
        return torch.where(c_pos, plus, minus)

    ce = (fv.ute * grid.TAREA_R)[None]
    cw = (-fv.utw * grid.TAREA_R)[None]
    cn = (fv.vtn * grid.TAREA_R)[None]
    cs = (-fv.vts * grid.TAREA_R)[None]

    mask_e = (kidx <= grid.KMTE[None])[None]
    mask_w = (kidx <= grid.KMTW[None])[None]
    mask_ee = (kidx <= kmtee[None])[None]
    tr_e = faceval(trcr, ce > 0, mask_e, mask_w, mask_ee,
                   alfxp, betxp, gamxp, alfxm, betxm, delxm,
                   bc.e, bc.w, lambda x: bc.e(bc.e(x)))
    mask_n = (kidx <= grid.KMTN[None])[None]
    mask_s = (kidx <= grid.KMTS[None])[None]
    mask_nn = (kidx <= kmtnn[None])[None]
    tr_n = faceval(trcr, cn > 0, mask_n, mask_s, mask_nn,
                   alfyp, betyp, gamyp, alfym, betym, delym,
                   bc.n, bc.s, bc.nn)

    dzt = thickness_t(cfg, grid)
    ltk = (ce * tr_e + cw * bc.w(tr_e)
           + cn * tr_n + cs * bc.s(tr_n)) / dzt[None]

    # vertical (source/advection.F90:2402-2476)
    talfzp, tbetzp, tgamzp, talfzm, tbetzm, tdelzm = upwind3_vert(grid)

    def kcol(a):
        return a.reshape(1, km, 1, 1)

    interior2 = (kidx < grid.KMT[None] - 1)[None]  # k < KMT-1
    azminus = torch.where(interior2, kcol(talfzm), kcol(talfzm + tdelzm))
    dzminus = torch.where(interior2, kcol(tdelzm), 0.0)

    t_kp1 = torch.cat([trcr[:, 1:], trcr[:, -1:]], dim=1)
    t_km1 = torch.cat([trcr[:, :1], trcr[:, :-1]], dim=1)
    t_kp2 = torch.cat([trcr[:, 2:], trcr[:, -1:], trcr[:, -1:]],
                      dim=1)[:, :km]
    tplus = (kcol(talfzp) * t_kp1 + kcol(tbetzp) * trcr
             + kcol(tgamzp) * t_km1)
    tminus = azminus * t_kp1 + kcol(tbetzm) * trcr + dzminus * t_kp2
    wtkb = fv.wtkb[None]
    auxb = (wtkb - torch.abs(wtkb)) * tplus + (wtkb + torch.abs(wtkb)) * tminus
    auxb[:, -1] = 0.0
    aux = torch.cat([torch.zeros_like(auxb[:, :1]), auxb[:, :-1]], dim=1)

    dz2r = 0.5 / dzt[None]
    vert = dz2r * (aux - auxb)
    if cfg.sfc_layer != "varthick":
        vert[:, 0] = (fv.wtk[0][None] * trcr[:, 0] / dzt[0]
                      - 0.5 * auxb[:, 0] / dzt[0])
    return torch.where(grid.kmask_t[None], ltk + vert, 0.0)


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
           + 0.125 * (bc.s(a) + bc.sw(a) + bc.n(a, "necorner", "vector")
                      + bc.nw(a, "necorner", "vector")))
    uue = bc.e(uuw)
    vus = (0.25 * (b + bc.s(b))
           + 0.125 * (bc.w(b) + bc.sw(b) + bc.e(b) + bc.se(b)))
    # vus folds as an E-face vector, given the degenerate top-row
    # antisymmetry of b (enforced each step on tripole grids)
    vun = bc.n(vus, "eface", "vector")

    # vertical velocity at U-box bottoms by continuity, integrated from the
    # surface value DHU (source/advection.F90:1345-1357)
    fc = (vun - vus + uue - uuw) * grid.UAREA_R
    wukb = dhu[None] + torch.cumsum(fc, dim=0)
    wuk = torch.cat([dhu[None].expand_as(wukb[:1]), wukb[:-1]], dim=0)

    cc = vun - vus + uue - uuw
    luk = 0.5 * (cc * uvel + vun * bc.n(uvel, "necorner", "vector")
                 - vus * bc.s(uvel)
                 + uue * bc.e(uvel) - uuw * bc.w(uvel)) \
        * grid.UAREA_R / dzu
    lvk = 0.5 * (cc * vvel + vun * bc.n(vvel, "necorner", "vector")
                 - vus * bc.s(vvel)
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
