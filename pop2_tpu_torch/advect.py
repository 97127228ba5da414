"""Advection of momentum and tracers (plain PyTorch).

Reference: ``source/advection.F90`` — flux velocities ``comp_flux_vel``
(:1970), centered tracer advection ``advt_centered`` (:2139), third-order
upwind (QUICKEST) tracer advection ``advt_upwind3`` (:2313), momentum
advection with metric terms ``advu`` (:1127). The reference's k-sequential
carry of the vertical velocity becomes a masked ``cumsum`` over the whole
column, and all levels/tracers are computed at once. These functions are the
plain versions the CUDA tracer and momentum kernels are held against. The
flux-limited Lax-Wendroff scheme ``advt_lw_lim`` (source/advection.F90:
2684-3331) has no kernel: the JAX package computes it outside its Pallas
tracer kernel too, and the baroclinic driver runs it, with the plain
vertical diffusion, in place of the tracer kernel.
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


def advt(cfg: ModelConfig, grid: Grid, bc: BC, fv: FluxVel, trcr,
         tmix=None, c2dtt=None):
    """Tracer-advection dispatch on cfg.tadvect (source/advection.F90:
    1684-1729), one scheme for all tracers. ``trcr`` is the current-time
    tracer field (centered/upwind3); lw_lim advects the mix-time field
    ``tmix`` with the per-level timestep ``c2dtt`` (km,)."""
    if cfg.tadvect == "centered":
        return advt_centered(cfg, grid, bc, fv, trcr)
    if cfg.tadvect == "upwind3":
        return advt_upwind3(cfg, grid, bc, fv, trcr)
    if cfg.tadvect == "lw_lim":
        if tmix is None or c2dtt is None:
            raise ValueError("lw_lim advection needs tmix and c2dtt")
        return advt_lw_lim(cfg, grid, bc, fv, tmix, c2dtt)
    raise NotImplementedError(f"tadvect {cfg.tadvect}")


# ---------------------------------------------------------------------------
# 2nd-order forward-in-time advection with 1-D flux limiters (lw_lim)
# (source/advection.F90:2684-3331)
# ---------------------------------------------------------------------------

def _limit(dTR, dOther, LW, MU, base, upwind_pos: bool):
    """One-dimensional Lax-Wendroff limiter (the psi_dTR pattern of
    source/advection.F90:3100-3258): where dTR and the adjacent difference
    share a sign, blend toward the LW face value, else pure upwind.
    ``upwind_pos`` selects TRACER = base + psi (the upstream cell) or
    base - psi."""
    psi = torch.where((dTR > 0.0) & (dOther > 0.0),
                      torch.minimum(LW * dTR, MU * dOther),
                      torch.where((dTR < 0.0) & (dOther < 0.0),
                                  torch.maximum(LW * dTR, MU * dOther),
                                  0.0))
    return base + psi if upwind_pos else base - psi


def _lw_face_coeffs(vel_dt, d_c, d_dn):
    """LW face coefficients along one horizontal direction
    (source/advection.F90:2995-3065): ``vel_dt`` = dt * face velocity,
    ``d_c``/``d_dn`` the cell widths at (i) and (i+1)."""
    p5phr = 1.0 / (d_c + d_dn)
    return torch.where(vel_dt > 0.0, (d_c - vel_dt) * p5phr,
                       torch.where(vel_dt < 0.0, (d_dn + vel_dt) * p5phr,
                                   d_c * p5phr))


def _mu_coeffs(vel_dt, vel_dt_up, vel_dt_dn, d_c, d_dn, LW_up, LW_dn):
    """MU face coefficients (the limiter's second factor) along one
    direction; ``*_up``/``*_dn`` the same quantities at the (i-1)/(i+1)
    faces (source/advection.F90:2986-3065)."""
    safe = torch.where(vel_dt != 0.0, vel_dt, 1.0)
    mu_pos = torch.where(vel_dt_up > 0.0, (d_c - vel_dt_up) / safe,
                         torch.where(vel_dt_up < 0.0,
                                     -vel_dt_up / safe * LW_up, 0.0))
    mu_neg = torch.where(vel_dt_dn < 0.0, -(d_dn + vel_dt_dn) / safe,
                         torch.where(vel_dt_dn > 0.0,
                                     -vel_dt_dn / safe * LW_dn, 0.0))
    return torch.where(vel_dt > 0.0, mu_pos,
                       torch.where(vel_dt < 0.0, mu_neg, 0.0))


def _lw_face_value(X, xs_dn, dTR, dTRm1, dTRp1, c, lw, mu):
    """The limited tracer value at the east (north) face of every cell
    from the provisional tracer ``X`` and its neighbour ``xs_dn``, by the
    sign of the face's flux ``c``."""
    return torch.where((c > 0.0)[None],
                       _limit(dTR, dTRm1, lw[None], mu[None], X, True),
                       torch.where((c < 0.0)[None],
                                   _limit(dTR, dTRp1, lw[None], mu[None],
                                          xs_dn, False),
                                   X + lw[None] * dTR))


def advt_lw_lim(cfg: ModelConfig, grid: Grid, bc: BC, fv: FluxVel, tmix,
                c2dtt):
    """Flux-limited Lax-Wendroff tracer advection L(T)
    (source/advection.F90:2684-3331), all tracers and levels at once.

    The scheme is forward in time: it advects the *mix-time* tracers
    ``tmix`` (advt dispatch, source/advection.F90:1698) with the advective
    timestep ``c2dtt`` (km,) in the limiter's CFL factors (under depth
    acceleration the per-level step). The reference's per-level AUX carry
    becomes a shifted copy of the whole-column AUXB; the vertical, x and y
    passes update the provisional tracer XSTAR in turn, and the tendency is
    the pure flux form
      L(T) = (AUX - AUXB)/dz + CE*T_E + CW*T_E(w) + CN*T_N + CS*T_N(s)."""
    km = cfg.km
    tiny = 1.0e-20
    dzt = thickness_t(cfg, grid).expand((km,) + tuple(grid.KMT.shape))
    adv_dt = c2dtt.reshape(km, 1, 1)
    kidx = torch.arange(1, km + 1, dtype=torch.int32,
                        device=tmix.device).reshape(km, 1, 1)

    # stencil weights (:2756-2775; the PBC form with TAREA_R/DZT holds for
    # the volume fluxes, which carry dz)
    ce = fv.ute * grid.TAREA_R / dzt
    cw = -fv.utw * grid.TAREA_R / dzt
    cn = fv.vtn * grid.TAREA_R / dzt
    cs = -fv.vts * grid.TAREA_R / dzt

    # dt * face velocities (:2758-2768, PBC form UTE/(HTE*min(DZT, DZT_e)))
    dzt_e = torch.clamp(bc.e(dzt), min=tiny)
    dzt_n = torch.clamp(bc.n(dzt), min=tiny)
    uvel_e_dt = adv_dt * fv.ute / (grid.HTE * torch.minimum(dzt, dzt_e))
    vvel_n_dt = adv_dt * fv.vtn / (grid.HTN * torch.minimum(dzt, dzt_n))

    # no advection through the surface of a variable-thickness surface
    # layer (:2786-2790)
    wtk_eff = fv.wtk
    if cfg.sfc_layer == "varthick":
        wtk_eff = torch.cat([torch.zeros_like(wtk_eff[:1]), wtk_eff[1:]])
    wtkb = fv.wtkb
    wtkbp1 = torch.cat([wtkb[1:], torch.zeros_like(wtkb[:1])])
    wtkb_safe = torch.where(wtkb != 0.0, wtkb, 1.0)

    # vertical LW_z / MU_z (:2919-2993, PBC form with the edge clamp
    # dz(km+1) := dz(km), which reproduces p5_dz_ph_r(km) = 0.5/dz(km))
    dzt_kp1 = torch.cat([dzt[1:], dzt[-1:]])
    dzt_kp2 = torch.cat([dzt[2:], dzt[-1:], dzt[-1:]])[:km]
    dzt_km1 = torch.cat([dzt[:1], dzt[:-1]])
    down = wtkb > 0.0
    lw_z = torch.where(down, (dzt_kp1 - adv_dt * wtkb) / (dzt + dzt_kp1),
                       (dzt + adv_dt * wtkb) / (dzt + dzt_kp1))
    mu_z_pos = torch.where(
        wtkbp1 > 0.0, (dzt_kp1 / adv_dt - wtkbp1) / wtkb_safe,
        torch.where(wtkbp1 < 0.0,
                    -wtkbp1 / wtkb_safe * (dzt_kp1 + adv_dt * wtkbp1)
                    / (dzt_kp1 + dzt_kp2), 0.0))
    mu_z_neg = torch.where(
        wtk_eff < 0.0, -(dzt / adv_dt + wtk_eff) / wtkb_safe,
        torch.where(wtk_eff > 0.0,
                    -wtk_eff / wtkb_safe * (dzt - adv_dt * wtk_eff)
                    / (dzt_km1 + dzt), 0.0))
    mu_z = torch.where(down, mu_z_pos, mu_z_neg)

    # -- vertical contribution (:3100-3160)
    X = tmix
    x_kp1 = torch.cat([X[:, 1:], X[:, -1:]], dim=1)
    x_kp2 = torch.cat([X[:, 2:], X[:, -1:], X[:, -1:]], dim=1)[:, :km]
    x_km1 = torch.cat([X[:, :1], X[:, :-1]], dim=1)
    valid_kp1 = ((kidx + 1) <= grid.KMT[None])[None]
    valid_kp2 = ((kidx + 2) <= grid.KMT[None])[None]
    not_top = (kidx > 1)[None]

    dTR = x_kp1 - X
    dTRp1 = torch.where(valid_kp2, x_kp2 - x_kp1, 0.0)
    dTRm1 = torch.where(not_top, X - x_km1, 0.0)
    auxb_pos = _limit(dTR, dTRp1, lw_z[None], mu_z[None], x_kp1,
                      False) * wtkb[None]
    auxb_neg = _limit(dTR, dTRm1, lw_z[None], mu_z[None], X,
                      True) * wtkb[None]
    auxb = torch.where(valid_kp1,
                       torch.where(down[None], auxb_pos,
                                   torch.where((wtkb < 0.0)[None], auxb_neg,
                                               0.0)), 0.0)
    aux = torch.cat([(wtk_eff[0] * X[:, 0])[:, None], auxb[:, :-1]], dim=1)
    xout = (aux - auxb - (wtk_eff - wtkb)[None] * X) / dzt[None]
    xstar = X - adv_dt[None] * xout

    # -- grid-x contribution (:3162-3215)
    u = uvel_e_dt
    dxt = grid.DXT
    dxt_w = torch.clamp(bc.w(dxt), min=tiny)
    dxt_e = torch.clamp(bc.e(dxt), min=tiny)
    dxt_ee = torch.clamp(bc.e(bc.e(dxt)), min=tiny)
    lw_x = _lw_face_coeffs(u, dxt, dxt_e)
    lw_x_w = _lw_face_coeffs(bc.w(u), dxt_w, dxt)
    lw_x_e = _lw_face_coeffs(bc.e(u), dxt_e, dxt_ee)
    mu_x = _mu_coeffs(u, bc.w(u), bc.e(u), dxt, dxt_e, lw_x_w, lw_x_e)

    kmaske = torch.where((kidx <= grid.KMT[None])
                         & (kidx <= grid.KMTE[None]), 1.0, 0.0)
    xs_e, xs_w = bc.e(xstar), bc.w(xstar)
    tr_e = _lw_face_value(
        xstar, xs_e, (xs_e - xstar) * kmaske[None],
        (xstar - xs_w) * bc.w(kmaske)[None],
        (bc.e(xs_e) - xs_e) * bc.e(kmaske)[None], ce, lw_x, mu_x)
    work = ce[None] * tr_e + cw[None] * bc.w(tr_e) - (ce + cw)[None] * X
    xout = xout + work
    xstar = xstar - adv_dt[None] * work

    # -- grid-y contribution and the divergence term (:3220-3286)
    v = vvel_n_dt
    dyt = grid.DYT
    dyt_s = torch.clamp(bc.s(dyt), min=tiny)
    dyt_n = torch.clamp(bc.n(dyt), min=tiny)
    dyt_nn = torch.clamp(bc.nn(dyt), min=tiny)
    lw_y = _lw_face_coeffs(v, dyt, dyt_n)
    lw_y_s = _lw_face_coeffs(bc.s(v), dyt_s, dyt)
    lw_y_n = _lw_face_coeffs(bc.n(v), dyt_n, dyt_nn)
    mu_y = _mu_coeffs(v, bc.s(v), bc.n(v), dyt, dyt_n, lw_y_s, lw_y_n)

    kmaskn = torch.where((kidx <= grid.KMT[None])
                         & (kidx <= grid.KMTN[None]), 1.0, 0.0)
    xs_n, xs_s = bc.n(xstar), bc.s(xstar)
    tr_n = _lw_face_value(
        xstar, xs_n, (xs_n - xstar) * kmaskn[None],
        (xstar - xs_s) * bc.s(kmaskn)[None],
        (bc.n(xs_n) - xs_n) * bc.n(kmaskn)[None], cn, lw_y, mu_y)
    div = (wtk_eff - wtkb) / dzt + ce + cw + cn + cs
    xout = xout + (cn[None] * tr_n + cs[None] * bc.s(tr_n)
                   - (cn + cs - div)[None] * X)
    return torch.where(grid.kmask_t[None], xout, 0.0)


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
