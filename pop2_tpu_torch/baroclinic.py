"""Baroclinic (3-D explicit) dynamics driver.

Reference: ``source/baroclinic.F90`` — ``baroclinic_driver`` (:578, tracer and
momentum block loops), ``clinic`` (:1635, Fx/Fy assembly), ``tracer_update``
(:1902), ``baroclinic_correct_adjust`` (:1217). The reference's per-block,
per-level loops with carried vertical state are whole-field tensor
expressions here, except the hot pieces that are hand-written CUDA kernels
on the GPU: the tracer tendency (``tracer_cuda``), the momentum forcing
(``clinic_cuda``), every implicit vertical solve (``tridiag_cuda``) and,
under ``hmix_tracer='gm'``, the GM/Redi mixing (``gm_slope_cuda`` +
``gm_tlt_cuda`` + ``gm_chain_cuda``, or ``gm_cuda`` at the end of
``gm.hdifft_gm``).

Time-mixing: leapfrog with Euler-forward first step; the averaging or
Robert filter is ``step``'s.

The port carries the dynamical core, KPP (with its non-local tracer
source, tidal and near-inertial wave mixing), GM or the biharmonic tracer
mixing, the submesoscale scheme (folded into the GM chain kernel where
that runs, its own tendency otherwise), the chlorophyll (or Jerlov)
shortwave heating, frazil ice, the passive tracers' surface fluxes,
interior sources and resets, the overflows' tracer exchange, the
geothermal bottom heat flux and depth acceleration, the interior T/S
restoring toward the forcing's 3-D targets, and the estuary box model's
exchange circulation at the forcing's river points (``estuary``), all
plain. Under ``chl_option='file'`` the chlorophyll is the forcing's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from pop2_tpu_torch import advect, clinic_cuda, eos, gm, gm_chain_cuda, hmix
from pop2_tpu_torch import estuary, ice
from pop2_tpu_torch import kpp
from pop2_tpu_torch import overflows, submeso, sw_absorption, tracer_cuda
from pop2_tpu_torch import tridiag, vmix
from pop2_tpu_torch import constants as const
from pop2_tpu_torch.config import ModelConfig
from pop2_tpu_torch.forcing import Forcing
from pop2_tpu_torch.grid import Grid, thickness_u
from pop2_tpu_torch.state import State
from pop2_tpu_torch.stencil import BC


class BaroclinicOut(NamedTuple):
    tracer_new: torch.Tensor  # predictor tracers (T,S updated if press avg)
    u_new: torch.Tensor       # normalized baroclinic velocity U'
    v_new: torch.Tensor
    rho_new: torch.Tensor     # density from predictor T,S (press avg only)
    zx: torch.Tensor          # (ny, nx) vertically-averaged forcing
    zy: torch.Tensor
    vdc: torch.Tensor         # (2, km, ny, nx) diffusivity used, for corrector
    vvc: torch.Tensor         # (km, ny, nx) viscosity used
    gm: Optional[gm.GMOut] = None  # GM tendency and diagnostics, if GM ran
    kpp: Optional[kpp.KPPOut] = None  # under vmix='kpp': hblt, hmxl, ...


def _timestep_arrays(cfg: ModelConfig, grid: Grid, leapfrog: bool):
    """c2dt factors (source/step_mod.F90:302-320): (c2dtt (km,) tensor,
    c2dtu, c2dtp). Under depth acceleration (``laccel``) the tracer step
    of level k is dtt*dttxcel(k), the top level's unaccelerated
    (source/time_management.F90:975-1009)."""
    dtt, dtu, dtp = cfg.time.dtt, cfg.time.dtu, cfg.time.dtp
    fac = 2.0 if leapfrog else 1.0
    xcel = vmix.depth_accel(cfg, grid)
    if xcel is not None:
        c2dtt = fac * dtt * xcel
    else:
        c2dtt = torch.full((cfg.km,), fac * dtt, dtype=cfg.torch_dtype,
                           device=grid.KMT.device)
    return c2dtt, fac * dtu, fac * dtp


def _masked_density(cfg, grid, ts_range, tracer):
    rho = eos.state(cfg, grid.vgrid.pressz, tracer[0], tracer[1], ts_range,
                    fit=grid.vgrid.poly)
    return torch.where(grid.kmask_t, rho, 0.0)


def driver(cfg: ModelConfig, grid: Grid, bc: BC, ts_range,
           state: State, forcing: Forcing, dh, dhu,
           leapfrog: bool, want_gm_diags: bool = True,
           sw_profile=None, kpp_statics=None, passive=None,
           ovf_statics=None, ovf_trans=None, ovf_sel=None,
           ovf_sets_tavg=None) -> BaroclinicOut:
    """Explicit baroclinic update (baroclinic_driver,
    source/baroclinic.F90:578): the tracer predictor and the normalized
    baroclinic velocity. ``sw_profile``: the Jerlov transmission profile
    (``sw_absorption.absorb_profile``) when ``sw_absorption='jerlov'``;
    ``kpp_statics``: ``kpp.build_statics`` when ``vmix='kpp'``;
    ``passive``: ``passive_tracers.PassiveTracers`` when the config has
    passive tracers; ``ovf_statics``: ``overflows.build_statics`` with the
    step's transports, product-set selection and set means (``step.step``
    computes them once a step)."""
    c2dtt, c2dtu, _ = _timestep_arrays(cfg, grid, leapfrog)
    beta = cfg.time.alpha if leapfrog else cfg.time.theta
    varthick = cfg.sfc_layer == "varthick"
    press_avg = cfg.lpressure_avg and leapfrog
    vg = grid.vgrid

    if leapfrog:
        tmix, umix, vmix_m, rhomix = (state.tracer_old, state.u_old,
                                      state.v_old, state.rho_old)
    else:
        tmix, umix, vmix_m, rhomix = (state.tracer_cur, state.u_cur,
                                      state.v_cur, state.rho_cur)

    # the chlorophyll field of the Ohlmann transmission, shared by KPP's
    # radiative boundary-layer term and the shortwave heating below: the
    # forcing's under chl_option='file', else (or without one) the constant
    chl = None
    if cfg.sw_absorption == "chlorophyll":
        if cfg.chl_option == "file":
            chl = forcing.chl
        if chl is None:
            chl = torch.full_like(forcing.shf_qsw, cfg.chl_const)

    # ---- vertical mixing coefficients (source/baroclinic.F90:714-734) -----
    coeffs = vmix.vmix_coeffs(cfg, grid, bc, tmix, umix, vmix_m, rhomix,
                              forcing=forcing, kpp_statics=kpp_statics,
                              chl=chl, ucur=state.u_cur, vcur=state.v_cur)
    kppo = coeffs.kpp
    hblt = kppo.hblt if kppo is not None else None
    hmxl = kppo.hmxl if kppo is not None else None
    with_passive = passive is not None and bool(passive.packages)

    # surface fluxes with the passive tracers' gas exchange
    # (set_sflux_passive_tracers, source/passive_tracers.F90:988)
    if with_passive:
        stf = forcing.stf.clone()
        stf[2:] += passive.set_sflux(cfg, grid, state.tracer_old,
                                     state.tracer_cur, forcing)
        forcing = forcing.replace(stf=stf)

    # ---- tracer tendencies (tracer_update, source/baroclinic.F90:1902):
    # hdifft + comp_flux_vel/advt + vdifft fused in one kernel. Under GM the
    # horizontal mixing is the GM kernels' (KPP's boundary layer the
    # transition layer's diabatic depth), its |S|^2 vertical diffusivity
    # joins the implicit solves (source/hmix_gm.F90:1741-1748), and the
    # tracer kernel runs without the Laplacian; so it does beside the
    # biharmonic mixing (del4, plain). The chain kernel folds the
    # submesoscale streamfunction into GM's; elsewhere the submesoscale
    # tendency is its own (mix_submeso.F90, beside hdifft in tracer_update).
    # The forward-in-time lw_lim advection has no kernel (neither has the JAX
    # package: its Pallas tracer kernel refuses lw_lim): under it advection
    # and vertical diffusion are plain, and so is the Laplacian mixing
    gm_out = None
    submeso_done = False
    if cfg.hmix_tracer == "gm":
        if gm_chain_cuda.available(cfg, grid):
            gm_out = gm_chain_cuda.hdifft_chain(
                cfg, grid, bc, ts_range, tmix, hblt=hblt, hmxl=hmxl,
                want_diags=want_gm_diags)
            submeso_done = cfg.lsubmeso
        else:
            gm_out = gm.hdifft_gm(cfg, grid, bc, ts_range, tmix, hblt=hblt,
                                  umix=umix, vmix_m=vmix_m)
        coeffs = coeffs._replace(vdc=coeffs.vdc + gm_out.vdc_gm[None])
    if cfg.tadvect == "lw_lim":
        fv = advect.comp_flux_vel(cfg, grid, bc, state.u_cur, state.v_cur,
                                  dh)
        ft = -advect.advt(cfg, grid, bc, fv, state.tracer_cur, tmix=tmix,
                          c2dtt=c2dtt)
        ft += vmix.vdifft(cfg, grid, coeffs.vdc, state.tracer_old,
                          forcing.stf)
        del2_done = False
    else:
        ft = tracer_cuda.tracer_tendency(
            cfg, grid, state.u_cur, state.v_cur, state.tracer_cur, tmix,
            state.tracer_old, coeffs.vdc, forcing.stf, dh)
        del2_done = tracer_cuda.with_del2(cfg)
    # ft is this step's own tensor: the terms below add to it in place
    if gm_out is not None:
        ft += gm_out.gtk
    elif not del2_done:
        ft += hmix.hdifft(cfg, grid, bc, tmix)
    if cfg.lsubmeso and not submeso_done:
        ft += submeso.submeso_tendency(cfg, grid, bc, ts_range, tmix,
                                       hmxl=hmxl)[0]
    if varthick:
        # freshwater tracer flux into the surface layer
        # (source/baroclinic.F90:2128-2138)
        ft[:, 0] += vg.dzr[0] * forcing.tfw
    # KPP non-local transport (add_kpp_sources,
    # source/vmix_kpp.F90:3633-3692)
    if kppo is not None:
        ft += kpp.kpp_sources(cfg, grid, kppo.ghat_src, forcing.stf)
    # penetrative shortwave heating (add_sw_absorb,
    # source/sw_absorption.F90:818): the Jerlov profile, or the Ohlmann
    # chlorophyll transmission of the chlorophyll field above
    if cfg.sw_absorption == "jerlov" and sw_profile is not None:
        ft = sw_absorption.add_sw_absorb(cfg, grid, ft, forcing.shf_qsw,
                                         sw_profile)
    elif cfg.sw_absorption == "chlorophyll":
        trans = sw_absorption.chl_transmission(cfg, grid, chl)
        ft = sw_absorption.add_sw_absorb(cfg, grid, ft, forcing.shf_qsw,
                                         trans)
    # passive-tracer interior sources (set_interior_passive_tracers,
    # source/passive_tracers.F90:768)
    if with_passive:
        ft[2:] += passive.set_interior(cfg, grid, state.tracer_old,
                                       state.tracer_cur, forcing=forcing)
    # T/S interior restoring (set_pt_interior, forcing_pt_interior.F90:569-
    # 668; set_s_interior, forcing_s_interior.F90): toward the forcing's 3-D
    # targets down to restore_max_level, the surface level only where
    # surface restoring is on
    for n, data, tau_d, maxlev, sfc in (
            (0, forcing.pt_interior_data, cfg.pt_interior_restore_tau_days,
             cfg.pt_interior_restore_max_level,
             cfg.pt_interior_surface_restore),
            (1, forcing.s_interior_data, cfg.s_interior_restore_tau_days,
             cfg.s_interior_restore_max_level,
             cfg.s_interior_surface_restore)):
        if data is not None:
            rtau = 1.0 / (tau_d * 86400.0)
            kidx = torch.arange(cfg.km, device=ft.device).reshape(cfg.km, 1,
                                                                  1)
            mask = grid.kmask_t & (kidx < maxlev)
            if not sfc:
                mask = mask & (kidx > 0)
            ft[n] += torch.where(mask, rtau * (data - state.tracer_cur[n]),
                                 0.0)
    # estuary exchange circulation (set_estuary_exch_circ,
    # source/estuary_vsf_mod.F90:645-755): vertical redistribution by the
    # box model's exchange flow at the river points
    if cfg.lestuary_exch and forcing.roff_f is not None:
        w_up, w_lo = estuary.device_layer_weights(cfg, grid, ft.dtype)
        ft += estuary.exchange_circulation(cfg, grid, state.tracer_cur,
                                           forcing.roff_f, w_up, w_lo)
    # overflow parameterization (ovf_driver, source/overflows.F90:3477; the
    # conservative regional exchange of overflows.py)
    if cfg.overflows and ovf_statics is not None:
        ft += overflows.tendency(cfg, grid, ovf_statics, state.tracer_cur,
                                 trans=ovf_trans, sel=ovf_sel,
                                 sets_tavg=ovf_sets_tavg)

    # geothermal bottom heat flux (geoheatflux.F90:69-232 and
    # vertical_mix.F90:1428-1443: VTFB = -geoflux at k == KMT where
    # zw(k) >= geoheatflux_depth; it enters the tendency as +geoflux*dzr)
    if cfg.geoheatflux_const != 0.0:
        kidx = torch.arange(cfg.km, device=ft.device).reshape(cfg.km, 1, 1)
        bottom = ((kidx == grid.KMT[None] - 1)
                  & (vg.zw.reshape(cfg.km, 1, 1) >= cfg.geoheatflux_depth))
        geo = cfg.geoheatflux_const * const.HFLUX_FACTOR
        ft[0] += torch.where(bottom, geo * vg.dzr.reshape(cfg.km, 1, 1),
                             0.0)

    # ---- build RHS / predictor update (source/baroclinic.F90:2212-2300) ---
    rhs = torch.where(grid.kmask_t[None], c2dtt.reshape(1, cfg.km, 1, 1) * ft,
                      0.0)
    if varthick and press_avg:
        # surface RHS for the T,S predictor includes the known part of the
        # surface-height change (source/baroclinic.F90:2217-2222)
        pterm = (2.0 * state.tracer_cur[:2, 0]
                 * (state.psurf_cur - state.psurf_old)[None]
                 / (const.GRAV * vg.dz[0]))
        rhs[:2, 0] = torch.where(grid.kmask_t[0][None],
                                 c2dtt[0] * ft[:2, 0] - pterm, 0.0)
        # predictor tridiagonal update of T,S, with PSURF(cur) on the LHS
        # (source/baroclinic.F90:885-895); the passive tracers carry their
        # right-hand side to the corrector
        tracer_new = torch.cat([torch.stack([
            state.tracer_old[n] + tridiag.impvmixt(
                rhs[n], coeffs.vdc[n], state.psurf_cur, grid.KMT, vg.dz,
                vg.dzwr, c2dtt, cfg.aidif, varthick=True, bottom=grid.DZBT)
            for n in range(2)]), rhs[2:]])
    elif not varthick:
        # tracer 0 has its own diffusivity class; the others share vdc[1]
        # and one factorization
        dT0 = tridiag.impvmixt(
            rhs[0], coeffs.vdc[0], state.psurf_cur, grid.KMT, vg.dz,
            vg.dzwr, c2dtt, cfg.aidif, varthick=False, bottom=grid.DZBT)
        dTs = tridiag.impvmixt_batch(
            rhs[1:], coeffs.vdc[1], state.psurf_cur, grid.KMT, vg.dz,
            vg.dzwr, c2dtt, cfg.aidif, varthick=False, bottom=grid.DZBT)
        tracer_new = state.tracer_old + torch.cat([dT0[None], dTs], dim=0)
    else:
        # varthick without pressure averaging (or Euler step): the full
        # update happens after the barotropic solve; carry the RHS
        tracer_new = rhs

    # ---- density at new time for pressure averaging -----------------------
    if press_avg:
        rho_new = _masked_density(cfg, grid, ts_range, tracer_new)
    else:
        rho_new = state.rho_cur

    # ---- momentum (clinic, source/baroclinic.F90:1635-1895): advu +
    # coriolis + gradp + hdiffu + vdiffu + ZX/ZY fused in one kernel
    fx, fy, zx, zy = clinic_cuda.clinic_rhs(
        cfg, grid, state, umix, vmix_m, rho_new, coeffs.vvc, forcing.smf,
        dhu, leapfrog)

    # implicit Coriolis 2x2 transform (source/baroclinic.F90:1013-1027)
    if cfg.time.impcor:
        w1 = c2dtu * beta * grid.FCOR
        w2 = c2dtu / (1.0 + w1 ** 2)
        rhs_u = (fx + w1 * fy) * w2
        rhs_v = (fy - w1 * fx) * w2
    else:
        rhs_u = c2dtu * fx
        rhs_v = c2dtu * fy

    # implicit vertical friction (source/baroclinic.F90:1066-1069)
    rhs_u, rhs_v = tridiag.impvmixu(rhs_u, rhs_v, coeffs.vvc, grid.KMU,
                                    vg.dz, vg.dzwr, c2dtu, cfg.aidif,
                                    bottom=grid.DZBU)

    # unnormalized baroclinic velocity (source/baroclinic.F90:1077-1080)
    upp = state.u_old + rhs_u
    vpp = state.v_old + rhs_v

    # subtract vertical mean (source/baroclinic.F90:1092-1140)
    dzc = thickness_u(cfg, grid)
    ubar = grid.HUR * torch.sum(upp * dzc, dim=0)
    vbar = grid.HUR * torch.sum(vpp * dzc, dim=0)
    u_new = torch.where(grid.kmask_u, upp - ubar[None], 0.0)
    v_new = torch.where(grid.kmask_u, vpp - vbar[None], 0.0)

    return BaroclinicOut(tracer_new=tracer_new, u_new=u_new, v_new=v_new,
                         rho_new=rho_new, zx=zx, zy=zy, vdc=coeffs.vdc,
                         vvc=coeffs.vvc, gm=gm_out, kpp=kppo)


def correct_adjust(cfg: ModelConfig, grid: Grid, bc: BC, ts_range,
                   state: State, out: BaroclinicOut, psurf_new,
                   coeffs_vdc, leapfrog: bool, avg_ts: bool = False,
                   passive=None):
    """Corrector/adjustment pass (source/baroclinic.F90:1217-1497):
    finish the tracer update with the new surface pressure, apply convective
    adjustment, the passive tracers' resets, the freezing reset or frazil
    ice, and recompute the new density.

    ``coeffs_vdc``: the same vertical diffusivity used by the predictor.
    Returns (tracer_new, rho_new, qice, aqice).
    """
    c2dtt, _, _ = _timestep_arrays(cfg, grid, leapfrog)
    varthick = cfg.sfc_layer == "varthick"
    press_avg = cfg.lpressure_avg and leapfrog
    tracer_new = out.tracer_new
    vg = grid.vgrid
    grav_dz1 = const.GRAV * vg.dz[0]

    # the corrector's solves take the 1-D dz under partial bottom cells
    # too, as the JAX package's do (ROADMAP.md Queue 3)
    if varthick:
        if press_avg:
            # corrector RHS for T,S at the surface
            # (source/baroclinic.F90:1283-1296)
            dts = []
            for n in range(2):
                rhs1 = torch.where(
                    grid.kmask_t[0],
                    ((2.0 * state.tracer_cur[n, 0] - state.tracer_old[n, 0])
                     * (state.psurf_cur - state.psurf_old)
                     - tracer_new[n, 0] * (psurf_new - state.psurf_cur))
                    / grav_dz1, 0.0)
                dT = tridiag.impvmixt_correct(
                    rhs1, coeffs_vdc[n], psurf_new, grid.KMT, vg.dz, vg.dzwr,
                    c2dtt, cfg.aidif, varthick=True)
                dts.append(tracer_new[n] + dT)
            if cfg.nt > 2:
                # passive tracers: surface RHS adjustment and one solve for
                # all of them (source/baroclinic.F90:1303-1321)
                rhs_p = tracer_new[2:].clone()
                rhs_p[:, 0] += torch.where(
                    grid.kmask_t[0][None],
                    -state.tracer_old[2:, 0]
                    * (psurf_new - state.psurf_old)[None] / grav_dz1, 0.0)
                dTs = tridiag.impvmixt_batch(
                    rhs_p, coeffs_vdc[1], psurf_new, grid.KMT, vg.dz,
                    vg.dzwr, c2dtt, cfg.aidif, varthick=True)
                dts.extend(state.tracer_old[2:] + dTs)
            tracer_new = torch.stack(dts)
        else:
            # no pressure averaging (or Euler step): tracer_new holds the
            # RHS; apply the surface-pressure term and solve all tracers
            # (source/baroclinic.F90:1326-1344); psurf at mixtime is
            # psurf_cur for the Euler/non-avg path
            rhs_all = tracer_new.clone()
            rhs_all[:, 0] += torch.where(
                grid.kmask_t[0][None],
                -state.tracer_old[:, 0]
                * (psurf_new - state.psurf_cur)[None] / grav_dz1, 0.0)
            dT0 = tridiag.impvmixt(
                rhs_all[0], coeffs_vdc[0], psurf_new, grid.KMT, vg.dz,
                vg.dzwr, c2dtt, cfg.aidif, varthick=True)
            dTs = tridiag.impvmixt_batch(
                rhs_all[1:], coeffs_vdc[1], psurf_new, grid.KMT, vg.dz,
                vg.dzwr, c2dtt, cfg.aidif, varthick=True)
            tracer_new = state.tracer_old + torch.cat([dT0[None], dTs],
                                                      dim=0)

    # reset surface temperature to freezing floor
    # (source/baroclinic.F90:1418-1421); frazil ice takes its place
    if cfg.reset_to_freezing and not cfg.liceform:
        if tracer_new is out.tracer_new:
            tracer_new = tracer_new.clone()
        tracer_new[0, 0] = torch.clamp(tracer_new[0, 0], min=-2.0)

    # convective adjustment (no-op for convection_type='diffusion')
    tracer_new = vmix.convad(cfg, grid, tracer_new)

    # passive-tracer resets (reset_passive_tracers,
    # source/baroclinic.F90:1458-1460), out of place
    if passive is not None and passive.packages:
        tracer_new = passive.reset(cfg, grid, tracer_new)

    # frazil ice formation (source/baroclinic.F90:1442-1450)
    qice, aqice = state.qice, state.aqice
    if cfg.liceform:
        tracer_new, qice, aqice = ice.ice_formation(
            cfg, grid, tracer_new, psurf_new, qice, aqice,
            0.5 if avg_ts else 1.0)

    # recompute density from final tracers (source/baroclinic.F90:1476-1482)
    rho_new = _masked_density(cfg, grid, ts_range, tracer_new)
    return tracer_new, rho_new, qice, aqice
