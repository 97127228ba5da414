"""One model timestep.

Reference: ``source/step_mod.F90:126-894`` and ``source/surface_hgt.F90:131``.
The whole step — dh/dt, baroclinic explicit update, barotropic implicit
solve, tracer corrector, time filtering — is one function from a ``State`` to
a new ``State``. The reference's three-time-level index rotation (:827-831)
becomes reassembly of the two-level state.

The time mixing is 'avg' or 'avgfit' (Euler first step, leapfrog,
averaging filter; the model's time manager says which steps average) or
'robert' (the Robert-Asselin filter every step, step_RF). The step is
``pre`` (up to the barotropic solver's first pass), the solver's loop and
``post``; ``graphs.py`` captures ``pre`` and ``post`` as CUDA graphs. On a tripole grid
the degenerate top U row is made symmetric after every update. With
overflows the transports are computed once a step and shared by the tracer
exchange, the barotropic continuity and the sidewall momentum. With
``with_extras`` the step also returns the fields the tavg registry
accumulates from inside the physics (``extras``: KPP's depths and mixing
internals, the diffusivities, GM's diagnostic columns and transition-layer
depths, the tracer tendency and the Robert filter's increment), as the JAX
package's step does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from pop2_tpu_torch import baroclinic, barotropic, eos, ice, overflows
from pop2_tpu_torch import solvers
from pop2_tpu_torch import constants as const
from pop2_tpu_torch.config import ModelConfig
from pop2_tpu_torch.forcing import Forcing
from pop2_tpu_torch.grid import Grid
from pop2_tpu_torch.reductions import global_sum
from pop2_tpu_torch.state import State
from pop2_tpu_torch.stencil import BC, tgrid_to_ugrid
from pop2_tpu_torch.tripole import enforce_top_symmetry


class StepDiagnostics(NamedTuple):
    solver_iters: int
    solver_rr: torch.Tensor
    # KPP's boundary-layer and mixed-layer depths (HBLT/HMXL,
    # vmix_kpp.F90), None without KPP
    hblt: Optional[torch.Tensor] = None
    hmxl: Optional[torch.Tensor] = None


def dhdt(cfg: ModelConfig, grid: Grid, bc: BC, state: State):
    """Change of surface height at T and U points
    (source/surface_hgt.F90:131-332)."""
    dtp = cfg.time.dtp
    if cfg.sfc_layer == "varthick":
        dh = ((state.psurf_cur - state.psurf_old) / (const.GRAV * dtp)
              - state.fw_old)
    elif cfg.sfc_layer == "rigid":
        dh = torch.zeros_like(state.psurf_cur)
    else:  # oldfree
        dh = (state.psurf_cur - state.psurf_old) / (const.GRAV * dtp)
    dhu = tgrid_to_ugrid(dh, grid.AU0, grid.AUN, grid.AUE, grid.AUNE, bc)
    dhu = torch.where(grid.kmask_u[0], dhu, 0.0)
    return dh, dhu


def _avg_filter(cfg: ModelConfig, grid: Grid, ts_range, state: State,
                new: State) -> State:
    """Time-averaging filter step (source/step_mod.F90:663-796):
    old' = (old+cur)/2, cur' = (cur+new)/2, with thickness-weighted clamped
    averaging of the surface tracer layer for the variable-thickness case.

    ``new`` here is the post-step state whose *_cur slots hold new-time
    values and *_old slots hold the (unrotated) current values.
    """
    varthick = cfg.sfc_layer == "varthick"
    dz1 = grid.vgrid.dz[0]

    def avg(a, b):
        return 0.5 * (a + b)

    t_old, t_cur, t_new = state.tracer_old, state.tracer_cur, new.tracer_cur
    p_old, p_cur, p_new = state.psurf_old, state.psurf_cur, new.psurf_cur

    tracer_old = avg(t_old, t_cur)
    tracer_cur = avg(t_cur, t_new)
    psurf_old, psurf_cur = avg(p_old, p_cur), avg(p_cur, p_new)

    if varthick:
        def surf_avg(ta, tb, pa, pb, pf):
            wmin = torch.minimum(ta[:, 0], tb[:, 0])
            wmax = torch.maximum(ta[:, 0], tb[:, 0])
            num = 0.5 * ((dz1 + pa / const.GRAV)[None] * ta[:, 0]
                         + (dz1 + pb / const.GRAV)[None] * tb[:, 0])
            t1 = num / (dz1 + pf / const.GRAV)[None]
            return torch.clamp(t1, min=wmin, max=wmax)

        # the averaged tracers are this function's own tensors
        tracer_old[:, 0] = surf_avg(t_old, t_cur, p_old, p_cur, psurf_old)
        tracer_cur[:, 0] = surf_avg(t_cur, t_new, p_cur, p_new, psurf_cur)

    # recompute densities from averaged tracers (source/step_mod.F90:781-790)
    rho_old = baroclinic._masked_density(cfg, grid, ts_range, tracer_old)
    rho_cur = baroclinic._masked_density(cfg, grid, ts_range, tracer_cur)

    return State(
        tracer_old=tracer_old, tracer_cur=tracer_cur,
        u_old=avg(state.u_old, state.u_cur),
        u_cur=avg(state.u_cur, new.u_cur),
        v_old=avg(state.v_old, state.v_cur),
        v_cur=avg(state.v_cur, new.v_cur),
        rho_old=rho_old, rho_cur=rho_cur,
        ubtrop_old=avg(state.ubtrop_old, state.ubtrop_cur),
        ubtrop_cur=avg(state.ubtrop_cur, new.ubtrop_cur),
        vbtrop_old=avg(state.vbtrop_old, state.vbtrop_cur),
        vbtrop_cur=avg(state.vbtrop_cur, new.vbtrop_cur),
        psurf_old=psurf_old, psurf_cur=psurf_cur,
        gradpx_old=avg(state.gradpx_old, state.gradpx_cur),
        gradpx_cur=avg(state.gradpx_cur, new.gradpx_cur),
        gradpy_old=avg(state.gradpy_old, state.gradpy_cur),
        gradpy_cur=avg(state.gradpy_cur, new.gradpy_cur),
        pguess=0.5 * (new.pguess + new.psurf_cur),
        fw_old=0.5 * (new.fw_old + state.fw_old),
        qice=new.qice, aqice=new.aqice,
        rf_s_prev=new.rf_s_prev, rf_s_prev_valid=new.rf_s_prev_valid)


class PreOut(NamedTuple):
    """What ``pre`` leaves for the solve and for ``post``."""
    bout: baroclinic.BaroclinicOut
    ovf_trans: object
    ovf_sel: object
    btrop: barotropic.BarotropicRHS
    solver: solvers.Solver
    carry: dict


def _check_time_mix(cfg: ModelConfig) -> None:
    if cfg.time.time_mix_opt not in ("avg", "avgfit", "robert"):
        raise NotImplementedError(
            f"time_mix_opt={cfg.time.time_mix_opt!r}: the time mixing is "
            "'avg', 'avgfit' or 'robert', as in the JAX package")


def pre(cfg: ModelConfig, grid: Grid, bc: BC, ts_range, state: State,
        forcing: Forcing, leapfrog: bool, pcsi_eigs=None, precond=None,
        sw_profile=None, kpp_statics=None, passive=None,
        ovf_statics=None, with_extras: bool = False) -> PreOut:
    """The step up to the barotropic solve: dh/dt, the overflow transports
    and product-set selection, ``baroclinic.driver`` (with GM's diagnostic
    columns under ``with_extras``), the overflows' renormalized forcing,
    ``barotropic.rhs`` and the solver's first pass (``Solver.init``). Reads
    nothing from the device."""
    _check_time_mix(cfg)
    # 1. surface height change (source/step_mod.F90:361)
    dh, dhu = dhdt(cfg, grid, bc, state)

    # overflow transports: evaluated once, shared by the tracer exchange and
    # the barotropic continuity injection (ovf_driver/ovf_transports,
    # source/overflows.F90:3477,3754)
    ovf_trans = ovf_q = ovf_sel = ovf_sets_tavg = None
    with_ovf = bool(cfg.overflows) and ovf_statics is not None
    if with_ovf:
        ovf_trans = overflows.transports(cfg, grid, ovf_statics,
                                         state.tracer_cur)
        if ovf_statics.sets is not None:
            # neutral-buoyancy product-set selection (ovf_loc_prd,
            # source/overflows.F90:4313-4360)
            ovf_sel, ovf_sets_tavg = overflows.product_set_selection(
                cfg, grid, ovf_statics, state.tracer_cur, ovf_trans)
        ovf_q = overflows.qsurf(cfg, grid, ovf_statics, ovf_trans,
                                sel=ovf_sel)

    # 2. explicit baroclinic update (source/step_mod.F90:375)
    bout = baroclinic.driver(cfg, grid, bc, ts_range, state, forcing,
                             dh, dhu, leapfrog, want_gm_diags=with_extras,
                             sw_profile=sw_profile, kpp_statics=kpp_statics,
                             passive=passive, ovf_statics=ovf_statics,
                             ovf_trans=ovf_trans, ovf_sel=ovf_sel,
                             ovf_sets_tavg=ovf_sets_tavg)

    # 3. implicit barotropic solve (source/step_mod.F90:437), up to the
    # solve; at overflow sidewall columns the vertically-integrated forcing
    # is renormalized for the sub-topography sidewall depth
    # (ovf_rhs_brtrpc_momentum, source/overflows.F90:5068-5224)
    zx, zy = bout.zx, bout.zy
    if with_ovf and ovf_statics.zren is not None:
        zx = zx * ovf_statics.zren
        zy = zy * ovf_statics.zren
    btrop = barotropic.rhs(cfg, grid, bc, state, forcing, zx, zy, leapfrog,
                           ovf_qsurf=ovf_q)
    solver = solvers.make_solver(cfg, btrop.op, bc, pcsi_eigs, precond,
                                 tol=solvers.tolerance(cfg, grid))
    return PreOut(bout=bout, ovf_trans=ovf_trans, ovf_sel=ovf_sel,
                  btrop=btrop, solver=solver,
                  carry=solver.init(state.pguess, btrop.rhs))


def post(cfg: ModelConfig, grid: Grid, bc: BC, ts_range, state: State,
         forcing: Forcing, leapfrog: bool, avg_ts: bool, p: PreOut,
         psurf_new, passive=None, ovf_statics=None,
         with_extras: bool = False):
    """The step from the solve's solution ``psurf_new`` (in the model's
    dtype) on: ``barotropic.finish``, ``correct_adjust``, the velocity
    assembly, the overflows' sidewall momentum, the pressure guess, the
    tripole top-row symmetry and the Robert or averaging filter. Returns
    the new state, and with ``with_extras`` (new state, ``extras``): the
    extras read ``state`` (its old and current tracers), so they are formed
    here, before a caller overwrites ``state`` with the new one."""
    bout = p.bout
    tout = barotropic.finish(cfg, grid, bc, p.btrop, psurf_new)

    # 4. corrector/adjustment pass (source/step_mod.F90:457)
    tracer_new, rho_new, qice, aqice = baroclinic.correct_adjust(
        cfg, grid, bc, ts_range, state, bout, tout.psurf_new, bout.vdc,
        leapfrog, avg_ts, passive=passive)

    # 5. full velocity = baroclinic' + barotropic (source/step_mod.F90:572)
    u_new = torch.where(grid.kmask_u, bout.u_new + tout.ubtrop_new[None],
                        0.0)
    v_new = torch.where(grid.kmask_u, bout.v_new + tout.vbtrop_new[None],
                        0.0)
    if (bool(cfg.overflows) and ovf_statics is not None
            and ovf_statics.mom_u is not None):
        # sidewall momentum sources: the overflow column renormalization
        # (ovf_UV + ovf_UV_solution, source/overflows.F90:4848,5884)
        u_new, v_new = overflows.momentum_adjust(
            cfg, grid, ovf_statics, p.ovf_trans, p.ovf_sel, u_new, v_new,
            tout.ubtrop_new, tout.vbtrop_new)
        u_new = torch.where(grid.kmask_u, u_new, 0.0)
        v_new = torch.where(grid.kmask_u, v_new, 0.0)

    if cfg.ldamp_uv:
        # velocity damping of the new time level (damping.F90 damping_uv,
        # called from step_mod.F90:600-602)
        spy = 365.0 * 86400.0 / cfg.time.dtt
        u_new = u_new * (1.0 - torch.clamp(torch.abs(u_new) / spy, max=0.99))
        v_new = v_new * (1.0 - torch.clamp(torch.abs(v_new) / spy, max=0.99))

    # 6. pressure guess extrapolation (source/step_mod.F90:634-640)
    pguess = 3.0 * (tout.psurf_new - state.psurf_cur) + state.psurf_old

    ubtrop_new, vbtrop_new = tout.ubtrop_new, tout.vbtrop_new
    gradpx_new, gradpy_new = tout.gradpx_new, tout.gradpy_new
    if cfg.ns_boundary == "tripole":
        # the top U row lies on the fold and is degenerate: each point
        # coincides with its index-reversed partner; keep them consistent
        # after every update (mpi/POP_HaloMod.F90:1977-1986)
        u_new, v_new, ubtrop_new, vbtrop_new, gradpx_new, gradpy_new = (
            enforce_top_symmetry(f) for f in (
                u_new, v_new, ubtrop_new, vbtrop_new, gradpx_new,
                gradpy_new))

    new = State(
        tracer_old=state.tracer_cur, tracer_cur=tracer_new,
        u_old=state.u_cur, u_cur=u_new,
        v_old=state.v_cur, v_cur=v_new,
        rho_old=state.rho_cur, rho_cur=rho_new,
        ubtrop_old=state.ubtrop_cur, ubtrop_cur=ubtrop_new,
        vbtrop_old=state.vbtrop_cur, vbtrop_cur=vbtrop_new,
        psurf_old=state.psurf_cur, psurf_cur=tout.psurf_new,
        gradpx_old=state.gradpx_cur, gradpx_cur=gradpx_new,
        gradpy_old=state.gradpy_cur, gradpy_cur=gradpy_new,
        pguess=pguess, fw_old=forcing.fw, qice=qice,
        aqice=aqice, rf_s_prev=state.rf_s_prev,
        rf_s_prev_valid=state.rf_s_prev_valid)

    # 7. time filtering (source/step_mod.F90:663-832)
    rf_tend_tracer = None
    if cfg.time.time_mix_opt == "robert":
        prefilter = new.tracer_old
        new = _robert_filter(cfg, grid, ts_range, state, new, forcing,
                             passive=passive)
        if with_extras:
            # Robert-filter tendency (RF_TEND_* tavg fields,
            # source/passive_tracers.F90:723-733): the filter's increment of
            # the current time level per unit time
            rf_tend_tracer = (new.tracer_old - prefilter) / cfg.time.dtt
    elif avg_ts:
        new = _avg_filter(cfg, grid, ts_range, state, new)
    if not with_extras:
        return new
    return new, extras(cfg, grid, p, state, tracer_new, leapfrog,
                       rf_tend_tracer)


def extras(cfg: ModelConfig, grid: Grid, p: PreOut, state: State,
           tracer_new, leapfrog: bool, rf_tend_tracer=None) -> dict:
    """The step-internal fields the tavg registry accumulates (the JAX
    package's step extras): KPP's HBLT/HMXL and mixing internals
    (vmix_kpp.F90), the diffusivity and viscosity, GM's diagnostic columns
    and transition-layer depths (hmix_gm.F90:2198-2209), the pre-filter
    tracer tendency over the step ((TNEW - TOLD)/c2dt, baroclinic.F90) from
    the pre-step ``state``, and the Robert filter's increment. Absent
    physics gives None."""
    bout = p.bout
    kppo, gmo = bout.kpp, bout.gm
    c2dtt = baroclinic._timestep_arrays(cfg, grid, leapfrog)[0]
    base = state.tracer_old if leapfrog else state.tracer_cur
    out = {name: getattr(kppo, name) if kppo is not None else None
           for name in ("hblt", "hmxl", "hmxl_dr", "kvmix", "kvmix_m",
                        "tpower")}
    out.update(vdc=bout.vdc, vvc=bout.vvc)
    out.update({name: getattr(gmo, name) if gmo is not None else None
                for name in ("kappa_isop", "kappa_thic", "hor_diff",
                             "dia_depth", "tlt_thick", "int_depth")})
    out["tend_tracer"] = (tracer_new - base) / c2dtt.reshape(1, cfg.km, 1, 1)
    out["rf_tend_tracer"] = rf_tend_tracer
    return out


def diagnostics(p: PreOut, iters: int, rr) -> StepDiagnostics:
    """The step's diagnostics from ``pre``'s output and the solve's."""
    kppo = p.bout.kpp
    return StepDiagnostics(
        solver_iters=iters, solver_rr=rr,
        hblt=kppo.hblt if kppo is not None else None,
        hmxl=kppo.hmxl if kppo is not None else None)


def step(cfg: ModelConfig, grid: Grid, bc: BC, ts_range, state: State,
         forcing: Forcing, leapfrog: bool, avg_ts: bool,
         pcsi_eigs=None, precond=None, sw_profile=None, kpp_statics=None,
         passive=None, ovf_statics=None, with_extras: bool = False):
    """Advance one timestep (leapfrog, Euler-forward for the first step,
    the averaging or Robert filter): ``pre``, the solver's loop, ``post``.
    ``pcsi_eigs``: PCSI's bounds, a pair or ``solvers.PCSIBounds``;
    ``precond``: the barotropic solver's preconditioner
    (``solvers.FSPAI9``) or None for the diagonal one; ``sw_profile``: the
    Jerlov shortwave profile; ``kpp_statics``: KPP's
    (``kpp.build_statics``); ``passive``: the passive-tracer packages
    (``passive_tracers.PassiveTracers``); ``ovf_statics``: the overflows'
    (``overflows.build_statics``). Returns (state, StepDiagnostics), and
    with ``with_extras`` (state, StepDiagnostics, extras) (``extras``)."""
    p = pre(cfg, grid, bc, ts_range, state, forcing, leapfrog, pcsi_eigs,
            precond, sw_profile, kpp_statics, passive, ovf_statics,
            with_extras)
    carry, iters, rr = p.solver.run(p.carry)
    out = post(cfg, grid, bc, ts_range, state, forcing, leapfrog, avg_ts, p,
               carry["x"].to(state.pguess.dtype), passive=passive,
               ovf_statics=ovf_statics, with_extras=with_extras)
    if with_extras:
        return out[0], diagnostics(p, iters, rr), out[1]
    return out, diagnostics(p, iters, rr)


def _robert_filter(cfg: ModelConfig, grid: Grid, ts_range, state: State,
                   new: State, forcing: Forcing, passive=None) -> State:
    """Robert-Asselin time filter (step_RF, source/step_mod.F90:919-1354).

    With robert_alpha = 1 (the default) only the current time level is
    filtered: W = old + new - 2 cur, cur += nu/2 W. Tracers are filtered
    thickness-weighted at the surface; PSURF and the tracers get global
    conservation adjustments (every tracer's); ice formation, the passive
    tracers' resets and the density act on the filtered fields.

    ``new`` is the post-step state (its *_old the pre-step current values,
    its *_cur the new-time values); ``state`` is the pre-step state.
    """
    rc = 0.5 * cfg.time.robert_nu * cfg.time.robert_alpha
    rn = 0.5 * cfg.time.robert_nu * (cfg.time.robert_alpha - 1.0)
    nonzero_new = cfg.time.robert_alpha != 1.0
    if cfg.sfc_layer != "varthick":
        raise NotImplementedError(
            "the Robert filter needs the variable-thickness surface layer "
            "(source/step_mod.F90:1152)")

    def filt(o, c, n):
        w = o + n - 2.0 * c
        c2 = c + rc * w
        n2 = n + rn * w if nonzero_new else n
        return c2, n2

    ub_c, ub_n = filt(state.ubtrop_old, state.ubtrop_cur, new.ubtrop_cur)
    vb_c, vb_n = filt(state.vbtrop_old, state.vbtrop_cur, new.vbtrop_cur)
    gx_c, gx_n = filt(state.gradpx_old, state.gradpx_cur, new.gradpx_cur)
    gy_c, gy_n = filt(state.gradpy_old, state.gradpy_cur, new.gradpy_cur)
    u_c, u_n = filt(state.u_old, state.u_cur, new.u_cur)
    v_c, v_n = filt(state.v_old, state.v_cur, new.v_cur)

    t_old, t_cur, t_new = state.tracer_old, state.tracer_cur, new.tracer_cur
    p_old, p_cur, p_new = state.psurf_old, state.psurf_cur, new.psurf_cur
    dz1 = grid.vgrid.dz[0]

    # interior tracer filter (k >= 2); S kept for the conservation sums
    store_rf = t_old + t_new - 2.0 * t_cur
    t_cur_f = t_cur.clone()
    t_cur_f[:, 1:] += rc * store_rf[:, 1:]
    t_new_f = t_new
    if nonzero_new:
        t_new_f = t_new.clone()
        t_new_f[:, 1:] += rn * store_rf[:, 1:]

    # surface: thickness-weighted filter (source/step_mod.F90:1071-1144)
    thick_o = dz1 + p_old / const.GRAV
    thick_c = dz1 + p_cur / const.GRAV
    thick_n = dz1 + p_new / const.GRAV
    s_sfc = (thick_o[None] * t_old[:, 0] + thick_n[None] * t_new[:, 0]
             - 2.0 * thick_c[None] * t_cur[:, 0])

    # masked volume-weighted S for conservation (:1051-1097)
    mask3 = grid.kmask_t.to(grid.TAREA.dtype)
    dzc = grid.vgrid.dz.reshape(cfg.km, 1, 1)
    store_int = store_rf.clone()
    store_int[:, 0] = 0.0
    svol = global_sum(grid.TAREA[None, None] * mask3[None] * dzc[None]
                      * store_int, b4b=cfg.b4b, axis=(1, 2, 3))
    svol = svol + global_sum(grid.TAREA[None] * mask3[0][None] * s_sfc,
                             b4b=cfg.b4b, axis=(1, 2))

    tth_c = thick_c[None] * t_cur[:, 0] + rc * s_sfc
    tth_n = (thick_n[None] * t_new[:, 0] + rn * s_sfc) if nonzero_new \
        else None

    # PSURF with its own conservation adjustment (:1099-1131)
    workb = p_old + p_new - 2.0 * p_cur
    p_cur_f = p_cur + rc * workb
    p_new_f = p_new + rn * workb if nonzero_new else p_new
    area = global_sum(grid.TAREA * grid.RCALCT, b4b=cfg.b4b)
    rf_sump = global_sum(workb * grid.TAREA * grid.RCALCT,
                         b4b=cfg.b4b) / area
    p_cur_f = p_cur_f - rc * rf_sump * grid.RCALCT
    if nonzero_new:
        p_new_f = p_new_f - rn * rf_sump * grid.RCALCT

    # surface tracers from the thickness-weighted values (:1132-1142)
    thick_c_f = dz1 + p_cur_f / const.GRAV
    t_cur_f[:, 0] = tth_c / thick_c_f[None]
    if nonzero_new:
        thick_n_f = dz1 + p_new_f / const.GRAV
        t_new_f[:, 0] = tth_n / thick_n_f[None]

    # global tracer conservation adjustment (:1160-1209)
    vol = (global_sum(mask3[1:] * dzc[1:] * grid.TAREA[None], b4b=cfg.b4b)
           + global_sum(mask3[0] * thick_c_f * grid.TAREA, b4b=cfg.b4b))
    rf_s = svol / vol
    # stabilized factor: the mean with the previous step's value once
    # there is one (:1178-1184)
    factor = torch.where(state.rf_s_prev_valid > 0.5,
                         0.5 * (rf_s + state.rf_s_prev), rf_s)
    t_cur_f = t_cur_f - (rc * factor)[:, None, None, None] * mask3[None]
    if nonzero_new:
        t_new_f = t_new_f - (rn * rf_s)[:, None, None, None] * mask3[None]

    # ice formation on both filtered levels, then the passive resets on the
    # filtered ones (:1239-1279)
    qice, aqice = new.qice, new.aqice
    if cfg.liceform:
        t_cur_f, qice, aqice = ice.ice_formation(
            cfg, grid, t_cur_f, p_cur_f, qice, aqice, 1.0)
        t_new_f, qice, aqice = ice.ice_formation(
            cfg, grid, t_new_f, p_new_f, qice, aqice, 1.0)
    if passive is not None and passive.packages:
        t_cur_f = passive.reset(cfg, grid, t_cur_f)
        if nonzero_new:
            t_new_f = passive.reset(cfg, grid, t_new_f)

    # densities of both levels (:1281-1288)
    rho_c = torch.where(grid.kmask_t, eos.state(
        cfg, grid.vgrid.pressz, t_cur_f[0], t_cur_f[1], ts_range,
        fit=grid.vgrid.poly), 0.0)
    rho_n = torch.where(grid.kmask_t, eos.state(
        cfg, grid.vgrid.pressz, t_new_f[0], t_new_f[1], ts_range,
        fit=grid.vgrid.poly), 0.0)

    # pressure guess from the filtered levels (:1310-1316)
    pguess = 3.0 * (p_new_f - p_cur_f) + state.psurf_old

    return State(
        tracer_old=t_cur_f, tracer_cur=t_new_f,
        u_old=u_c, u_cur=u_n, v_old=v_c, v_cur=v_n,
        rho_old=rho_c, rho_cur=rho_n,
        ubtrop_old=ub_c, ubtrop_cur=ub_n,
        vbtrop_old=vb_c, vbtrop_cur=vb_n,
        psurf_old=p_cur_f, psurf_cur=p_new_f,
        gradpx_old=gx_c, gradpx_cur=gx_n,
        gradpy_old=gy_c, gradpy_cur=gy_n,
        pguess=pguess, fw_old=forcing.fw, qice=qice, aqice=aqice,
        rf_s_prev=rf_s, rf_s_prev_valid=torch.ones_like(
            state.rf_s_prev_valid))
