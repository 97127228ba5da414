"""One model timestep.

Reference: ``source/step_mod.F90:126-894`` and ``source/surface_hgt.F90:131``.
The whole step — dh/dt, baroclinic explicit update, barotropic implicit
solve, tracer corrector, time filtering — is one function from a ``State`` to
a new ``State``. The reference's three-time-level index rotation (:827-831)
becomes reassembly of the two-level state.

This slice carries the 'avg' time mixing (Euler first step, leapfrog,
averaging filter). The Robert filter, the tripole top-row symmetry, the
overflow branches and the tavg extras of the JAX package's step are later
slices; ``supported.check_supported`` refuses the switches that select them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from pop2_tpu_torch import baroclinic, barotropic
from pop2_tpu_torch import constants as const
from pop2_tpu_torch.config import ModelConfig
from pop2_tpu_torch.forcing import Forcing
from pop2_tpu_torch.grid import Grid
from pop2_tpu_torch.state import State
from pop2_tpu_torch.stencil import BC, tgrid_to_ugrid


class StepDiagnostics(NamedTuple):
    solver_iters: int
    solver_rr: torch.Tensor


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


def step(cfg: ModelConfig, grid: Grid, bc: BC, ts_range, state: State,
         forcing: Forcing, leapfrog: bool, avg_ts: bool,
         pcsi_eigs: Optional[Tuple[float, float]] = None):
    """Advance one timestep (leapfrog, Euler-forward for the first step,
    optional averaging filter). Returns (state, StepDiagnostics)."""
    if cfg.time.time_mix_opt != "avg":
        raise NotImplementedError(
            f"time_mix_opt={cfg.time.time_mix_opt!r} is not ported yet "
            "(ROADMAP.md Queue 1 items 5, 10)")

    # 1. surface height change (source/step_mod.F90:361)
    dh, dhu = dhdt(cfg, grid, bc, state)

    # 2. explicit baroclinic update (source/step_mod.F90:375)
    # (no time-averaged history yet: the GM diagnostic columns are not
    # written)
    bout = baroclinic.driver(cfg, grid, bc, ts_range, state, forcing,
                             dh, dhu, leapfrog, want_gm_diags=False)

    # 3. implicit barotropic solve (source/step_mod.F90:437)
    tout = barotropic.driver(cfg, grid, bc, state, forcing, bout.zx,
                             bout.zy, leapfrog, pcsi_eigs)

    # 4. corrector/adjustment pass (source/step_mod.F90:457)
    tracer_new, rho_new = baroclinic.correct_adjust(
        cfg, grid, bc, ts_range, state, bout, tout.psurf_new, bout.vdc,
        leapfrog)

    # 5. full velocity = baroclinic' + barotropic (source/step_mod.F90:572)
    u_new = torch.where(grid.kmask_u, bout.u_new + tout.ubtrop_new[None],
                        0.0)
    v_new = torch.where(grid.kmask_u, bout.v_new + tout.vbtrop_new[None],
                        0.0)

    # 6. pressure guess extrapolation (source/step_mod.F90:634-640)
    pguess = 3.0 * (tout.psurf_new - state.psurf_cur) + state.psurf_old

    new = State(
        tracer_old=state.tracer_cur, tracer_cur=tracer_new,
        u_old=state.u_cur, u_cur=u_new,
        v_old=state.v_cur, v_cur=v_new,
        rho_old=state.rho_cur, rho_cur=rho_new,
        ubtrop_old=state.ubtrop_cur, ubtrop_cur=tout.ubtrop_new,
        vbtrop_old=state.vbtrop_cur, vbtrop_cur=tout.vbtrop_new,
        psurf_old=state.psurf_cur, psurf_cur=tout.psurf_new,
        gradpx_old=state.gradpx_cur, gradpx_cur=tout.gradpx_new,
        gradpy_old=state.gradpy_cur, gradpy_cur=tout.gradpy_new,
        pguess=pguess, fw_old=forcing.fw, qice=state.qice,
        aqice=state.aqice, rf_s_prev=state.rf_s_prev,
        rf_s_prev_valid=state.rf_s_prev_valid)

    # 7. time filtering (source/step_mod.F90:663-832)
    if avg_ts:
        new = _avg_filter(cfg, grid, ts_range, state, new)

    return new, StepDiagnostics(solver_iters=tout.solver_iters,
                                solver_rr=tout.solver_rr)
