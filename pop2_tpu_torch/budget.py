"""Tracer budget diagnostics.

Reference: ``source/budget_diagnostics.F90`` — ``diag_for_tracer_budgets``
(volume-weighted tracer totals including the variable-thickness surface
volume, and the mean SSH/volume bookkeeping) and ``tracer_budgets`` (budget
closure over an averaging interval: dV*T/dt against the accumulated surface
flux, shortwave and ice terms). Each is a few whole-field reductions on the
state's device; the results stay tensors. On a block grid of a
decomposition (``parallel.mesh``) the reductions run over every block.
"""

from __future__ import annotations

import torch

from pop2_tpu_torch import constants as const
from pop2_tpu_torch.config import ModelConfig
from pop2_tpu_torch.forcing import Forcing
from pop2_tpu_torch.grid import Grid, thickness_t
from pop2_tpu_torch.parallel import mesh as pmesh
from pop2_tpu_torch.reductions import global_sum
from pop2_tpu_torch.state import State


def tracer_totals(cfg: ModelConfig, grid: Grid, state: State):
    """Volume integral of each tracer over the ocean (tracer * cm^3), (nt,),
    of the current time level. With a variable-thickness surface layer the
    top-cell volume includes the SSH contribution psurf/g
    (diag_for_tracer_budgets, budget_diagnostics.F90)."""
    dzvol = thickness_t(cfg, grid) * grid.TAREA[None]
    with pmesh.grid_scope(grid):
        tot = global_sum(torch.where(grid.kmask_t[None],
                                     state.tracer_cur * dzvol[None], 0.0),
                         axis=(1, 2, 3))
        if cfg.sfc_layer == "varthick":
            ssh_vol = ((state.psurf_cur / const.GRAV) * grid.TAREA
                       * grid.RCALCT)
            tot = tot + global_sum(state.tracer_cur[:, 0] * ssh_vol[None],
                                   axis=(1, 2))
    return tot


def ocean_volume(cfg: ModelConfig, grid: Grid, state: State):
    """Total ocean volume (cm^3) incl. the SSH contribution."""
    vol = grid.volume_t
    if cfg.sfc_layer == "varthick":
        with pmesh.grid_scope(grid):
            vol = vol + global_sum((state.psurf_cur / const.GRAV)
                                   * grid.TAREA * grid.RCALCT)
    return vol


def surface_flux_integral(cfg: ModelConfig, grid: Grid, forcing: Forcing):
    """Area integral of the prescribed surface tracer input per second
    (tracer * cm^3 / s), (nt,): STF plus, for temperature, penetrating
    shortwave, plus the freshwater tracer content TFW."""
    area = grid.TAREA * grid.RCALCT
    with pmesh.grid_scope(grid):
        tot = global_sum(forcing.stf * area[None], axis=(1, 2))
        tot[0] += global_sum(forcing.shf_qsw * area)
        if cfg.sfc_layer == "varthick":
            tot = tot + global_sum(forcing.tfw * area[None], axis=(1, 2))
    return tot


def budget_residual(cfg: ModelConfig, grid: Grid, before: State,
                    after: State, forcing: Forcing, nsteps: int):
    """Normalized closure error of each tracer budget over ``nsteps``
    full steps: ((total_after - total_before) - flux*dt) / volume
    (tracer_budgets, budget_diagnostics.F90): per tracer, the mean
    concentration drift the surface input does not explain."""
    dt = nsteps * cfg.time.dtt
    d_tot = tracer_totals(cfg, grid, after) - tracer_totals(cfg, grid,
                                                            before)
    influx = surface_flux_integral(cfg, grid, forcing) * dt
    return (d_tot - influx) / grid.volume_t
