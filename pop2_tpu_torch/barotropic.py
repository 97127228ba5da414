"""Barotropic (implicit free-surface) driver.

Reference: ``source/barotropic.F90:267-735`` — builds auxiliary velocities and
the elliptic RHS, solves for the new surface pressure, removes the
checkerboard null space, and reconstructs barotropic velocities and pressure
gradients. The non-leapfrog path is the Euler-forward first step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pop2_tpu_torch import solvers
from pop2_tpu_torch import constants as const
from pop2_tpu_torch.config import ModelConfig
from pop2_tpu_torch.forcing import Forcing
from pop2_tpu_torch.grid import Grid
from pop2_tpu_torch.reductions import global_sum
from pop2_tpu_torch.state import State
from pop2_tpu_torch.stencil import BC, div, grad


class BarotropicOut(NamedTuple):
    psurf_new: torch.Tensor
    gradpx_new: torch.Tensor
    gradpy_new: torch.Tensor
    ubtrop_new: torch.Tensor
    vbtrop_new: torch.Tensor
    solver_iters: int
    solver_rr: torch.Tensor


def diagonal_correction(cfg: ModelConfig, grid: Grid, leapfrog: bool):
    """Time-dependent diagonal term of the implicit free-surface operator
    (source/barotropic.F90:532-552)."""
    if cfg.sfc_layer == "rigid":
        return torch.zeros_like(grid.TAREA)
    dtp = cfg.time.dtp
    beta = cfg.time.alpha if leapfrog else cfg.time.theta
    c2dtp = (2.0 if leapfrog else 1.0) * dtp
    return torch.where(grid.RCALCT > 0,
                       grid.TAREA / (beta * c2dtp * dtp * const.GRAV), 0.0)


class BarotropicRHS(NamedTuple):
    """The barotropic step up to its solve (``rhs``): the auxiliary
    velocities, the reference gradients, the elliptic right-hand side and
    operator, and ``beta * c2dtp``."""
    uh: torch.Tensor
    vh: torch.Tensor
    gpx_ref: torch.Tensor
    gpy_ref: torch.Tensor
    rhs: torch.Tensor
    op: solvers.BtropOperator
    beta_c2dtp: float


def rhs(cfg: ModelConfig, grid: Grid, bc: BC, state: State,
        forcing: Forcing, zx, zy, leapfrog: bool,
        ovf_qsurf=None) -> BarotropicRHS:
    """The momentum right-hand side, the auxiliary velocities, the elliptic
    right-hand side and the operator (source/barotropic.F90:420-552);
    ``ovf_qsurf``: the overflows' equivalent surface volume flux
    (``overflows.qsurf``) or None."""
    dtp = cfg.time.dtp
    beta = cfg.time.alpha if leapfrog else cfg.time.theta
    gamma = cfg.time.gamma
    c2dtp = (2.0 if leapfrog else 1.0) * dtp
    varthick = cfg.sfc_layer == "varthick"
    mask_t = grid.kmask_t[0]

    # ---- r.h.s. of barotropic momentum (source/barotropic.F90:420-445) ----
    if leapfrog:
        work3 = c2dtp * (zx - gamma * state.gradpx_cur
                         - (1.0 - gamma) * state.gradpx_old)
        work4 = c2dtp * (zy - gamma * state.gradpy_cur
                         - (1.0 - gamma) * state.gradpy_old)
    else:  # Euler-forward first step
        work3 = c2dtp * (zx - state.gradpx_cur)
        work4 = c2dtp * (zy - state.gradpy_cur)

    # ---- auxiliary velocities (source/barotropic.F90:468-482) -------------
    if cfg.time.impcor:
        w1 = c2dtp * beta * grid.FCOR
        w2 = 1.0 / (1.0 + w1 ** 2)
        uh = w2 * (work3 + w1 * work4) + state.ubtrop_old
        vh = w2 * (work4 - w1 * work3) + state.vbtrop_old
    else:
        uh = work3 + state.ubtrop_old
        vh = work4 + state.vbtrop_old

    # ---- elliptic RHS (source/barotropic.F90:490-552) ---------------------
    gpx_ref = state.gradpx_old if leapfrog else state.gradpx_cur
    gpy_ref = state.gradpy_old if leapfrog else state.gradpy_cur
    w3 = grid.HU * (uh + beta * c2dtp * gpx_ref)
    w4 = grid.HU * (vh + beta * c2dtp * gpy_ref)
    b = div(w3, w4, grid.DXU, grid.DYU, mask_t, bc) / (beta * c2dtp)

    diag_corr = diagonal_correction(cfg, grid, leapfrog)
    fw_eff = forcing.fw
    if ovf_qsurf is not None:
        # prescribed overflow transports enter the column-integrated
        # continuity like a (globally zero-sum) surface volume flux
        # (ovf_rhs_brtrpc_continuity, source/overflows.F90:5068-5120)
        fw_eff = fw_eff + ovf_qsurf
    if varthick:
        b = (b - diag_corr * state.psurf_cur
             - fw_eff * grid.TAREA / (beta * c2dtp))
    elif cfg.sfc_layer == "oldfree":
        b = b - diag_corr * state.psurf_cur
    return BarotropicRHS(uh=uh, vh=vh, gpx_ref=gpx_ref, gpy_ref=gpy_ref,
                         rhs=b, op=solvers.make_operator(grid, diag_corr),
                         beta_c2dtp=beta * c2dtp)


def finish(cfg: ModelConfig, grid: Grid, bc: BC, r: BarotropicRHS,
           psurf_new, solver_iters=None, solver_rr=None) -> BarotropicOut:
    """From the solve's new surface pressure: the null-space removal, the
    new gradients and barotropic velocities
    (source/barotropic.F90:606-650)."""
    # ---- checkerboard null-space removal (source/barotropic.F90:606-634) --
    if cfg.sfc_layer == "varthick":
        xcheck = global_sum(psurf_new * grid.checker, b4b=cfg.b4b)
        psurf_new = (psurf_new + grid.constnt * grid.rcheck * xcheck
                     - grid.checker * grid.rconst * xcheck)

    # ---- new gradients and barotropic velocities --------------------------
    gradpx_new, gradpy_new = grad(psurf_new, grid.DXUR, grid.DYUR,
                                  grid.kmask_u[0], bc)
    ubtrop_new = r.uh - r.beta_c2dtp * (gradpx_new - r.gpx_ref)
    vbtrop_new = r.vh - r.beta_c2dtp * (gradpy_new - r.gpy_ref)

    return BarotropicOut(psurf_new=psurf_new, gradpx_new=gradpx_new,
                         gradpy_new=gradpy_new, ubtrop_new=ubtrop_new,
                         vbtrop_new=vbtrop_new, solver_iters=solver_iters,
                         solver_rr=solver_rr)


def driver(cfg: ModelConfig, grid: Grid, bc: BC, state: State,
           forcing: Forcing, zx, zy, leapfrog: bool,
           pcsi_eigs=None, precond=None, ovf_qsurf=None) -> BarotropicOut:
    """The barotropic step: ``rhs``, the solve (source/barotropic.F90:
    564-598), ``finish``. ``pcsi_eigs``: PCSI's bounds, a pair or
    ``solvers.PCSIBounds``."""
    r = rhs(cfg, grid, bc, state, forcing, zx, zy, leapfrog, ovf_qsurf)
    psurf_new, iters, rr = solvers.solve(
        cfg, r.op, bc, state.pguess, r.rhs, eigs=pcsi_eigs, precond=precond,
        tol=solvers.tolerance(cfg, grid))
    return finish(cfg, grid, bc, r, psurf_new, iters, rr)
