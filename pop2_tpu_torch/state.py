"""Model prognostic state and initialization.

Reference: ``source/prognostic.F90`` — the 3-time-level rotating-index arrays
become a frozen two-level (old, cur) dataclass of tensors carried through the
functional step; the ``newtime`` slot exists only as intermediate values
inside ``step`` (the index rotation at source/step_mod.F90:827-831 becomes
reassembly of the dataclass).

Initialization 'internal' reproduces the reference's horizontally-uniform 1992
Levitus T/S profile (source/initial.F90:962-1428).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from pop2_tpu_torch import constants as const
from pop2_tpu_torch import eos
from pop2_tpu_torch._tree import TensorTree
from pop2_tpu_torch.config import ModelConfig
from pop2_tpu_torch.grid import Grid


@dataclass(frozen=True)
class State(TensorTree):
    """Two-time-level prognostic state (shapes: tracer (nt,km,ny,nx),
    velocity/rho (km,ny,nx), 2-D fields (ny,nx))."""
    tracer_old: torch.Tensor
    tracer_cur: torch.Tensor
    u_old: torch.Tensor
    u_cur: torch.Tensor
    v_old: torch.Tensor
    v_cur: torch.Tensor
    rho_old: torch.Tensor
    rho_cur: torch.Tensor
    ubtrop_old: torch.Tensor
    ubtrop_cur: torch.Tensor
    vbtrop_old: torch.Tensor
    vbtrop_cur: torch.Tensor
    psurf_old: torch.Tensor
    psurf_cur: torch.Tensor
    gradpx_old: torch.Tensor
    gradpx_cur: torch.Tensor
    gradpy_old: torch.Tensor
    gradpy_cur: torch.Tensor
    pguess: torch.Tensor
    fw_old: torch.Tensor
    qice: torch.Tensor
    aqice: torch.Tensor
    # Robert-filter conservation memory
    rf_s_prev: torch.Tensor        # (nt,)
    rf_s_prev_valid: torch.Tensor  # ()


# 1992 Levitus global-mean profiles (source/initial.F90:963-1003)
DEPTH_LEVITUS = np.array([
    0., 10., 20., 30., 50., 75., 100., 125., 150., 200., 250., 300., 400.,
    500., 600., 700., 800., 900., 1000., 1100., 1200., 1300., 1400., 1500.,
    1750., 2000., 2500., 3000., 3500., 4000., 4500., 5000., 5500.])
TMEAN_LEVITUS = np.array([
    18.27, 18.22, 18.09, 17.87, 17.17, 16.11, 15.07, 14.12, 13.29, 11.87,
    10.78, 9.94, 8.53, 7.35, 6.38, 5.65, 5.06, 4.57, 4.13, 3.80, 3.51, 3.26,
    3.05, 2.86, 2.47, 2.19, 1.78, 1.49, 1.26, 1.05, 0.91, 0.87, 1.00])
SMEAN_LEVITUS = np.array([
    34.57, 34.67, 34.73, 34.79, 34.89, 34.97, 35.01, 35.03, 35.03, 34.98,
    34.92, 34.86, 34.76, 34.68, 34.63, 34.60, 34.59, 34.60, 34.61, 34.63,
    34.65, 34.66, 34.68, 34.70, 34.72, 34.74, 34.75, 34.74, 34.74, 34.73,
    34.73, 34.72, 34.72])


def levitus_profile(zt_cm: np.ndarray):
    """Piecewise-linear interpolation of the Levitus mean profile to layer
    midpoints (source/initial.F90:1397-1416)."""
    z_m = np.asarray(zt_cm) * const.MPERCM
    t = np.interp(z_m, DEPTH_LEVITUS, TMEAN_LEVITUS)
    s = np.interp(z_m, DEPTH_LEVITUS, SMEAN_LEVITUS) * const.PPT_TO_SALT
    return t, s


def initial_state(cfg: ModelConfig, grid: Grid, device=None,
                  passive=None) -> State:
    """Rest state with the internal Levitus T/S profile, on ``device``
    (default: where the grid lives); passive-tracer packages
    (``passive_tracers.PassiveTracers``) supply their own initial fields
    for slots 2.."""
    if device is None:
        device = grid.KMT.device
    dt = cfg.torch_dtype
    nt, km, ny, nx = cfg.nt, cfg.km, cfg.ny, cfg.nx
    tinit, sinit = levitus_profile(grid.vgrid.zt.double().cpu().numpy())
    tracer = np.zeros((nt, km, ny, nx))
    kmask = grid.kmask_t.cpu().numpy()
    tracer[0] = tinit[:, None, None] * kmask
    tracer[1] = sinit[:, None, None] * kmask
    if passive is not None and passive.packages:
        tracer[2:] = passive.init_values(cfg, grid) * kmask[None]
    tracer_t = torch.as_tensor(tracer).to(device=device, dtype=dt)

    grid = grid.to(device)
    rho = eos.state(cfg, grid.vgrid.pressz, tracer_t[0], tracer_t[1],
                    fit=grid.vgrid.poly)
    rho = torch.where(grid.kmask_t, rho, torch.zeros_like(rho))

    z2 = torch.zeros((ny, nx), dtype=dt, device=device)
    z3 = torch.zeros((km, ny, nx), dtype=dt, device=device)
    return State(
        tracer_old=tracer_t, tracer_cur=tracer_t,
        u_old=z3, u_cur=z3, v_old=z3, v_cur=z3,
        rho_old=rho, rho_cur=rho,
        ubtrop_old=z2, ubtrop_cur=z2, vbtrop_old=z2, vbtrop_cur=z2,
        psurf_old=z2, psurf_cur=z2,
        gradpx_old=z2, gradpx_cur=z2, gradpy_old=z2, gradpy_cur=z2,
        pguess=z2, fw_old=z2, qice=z2, aqice=z2,
        rf_s_prev=torch.zeros((nt,), dtype=dt, device=device),
        rf_s_prev_valid=torch.zeros((), dtype=dt, device=device))
