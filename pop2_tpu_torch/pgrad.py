"""Hydrostatic pressure gradient (plain PyTorch).

Reference: ``source/pressure_grad.F90:187-306`` — the per-level running sum
over k becomes a single ``cumsum`` over the whole column:

  PK{X,Y}_k = g * sum_{m=1..k} dzw_{m-1} * 0.5 * (Grad rho_m + Grad rho_{m-1})

with Grad rho_0 = Grad rho_1, and the optional 4-level pressure averaging
rho_avg = 0.25*(rho^{n+1} + 2 rho^n + rho^{n-1}) * bouss(k) on leapfrog steps.
"""

from __future__ import annotations

import torch

from pop2_tpu_torch import constants as const
from pop2_tpu_torch.config import ModelConfig
from pop2_tpu_torch.grid import Grid
from pop2_tpu_torch.stencil import BC, grad


def bouss_factor(cfg: ModelConfig, pressz) -> torch.Tensor:
    """Boussinesq pressure-compressibility correction 1/r(p)
    (source/pressure_grad.F90:168-175; Dukowicz 2000)."""
    if cfg.lbouss_correct:
        p = pressz
        return 1.0 / (1.02819 + 4.4004e-5 * p
                      - 2.93161e-4 * torch.exp(-0.05 * p))
    return torch.ones_like(pressz)


def rho_average(cfg: ModelConfig, grid: Grid, rho_old, rho_cur, rho_new,
                leapfrog: bool):
    """Density the pressure gradient acts on: the 1-2-1 time average on
    pressure-averaged leapfrog steps, scaled per level by the Boussinesq
    factor."""
    if cfg.lpressure_avg and leapfrog:
        rhoavg = 0.25 * (rho_new + 2.0 * rho_cur + rho_old)
    else:
        rhoavg = rho_cur
    bouss = bouss_factor(cfg, grid.vgrid.pressz)
    return rhoavg * bouss.reshape(cfg.km, 1, 1)


def gradp(cfg: ModelConfig, grid: Grid, bc: BC, rhoavg):
    """Pressure gradient (PKX, PKY) at all levels, (km, ny, nx) each, of the
    averaged, Boussinesq-scaled density from ``rho_average``."""
    km = cfg.km
    rkx, rky = grad(rhoavg, grid.DXUR, grid.DYUR, grid.kmask_u, bc)

    # rho_0 := rho_1 for the surface half-layer contribution
    rkx_m1 = torch.cat([rkx[:1], rkx[:-1]], dim=0)
    rky_m1 = torch.cat([rky[:1], rky[:-1]], dim=0)
    # factor = dzw(k-1)*grav*0.5 (source/pressure_grad.F90:287)
    fac = grid.vgrid.dzw[0:km].reshape(km, 1, 1) * const.GRAV * 0.5
    pkx = torch.cumsum(fac * (rkx + rkx_m1), dim=0)
    pky = torch.cumsum(fac * (rky + rky_m1), dim=0)
    return pkx, pky
