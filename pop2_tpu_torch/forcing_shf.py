"""Surface heat flux formulations: bulk-NCEP and Barnier restoring.

Reference: ``source/forcing_shf.F90`` — ``calc_shf_bulk_ncep`` (:1586-1792,
sensible/latent from Large & Pond iterative bulk formulas
``sen_lat_flux`` :1935-2175, longwave with Budyko latitude-dependent cloud
factor :1707-1720, weak/strong SST restoring blend) and
``calc_shf_barnier_restoring`` (:1436-1579, STF = (T* - T) dz1/tau).

The reference reads the data fields from monthly files; here they arrive as
a dict of tensors (compose with ``forcing_tools.MonthlyClimatology`` for
time interpolation). Everything is elementwise on the device; the latitude
cloud table ``ccint`` is interpolated on the host once a grid and kept on
the grid's device (``ccint`` caches it on the grid object).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from pop2_tpu_torch import constants as const
from pop2_tpu_torch.config import ModelConfig
from pop2_tpu_torch.grid import Grid

RHO_AIR = 1.2           # kg/m^3   (pop_constants:238)
CP_AIR = 1005.0         # J/kg/K
LATENT_HEAT_VAPOR_MKS = 2.501e6
STEFAN_BOLTZMANN = 567.0e-10   # W/m^2/K^4
EMISSIVITY = 1.0

#: Budyko cloud-factor table vs latitude (forcing_shf.F90:172-187)
_CC = np.array([0.88, 0.84, 0.80, 0.76, 0.72, 0.68, 0.63, 0.59, 0.52,
                0.50, 0.50, 0.50, 0.52, 0.59, 0.63, 0.68, 0.72, 0.76,
                0.80, 0.84, 0.88])
_CLAT = np.linspace(-90.0, 90.0, 21)


def ccint(grid: Grid) -> torch.Tensor:
    """Latitude-interpolated cloud coefficient at T points (:408-424),
    float64 on the grid's device: ``np.interp`` on the host the first time,
    kept on the grid object after that (so a step never copies it from the
    host)."""
    cached = grid.__dict__.get("_ccint")
    if cached is None:
        lat = grid.TLAT.detach().double().cpu().numpy() * const.RADIAN
        cached = torch.as_tensor(np.interp(lat, _CLAT, _CC),
                                 device=grid.TLAT.device)
        grid.__dict__["_ccint"] = cached
    return cached


def cdn(u):
    """Neutral 10-m drag coefficient (forcing_shf.F90 CDN function)."""
    return 0.0027 / u + 1.42e-4 + 7.64e-5 * u


def sen_lat_flux(us, sst_c, tair_k, qair, hu=10.0, ht=2.0, hq=2.0):
    """Sensible/latent heat fluxes into the ocean (W/m^2) from the Large &
    Pond iterative stability-corrected bulk formulas
    (sen_lat_flux, forcing_shf.F90:1935-2175). Inputs: wind speed (m/s),
    SST (degC), air temperature (K), specific humidity (kg/kg). Two fixed
    refinement passes; ``0.5 + 0.5 sign(x)`` gives 0.5 at x = 0, as the
    reference's."""
    umin, zolmin, vonk = 0.5, -100.0, 0.4
    lapse_rate = 0.01
    grav_mks = const.GRAV / 100.0
    f1 = 0.606
    aln = float(np.log(ht / 10.0))
    czol = hu * vonk * grav_mks
    tk0 = const.T0_KELVIN

    sh = torch.clamp(us, min=umin)
    t0 = tair_k * (1.0 + f1 * qair)
    qsat = 640380.0 / torch.exp(5107.4 / (sst_c + tk0))
    sshum0 = 0.98 * qsat / RHO_AIR
    delp = tair_k + lapse_rate * ht - sst_c - tk0
    delq = qair - sshum0

    stable = 0.5 + 0.5 * torch.sign(delp)
    rdn = torch.sqrt(cdn(sh))
    rhn = (1.0 - stable) * 0.0327 + stable * 0.0180
    ren = 0.0346
    ustar = rdn * sh
    tstar = rhn * delp
    qstar = ren * delq

    def stability(ustar, tstar, qstar):
        huol = czol * (tstar / t0 + qstar / (1.0 / f1 + qair)) / ustar ** 2
        huol = torch.clamp(huol, min=zolmin)
        stable = 0.5 + 0.5 * torch.sign(huol)
        htol = huol * ht / hu
        x = torch.sqrt(torch.clamp(torch.sqrt(torch.abs(1.0 - 16.0 * huol)),
                                   min=1.0))
        psimh = (-5.0 * huol * stable + (1.0 - stable)
                 * (torch.log((1.0 + x * (2.0 + x)) * (1.0 + x * x) / 8.0)
                    - 2.0 * torch.atan(x) + 1.571))
        xh = torch.clamp(torch.sqrt(torch.abs(1.0 - 16.0 * htol)), min=1.0)
        psixh = (-5.0 * htol * stable
                 + (1.0 - stable) * 2.0 * torch.log((1.0 + xh) / 2.0))
        return stable, psimh, psixh

    for _ in range(2):  # the reference's two refinement passes
        stable, psimh, psixh = stability(ustar, tstar, qstar)
        rd = rdn / (1.0 - rdn / vonk * psimh)
        uzn = torch.clamp(sh * rd / rdn, min=umin)
        rdn = torch.sqrt(cdn(uzn))
        rhn = (1.0 - stable) * 0.0327 + stable * 0.0180
        rd = rdn / (1.0 - rdn / vonk * psimh)
        rh = rhn / (1.0 + rhn / vonk * (aln - psixh))
        re = ren / (1.0 + ren / vonk * (aln - psixh))
        ustar = rd * sh
        qstar = re * delq
        tstar = rh * delp

    tau = RHO_AIR * ustar ** 2 * us / sh
    hs = CP_AIR * tau * tstar / ustar
    hl = LATENT_HEAT_VAPOR_MKS * tau * qstar / ustar
    return hs, hl


def bulk_ncep(cfg: ModelConfig, grid: Grid, sst_model,
              data: Dict[str, torch.Tensor],
              t_strong_restore_limit: float = -1.8,
              dt_restore_limit: float = 2.0,
              shf_weak_restore: float = 0.0,
              shf_strong_restore: float = 92.64):
    """Bulk-NCEP surface heat flux (calc_shf_bulk_ncep :1586-1792).

    data fields (SI): 'windspd' (m/s), 'tair' (K), 'qair' (kg/kg),
    'qsw' (W/m^2), 'cldfrac' (0-1), 'sst' (degC restoring climatology).
    Returns (stf_t, shf_qsw) in model flux units (degC cm/s).
    """
    sst = sst_model
    hs, hl = sen_lat_flux(data["windspd"], sst, data["tair"], data["qair"])

    frac_cloud = 1.0 - ccint(grid) * data["cldfrac"] ** 2
    rtea = torch.sqrt(1000.0 * data["qair"]
                      / (0.622 + 0.378 * data["qair"]) + 1.0e-20)
    qlw = (-EMISSIVITY * STEFAN_BOLTZMANN * data["tair"] ** 3
           * (data["tair"] * (0.39 - 0.05 * rtea) * frac_cloud
              + 4.0 * (sst + const.T0_KELVIN - data["tair"])))

    # ice-edge weighting (ocean_weights :1807-1840): weak restoring over
    # open ocean, strong restoring toward the data where it is near
    # freezing (proxy for ice cover)
    wgt = torch.clamp((data["sst"] - t_strong_restore_limit)
                      / dt_restore_limit, 0.0, 1.0)
    wrest = shf_weak_restore * wgt * (data["sst"] - sst)
    srest = shf_strong_restore * (1.0 - wgt) * (data["sst"] - sst)

    r = grid.RCALCT
    stf_t = const.HFLUX_FACTOR * r * (wgt * (hs + hl + qlw)
                                      + wrest + srest)
    shf_qsw = const.HFLUX_FACTOR * r * wgt * data["qsw"]
    return stf_t, shf_qsw


def barnier_restoring(cfg: ModelConfig, grid: Grid, sst_model, tstar, tau,
                      qsw=None):
    """Barnier restoring (calc_shf_barnier_restoring :1436-1579):
    STF = (T* - T) dz1 / tau where tau (seconds) > 0.
    Returns (stf_t, shf_qsw)."""
    dz1 = grid.vgrid.dz[0]
    stf_t = torch.where((tau > 0.0) & (grid.RCALCT > 0.0),
                        (tstar - sst_model) * dz1
                        / torch.where(tau > 0.0, tau, 1.0), 0.0)
    shf_qsw = (const.HFLUX_FACTOR * qsw * grid.RCALCT
               if qsw is not None else torch.zeros_like(stf_t))
    return stf_t, shf_qsw
