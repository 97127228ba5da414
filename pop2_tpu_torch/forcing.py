"""Surface forcing.

Reference: ``source/forcing.F90`` dispatch + per-field modules. The analytic
option of the reference's test configuration (``input_templates/test_pop2_in``:
analytic zonal wind stress, source/forcing_ws.F90:266-292, zero heat and
freshwater fluxes) is the model's own forcing. A standalone forced run
composes its ``Forcing`` around ``Model.advance`` from the data-driven pieces:
monthly wind stress from a file (``read_ws_file``, ``file_wind_stress``),
surface restoring (``restoring_forcing``), bulk-NCEP heat and freshwater
fluxes (``forcing_shf``, ``forcing_sfwf``), marginal-seas balancing
(``ms_balance``), monthly climatologies (``forcing_tools``), and the optional
fields below: the interior restoring targets, chlorophyll, river runoff, the
gas-exchange inputs and the per-component coupler fluxes. Coupled forcing is
a later slice (ROADMAP.md Queue 1 item 11g).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from pop2_tpu_torch._tree import TensorTree
from pop2_tpu_torch.config import ModelConfig
from pop2_tpu_torch.forcing_tools import MonthlyClimatology
from pop2_tpu_torch.grid import Grid, grid_bc
from pop2_tpu_torch.stencil import ugrid_to_tgrid


@dataclass(frozen=True)
class Forcing(TensorTree):
    smf: torch.Tensor       # (2, ny, nx) surface momentum flux at U points
    smft: torch.Tensor      # (2, ny, nx) same at T points
    stf: torch.Tensor       # (nt, ny, nx) surface tracer fluxes
    tfw: torch.Tensor       # (nt, ny, nx) tracer content of freshwater flux
    shf_qsw: torch.Tensor   # (ny, nx) penetrating shortwave
    fw: torch.Tensor        # (ny, nx) freshwater flux (cm/s)
    atm_press: torch.Tensor  # (ny, nx) atmospheric pressure
    # optional 3-D interior restoring targets (km, ny, nx)
    # (source/forcing_pt_interior.F90 / forcing_s_interior.F90)
    pt_interior_data: Optional[torch.Tensor] = None
    s_interior_data: Optional[torch.Tensor] = None
    # optional gas-exchange inputs (cfc_mod.F90 'model' formulation); without
    # u10_sqr the gas fluxes are zero
    u10_sqr: Optional[torch.Tensor] = None   # (ny, nx) 10-m wind^2 (cm^2/s^2)
    ifrac: Optional[torch.Tensor] = None     # (ny, nx) sea-ice fraction
    tracer_atm: Optional[torch.Tensor] = None  # (n_gas, 2) (nh, sh) per gas
    chl: Optional[torch.Tensor] = None  # (ny, nx) surface chlorophyll mg/m^3
    #                                     (sw_absorption 'chlorophyll'/'file')
    roff_f: Optional[torch.Tensor] = None  # (ny, nx) river runoff kg/m^2/s
    #                                        (estuary EBM exchange)
    # optional per-component coupler fluxes, in SI units, for the tavg
    # registry alone (PREC_F/EVAP_F/... fields, source/forcing_coupled.F90
    # accumulate_tavg_field calls)
    prec_f: Optional[torch.Tensor] = None    # rain+snow, kg/m^2/s
    snow_f: Optional[torch.Tensor] = None    # kg/m^2/s
    evap_f: Optional[torch.Tensor] = None    # kg/m^2/s
    melt_f: Optional[torch.Tensor] = None    # ice melt water, kg/m^2/s
    ioff_f: Optional[torch.Tensor] = None    # ice runoff, kg/m^2/s
    salt_f: Optional[torch.Tensor] = None    # salt flux, kg(salt)/m^2/s
    senh_f: Optional[torch.Tensor] = None    # sensible heat, W/m^2
    lwup_f: Optional[torch.Tensor] = None    # longwave up, W/m^2
    lwdn_f: Optional[torch.Tensor] = None    # longwave down, W/m^2
    melth_f: Optional[torch.Tensor] = None   # ice melt heat, W/m^2
    # () the 18.6-year lunar-nodal-cycle factor on the tidal energy; None
    # is 1. Under ltidal_lunar_cycle the model refreshes it from its
    # calendar before every step (Model._lunar_forcing)
    tidal_lnc: Optional[torch.Tensor] = None


def analytic_forcing(cfg: ModelConfig, grid: Grid, device=None) -> Forcing:
    """Constant-in-time analytic wind stress
    tau_x = -cos(3*lat) (source/forcing_ws.F90:275-277), everything else zero.
    """
    if device is None:
        device = grid.KMT.device
    grid = grid.to(device)
    dt = cfg.torch_dtype
    ny, nx, nt = cfg.ny, cfg.nx, cfg.nt
    z = torch.zeros((ny, nx), dtype=dt, device=device)
    smf = torch.stack([-torch.cos(3.0 * grid.ULAT) * grid.RCALCU, z])
    smft = torch.stack([-torch.cos(3.0 * grid.TLAT) * grid.RCALCT, z])
    zt = torch.zeros((nt, ny, nx), dtype=dt, device=device)
    return Forcing(smf=smf.to(dt), smft=smft.to(dt), stf=zt, tfw=zt,
                   shf_qsw=z, fw=z, atm_press=z)


def restoring_forcing(cfg: ModelConfig, grid: Grid, base: Forcing,
                      sst_data=None, sss_data=None,
                      state_sst=None, state_sss=None,
                      tau_days: float = 30.0) -> Forcing:
    """Surface restoring toward prescribed SST/SSS climatology
    (shf_formulation='restoring', source/forcing_shf.F90 and
    source/forcing_sfwf.F90): STF = dz1*(data - model)/tau."""
    dz1 = grid.vgrid.dz[0]
    tau = tau_days * 86400.0
    stf = base.stf.clone()
    if sst_data is not None and state_sst is not None:
        stf[0] += grid.RCALCT * dz1 * (sst_data - state_sst) / tau
    if sss_data is not None and state_sss is not None:
        stf[1] += grid.RCALCT * dz1 * (sss_data - state_sss) / tau
    return base.replace(stf=stf)


def read_ws_file(path: str, ny: int, nx: int, dtype=">f8"):
    """Read a POP-format binary wind-stress file: 12 monthly records of
    (TAUX, TAUY) pairs — 24 (ny, nx) records in all
    (forcing_ws.F90 monthly read :222-260). Returns (taux, tauy), each
    (12, ny, nx) host float64, dyn/cm^2."""
    raw = np.fromfile(path, dtype=dtype)
    need = 24 * ny * nx
    if raw.size < need:
        raise ValueError(f"wind-stress file holds {raw.size} values, "
                         f"need {need}")
    rec = raw[:need].reshape(12, 2, ny, nx).astype(np.float64)
    return rec[:, 0], rec[:, 1]


def file_wind_stress(cfg: ModelConfig, grid: Grid, base: Forcing,
                     taux_monthly, tauy_monthly, thour,
                     data_type: str = "monthly-equal",
                     interp: str = "linear") -> Forcing:
    """Monthly-climatology wind stress interpolated to model time
    (forcing_ws.F90 'monthly' data type + forcing_tools interpolation).

    taux/tauy_monthly: (12, ny, nx) at U points (dyn/cm^2), host arrays or
    tensors (kept on the device as ``MonthlyClimatology``s, which a caller
    that steps many times builds once and passes instead); ``thour`` the
    model hour (host float or 0-d tensor). Returns the forcing with SMF/SMFT
    replaced; the U-to-T average takes the south and west neighbours, so
    the tripole fold is not crossed."""
    device = base.smf.device
    cx, cy = (c if isinstance(c, MonthlyClimatology)
              else MonthlyClimatology.create(c, interp, data_type, device)
              for c in (taux_monthly, tauy_monthly))
    taux = cx.at(thour) * grid.RCALCU
    tauy = cy.at(thour) * grid.RCALCU
    bc = grid_bc(cfg)
    smft = torch.stack([ugrid_to_tgrid(taux, bc) * grid.RCALCT,
                        ugrid_to_tgrid(tauy, bc) * grid.RCALCT])
    dt = base.smf.dtype
    return base.replace(smf=torch.stack([taux, tauy]).to(dt),
                        smft=smft.to(dt))
