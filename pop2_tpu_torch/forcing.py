"""Surface forcing.

Reference: ``source/forcing.F90`` dispatch + per-field modules. This slice
carries the standalone analytic option of the reference's test configuration
(``input_templates/test_pop2_in``): analytic zonal wind stress
(source/forcing_ws.F90:266-292), zero heat/freshwater fluxes. The gas-exchange inputs of the CFC and SF6
packages (10-m wind speed squared, ice fraction, atmospheric mole fractions)
are optional fields a caller fills. Restoring, file-based and coupled
forcing are later slices (ROADMAP.md Queue 1 item 11).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from pop2_tpu_torch._tree import TensorTree
from pop2_tpu_torch.config import ModelConfig
from pop2_tpu_torch.grid import Grid


@dataclass(frozen=True)
class Forcing(TensorTree):
    smf: torch.Tensor       # (2, ny, nx) surface momentum flux at U points
    smft: torch.Tensor      # (2, ny, nx) same at T points
    stf: torch.Tensor       # (nt, ny, nx) surface tracer fluxes
    tfw: torch.Tensor       # (nt, ny, nx) tracer content of freshwater flux
    shf_qsw: torch.Tensor   # (ny, nx) penetrating shortwave
    fw: torch.Tensor        # (ny, nx) freshwater flux (cm/s)
    atm_press: torch.Tensor  # (ny, nx) atmospheric pressure
    # () the 18.6-year lunar-nodal-cycle factor on the tidal energy; None
    # is 1. Under ltidal_lunar_cycle the model refreshes it from its
    # calendar before every step (Model._lunar_forcing)
    tidal_lnc: Optional[torch.Tensor] = None
    # optional gas-exchange inputs (cfc_mod.F90 'model' formulation); without
    # u10_sqr the gas fluxes are zero
    u10_sqr: Optional[torch.Tensor] = None   # (ny, nx) 10-m wind^2 (cm^2/s^2)
    ifrac: Optional[torch.Tensor] = None     # (ny, nx) sea-ice fraction
    tracer_atm: Optional[torch.Tensor] = None  # (n_gas, 2) (nh, sh) per gas


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
