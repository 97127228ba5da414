"""Coupler adapter: import/export of coupling fields.

The port's copy of the JAX package's ``coupled.py``. Reference:
``drivers/mct/ocn_import_export.F90`` (SI <-> CGS conversions and field
packing; import :180-260, export :535-760) and
``source/forcing_coupled.F90`` (flux combination into STF/FW :720-850). A
pure-function API that converts a dict of SI coupler fields (tensors on the
model's device) into the model's ``Forcing``, and the model state into the
export dict, usable by any driver (``ocn_component.OcnComponent`` or a
script of its own). As in the JAX package the wind stress is not rotated by
ANGLE.
"""

from __future__ import annotations

from typing import Dict

import torch

from pop2_tpu_torch import constants as const
from pop2_tpu_torch.config import ModelConfig
from pop2_tpu_torch.forcing import Forcing
from pop2_tpu_torch.grid import Grid, grid_bc
from pop2_tpu_torch.parallel import mesh as pmesh
from pop2_tpu_torch.state import State
from pop2_tpu_torch.stencil import tgrid_to_ugrid, ugrid_to_tgrid

LATENT_HEAT_VAPOR_MKS = 2.501e6   # J/kg
LATENT_HEAT_FUSION_MKS = 3.337e5  # J/kg

#: import fields (x2o), SI units, on the T grid, shape (ny, nx)
IMPORT_FIELDS = (
    "taux", "tauy",           # wind stress (N/m^2, true east/north)
    "swnet",                  # net shortwave (W/m^2)
    "sen", "lwup", "lwdn", "melth",   # heat fluxes (W/m^2)
    "snow", "rain", "evap", "melt", "rofl", "rofi",  # water (kg/m^2/s)
    "salt",                   # salt flux (kg/m^2/s)
    "ifrac", "pslv",          # ice fraction, sea-level pressure (Pa)
    "duu10n",                 # 10-m wind speed squared (m^2/s^2)
)


def ocn_import(cfg: ModelConfig, grid: Grid, x2o: Dict[str, torch.Tensor],
               lfw_as_salt_flx: bool = True) -> Forcing:
    """Convert SI coupler fields into model forcing
    (ocn_import :180-260 + set_coupled_forcing :720-850). A field absent
    from ``x2o`` is zero; ``u10_sqr`` and ``ifrac`` are set only where
    ``duu10n`` and ``ifrac`` are given."""
    bc = grid_bc(cfg)
    r = grid.RCALCT

    def get(name):
        v = x2o.get(name)
        return torch.zeros_like(r) if v is None else v.to(r.dtype)

    # wind stress: N/m^2 -> dyn/cm^2 == momentum flux (cm/s)^2 via
    # momentum_factor; rotation is identity for ANGLE == 0 grids
    taux = get("taux") * const.MOMENTUM_FACTOR * r
    tauy = get("tauy") * const.MOMENTUM_FACTOR * r
    smft = torch.stack([taux, tauy])
    with pmesh.grid_scope(grid):  # on a block grid, the neighbours' halo
        smf = torch.stack([
            torch.where(grid.kmask_u[0],
                        tgrid_to_ugrid(taux, grid.AU0, grid.AUN, grid.AUE,
                                       grid.AUNE, bc), 0.0),
            torch.where(grid.kmask_u[0],
                        tgrid_to_ugrid(tauy, grid.AU0, grid.AUN, grid.AUE,
                                       grid.AUNE, bc), 0.0)])

    shf_qsw = get("swnet") * r * const.HFLUX_FACTOR

    # non-solar heat flux (forcing_coupled.F90:723-727)
    stf_t = (get("evap") * LATENT_HEAT_VAPOR_MKS
             + get("sen") + get("lwup") + get("lwdn") + get("melth")
             - (get("snow") + get("rofi")) * LATENT_HEAT_FUSION_MKS
             ) * r * const.HFLUX_FACTOR

    prec = get("rain") + get("snow")
    if lfw_as_salt_flx:
        # virtual salt flux (forcing_coupled.F90:813-817)
        stf_s = r * ((prec + get("evap") + get("melt") + get("rofl")
                      + get("rofi")) * const.SALINITY_FACTOR
                     + get("salt") * const.SFLUX_FACTOR)
        fw = torch.zeros_like(r)
    else:
        stf_s = r * get("salt") * const.SFLUX_FACTOR
        fw = r * const.FWMASS_TO_FWFLUX * (prec + get("evap") + get("melt")
                                           + get("rofl") + get("rofi"))

    stf = torch.zeros((cfg.nt,) + tuple(r.shape), dtype=cfg.torch_dtype,
                      device=r.device)
    stf[0] = stf_t
    stf[1] = stf_s

    atm_press = 10.0 * get("pslv") * r  # Pa -> dyn/cm^2

    return Forcing(smf=smf, smft=smft, stf=stf,
                   tfw=torch.zeros_like(stf), shf_qsw=shf_qsw, fw=fw,
                   atm_press=atm_press,
                   u10_sqr=(get("duu10n") * const.CMPERM ** 2 * r
                            if "duu10n" in x2o else None),
                   ifrac=(get("ifrac") * r if "ifrac" in x2o else None),
                   # per-component fluxes retained (SI) for the tavg
                   # registry (forcing_coupled.F90 tavg accumulations)
                   roff_f=get("rofl") * r,
                   prec_f=prec * r, snow_f=get("snow") * r,
                   evap_f=get("evap") * r, melt_f=get("melt") * r,
                   ioff_f=get("rofi") * r, salt_f=get("salt") * r,
                   senh_f=get("sen") * r, lwup_f=get("lwup") * r,
                   lwdn_f=get("lwdn") * r, melth_f=get("melth") * r)


def ocn_export(cfg: ModelConfig, grid: Grid, state: State,
               qflux=None) -> Dict[str, torch.Tensor]:
    """Pack export state o2x in SI units on the T grid
    (ocn_export :535-760): SST (K), SSS (psu), surface currents (m/s),
    surface-slope components, and the ice-formation heat flux."""
    bc = grid_bc(cfg)
    with pmesh.grid_scope(grid):  # on a block grid, the neighbours' halo
        u_t = ugrid_to_tgrid(state.u_cur[0], bc)
        v_t = ugrid_to_tgrid(state.v_cur[0], bc)
        dhdx = ugrid_to_tgrid(state.gradpx_cur, bc) / const.GRAV
        dhdy = ugrid_to_tgrid(state.gradpy_cur, bc) / const.GRAV
    out = {
        "So_t": state.tracer_cur[0, 0] + const.T0_KELVIN,
        "So_s": state.tracer_cur[1, 0] * const.SALT_TO_PPT,
        "So_u": u_t * const.MPERCM,
        "So_v": v_t * const.MPERCM,
        "So_dhdx": dhdx,
        "So_dhdy": dhdy,
        "So_ssh": state.psurf_cur / const.GRAV * const.MPERCM,
    }
    if qflux is not None:
        out["Fioo_q"] = qflux / const.HFLUX_FACTOR  # degC*cm/s -> W/m^2
    return out
