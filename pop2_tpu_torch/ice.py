"""Frazil ice formation (plain PyTorch).

Reference: ``source/ice.F90`` — ``ice_formation`` (:357-621) warms T (and
adjusts S) wherever the new temperature falls below freezing, turning the
deficit into an ice heat-flux accumulator (QICE/AQICE) for the coupler;
``tfreez`` (:725) is the linear_salt freezing temperature;
``ice_flx_to_coupler`` (:625) turns the accumulator into the heat flux the
coupler cap exports.
"""

from __future__ import annotations

import torch

from pop2_tpu_torch import constants as const
from pop2_tpu_torch.config import ModelConfig
from pop2_tpu_torch.grid import Grid

DFREEZE = -0.0544           # degC per psu (shr_frz linear_salt)
SALICE = const.SEA_ICE_SALINITY * const.PPT_TO_SALT
SALREF = const.OCN_REF_SALINITY * const.PPT_TO_SALT


def tfreez(salt_msu):
    """Freezing temperature (degC) of sea water (source/ice.F90:745-753,
    the linear_salt form of shr_frz_freezetemp)."""
    return DFREEZE * salt_msu * const.SALT_TO_PPT


def ice_formation(cfg: ModelConfig, grid: Grid, tnew, psurf_new, qice, aqice,
                  time_weight: float, kmxice: int = 1):
    """Frazil-ice adjustment of the new-time tracers (source/ice.F90:428-616),
    bottom-up over the levels kmxice..1, in the salt-flux form
    (lfw_as_salt_flx, the standalone default). Returns (tnew, qice, aqice);
    ``tnew`` is a new tensor."""
    dz = grid.vgrid.dz
    ref_val = SALREF - SALICE
    cpol = const.CP_OVER_LHFUSION
    tnew = tnew.clone()
    qice = torch.zeros_like(qice)

    # sub-surface layers kmxice..2 (bottom-up; empty for kmxice = 1)
    for k in range(kmxice, 1, -1):
        k0 = k - 1
        tfrz = tfreez(tnew[1, k0])
        potice = torch.where(grid.kmask_t[k0],
                             (tfrz - tnew[0, k0]) * dz[k0], 0.0)
        potice = torch.maximum(potice, qice)
        tnew[0, k0] += potice / dz[k0]
        tnew[1, k0] += ref_val * potice * cpol / dz[k0]
        qice = qice - potice

    # surface layer (source/ice.F90:535-569)
    tfrz = tfreez(tnew[1, 0])
    thick = dz[0]
    if cfg.sfc_layer == "varthick":
        thick = thick + psurf_new / const.GRAV + 1.0e-20
    potice = torch.where(grid.kmask_t[0], (tfrz - tnew[0, 0]) * thick, 0.0)
    potice = torch.maximum(potice, qice)
    tnew[0, 0] += potice / thick
    tnew[1, 0] += ref_val * potice * cpol / thick
    qice = qice - potice

    aqice = aqice + time_weight * qice

    # the melt potential offsets accumulated freezing (:590-614)
    tfrz = tfreez(tnew[1, 0])
    potice = torch.where(grid.kmask_t[0], (tfrz - tnew[0, 0]) * thick, 0.0)
    potice = torch.maximum(potice, aqice)
    tnew[0, 0] += potice / thick
    tnew[1, 0] += ref_val * potice * cpol / thick
    aqice = aqice - time_weight * potice
    return tnew, qice, aqice


def ice_flx_to_coupler(cfg: ModelConfig, grid: Grid, tcur, aqice,
                       tlast_ice: float):
    """Convert the accumulated ice potential to the coupler heat flux QFLUX
    (source/ice.F90:625-720 logic): QFLUX = -AQICE/tlast_ice, in degC cm/s
    (the coupler adapter divides by hflux_factor for W/m^2). Returns
    (qflux, aqice reset to zero)."""
    qflux = -aqice / max(tlast_ice, 1.0e-20)
    return qflux, torch.zeros_like(aqice)
