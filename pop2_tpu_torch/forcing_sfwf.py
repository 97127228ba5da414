"""Standalone surface-freshwater forcing (``source/forcing_sfwf.F90``).

Formulations:
- ``restoring``: salt flux from SSS restoring,
  STF_S = (SSS* - S) * rtau * dz1 (set_sfwf, :1018-1060);
- ``bulk-NCEP``: evaporation from the latent heat flux + precipitation
  scaled by the water-balance ``precip_fact`` + weak/strong SSS
  restoring with the weak term's global area mean removed
  (calc_sfwf_bulk_ncep, :1159-1532).

The annual precipitation-balance adjustment (``ladjust_precip``,
precip_adjustment :1818-1928) is a host-side accumulator (``PrecipBalance``,
host NumPy): it tracks the annual-mean precipitation and the year-over-year
change in volume-averaged salinity and mean SSH, and nudges ``precip_fact``
so the net surface freshwater budget closes.

The two global sums of the bulk formulation go through
``reductions.global_sum`` and stay on the device. On a block grid of a
decomposition (``parallel.mesh``) they, and the accumulator's host sums,
run over every block.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from pop2_tpu_torch import constants as const
from pop2_tpu_torch.config import ModelConfig
from pop2_tpu_torch.grid import Grid
from pop2_tpu_torch.parallel import mesh as pmesh
from pop2_tpu_torch.reductions import global_sum, slab_total


def restore_rtau(cfg: ModelConfig) -> float:
    """1/tau in 1/s from the restoring time scale in days
    (init_sfwf, source/forcing_sfwf.F90:454)."""
    return 1.0 / (86400.0 * cfg.sfwf_restore_tau)


def sfwf_restoring(cfg: ModelConfig, grid: Grid, sss_data, salt_surf):
    """Salt flux (msu*cm/s) from SSS restoring (set_sfwf 'restoring',
    source/forcing_sfwf.F90:1018-1040): (SSS* - S) * rtau * dz1."""
    dz1 = grid.vgrid.dz[0]
    return (grid.RCALCT * (sss_data - salt_surf)
            * restore_rtau(cfg) * dz1)


class SfwfOut(NamedTuple):
    stf_salt: torch.Tensor   # salt flux (msu*cm/s)
    fw: torch.Tensor         # freshwater flux (cm/s), varthick only
    tfw_temp: torch.Tensor   # temperature content of fw flux
    precip_total: torch.Tensor  # area-integrated precip (kg/s * cm^2/m^2)


def sfwf_bulk_ncep(cfg: ModelConfig, grid: Grid, qlat, precip_data,
                   sss_data, salt_surf, sst_surf, ocn_wgt,
                   mask_sr: Optional[torch.Tensor] = None,
                   precip_fact: float = 1.0):
    """Bulk-NCEP surface freshwater flux
    (calc_sfwf_bulk_ncep, source/forcing_sfwf.F90:1159-1532).

    qlat: latent heat flux (W/m^2, negative = ocean loses heat);
    precip_data: precipitation (kg/m^2/s); ocn_wgt: (1 - ice fraction) *
    RCALCT (forcing_coupled.F90:895); mask_sr: 1 outside marginal seas.
    """
    if mask_sr is None:
        mask_sr = torch.ones_like(grid.RCALCT)
    ocean = grid.KMT > 0

    # evaporation from the latent heat flux (kg/m^2/s) (:1262-1263)
    evap = qlat / const.LATENT_HEAT_VAPOR_MKS
    # precipitation with the balance factor (:1267-1268)
    precip = precip_data * precip_fact

    dsss = sss_data - salt_surf
    # weak (open-water) restoring, global mean removed (:1274-1287,
    # :1313-1332)
    wrest = -cfg.sfwf_weak_restore * ocn_wgt * mask_sr * dsss
    with pmesh.grid_scope(grid):
        num = global_sum(grid.TAREA * wrest, b4b=cfg.b4b)
        den = global_sum(grid.TAREA * ocn_wgt * mask_sr, b4b=cfg.b4b)
    weak_mean = num / torch.where(den != 0.0, den, 1.0)
    wrest = wrest - ocn_wgt * mask_sr * weak_mean

    # strong (under-ice / marginal-seas) restoring (:1291-1305)
    srest = torch.where(ocean,
                        -cfg.sfwf_strong_restore * (1.0 - ocn_wgt) * dsss,
                        0.0)
    srest = torch.where(ocean & (mask_sr == 0.0),
                        -cfg.sfwf_strong_restore_ms * dsss, srest)

    zero = torch.zeros_like(evap)
    if cfg.sfc_layer == "varthick" and not cfg.lfw_as_salt_flx:
        # real freshwater flux: restoring as salt flux, P-E as volume
        # (:1354-1368)
        stf_salt = (wrest + srest) * const.SALINITY_FACTOR
        fw = (ocn_wgt * mask_sr * (evap + precip)
              * const.FWMASS_TO_FWFLUX)
        tfw_temp = fw * sst_surf
    else:
        # everything as virtual salt flux (:1374-1380)
        stf_salt = (ocn_wgt * mask_sr * (evap + precip) + wrest + srest) \
            * const.SALINITY_FACTOR
        fw = zero
        tfw_temp = zero

    # annual-mean precip accumulation term (:1392-1396)
    with pmesh.grid_scope(grid):
        precip_total = global_sum(
            torch.where(mask_sr > 0.0, precip * grid.TAREA * ocn_wgt, 0.0),
            b4b=cfg.b4b)
    return SfwfOut(stf_salt=stf_salt, fw=fw, tfw_temp=tfw_temp,
                   precip_total=precip_total)


def make_precip_fact(cfg: ModelConfig) -> float:
    """Initial precipitation factor: the constant unless the annual
    balancing is on (init_sfwf, source/forcing_sfwf.F90:316-318)."""
    return 1.0 if cfg.ladjust_precip else cfg.precip_fact_const


def set_sfwf(cfg: ModelConfig, grid: Grid, sss_data, salt_surf,
             sst_surf=None, qlat=None, precip_data=None, ocn_wgt=None,
             mask_sr=None, precip_fact: Optional[float] = None):
    """Formulation dispatch (set_sfwf, source/forcing_sfwf.F90:959-1152).
    Returns SfwfOut; the 'restoring' branch fills only stf_salt."""
    if precip_fact is None:
        precip_fact = make_precip_fact(cfg)
    if cfg.sfwf_formulation == "restoring":
        stf = sfwf_restoring(cfg, grid, sss_data, salt_surf)
        zero = torch.zeros_like(stf)
        return SfwfOut(stf_salt=stf, fw=zero, tfw_temp=zero,
                       precip_total=torch.zeros((), dtype=stf.dtype,
                                                device=stf.device))
    if cfg.sfwf_formulation == "bulk-NCEP":
        return sfwf_bulk_ncep(cfg, grid, qlat, precip_data, sss_data,
                              salt_surf, sst_surf, ocn_wgt,
                              mask_sr=mask_sr, precip_fact=precip_fact)
    raise NotImplementedError(
        f"sfwf_formulation {cfg.sfwf_formulation!r}")


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _over_slabs(grid: Grid, a) -> np.ndarray:
    """The float64 partial sums ``a`` summed over the blocks of ``grid``'s
    decomposition (``a`` itself on the whole domain)."""
    with pmesh.grid_scope(grid):
        t = slab_total(torch.as_tensor(np.asarray(a, dtype=np.float64),
                                       device=grid.TAREA.device))
    return t.cpu().numpy()


class PrecipBalance:
    """Host-side ``ladjust_precip`` accumulator
    (precip_adjustment, source/forcing_sfwf.F90:1818-1928).

    Per step: ``accumulate(precip_total, dt)``. At the end of each year:
    ``end_of_year(sal_mean_per_level, ssh_mean_change)`` updates
    ``precip_fact`` from the volume-averaged salinity tendency (converted
    to an equivalent freshwater flux with ocn_ref_salinity) plus the mean
    SSH mass change, divided by the annual-mean precipitation. Everything
    here is host NumPy: ``accumulate`` reads its argument from the device
    once a step."""

    def __init__(self, cfg: ModelConfig, grid: Grid,
                 precip_fact: float = 1.0):
        self.cfg = cfg
        self.precip_fact = float(precip_fact)
        kmt = _host(grid.KMT)
        mask = kmt > 0
        area = _host(grid.TAREA).astype(np.float64)
        dz = _host(grid.vgrid.dz).astype(np.float64)
        km = dz.shape[0]
        k3 = np.arange(1, km + 1)[:, None, None]
        mask3 = k3 <= kmt[None]
        # [area (cm^2), the volume of each level (cm^3)], over every block
        sums = _over_slabs(grid, np.concatenate([
            [(area * mask).sum()],
            (area[None] * mask3 * dz[:, None, None]).sum(axis=(1, 2))]))
        self.area_t = float(sums[0])
        self.volume_t_k = sums[1:]
        self.sum_precip = 0.0
        self.sal_initial = None       # (km,) volume-avg salinity, msu
        self.ssh_initial = 0.0

    def accumulate(self, precip_total, dt: float):
        """Accumulate dt * area-mean precip (kg/m^2/s); precip_total is
        SfwfOut.precip_total (:1406-1410)."""
        self.sum_precip += (dt * 1.0e-4 * float(precip_total)
                            / self.area_t)

    def salinity_means(self, grid: Grid, salt) -> np.ndarray:
        """Volume-averaged salinity per level (msu) (:1432-1500)."""
        kmt = _host(grid.KMT)
        area = _host(grid.TAREA).astype(np.float64)
        dz = _host(grid.vgrid.dz).astype(np.float64)
        s = _host(salt)
        km = dz.shape[0]
        k3 = np.arange(1, km + 1)[:, None, None]
        m3 = k3 <= kmt[None]
        num = _over_slabs(grid, (s * area[None] * m3
                                 * dz[:, None, None]).sum(axis=(1, 2)))
        vol = np.where(self.volume_t_k > 0, self.volume_t_k, 1.0)
        return num / vol

    def end_of_year(self, sal_final: np.ndarray, ssh_final: float,
                    seconds_in_year: float = 365.0 * 86400.0) -> float:
        """Update precip_fact (:1818-1928); returns the new factor.
        sal_final: per-level volume-mean salinity (msu); ssh_final:
        annual mean SSH mass change (kg/m^2/s)."""
        ann_avg_precip = self.sum_precip / seconds_in_year
        self.sum_precip = 0.0
        if self.sal_initial is None:
            self.sal_initial = sal_final.copy()
            self.ssh_initial = ssh_final
            return self.precip_fact

        dsal = (sal_final - self.sal_initial) / seconds_in_year  # msu/s
        vol = self.volume_t_k
        sal_tendency = float((vol * dsal).sum() / vol.sum())
        # msu/s -> -(kg/m^2/s): vol*1e-6 (cm^3->m^3) * 1e6 (msu->psu *
        # water density), area*1e-4 (cm^2->m^2) (:1884-1888)
        sal_tendency = (-sal_tendency * vol.sum() * 1.0e4
                        / self.area_t / const.OCN_REF_SALINITY)
        fw_tendency = ssh_final - self.ssh_initial

        precip_tav = ann_avg_precip / self.precip_fact
        if precip_tav != 0.0:
            self.precip_fact -= (sal_tendency + fw_tendency) / precip_tav
        self.sal_initial = sal_final.copy()
        self.ssh_initial = ssh_final
        return self.precip_fact
