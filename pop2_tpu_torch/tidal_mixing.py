"""Tidally driven internal-wave mixing: the Jayne / St Laurent, Schmittner
and Polzin formulations, the Southern-Ocean floor and the lunar cycle.

Reference: ``source/tidal_mixing.F90``. The tidal energy flux E(x, y) at the
bottom drives a diffusivity kappa = Gamma q E F(z) / (rho N^2) with the
St Laurent et al. (2002) exponential vertical redistribution F(z)
(init_tidal_mixing2 :1280-1310, tidal_form_coef_jayne :2512-2548). KPP's
interior mixing adds it to the background diffusivity, capped at
``tidal_mix_max`` (vmix_kpp.F90:1755-1835, ``kpp.ri_iwmix``).

The time-invariant coefficients (Jayne's Gamma q E F(z), Schmittner's sum
over deeper levels, the Southern-Ocean floor, Polzin's 2-D fields) are built
once on the host in float64 NumPy; a step divides Jayne's and Schmittner's
by N^2. Polzin's profile is shaped by the step's N^2 (``polzin_diff``): its
integral from each interface to the sea floor is a reversed cumulative sum,
its bottom N^2 a gather at the column's last interface. The lunar factor is
a host value of the model's calendar (``lunar_nodal_modulation``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pop2_tpu_torch import constants as const
from pop2_tpu_torch.config import ModelConfig


def _np(t) -> np.ndarray:
    return t.detach().double().cpu().numpy() if hasattr(t, "detach") \
        else np.asarray(t, np.float64)


def energy_flux(cfg: ModelConfig, grid) -> np.ndarray:
    """Tidal energy flux E(x, y) in W/m^2 at T points: from a POP binary
    record when ``tidal_energy_file`` is set (tidal_read_energy_jayne), else
    the constant ``tidal_energy_const``."""
    ny, nx = cfg.ny, cfg.nx
    if cfg.tidal_energy_file is not None:
        raw = np.fromfile(cfg.tidal_energy_file, dtype=">f8")
        if raw.size < ny * nx:
            raise ValueError("tidal_energy_file too small")
        return raw[:ny * nx].reshape(ny, nx).astype(np.float64)
    return np.full((ny, nx), cfg.tidal_energy_const)


def build_tidal_coef(cfg: ModelConfig, grid) -> np.ndarray:
    """TIDAL_COEF_3D = (Gamma/rho_fw) q E F(z) at the interfaces below each
    level, masked to the ocean column, (km, ny, nx) float64.

    F(z): num_k = exp(-(HT - zw_k)/zeta) for k < KMT, 1 at k == KMT, over
    sum_{k<KMT} num_k dzw_k (init_tidal_mixing2 :1280-1299); E goes from
    W/m^2 to erg/s/cm^2 (x1000, :2231)."""
    km = cfg.km
    zw = _np(grid.vgrid.zw)
    dzw = _np(grid.vgrid.dzw)
    HT, KMT, RCALCT = _np(grid.HT), _np(grid.KMT), _np(grid.RCALCT)
    zeta = cfg.tidal_vertical_decay_scale

    kidx = np.arange(1, km + 1)[:, None, None]   # 1-based level
    num = np.exp(-(HT[None] - zw[:, None, None]) / zeta)
    interior = kidx < KMT[None]
    at_bottom = kidx == KMT[None]
    denom = np.sum(np.where(interior, num * dzw[1:km + 1, None, None], 0.0),
                   axis=0)
    denom = np.where(denom > 0.0, denom, 1.0)
    vert_func = np.where(interior | at_bottom,
                         np.where(at_bottom, 1.0, num) / denom, 0.0)

    qe = (cfg.tidal_local_mixing_fraction * 1000.0
          * energy_flux(cfg, grid))       # erg/s/cm^2
    gamma_rhor = cfg.tidal_mixing_efficiency / const.RHO_FW
    return gamma_rhor * RCALCT[None] * qe[None] * vert_func


# ---------------------------------------------------------------------------
# Schmittner & Egbert (2014) subgrid-scale method
# (init_tidal_mixing2 :1354-1420, tidal_form_coef_schm :2555-2624,
#  Southern-Ocean modification :1410-1435)
# ---------------------------------------------------------------------------

def energy_flux_3d(cfg: ModelConfig, grid) -> np.ndarray:
    """q E(x, y, z) of the Schmittner method (W/m^2 a level): a POP binary
    3-D record (``tidal_energy_file``, km records) where the file holds one,
    else the 2-D flux deposited in the bottom cell."""
    km, ny, nx = cfg.km, cfg.ny, cfg.nx
    if cfg.tidal_energy_file is not None:
        raw = np.fromfile(cfg.tidal_energy_file, dtype=">f8")
        if raw.size >= km * ny * nx:
            return raw[:km * ny * nx].reshape(km, ny, nx).astype(np.float64)
    e2 = energy_flux(cfg, grid)
    kidx = np.arange(1, km + 1)[:, None, None]
    return np.where(kidx == _np(grid.KMT)[None], e2[None], 0.0)


def build_tidal_coef_schmittner(cfg: ModelConfig, grid) -> np.ndarray:
    """TIDAL_COEF_3D(k) = (Gamma/rho) sum_{k1>k} q E(k1)
    exp((zw_k - zw_k1)/zeta) decay(k1), with the SSJ02 decay
    decay(k) = 1/zeta / (1 - exp(-zw_k/zeta)) (tidal_form_coef_schm,
    source/tidal_mixing.F90:2555-2624), masked to k < KMT, (km, ny, nx)
    float64. The sum over deeper levels is a (km, km) weight matrix
    contracted with the column's flux."""
    km = cfg.km
    zw = _np(grid.vgrid.zw)
    KMT = _np(grid.KMT)
    zetar = 1.0 / cfg.tidal_vertical_decay_scale
    decay_fn = zetar / (1.0 - np.exp(-zetar * zw))

    qe = cfg.tidal_local_mixing_fraction * 1000.0 * energy_flux_3d(cfg, grid)
    gamma_rhor = cfg.tidal_mixing_efficiency / const.RHO_FW

    kidx = np.arange(1, km + 1)
    # weight[k, k1] = exp((zw_k - zw_k1)/zeta) decay(k1) for k1 > k
    w = np.exp((zw[:, None] - zw[None, :]) * zetar) * decay_fn[None, :]
    w = np.where(kidx[None, :] > kidx[:, None], w, 0.0)

    qe_m = np.where(kidx[:, None, None] <= KMT[None], qe, 0.0)
    coef = np.einsum("kl,lyx->kyx", w, qe_m)
    valid = kidx[:, None, None] < KMT[None]
    return gamma_rhor * np.where(valid, coef, 0.0)


def schmittner_socn_floor(cfg: ModelConfig, grid) -> np.ndarray:
    """The Southern-Ocean deep-mixing floor (cm^2/s), kappa >=
    max(tanh((zw - 500 m)/100 m), 0) (1 - tanh((lat + 40)/8))/2
    (source/tidal_mixing.F90:1410-1420), (km, ny, nx) float64."""
    zw = _np(grid.vgrid.zw)[:, None, None]
    tlatd = _np(grid.TLAT) * const.RADIAN
    tanh_zw = np.maximum(np.tanh((zw - 500.0e2) / 100.0e2), 0.0)
    tanh_lat = 0.5 * (1.0 - np.tanh((tlatd[None] + 40.0) / 8.0))
    return tanh_zw * tanh_lat


# ---------------------------------------------------------------------------
# Polzin (2009) / Melet et al. (2013) method
# (init_tidal_mixing2 :1316-1352, tidal_zstarp_inv :3960-4000,
#  tidal_compute_diff_polzin_2D :3147-3255)
# ---------------------------------------------------------------------------

MU_POLZIN = 6.97e-2
NB_REF_POLZIN = 9.6e-4          # 1/s reference bottom buoyancy frequency
KAPPA_POLZIN = 2.0 * np.pi / 125.0 * 1.0e-5   # 1/cm topographic wavenumber
TIDAL_EPS_N2 = 1.0e-14          # 1/s^2 stratification floor


class PolzinStatics(NamedTuple):
    """The time-independent Polzin/Melet fields, (ny, nx) tensors."""
    coef2d: torch.Tensor    # (Gamma/rho) q E
    h2: torch.Tensor        # topographic roughness^2 (cm^2)
    urms: torch.Tensor      # barotropic tidal rms speed (cm/s)
    htinv: torch.Tensor     # 1/HT (1e-3 on land)


def polzin_statics(cfg: ModelConfig, grid) -> PolzinStatics:
    """The static Polzin fields on the grid's device in the config's dtype;
    the roughness and the rms speed are the config's constants
    ``tidal_h2_const`` and ``tidal_urms_const`` (the reference reads them
    from tidal_vars_file_polz, tidal_read_roughness_RMS)."""
    HT = _np(grid.HT)
    htinv = np.where(HT != 0.0, 1.0 / np.where(HT != 0.0, HT, 1.0), 1.0e-3)
    qe = cfg.tidal_local_mixing_fraction * 1000.0 * energy_flux(cfg, grid)
    coef2d = (cfg.tidal_mixing_efficiency / const.RHO_FW
              * _np(grid.RCALCT) * qe)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(
            device=grid.KMT.device, dtype=cfg.torch_dtype)

    return PolzinStatics(coef2d=t(coef2d),
                         h2=t(np.full_like(HT, cfg.tidal_h2_const)),
                         urms=t(np.full_like(HT, cfg.tidal_urms_const)),
                         htinv=t(htinv))


def polzin_diff(cfg: ModelConfig, grid, statics: PolzinStatics, n2):
    """The step's Polzin/Melet tidal diffusivity at the interfaces below
    each level, (km, ny, nx), from ``n2`` (km, ny, nx), N^2 there:
      zstarp_inv = kappa^2/(mu Nbref^2) H2 N_b <N^2> / u_rms
      K(z) = coef2d N^2/(N^2 + omega^2)
             (1/H + zstarp_inv) / <N^2> / (1 + z*(z) zstarp_inv)^2
    with z*(z) = int_z^bottom N^2 dz' / <N^2>
    (tidal_compute_diff_polzin_2D, source/tidal_mixing.F90:3147-3255)."""
    km = cfg.km
    dzw = grid.vgrid.dzw[1:km + 1].reshape(km, 1, 1)
    kidx = torch.arange(1, km + 1, device=n2.device,
                        dtype=torch.int32).reshape(km, 1, 1)
    kmt = grid.KMT
    in_col = kidx <= kmt[None] - 1             # interfaces above the bottom

    n2f = torch.where(in_col, torch.clamp(n2, min=TIDAL_EPS_N2), 0.0)

    # integral of N^2 from each interface down to the sea floor
    n2_int = torch.flip(torch.cumsum(torch.flip(n2f * dzw, [0]), 0), [0])
    n2_avg = n2_int[0] * statics.htinv         # <N^2>
    n2_avg_safe = torch.where(n2_avg > 0.0, n2_avg, 1.0)

    # N at the column's last interface above the sea floor (KMT - 1)
    kb = torch.clamp(kmt.long() - 2, min=0)[None]
    nb = torch.sqrt(torch.where(kmt >= 2, torch.gather(n2f, 0, kb)[0], 0.0))

    zstar_inv_coeff = KAPPA_POLZIN ** 2 / (MU_POLZIN * NB_REF_POLZIN ** 2)
    urms_ok = statics.urms != 0.0
    zstarp_inv = torch.where(
        urms_ok, zstar_inv_coeff * statics.h2 * nb * n2_avg
        / torch.where(urms_ok, statics.urms, 1.0), 0.0)

    zstarz = n2_int / n2_avg_safe[None]        # z*(z)
    shape_fac = ((statics.htinv + zstarp_inv)[None] / n2_avg_safe[None]
                 / (1.0 + zstarz * zstarp_inv[None]) ** 2)
    freq_fac = n2f / (n2f + (const.OMEGA ** 2))
    return torch.where(in_col, freq_fac * statics.coef2d[None] * shape_fac,
                       0.0)


# ---------------------------------------------------------------------------
# The 18.6-year lunar nodal cycle (LNC) of the tidal energy
# (source/tidal_mixing.F90:419-520, 1462-1742: the reference reads daily
# modulation time series for each constituent; these are the Doodson nodal
# amplitude factors those files hold, the energy scaling as their square)
# ---------------------------------------------------------------------------

LNC_PERIOD_YEARS = 18.613
#: the year at which the longitude N of the lunar ascending node is 0
LNC_EPOCH_YEAR = 1969.9
#: share of the barotropic tidal dissipation by constituent (Egbert & Ray)
LNC_ENERGY_WEIGHTS = {"m2": 0.68, "s2": 0.17, "k1": 0.10, "o1": 0.05}
#: amplitude nodal factors f = 1 + a cos(N) (Doodson); the solar S2 has no
#: lunar modulation
LNC_AMP_COEF = {"m2": -0.0373, "s2": 0.0, "k1": 0.1150, "o1": 0.1885}


def lunar_nodal_modulation(year_frac: float) -> float:
    """The energy-weighted modulation of the tidal dissipation at the
    decimal year ``year_frac``: sum_c w_c (1 + a_c cos N)^2 with N the
    lunar node's longitude (period 18.613 years). Under
    ``ltidal_lunar_cycle`` it multiplies the tidal diffusivity."""
    n = 2.0 * np.pi * (year_frac - LNC_EPOCH_YEAR) / LNC_PERIOD_YEARS
    return float(sum(w * (1.0 + LNC_AMP_COEF[c] * np.cos(n)) ** 2
                     for c, w in LNC_ENERGY_WEIGHTS.items()))
