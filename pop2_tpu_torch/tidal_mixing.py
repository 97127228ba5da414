"""Tidally driven internal-wave mixing: the Jayne / St Laurent formulation.

Reference: ``source/tidal_mixing.F90``. The tidal energy flux E(x, y) at the
bottom drives a diffusivity kappa = Gamma q E F(z) / (rho N^2) with the
St Laurent et al. (2002) exponential vertical redistribution F(z)
(init_tidal_mixing2 :1280-1310, tidal_form_coef_jayne :2512-2548). KPP's
interior mixing adds it to the background diffusivity, capped at
``tidal_mix_max`` (vmix_kpp.F90:1755-1835, ``kpp.ri_iwmix``).

The time-invariant coefficient Gamma q E F(z) is built once on the host in
float64 NumPy and kept as a (km, ny, nx) tensor; a step divides it by N^2.
The Schmittner and Polzin methods, the Southern-Ocean floor and the lunar
cycle are not ported (``supported.py``, ROADMAP.md Queue 1 item 11).
"""

from __future__ import annotations

import numpy as np

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
