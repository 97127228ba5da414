"""Horizontal mixing: Laplacian del2 and biharmonic del4 for momentum and
tracers (plain PyTorch) and the dispatch to the anisotropic momentum closure
(``hmix_aniso``).

Reference: ``source/hmix_del2.F90:670-1144`` and
``source/hmix_del4.F90:637-1060``, using the stencil coefficients
precomputed in grid.py. Land boundary conditions enter through per-level
masking of the tracer coefficients (zero-flux) and through zeroing over land
for momentum (no-slip). Under ``ltopostress`` the Laplacian friction relaxes
the flow toward the topographic-stress velocities ``grid.TSU``/``TSV``. GM
is ``gm.py``.
"""

from __future__ import annotations

import torch

from pop2_tpu_torch.config import ModelConfig
from pop2_tpu_torch.grid import Grid
from pop2_tpu_torch.stencil import BC


def _tracer_lap_coeffs(cfg: ModelConfig, grid: Grid):
    """Per-level masked 5-point tracer Laplacian coefficients (zero-flux
    land BC): a face is open at level k only if the neighbour is ocean
    there."""
    kidx = torch.arange(1, cfg.km + 1, dtype=torch.int32,
                        device=grid.KMT.device).reshape(cfg.km, 1, 1)
    mask = grid.kmask_t
    cn = torch.where((kidx <= grid.KMTN[None]) & mask, grid.DTN[None], 0.0)
    cs = torch.where((kidx <= grid.KMTS[None]) & mask, grid.DTS[None], 0.0)
    ce = torch.where((kidx <= grid.KMTE[None]) & mask, grid.DTE[None], 0.0)
    cw = torch.where((kidx <= grid.KMTW[None]) & mask, grid.DTW[None], 0.0)
    cc = -(cn + cs + ce + cw)
    return cc, cn, cs, ce, cw


def hdifft_del2(cfg: ModelConfig, grid: Grid, bc: BC, tmix):
    """Laplacian tracer diffusion ah*Del2(T) for all tracers/levels
    (source/hmix_del2.F90:1034-1095). tmix: (nt, km, ny, nx)."""
    cc, cn, cs, ce, cw = _tracer_lap_coeffs(cfg, grid)
    return cfg.auto_ah * (cc[None] * tmix
                          + cn[None] * bc.n(tmix) + cs[None] * bc.s(tmix)
                          + ce[None] * bc.e(tmix) + cw[None] * bc.w(tmix))


def topostress_relative(cfg: ModelConfig, grid: Grid, umixk, vmixk):
    """The velocities the Laplacian friction acts on: under
    ``ltopostress`` their departure from the topographic-stress velocities
    on ocean points (source/hmix_del2.F90:765-772), else themselves."""
    if not cfg.ltopostress:
        return umixk, vmixk
    return (torch.where(grid.kmask_u, umixk - grid.TSU, umixk),
            torch.where(grid.kmask_u, vmixk - grid.TSV, vmixk))


def _mom_lap(grid: Grid, bc: BC, u, v):
    """The momentum Laplacian with the metric terms that mix U and V (the
    stencil del2 and del4 share; source/hmix_del4.F90:727-770)."""
    cc = grid.DUC + grid.DUM
    nu = bc.n(u, "necorner", "vector")
    nv = bc.n(v, "necorner", "vector")
    lap_u = (cc * u + grid.DUN * nu + grid.DUS * bc.s(u)
             + grid.DUE * bc.e(u) + grid.DUW * bc.w(u))
    lap_v = (cc * v + grid.DUN * nv + grid.DUS * bc.s(v)
             + grid.DUE * bc.e(v) + grid.DUW * bc.w(v))
    mix_v = (grid.DMC * v + grid.DMN * nv + grid.DMS * bc.s(v)
             + grid.DME * bc.e(v) + grid.DMW * bc.w(v))
    mix_u = (grid.DMC * u + grid.DMN * nu + grid.DMS * bc.s(u)
             + grid.DME * bc.e(u) + grid.DMW * bc.w(u))
    return lap_u + mix_v, lap_v - mix_u


def hdiffu_del2(cfg: ModelConfig, grid: Grid, bc: BC, umixk, vmixk):
    """Laplacian momentum diffusion with metric terms that mix U and V
    (source/hmix_del2.F90:892-936), relaxing toward the topographic-stress
    velocities under ``ltopostress``. umixk/vmixk: (km, ny, nx).
    Returns (hduk, hdvk) masked to zero over land."""
    return del2_friction(cfg, grid, bc,
                         *topostress_relative(cfg, grid, umixk, vmixk))


def del2_friction(cfg: ModelConfig, grid: Grid, bc: BC, u, v):
    """am Lap(u, v) masked to zero over land: the Laplacian friction of the
    velocities it acts on (``hdiffu_del2`` after ``topostress_relative``;
    the momentum kernel's fused friction)."""
    lu, lv = _mom_lap(grid, bc, u, v)
    am = cfg.auto_am
    return (torch.where(grid.kmask_u, am * lu, 0.0),
            torch.where(grid.kmask_u, am * lv, 0.0))


def hdifft_del4(cfg: ModelConfig, grid: Grid, bc: BC, tmix):
    """Biharmonic tracer mixing ah4 Del2(Del2(T)) for all tracers and
    levels (source/hmix_del4.F90:963-1060): the masked Laplacian applied
    twice; ``ah4`` is negative."""
    cc, cn, cs, ce, cw = _tracer_lap_coeffs(cfg, grid)

    def lap(t):
        return (cc[None] * t + cn[None] * bc.n(t) + cs[None] * bc.s(t)
                + ce[None] * bc.e(t) + cw[None] * bc.w(t))

    return cfg.ah4 * lap(lap(tmix))


def hdiffu_del4(cfg: ModelConfig, grid: Grid, bc: BC, umixk, vmixk):
    """Biharmonic momentum mixing am4 Del2(Del2(u, v))
    (source/hmix_del4.F90:637-880); ``am4`` is negative. The intermediate
    Laplacian is zeroed over land before the second application (the
    boundary condition, :770-776)."""
    d2u, d2v = _mom_lap(grid, bc, umixk, vmixk)
    d2u = torch.where(grid.kmask_u, d2u, 0.0)
    d2v = torch.where(grid.kmask_u, d2v, 0.0)
    hdu, hdv = _mom_lap(grid, bc, d2u, d2v)
    return (torch.where(grid.kmask_u, cfg.am4 * hdu, 0.0),
            torch.where(grid.kmask_u, cfg.am4 * hdv, 0.0))


def hdifft(cfg: ModelConfig, grid: Grid, bc: BC, tmix):
    """Dispatch (source/horizontal_mix.F90:486-)."""
    if cfg.hmix_tracer == "del2":
        return hdifft_del2(cfg, grid, bc, tmix)
    if cfg.hmix_tracer == "del4":
        return hdifft_del4(cfg, grid, bc, tmix)
    raise ValueError(f"hmix_tracer={cfg.hmix_tracer!r}: GM is gm.py's")


def hdiffu(cfg: ModelConfig, grid: Grid, bc: BC, umixk, vmixk):
    """Dispatch (source/horizontal_mix.F90:427-)."""
    if cfg.hmix_momentum == "del2":
        return hdiffu_del2(cfg, grid, bc, umixk, vmixk)
    if cfg.hmix_momentum == "del4":
        return hdiffu_del4(cfg, grid, bc, umixk, vmixk)
    if cfg.hmix_momentum == "aniso":
        from pop2_tpu_torch import hmix_aniso
        return hmix_aniso.hdiffu_aniso(cfg, grid, bc, grid.aniso, umixk,
                                       vmixk)
    raise ValueError(f"hmix_momentum={cfg.hmix_momentum!r}")
