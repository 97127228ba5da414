"""Horizontal mixing: Laplacian del2 for momentum and tracers (plain PyTorch)
and the dispatch to the anisotropic momentum closure (``hmix_aniso``).

Reference: ``source/hmix_del2.F90:670-1144`` using the stencil coefficients
precomputed in grid.py. Land boundary conditions enter through per-level
masking of the tracer coefficients (zero-flux) and through zeroing over land
for momentum (no-slip). del4 is a later slice (ROADMAP.md Queue 1 item 11)
and its dispatch branches raise; GM is ``gm.py``.
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


def hdiffu_del2(cfg: ModelConfig, grid: Grid, bc: BC, umixk, vmixk):
    """Laplacian momentum diffusion with metric terms that mix U and V
    (source/hmix_del2.F90:892-936). umixk/vmixk: (km, ny, nx).
    Returns (hduk, hdvk) masked to zero over land."""
    am = cfg.auto_am
    cc = grid.DUC + grid.DUM
    nu = bc.n(umixk, "necorner", "vector")
    nv = bc.n(vmixk, "necorner", "vector")
    lap_u = (cc * umixk + grid.DUN * nu + grid.DUS * bc.s(umixk)
             + grid.DUE * bc.e(umixk) + grid.DUW * bc.w(umixk))
    lap_v = (cc * vmixk + grid.DUN * nv + grid.DUS * bc.s(vmixk)
             + grid.DUE * bc.e(vmixk) + grid.DUW * bc.w(vmixk))
    mix_v = (grid.DMC * vmixk + grid.DMN * nv
             + grid.DMS * bc.s(vmixk) + grid.DME * bc.e(vmixk)
             + grid.DMW * bc.w(vmixk))
    mix_u = (grid.DMC * umixk + grid.DMN * nu
             + grid.DMS * bc.s(umixk) + grid.DME * bc.e(umixk)
             + grid.DMW * bc.w(umixk))
    hduk = am * (lap_u + mix_v)
    hdvk = am * (lap_v - mix_u)
    return (torch.where(grid.kmask_u, hduk, 0.0),
            torch.where(grid.kmask_u, hdvk, 0.0))


def hdifft(cfg: ModelConfig, grid: Grid, bc: BC, tmix):
    """Dispatch (source/horizontal_mix.F90:486-)."""
    if cfg.hmix_tracer == "del2":
        return hdifft_del2(cfg, grid, bc, tmix)
    raise NotImplementedError(
        f"hmix_tracer={cfg.hmix_tracer!r} is not ported yet (ROADMAP.md "
        "Queue 1 items 7, 11)")


def hdiffu(cfg: ModelConfig, grid: Grid, bc: BC, umixk, vmixk):
    """Dispatch (source/horizontal_mix.F90:427-)."""
    if cfg.hmix_momentum == "del2":
        return hdiffu_del2(cfg, grid, bc, umixk, vmixk)
    if cfg.hmix_momentum == "aniso":
        from pop2_tpu_torch import hmix_aniso
        return hmix_aniso.hdiffu_aniso(cfg, grid, bc, grid.aniso, umixk,
                                       vmixk)
    raise NotImplementedError(
        f"hmix_momentum={cfg.hmix_momentum!r} is not ported yet (ROADMAP.md "
        "Queue 1 item 11)")
