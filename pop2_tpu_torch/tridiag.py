"""Batched implicit vertical-mixing tridiagonal solves.

Port of the Thomas-algorithm sweeps of ``source/vertical_mix.F90:1164``
(impvmixt), ``:1460`` (impvmixt_correct) and ``:1679`` (impvmixu). The
functions here build the system; ``tridiag_cuda.thomas`` sweeps it — the
hand-written CUDA kernel on the GPU, its plain PyTorch version on the CPU.

System solved per column, for the increment F:

  (hfac_k + A_k + C_k) F_k - A_k F_{k+1} - C_k F_{k-1} = hfac_k * RHS_k

with hfac_k = dz_k / c2dt_k, A_k = aidif * VDC_k / dzw_k (zero at/below the
column bottom), C_k = A_{k-1}, and a surface-layer thickness correction
H1 = hfac_1 + PSURF/(g*c2dt_1) for the variable-thickness surface layer.
Under partial bottom cells (``bottom``: the (ny, nx) thickness of each
column's bottom level, ``Grid.DZBT`` or ``DZBU``) dz_k is that thickness at
the bottom level, and the interface spacing dzw_k = (dz_k + dz_{k+1})/2 is
formed at every level from the column's thicknesses, as the JAX package
forms it from its 3-D DZT (vertical_mix.F90 partial_bottom_cells branches);
the sweep takes the bottom level's hfac as a plane.
"""

from __future__ import annotations

import torch

from pop2_tpu_torch import constants as const
from pop2_tpu_torch import tridiag_cuda


def _coupling(dz, dzwr, coef, aidif: float, kmax, bottom=None):
    """A_k = aidif * coef_k / dzw_k with the last level zeroed; with
    ``bottom`` the spacing of the column's own thicknesses."""
    km = coef.shape[0]
    if bottom is None:
        spacing = dzwr[1:km + 1].reshape(km, 1, 1)
    else:
        kidx = torch.arange(km, device=coef.device).reshape(km, 1, 1)
        dzt = torch.where(kidx == kmax[None] - 1, bottom[None],
                          dz.reshape(km, 1, 1))
        spacing = 1.0 / (0.5 * (dzt + torch.cat([dzt[1:], dzt[-1:]])))
    A = aidif * spacing * coef
    A[-1] = 0.0  # A is a fresh tensor: zero the last level in place
    return A


def _diagonal(dz, c2dt, kmax, bottom=None):
    """(hfac (km,), h1 (ny, nx), hbot (ny, nx) or None): the level table
    dz/c2dt (c2dt a number or a (km,) step a level), the surface level's
    own term (before the psurf correction) and under partial bottom cells
    the bottom level's, bottom/c2dt of that level (land: level 0's)."""
    hfac = dz / c2dt
    if bottom is None:
        return hfac, hfac[0].expand(kmax.shape), None
    if isinstance(c2dt, torch.Tensor) and c2dt.ndim == 1:  # a step a level
        c2dt = c2dt[(kmax.long() - 1).clamp(min=0)]
    hbot = bottom / c2dt
    return hfac, torch.where(kmax == 1, hbot, hfac[0]), hbot


def impvmixt_batch(rhs, vdc, psurf, kmt, dz, dzwr, c2dtt, aidif: float,
                   varthick: bool, bottom=None):
    """Multi-tracer implicit mixing sharing one factorization: all tracers
    in ``rhs`` (nr, km, ny, nx) use the same diffusivity ``vdc``
    (km, ny, nx). ``rhs`` is the explicit right-hand side already multiplied
    by c2dtt; ``bottom`` the bottom level's thickness under partial bottom
    cells. Returns the increments dT, (nr, km, ny, nx)."""
    hfac, h1, hbot = _diagonal(dz, c2dtt, kmt, bottom)
    A = _coupling(dz, dzwr, vdc, aidif, kmt, bottom)
    if varthick:
        h1 = h1 + psurf / (const.GRAV * c2dtt[0])
    return tridiag_cuda.thomas(hfac, h1.contiguous(), kmt, A,
                               rhs.contiguous(), hbot)


def impvmixt(rhs, vdc, psurf, kmt, dz, dzwr, c2dtt, aidif: float,
             varthick: bool, bottom=None):
    """Implicit tracer mixing for one tracer: solve for the increment dT
    (source/vertical_mix.F90:1164-1382). rhs: (km, ny, nx); the caller forms
    T_new = T_old + dT."""
    return impvmixt_batch(rhs[None], vdc, psurf, kmt, dz, dzwr, c2dtt,
                          aidif, varthick, bottom)[0]


def impvmixt_correct(rhs1, vdc, psurf, kmt, dz, dzwr, c2dtt, aidif: float,
                     varthick: bool):
    """Corrector-step variant (source/vertical_mix.F90:1460-1672): only the
    k=1 RHS is nonzero; it propagates down through the C*F_{k-1} coupling.

    rhs1: (ny, nx) surface right-hand side.
    Returns the correction dT, (km, ny, nx).
    """
    km = vdc.shape[0]
    rhs = torch.zeros((km,) + tuple(rhs1.shape), dtype=rhs1.dtype,
                      device=rhs1.device)
    rhs[0] = rhs1
    return impvmixt(rhs, vdc, psurf, kmt, dz, dzwr, c2dtt, aidif, varthick)


def impvmixu(rhs_u, rhs_v, vvc, kmu, dz, dzwr, c2dtu, aidif: float,
             bottom=None):
    """Implicit momentum mixing (source/vertical_mix.F90:1679-1881): solves
    for the modified RHS (already times c2dtu); the two components share one
    factorization; ``bottom`` as in ``impvmixt_batch``. Returns (Fu, Fv)."""
    hfac, h1, hbot = _diagonal(dz, c2dtu, kmu, bottom)
    A = _coupling(dz, dzwr, vvc, aidif, kmu, bottom)
    out = tridiag_cuda.thomas(hfac, h1.contiguous(), kmu, A,
                              torch.stack([rhs_u, rhs_v]), hbot)
    return out[0], out[1]
