"""Batched implicit vertical-mixing tridiagonal solves.

Port of the Thomas-algorithm sweeps of ``source/vertical_mix.F90:1164``
(impvmixt), ``:1460`` (impvmixt_correct) and ``:1679`` (impvmixu). The
functions here build the system; ``tridiag_cuda.thomas`` sweeps it — the
hand-written CUDA kernel on the GPU, its plain PyTorch version on the CPU.

System solved per column (no partial bottom cells), for the increment F:

  (hfac_k + A_k + C_k) F_k - A_k F_{k+1} - C_k F_{k-1} = hfac_k * RHS_k

with hfac_k = dz_k / c2dt_k, A_k = aidif * VDC_k / dzw_k (zero at/below the
column bottom), C_k = A_{k-1}, and a surface-layer thickness correction
H1 = hfac_1 + PSURF/(g*c2dt_1) for the variable-thickness surface layer.
"""

from __future__ import annotations

import torch

from pop2_tpu_torch import constants as const
from pop2_tpu_torch import tridiag_cuda


def _coupling(dz, dzwr, coef, aidif: float):
    """A_k = aidif * coef_k / dzw_k with the last level zeroed."""
    if dz.ndim != 1:
        raise NotImplementedError(
            "3-D layer thickness (partial bottom cells) is not ported yet "
            "(ROADMAP.md Queue 2 kernel 1: 3-D DZT)")
    km = coef.shape[0]
    A = aidif * dzwr[1:km + 1].reshape(km, 1, 1) * coef
    A[-1] = 0.0  # A is a fresh tensor: zero the last level in place
    return A


def impvmixt_batch(rhs, vdc, psurf, kmt, dz, dzwr, c2dtt, aidif: float,
                   varthick: bool):
    """Multi-tracer implicit mixing sharing one factorization: all tracers
    in ``rhs`` (nr, km, ny, nx) use the same diffusivity ``vdc``
    (km, ny, nx). ``rhs`` is the explicit right-hand side already multiplied
    by c2dtt. Returns the increments dT, (nr, km, ny, nx)."""
    hfac = dz / c2dtt
    A = _coupling(dz, dzwr, vdc, aidif)
    h1 = hfac[0].expand(rhs.shape[2:])
    if varthick:
        h1 = h1 + psurf / (const.GRAV * c2dtt[0])
    return tridiag_cuda.thomas(hfac, h1.contiguous(), kmt, A,
                               rhs.contiguous())


def impvmixt(rhs, vdc, psurf, kmt, dz, dzwr, c2dtt, aidif: float,
             varthick: bool):
    """Implicit tracer mixing for one tracer: solve for the increment dT
    (source/vertical_mix.F90:1164-1382). rhs: (km, ny, nx); the caller forms
    T_new = T_old + dT."""
    return impvmixt_batch(rhs[None], vdc, psurf, kmt, dz, dzwr, c2dtt,
                          aidif, varthick)[0]


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


def impvmixu(rhs_u, rhs_v, vvc, kmu, dz, dzwr, c2dtu, aidif: float):
    """Implicit momentum mixing (source/vertical_mix.F90:1679-1881): solves
    for the modified RHS (already times c2dtu); the two components share one
    factorization. Returns (Fu, Fv)."""
    hfac = dz / c2dtu
    A = _coupling(dz, dzwr, vvc, aidif)
    h1 = hfac[0].expand(rhs_u.shape[1:]).contiguous()
    out = tridiag_cuda.thomas(hfac, h1, kmu, A, torch.stack([rhs_u, rhs_v]))
    return out[0], out[1]
