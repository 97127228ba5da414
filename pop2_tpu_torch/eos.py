"""Equation of state rho(Theta, S, p).

Reference: ``source/state_mod.F90``. Pure elementwise functions over whole
(km, ny, nx) tensors.

Types:
  * ``mwjf``  — McDougall, Wright, Jackett & Feistel 25-term rational EOS
                (source/state_mod.F90:418-498; test value rho=1.033213242
                g/cm^3 at S=35 PSU, theta=20 C, pressz=200 bars).
  * ``jmcd``  — Jackett & McDougall (1995), UNESCO + secant bulk modulus.
  * ``linear``— linear expansion about a reference state
                (source/state_mod.F90:664-672).

The Bryan-Cox ``polynomial`` fit is not ported yet (ROADMAP.md Queue 1
item 11).

Units: T in degC, S in g/g (msu), p in bars; rho in g/cm^3.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from pop2_tpu_torch.config import ModelConfig

P001 = 0.001

# MWJF numerator coefficients (source/state_mod.F90:173-185), with the
# kg/m^3 -> g/cm^3 conversion folded in
MWJF_NP0S0T0 = 9.99843699e+2 * P001
MWJF_NP0S0T1 = 7.35212840e+0 * P001
MWJF_NP0S0T2 = -5.45928211e-2 * P001
MWJF_NP0S0T3 = 3.98476704e-4 * P001
MWJF_NP0S1T0 = 2.96938239e+0 * P001
MWJF_NP0S1T1 = -7.23268813e-3 * P001
MWJF_NP0S2T0 = 2.12382341e-3 * P001
MWJF_NP1S0T0 = 1.04004591e-2 * P001
MWJF_NP1S0T2 = 1.03970529e-7 * P001
MWJF_NP1S1T0 = 5.18761880e-6 * P001
MWJF_NP2S0T0 = -3.24041825e-8 * P001
MWJF_NP2S0T2 = -1.23869360e-11 * P001

# MWJF denominator coefficients (source/state_mod.F90:189-202)
MWJF_DP0S0T0 = 1.0e+0
MWJF_DP0S0T1 = 7.28606739e-3
MWJF_DP0S0T2 = -4.60835542e-5
MWJF_DP0S0T3 = 3.68390573e-7
MWJF_DP0S0T4 = 1.80809186e-10
MWJF_DP0S1T0 = 2.14691708e-3
MWJF_DP0S1T1 = -9.27062484e-6
MWJF_DP0S1T3 = -1.78343643e-10
MWJF_DP0SQT0 = 4.76534122e-6
MWJF_DP0SQT2 = 1.63410736e-9
MWJF_DP1S0T0 = 5.30848875e-6
MWJF_DP2S0T3 = -3.03175128e-16
MWJF_DP3S0T1 = -1.27934137e-17

# UNESCO fresh-water / surface-salinity coefficients and Jackett & McDougall
# bulk-modulus coefficients (source/state_mod.F90:97-162, Table A1 of
# Jackett & McDougall 1995)
UNT0 = 999.842594
UNT1 = 6.793952e-2
UNT2 = -9.095290e-3
UNT3 = 1.001685e-4
UNT4 = -1.120083e-6
UNT5 = 6.536332e-9
UNS1T0 = 0.824493
UNS1T1 = -4.0899e-3
UNS1T2 = 7.6438e-5
UNS1T3 = -8.2467e-7
UNS1T4 = 5.3875e-9
UNSQT0 = -5.72466e-3
UNSQT1 = 1.0227e-4
UNSQT2 = -1.6546e-6
UNS2T0 = 4.8314e-4
BUP0S0T0 = 1.965933e+4
BUP0S0T1 = 1.444304e+2
BUP0S0T2 = -1.706103
BUP0S0T3 = 9.648704e-3
BUP0S0T4 = -4.190253e-5
BUP0S1T0 = 5.284855e+1
BUP0S1T1 = -3.101089e-1
BUP0S1T2 = 6.283263e-3
BUP0S1T3 = -5.084188e-5
BUP0SQT0 = 3.886640e-1
BUP0SQT1 = 9.085835e-3
BUP0SQT2 = -4.619924e-4
BUP1S0T0 = 3.186519
BUP1S0T1 = 2.212276e-2
BUP1S0T2 = -2.984642e-4
BUP1S0T3 = 1.956415e-6
BUP1S1T0 = 6.704388e-3
BUP1S1T1 = -1.847318e-4
BUP1S1T2 = 2.059331e-7
BUP1SQT0 = 1.480266e-4
BUP2S0T0 = 2.102898e-4
BUP2S0T1 = -1.202016e-5
BUP2S0T2 = 1.394680e-7
BUP2S1T0 = -2.040237e-6
BUP2S1T1 = 6.128773e-8
BUP2S1T2 = 6.207323e-10

# linear EOS parameters (source/state_mod.F90:224-229)
T_LEOS_REF = 19.0
S_LEOS_REF = 0.035
RHO_LEOS_REF = 1.025022
LEOS_ALF = 2.55e-4
LEOS_BET = 7.64e-1

# T/S valid ranges per 250 m depth bin for range enforcement
# (source/state_mod.F90:1286-1336); S in ppt here, converted at build time.
TREFMIN = np.array([-2., -2., -2., -2., -1., -1., -1., -1., -1., -1., -1.,
                    -1., -1., -1., -1., -1., -1., -1., -1., 0., 0., 0., 0.,
                    0., 0., 0., 0., 0., 0., 0., 0., 0., 0.])
TREFMAX = np.array([29., 19., 14., 11., 9., 7., 7., 7., 7., 7., 7., 7., 7.,
                    7., 7., 7., 7., 7., 7., 7., 7., 7., 7., 7., 7., 7., 7.,
                    7., 7., 7., 7., 7., 7.])
SREFMIN = np.array([28.5, 33.7, 34.0, 34.1, 34.2, 34.4, 34.5, 34.5, 34.6,
                    34.6, 34.6, 34.6, 34.6, 34.6, 34.6, 34.6, 34.6, 34.6,
                    34.6, 34.6, 34.6, 34.6, 34.6, 34.7, 34.7, 34.7, 34.7,
                    34.7, 34.7, 34.7, 34.7, 34.7, 34.7])
SREFMAX = np.array([37.0, 36.6, 35.8, 35.7, 35.3, 35.1, 35.1, 35.0, 35.0,
                    35.0, 35.0, 35.0, 35.0, 35.0, 35.0, 35.0, 35.0, 35.0,
                    35.0, 35.0, 35.0, 35.0, 35.0, 35.0, 35.0, 35.0, 35.0,
                    35.0, 35.0, 35.0, 35.0, 35.0, 35.0])


class TSRange(NamedTuple):
    """Per-level valid T/S ranges, shape (km, 1, 1) for broadcasting."""
    tmin: torch.Tensor
    tmax: torch.Tensor
    smin: torch.Tensor
    smax: torch.Tensor

    def to(self, device):
        return TSRange(*(t.to(device) for t in self))


def build_ts_range(zt_cm: np.ndarray, dtype, device="cpu") -> TSRange:
    """Per-level ranges from the 250-m depth bins
    (source/state_mod.F90:1345-1351, conversion at :1131-1134)."""
    idx = np.minimum((np.asarray(zt_cm) * 0.01 / 250.0).astype(int), 32)

    def f(a):
        return torch.as_tensor(a.reshape(-1, 1, 1)).to(device=device,
                                                       dtype=dtype)
    return TSRange(tmin=f(TREFMIN[idx]), tmax=f(TREFMAX[idx]),
                   smin=f(SREFMIN[idx] * 1e-3), smax=f(SREFMAX[idx] * 1e-3))


def _adjust_ts(cfg: ModelConfig, T, S, ts_range: Optional[TSRange]):
    if cfg.state_range_opt == "enforce" and ts_range is not None:
        TQ = torch.clamp(T, min=ts_range.tmin, max=ts_range.tmax)
        SQ = torch.clamp(S, min=ts_range.smin, max=ts_range.smax)
    else:
        # prevent garbage on land points (source/state_mod.F90:353-358)
        TQ = torch.clamp(T, -1000.0, 1000.0)
        SQ = torch.clamp(S, 0.0, 1000.0)
    return TQ, SQ


def mwjf_rho(T, S_msu, p_bars, want_drhodt: bool = False,
             want_drhods: bool = False):
    """MWJF density (g/cm^3) and optional dT/dS derivatives.

    ``p_bars`` broadcasts against T/S (pass (km,1,1) for 3-D fields).
    Follows source/state_mod.F90:418-498 term for term.
    """
    p = 10.0 * p_bars  # bars -> the dbar-like pressure in the fit
    TQ = T
    SQ = 1000.0 * S_msu
    SQR = torch.sqrt(SQ)

    nums0t0 = MWJF_NP0S0T0 + p * (MWJF_NP1S0T0 + p * MWJF_NP2S0T0)
    nums0t1 = MWJF_NP0S0T1
    nums0t2 = MWJF_NP0S0T2 + p * (MWJF_NP1S0T2 + p * MWJF_NP2S0T2)
    nums0t3 = MWJF_NP0S0T3
    nums1t0 = MWJF_NP0S1T0 + p * MWJF_NP1S1T0
    nums1t1 = MWJF_NP0S1T1
    nums2t0 = MWJF_NP0S2T0

    work1 = (nums0t0 + TQ * (nums0t1 + TQ * (nums0t2 + nums0t3 * TQ))
             + SQ * (nums1t0 + nums1t1 * TQ + nums2t0 * SQ))

    dens0t0 = MWJF_DP0S0T0 + p * MWJF_DP1S0T0
    dens0t1 = MWJF_DP0S0T1 + p ** 3 * MWJF_DP3S0T1
    dens0t2 = MWJF_DP0S0T2
    dens0t3 = MWJF_DP0S0T3 + p ** 2 * MWJF_DP2S0T3
    dens0t4 = MWJF_DP0S0T4
    dens1t0 = MWJF_DP0S1T0
    dens1t1 = MWJF_DP0S1T1
    dens1t3 = MWJF_DP0S1T3
    densqt0 = MWJF_DP0SQT0
    densqt2 = MWJF_DP0SQT2

    work2 = (dens0t0 + TQ * (dens0t1 + TQ * (dens0t2
             + TQ * (dens0t3 + dens0t4 * TQ)))
             + SQ * (dens1t0 + TQ * (dens1t1 + TQ * TQ * dens1t3)
                     + SQR * (densqt0 + TQ * TQ * densqt2)))
    denomk = 1.0 / work2
    rho = work1 * denomk

    out = [rho]
    if want_drhodt:
        work3 = (nums0t1 + TQ * (2.0 * nums0t2 + 3.0 * nums0t3 * TQ)
                 + nums1t1 * SQ)
        work4 = (dens0t1 + SQ * dens1t1
                 + TQ * (2.0 * (dens0t2 + SQ * SQR * densqt2)
                         + TQ * (3.0 * (dens0t3 + SQ * dens1t3)
                                 + TQ * 4.0 * dens0t4)))
        out.append((work3 - work1 * denomk * work4) * denomk)
    if want_drhods:
        work3 = nums1t0 + nums1t1 * TQ + 2.0 * nums2t0 * SQ
        work4 = (dens1t0 + TQ * (dens1t1 + TQ * TQ * dens1t3)
                 + 1.5 * SQR * (densqt0 + TQ * TQ * densqt2))
        out.append((work3 - work1 * denomk * work4) * denomk * 1000.0)
    return tuple(out) if len(out) > 1 else out[0]


def jmcd_rho(T, S_msu, p_bars, want_drhodt: bool = False,
             want_drhods: bool = False):
    """Jackett & McDougall (1995) EOS: UNESCO surface density + JMcD secant
    bulk modulus (source/state_mod.F90:502-607). ``p_bars`` is the in-situ
    reference pressure in bars. Returns rho in g/cm^3 (and optional T/S
    derivatives; the dS derivative is per msu, the unit factors cancel as in
    the reference).
    """
    p = p_bars
    p2 = p * p
    TQ = T
    SQ = 1000.0 * S_msu
    SQR = torch.sqrt(SQ)
    T2 = TQ * TQ

    # surface (p=0) UNESCO density anomaly (:517-524)
    work1 = UNS1T0 + UNS1T1 * TQ + (UNS1T2 + UNS1T3 * TQ + UNS1T4 * T2) * T2
    work2 = SQR * (UNSQT0 + UNSQT1 * TQ + UNSQT2 * T2)
    rho_s = (UNT1 * TQ + (UNT2 + UNT3 * TQ + (UNT4 + UNT5 * TQ) * T2) * T2
             + (UNS2T0 * SQ + work1 + work2) * SQ)

    # bulk modulus at pressure p (:530-545)
    work3 = (BUP0S1T0 + BUP0S1T1 * TQ + (BUP0S1T2 + BUP0S1T3 * TQ) * T2
             + p * (BUP1S1T0 + BUP1S1T1 * TQ + BUP1S1T2 * T2)
             + p2 * (BUP2S1T0 + BUP2S1T1 * TQ + BUP2S1T2 * T2))
    work4 = SQR * (BUP0SQT0 + BUP0SQT1 * TQ + BUP0SQT2 * T2 + BUP1SQT0 * p)
    bulk_mod = (BUP0S0T0 + BUP0S0T1 * TQ
                + (BUP0S0T2 + BUP0S0T3 * TQ + BUP0S0T4 * T2) * T2
                + p * (BUP1S0T0 + BUP1S0T1 * TQ
                       + (BUP1S0T2 + BUP1S0T3 * TQ) * T2)
                + p2 * (BUP2S0T0 + BUP2S0T1 * TQ + BUP2S0T2 * T2)
                + SQ * (work3 + work4))
    denomk = 1.0 / (bulk_mod - p)
    rho = ((UNT0 + rho_s) * bulk_mod * denomk) * P001

    out = [rho]
    if want_drhodt:
        drdt0 = (UNT1 + 2.0 * UNT2 * TQ
                 + (3.0 * UNT3 + 4.0 * UNT4 * TQ + 5.0 * UNT5 * T2) * T2
                 + (UNS1T1 + 2.0 * UNS1T2 * TQ
                    + (3.0 * UNS1T3 + 4.0 * UNS1T4 * TQ) * T2
                    + (UNSQT1 + 2.0 * UNSQT2 * TQ) * SQR) * SQ)
        dkdt = (BUP0S0T1 + 2.0 * BUP0S0T2 * TQ
                + (3.0 * BUP0S0T3 + 4.0 * BUP0S0T4 * TQ) * T2
                + p * (BUP1S0T1 + 2.0 * BUP1S0T2 * TQ + 3.0 * BUP1S0T3 * T2)
                + p2 * (BUP2S0T1 + 2.0 * BUP2S0T2 * TQ)
                + SQ * (BUP0S1T1 + 2.0 * BUP0S1T2 * TQ + 3.0 * BUP0S1T3 * T2
                        + p * (BUP1S1T1 + 2.0 * BUP1S1T2 * TQ)
                        + p2 * (BUP2S1T1 + 2.0 * BUP2S1T2 * TQ)
                        + SQR * (BUP0SQT1 + 2.0 * BUP0SQT2 * TQ)))
        out.append((denomk * (drdt0 * bulk_mod
                              - p * (UNT0 + rho_s) * dkdt * denomk)) * P001)
    if want_drhods:
        drds0 = 2.0 * UNS2T0 * SQ + work1 + 1.5 * work2
        dkds = work3 + 1.5 * work4
        # per-msu derivative: the *1000 (psu/msu) and *0.001 (kg/m^3 ->
        # g/cm^3) factors cancel (source/state_mod.F90:594-600)
        out.append(denomk * (drds0 * bulk_mod
                             - p * (UNT0 + rho_s) * dkds * denomk))
    return tuple(out) if len(out) > 1 else out[0]


def linear_rho(T, S_msu, want_drhodt: bool = False,
               want_drhods: bool = False):
    """Linear EOS (source/state_mod.F90:664-672); returns full density."""
    rho = (RHO_LEOS_REF + LEOS_BET * (S_msu - S_LEOS_REF)
           - LEOS_ALF * (T - T_LEOS_REF))
    out = [rho]
    if want_drhodt:
        out.append(torch.full_like(rho, -LEOS_ALF))
    if want_drhods:
        out.append(torch.full_like(rho, LEOS_BET))
    return tuple(out) if len(out) > 1 else out[0]

def state(cfg: ModelConfig, pressz, T, S, ts_range: Optional[TSRange] = None,
          want_drhodt: bool = False, want_drhods: bool = False):
    """rho (and optional derivatives) for full 3-D (km, ny, nx) fields.

    ``pressz`` is the per-level reference pressure (bars), shape (km,) — the
    displaced-parcel variant (k != kk) is available by passing a different
    pressure profile.
    """
    p = pressz.reshape(-1, 1, 1)
    TQ, SQ = _adjust_ts(cfg, T, S, ts_range)
    if cfg.state_choice == "mwjf":
        return mwjf_rho(TQ, SQ, p, want_drhodt, want_drhods)
    if cfg.state_choice == "jmcd":
        return jmcd_rho(TQ, SQ, p, want_drhodt, want_drhods)
    if cfg.state_choice == "linear":
        return linear_rho(TQ, SQ, want_drhodt, want_drhods)
    raise NotImplementedError(cfg.state_choice)


def state_at_level(cfg: ModelConfig, press_bars, T, S,
                   ts_range_k: Optional[tuple] = None):
    """rho for a single level/field displaced to pressure ``press_bars``
    (used by convective adjustment's k -> k+1 displacement,
    source/vertical_mix.F90:1955-1958)."""
    if ts_range_k is not None:
        tmin, tmax, smin, smax = ts_range_k
        T = torch.clamp(T, min=tmin, max=tmax)
        S = torch.clamp(S, min=smin, max=smax)
    else:
        T = torch.clamp(T, -1000.0, 1000.0)
        S = torch.clamp(S, 0.0, 1000.0)
    if cfg.state_choice == "mwjf":
        return mwjf_rho(T, S, press_bars)
    if cfg.state_choice == "jmcd":
        return jmcd_rho(T, S, press_bars)
    if cfg.state_choice == "linear":
        return linear_rho(T, S)
    raise NotImplementedError(cfg.state_choice)
