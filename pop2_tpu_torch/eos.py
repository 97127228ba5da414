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
  * ``polynomial`` — Bryan-Cox per-level 9-term cubic fits of UNESCO (1981)
                (source/state_mod.F90:600-662, fitted as init_state_coeffs
                :1168-1560 does).

The polynomial fit depends on the pressure profile it is made for, one level
at a time. The levels' own pressures are fitted on the host in NumPy once,
when the grid is built (``polynomial_fit``), and the fit is a field of the
vertical grid (``VGrid.poly``), so it moves with the grid. The other
profiles the package takes densities at (a parcel displaced one level down,
one level's pressure alone) are rows of that fit (``fit_rows``). A step only
reads it: a copy from the host inside a step would break a captured step,
so a density without a fit raises.

Units: T in degC, S in g/g (msu), p in bars; rho in g/cm^3.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from pop2_tpu_torch._tree import TensorTree
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
          want_drhodt: bool = False, want_drhods: bool = False,
          fit: Optional["PolyFit"] = None):
    """rho (and optional derivatives) for full 3-D (km, ny, nx) fields.

    ``pressz`` is the per-level reference pressure (bars), shape (km,) — the
    displaced-parcel variant (k != kk) is available by passing a different
    pressure profile. Under ``polynomial``, ``fit`` is the fit of that
    profile: ``grid.vgrid.poly``, or ``fit_rows`` of it.
    """
    p = pressz.reshape(-1, 1, 1)
    TQ, SQ = _adjust_ts(cfg, T, S, ts_range)
    if cfg.state_choice == "mwjf":
        return mwjf_rho(TQ, SQ, p, want_drhodt, want_drhods)
    if cfg.state_choice == "jmcd":
        return jmcd_rho(TQ, SQ, p, want_drhodt, want_drhods)
    if cfg.state_choice == "linear":
        return linear_rho(TQ, SQ, want_drhodt, want_drhods)
    if cfg.state_choice == "polynomial":
        return poly_rho(TQ, SQ, _need_fit(fit), want_drhodt, want_drhods)
    raise NotImplementedError(cfg.state_choice)


def state_at_level(cfg: ModelConfig, press_bars, T, S,
                   ts_range_k: Optional[tuple] = None,
                   fit: Optional["PolyFit"] = None):
    """rho for a single level/field displaced to pressure ``press_bars``
    (used by convective adjustment's k -> k+1 displacement,
    source/vertical_mix.F90:1955-1958; under ``polynomial`` ``fit`` is that
    level's, ``fit_rows(grid.vgrid.poly, k)``)."""
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
    if cfg.state_choice == "polynomial":
        fit = _need_fit(fit)
        if T.ndim == 2:
            return poly_rho(T[None], S[None], fit)[0]
        return poly_rho(T, S, fit)
    raise NotImplementedError(cfg.state_choice)


# ---------------------------------------------------------------------------
# Bryan-Cox 'polynomial' EOS (source/state_mod.F90:600-662 evaluation,
# init_state_coeffs :1168-1560): per-level 9-term cubic fits of the full
# UNESCO (1981) equation of state in potential-temperature/salinity
# anomalies about level-mean reference values. The reference fits with a
# 1968 JPL iterative least-squares routine (lsqsl2 :1778); here numpy's
# lstsq solves the same overdetermined system on the host, once a profile.
# ---------------------------------------------------------------------------

# T/S sampling ranges per 250 m depth bin: the range-enforcement tables
# above (state_mod.F90:1280-1330)
_NS_SALT = 5
_NS_TEMP = 2 * _NS_SALT


def unesco_rho(t, s, pbars):
    """Full UNESCO (1981) in-situ density (kg/m^3) from in-situ T (degC),
    S (psu), p (bars) — Gill (1982) App. 3 / UNESCO Tech. Paper 36, the
    formula init_state_coeffs samples (state_mod.F90 'unesco'). NumPy."""
    t = np.asarray(t, np.float64)
    s = np.asarray(s, np.float64)
    p = np.asarray(pbars, np.float64)
    # density at one standard atmosphere
    rw = (999.842594 + 6.793952e-2 * t - 9.095290e-3 * t**2
          + 1.001685e-4 * t**3 - 1.120083e-6 * t**4 + 6.536332e-9 * t**5)
    rsto = (rw
            + s * (0.824493 - 4.0899e-3 * t + 7.6438e-5 * t**2
                   - 8.2467e-7 * t**3 + 5.3875e-9 * t**4)
            + s**1.5 * (-5.72466e-3 + 1.0227e-4 * t - 1.6546e-6 * t**2)
            + 4.8314e-4 * s**2)
    # secant bulk modulus
    kw = (19652.21 + 148.4206 * t - 2.327105 * t**2
          + 1.360477e-2 * t**3 - 5.155288e-5 * t**4)
    ksto = (kw
            + s * (54.6746 - 0.603459 * t + 1.09987e-2 * t**2
                   - 6.1670e-5 * t**3)
            + s**1.5 * (7.944e-2 + 1.6483e-2 * t - 5.3009e-4 * t**2))
    kstp = (ksto
            + p * (3.239908 + 1.43713e-3 * t + 1.16092e-4 * t**2
                   - 5.77905e-7 * t**3)
            + p * s * (2.2838e-3 - 1.0981e-5 * t - 1.6078e-6 * t**2)
            + p * s**1.5 * 1.91075e-4
            + p**2 * (8.50935e-5 - 6.12293e-6 * t + 5.2787e-8 * t**2)
            + p**2 * s * (-9.9348e-7 + 2.0816e-8 * t + 9.1697e-10 * t**2))
    return rsto / (1.0 - p / kstp)


def potem(t, s, pbars):
    """Potential temperature from in-situ T, S, p (Bryden 1973; the
    reference's 'potem', state_mod.F90). NumPy."""
    t = np.asarray(t, np.float64)
    s = np.asarray(s, np.float64)
    p = np.asarray(pbars, np.float64)
    p2, p3 = p * p, p * p * p
    potmp = (p * (3.6504e-4 + t * (8.3198e-5 + t * (-5.4065e-7
                                                    + t * 4.0274e-9)))
             + p * (s - 35.0) * (1.7439e-5 - t * 2.9778e-7)
             + p2 * (8.9309e-7 + t * (-3.1628e-8 + t * 2.1987e-10))
             - 4.1057e-9 * p2 * (s - 35.0)
             + p3 * (-1.6056e-10 + t * 5.0484e-12))
    return t - potmp


def _poly_coeffs_np(zt_cm: tuple, pressz: tuple):
    """(coeffs (9, km), to (km), so (km), sigo (km)) in model units, the
    init_state_coeffs pipeline (state_mod.F90:1340-1537). NumPy."""
    zt = np.asarray(zt_cm)
    pz = np.asarray(pressz)
    km = len(zt)
    coeffs = np.zeros((9, km))
    to = np.zeros(km)
    so = np.zeros(km)
    sigo = np.zeros(km)
    for k in range(km):
        i = min(int(zt[k] * 0.01 / 250.0), 32)
        ts = np.linspace(TREFMIN[i], TREFMAX[i], _NS_TEMP)
        ss = np.linspace(SREFMIN[i], SREFMAX[i], _NS_SALT)
        tg, sg = (a.ravel() for a in np.meshgrid(ts, ss, indexing="ij"))
        sigma = unesco_rho(tg, sg, pz[k]) - 1.0e3
        theta = potem(tg, sg, pz[k])
        t_avg, s_avg = tg.mean(), sg.mean()
        sigo[k] = unesco_rho(t_avg, s_avg, pz[k]) - 1.0e3
        to[k] = theta.mean()
        so[k] = s_avg
        ta = theta - to[k]
        sa = sg - so[k]
        A = np.stack([ta, sa, ta * ta, ta * sa, sa * sa, ta**3,
                      sa * sa * ta, ta * ta * sa, sa**3], axis=1)
        coeffs[:, k] = np.linalg.lstsq(A, sigma - sigo[k], rcond=None)[0]
    # unit rescaling (state_mod.F90:1525-1537): the coefficients go to
    # (g/cm^3 - 1)/msu units; sigo stays in kg/m^3 (the reference scales
    # it down then back up, :1526 and :1536) and the evaluation adds
    # sigo*1e-3 + 1
    so = so * 1.0e-3 - 0.035
    for idx, fac in ((0, 1e-3), (2, 1e-3), (4, 1e3), (5, 1e-3),
                     (6, 1e3), (8, 1e6)):
        coeffs[idx] *= fac
    return coeffs, to, so, sigo


def _depth_from_pressz(pz: tuple) -> np.ndarray:
    """Invert the Levitus hydrostatic pressure fit (grid.pressure_bars)
    for the 250 m range-table binning of the polynomial fit; Newton on
    the smooth monotone fit converges in a few steps. NumPy."""
    p = np.asarray(pz, np.float64)
    d = p / 0.100766                      # linear first guess (m)
    for _ in range(6):
        f = (0.059808 * (np.exp(-0.025 * d) - 1.0) + 0.100766 * d
             + 2.28405e-7 * d * d - p)
        fp = (-0.025 * 0.059808 * np.exp(-0.025 * d) + 0.100766
              + 2.0 * 2.28405e-7 * d)
        d = d - f / fp
    return np.maximum(d, 0.0) * 100.0     # cm


@dataclass(frozen=True)
class PolyFit(TensorTree):
    """A pressure profile's polynomial fit on the device, in the model's
    dtype, each shaped to broadcast over (n, ny, nx) fields of the
    profile's n levels: coeffs (9, n, 1, 1); tref, sref, sigref (n, 1, 1),
    the reference's to, so, sigo."""
    coeffs: torch.Tensor
    tref: torch.Tensor
    sref: torch.Tensor
    sigref: torch.Tensor


def polynomial_fit(cfg: ModelConfig, pressz) -> Optional[PolyFit]:
    """``VGrid.poly``: under ``state_choice='polynomial'`` the fit of the
    levels' pressures ``pressz`` (bars, (km,)), made when the grid is built,
    on the host from the values as their dtype holds them and copied to
    their device and dtype; None under another equation of state."""
    if cfg.state_choice != "polynomial":
        return None
    pz = tuple(np.asarray(pressz.detach().cpu(), np.float64).ravel())
    coeffs, to, so, sigo = _poly_coeffs_np(tuple(_depth_from_pressz(pz)),
                                           pz)

    def dev(a, *shape):
        return torch.as_tensor(a).to(device=pressz.device,
                                     dtype=pressz.dtype).reshape(*shape)
    n = len(pz)
    return PolyFit(coeffs=dev(coeffs, 9, n, 1, 1), tref=dev(to, n, 1, 1),
                   sref=dev(so, n, 1, 1), sigref=dev(sigo, n, 1, 1))


def fit_rows(fit: Optional[PolyFit],
             rows: Union[str, int]) -> Optional[PolyFit]:
    """The fit of another profile, taken from ``fit``, the levels' own
    (``VGrid.poly``). Each level's fit depends on its pressure alone, so
    these are bitwise the profile's own fit. ``rows='down'``:
    pressz[min(k+1, km-1)], a parcel displaced one level down (Richardson
    mixing, GM's N^2 and diffusivities). An int k: level k's pressure
    alone, one row that broadcasts over any number of levels (convective
    adjustment; k = 0 is potential density's). None stays None."""
    if fit is None:
        return None
    if rows == "down":
        def pick(x, dim):
            return torch.cat([x.narrow(dim, 1, x.shape[dim] - 1),
                              x.narrow(dim, x.shape[dim] - 1, 1)], dim)
    else:
        def pick(x, dim):
            return x.narrow(dim, rows, 1)
    return PolyFit(coeffs=pick(fit.coeffs, 1), tref=pick(fit.tref, 0),
                   sref=pick(fit.sref, 0), sigref=pick(fit.sigref, 0))


def _need_fit(fit: Optional[PolyFit]) -> PolyFit:
    if fit is None:
        raise ValueError(
            "state_choice='polynomial': no prebuilt fit for this pressure "
            "profile; pass fit=grid.vgrid.poly (fitted when the grid is "
            "built) or eos.fit_rows of it")
    return fit


def poly_rho(T, S_msu, fit: PolyFit, want_drhodt: bool = False,
             want_drhods: bool = False):
    """Evaluate the per-level cubic fit (state_mod.F90:600-662); T is
    potential temperature (the model's prognostic temperature), S in msu;
    T and S (n, ny, nx) for a fit of n levels (or of one, broadcast)."""
    c = fit.coeffs
    tq = T - fit.tref
    sq = S_msu - fit.sref - 0.035
    rho = ((c[0] + (c[3] + c[6] * sq) * sq
            + (c[2] + c[7] * sq + c[5] * tq) * tq) * tq
           + (c[1] + (c[4] + c[8] * sq) * sq) * sq
           + fit.sigref * 1.0e-3 + 1.0)
    out = [rho]
    if want_drhodt:
        out.append(c[0] + (c[3] + c[6] * sq) * sq
                   + (2.0 * c[2] + 2.0 * c[7] * sq + 3.0 * c[5] * tq) * tq)
    if want_drhods:
        out.append((c[3] + 2.0 * c[6] * sq + c[7] * tq) * tq + c[1]
                   + (2.0 * c[4] + 3.0 * c[8] * sq) * sq)
    return tuple(out) if len(out) > 1 else out[0]
