"""Surface carbonate-system chemistry (OCMIP-2).

Reference: ``source/co2calc.F90`` — equilibrium constants (comp_co3_coeffs
/ comp_co3_coeffs_surf: ff (Weiss & Price 1980 fugacity), k0 (Weiss 1974),
k1/k2 (Millero-95 pH_SWS or Lueker pH_tot refits), kb, kw, ks, kf, and
the salinity-proportional borate/sulfate/fluoride totals :319-600) and the
total-alkalinity pH solve (the reference's Newton-safeguarded ``drtsafe``
:1000-1200; here, as in the JAX package, a fixed-count bisection on pH).

The bisection runs its 50 halvings whatever the data: no early exit and no
read of the device, so a step that solves the carbonate system (three
solves: the ecosystem's DIC and DIC_ALT_CO2, the abiotic DIC) stays inside
a captured CUDA graph. Elementwise on the surface plane; plain PyTorch.

Units inside: mol/kg and atm; pH on the chosen scale.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

T0_K = 273.15


class CO3Coeffs(NamedTuple):
    ff: torch.Tensor
    k0: torch.Tensor
    k1: torch.Tensor
    k2: torch.Tensor
    kb: torch.Tensor
    kw: torch.Tensor
    ks: torch.Tensor
    kf: torch.Tensor
    bt: torch.Tensor
    st: torch.Tensor
    ft: torch.Tensor


def surface_coeffs(temp, salt, ph_tot_scale: bool = True) -> CO3Coeffs:
    """Surface (1 atm) equilibrium constants (co2calc.F90:319-600)."""
    s = torch.clamp(salt, 0.0, 45.0)
    tk = temp + T0_K
    tk100 = tk / 100.0
    tk1002 = tk100 * tk100
    invtk = 1.0 / tk
    dlogtk = torch.log(tk)
    s2 = s * s
    sqrts = torch.sqrt(s)
    is_ = 19.924 * s / (1000.0 - 1.005 * s)
    is2 = is_ * is_
    sqrtis = torch.sqrt(is_)
    scl = s / 1.80655
    log_1m = torch.log(1.0 - 0.001005 * s)
    log_cent = math.log(1e-2)

    ff = torch.exp(-162.8301 + 218.2968 / tk100
                   + 90.9241 * (dlogtk + log_cent) - 1.47696 * tk1002
                   + s * (0.025695 - 0.025225 * tk100 + 0.0049867 * tk1002))
    k0 = torch.exp(93.4517 / tk100 - 60.2409
                   + 23.3585 * (dlogtk + log_cent)
                   + s * (0.023517 - 0.023656 * tk100 + 0.0047036 * tk1002))
    if ph_tot_scale:
        k1 = 10.0 ** -(3633.86 * invtk - 61.2172 + 9.67770 * dlogtk
                       - 0.011555 * s + 0.0001152 * s2)
        k2 = 10.0 ** -(471.78 * invtk + 25.9290 - 3.16967 * dlogtk
                       - 0.01781 * s + 0.0001122 * s2)
    else:
        k1 = 10.0 ** -(3670.7 * invtk - 62.008 + 9.7944 * dlogtk
                       - 0.0118 * s + 0.000116 * s2)
        k2 = 10.0 ** -(1394.7 * invtk + 4.777 - 0.0184 * s + 0.000118 * s2)
    kb = torch.exp((-8966.90 - 2890.53 * sqrts - 77.942 * s
                    + 1.728 * s * sqrts - 0.0996 * s2) * invtk
                   + 148.0248 + 137.1942 * sqrts + 1.62142 * s
                   + (-24.4344 - 25.085 * sqrts - 0.2474 * s) * dlogtk
                   + 0.053105 * sqrts * tk)
    kw = torch.exp(-13847.26 * invtk + 148.9652 - 23.6521 * dlogtk
                   + (118.67 * invtk - 5.977 + 1.0495 * dlogtk) * sqrts
                   - 0.01615 * s)
    ks = torch.exp(-4276.1 * invtk + 141.328 - 23.093 * dlogtk
                   + (-13856.0 * invtk + 324.57 - 47.986 * dlogtk) * sqrtis
                   + (35474.0 * invtk - 771.54 + 114.723 * dlogtk) * is_
                   - 2698.0 * invtk * is_ * sqrtis
                   + 1776.0 * invtk * is2 + log_1m)
    st = 0.14 / 96.062 * scl
    kf = torch.exp(1590.2 * invtk - 12.641 + 1.525 * sqrtis + log_1m
                   + torch.log(1.0 + st / ks))
    bt = 0.000232 / 10.811 * scl
    ft = 0.000067 / 18.9984 * scl
    return CO3Coeffs(ff=ff, k0=k0, k1=k1, k2=k2, kb=kb, kw=kw, ks=ks,
                     kf=kf, bt=bt, st=st, ft=ft)


def _ta_of_h(h, dic, c: CO3Coeffs, pt, sit):
    """Total alkalinity as a function of [H+] (the reference's ta_iter
    function; the nutrient terms are not taken, as in the JAX package)."""
    h2 = h * h
    denom = h2 + c.k1 * h + c.k1 * c.k2
    hco3 = dic * c.k1 * h / denom
    co3 = dic * c.k1 * c.k2 / denom
    boh4 = c.bt / (1.0 + h / c.kb)
    oh = c.kw / h
    hfree = h / (1.0 + c.st / c.ks)
    hso4 = c.st / (1.0 + c.ks / hfree)
    hf = c.ft / (1.0 + c.kf / hfree)
    return hco3 + 2.0 * co3 + boh4 + oh - hfree - hso4 - hf


class CO2Result(NamedTuple):
    ph: torch.Tensor
    h: torch.Tensor
    co2star: torch.Tensor    # [CO2*] (mol/kg)
    pco2: torch.Tensor       # fugacity-corrected pCO2 (uatm)
    co3: torch.Tensor        # carbonate ion (mol/kg)


def co2calc_surface(temp, salt, dic, ta, pt=0.0, sit=0.0,
                    phlo: float = 6.0, phhi: float = 10.0,
                    iters: int = 50) -> CO2Result:
    """Solve the surface carbonate system for [H+] by fixed-count
    bisection on pH; dic/ta in mol/kg. Returns pH, CO2*, pCO2 (uatm)."""
    c = surface_coeffs(temp, salt)
    lo = torch.full_like(temp, phlo)
    hi = torch.full_like(lo, phhi)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        resid = _ta_of_h(10.0 ** -mid, dic, c, pt, sit) - ta
        # TA(h) decreases with h (increases with pH): a residual above zero
        # means the pH is too high
        high = resid > 0.0
        hi = torch.where(high, mid, hi)
        lo = torch.where(high, lo, mid)
    ph = 0.5 * (lo + hi)
    h = 10.0 ** -ph
    denom = h * h + c.k1 * h + c.k1 * c.k2
    co2star = dic * h * h / denom
    co3 = dic * c.k1 * c.k2 / denom
    pco2 = co2star / c.ff * 1.0e6
    return CO2Result(ph=ph, h=h, co2star=co2star, pco2=pco2, co3=co3)
