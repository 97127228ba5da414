"""CFC-11/CFC-12 and SF6 gas tracer packages.

Reference: ``source/cfc_mod.F90`` (Schmidt numbers :comp_cfc_schmidt,
solubilities :comp_cfc_sol_0 (Warner & Weiss), latitude-blended
atmospheric mole fractions :comp_pcfc, air-sea flux :cfc_set_sflux
STF = PV (Csat - Csurf) with PV = (1-fice) a U10^2 sqrt(660/Sc)) and
``source/sf6_mod.F90`` (same pattern, SF6 coefficients :1073-1180).

The per-hemisphere mole fractions arrive each step through
``Forcing.tracer_atm`` (slot-ordered (nh, sh) pairs); constant package
defaults stand in when it is absent. Without ``Forcing.u10_sqr`` the fluxes
are zero.
"""

from __future__ import annotations

import torch

from pop2_tpu_torch import constants as const
from pop2_tpu_torch.config import ModelConfig
from pop2_tpu_torch.grid import Grid
from pop2_tpu_torch.passive_tracers import TracerPackage

XKW_COEFF = 6.97e-9     # s/cm; a = 0.251 cm/hr (m/s)^-2 (pop_constants:115)
P_1ATM = 1013.25e3      # dyn/cm^2

#: Schmidt polynomial Sc = a + b T + c T^2 + d T^3 + e T^4 (T in degC)
SCHMIDT = {
    "CFC11": (3579.2, -222.63, 7.5749, -0.14595, 0.0011874),
    "CFC12": (3828.1, -249.86, 8.7603, -0.1716, 0.001408),
    "SF6": (3177.5, -200.57, 6.8865, -0.13335, 0.0010877),
}

#: solubility ln(K0) = a1 + a2/Tk + a3 ln(Tk) + a4 Tk^2
#:                    + S (b1 + Tk (b2 + b3 Tk)), Tk = (T+273.16)/100
SOLUBILITY = {
    "CFC11": (-229.9261, 319.6552, 119.4471, -1.39165,
              -0.142382, 0.091459, -0.0157274),
    "CFC12": (-218.0971, 298.9702, 113.8049, -1.39165,
              -0.143566, 0.091015, -0.0153924),
    "SF6": (-96.5975, 139.883, 37.8193, 0.0,
            0.0310693, -0.0356385, 0.00743254),
}


def schmidt_number(name: str, sst):
    a, b, c, d, e = SCHMIDT[name]
    t = torch.clamp(sst, -2.0, 40.0)
    return a + t * (b + t * (c + t * (d + t * e)))


def solubility_0(name: str, sst, sss):
    """Solubility at 1 atm total pressure (mol/l/atm)."""
    a1, a2, a3, a4, b1, b2, b3 = SOLUBILITY[name]
    tk = (sst + const.T0_KELVIN) * 0.01
    return torch.exp(a1 + a2 / tk + a3 * torch.log(tk) + a4 * tk ** 2
                     + sss * (b1 + tk * (b2 + b3 * tk)))


def blend_hemispheres(tlat_deg, nh, sh):
    """SH value south of 10S, NH north of 10N, linear blend between
    (comp_pcfc, cfc_mod.F90)."""
    frac = torch.clamp((tlat_deg + 10.0) * 0.05, 0.0, 1.0)
    return sh + frac * (nh - sh)


class GasTracers(TracerPackage):
    """CFC11+CFC12 (or SF6) with air-sea gas exchange."""

    #: constant atmospheric mole fractions (pmol/mol), (nh, sh) per gas,
    #: used when Forcing.tracer_atm is absent (~1995 values)
    default_atm = {"CFC11": (265.0, 260.0), "CFC12": (530.0, 525.0),
                   "SF6": (3.4, 3.2)}

    def __init__(self, gases=("CFC11", "CFC12")):
        self.names = tuple(gases)

    def set_sflux(self, cfg: ModelConfig, grid: Grid, tracers_old,
                  tracers_cur, forcing=None):
        sst = tracers_cur[0, 0]
        u10sq = forcing.u10_sqr if forcing is not None else None
        if u10sq is None:
            return torch.zeros((len(self.names),) + tuple(sst.shape),
                               dtype=cfg.torch_dtype, device=sst.device)
        sss = tracers_cur[1, 0] * const.SALT_TO_PPT
        tlat_deg = grid.TLAT * const.RADIAN
        ifrac = (forcing.ifrac if forcing.ifrac is not None
                 else torch.zeros_like(sst))
        ifrac = torch.clamp(ifrac, 0.0, 1.0)
        ap = torch.where(forcing.atm_press > 0.0,
                         forcing.atm_press / P_1ATM, 1.0)
        xkw_ice = (1.0 - ifrac) * XKW_COEFF * u10sq

        fluxes = []
        for i, name in enumerate(self.names):
            if forcing.tracer_atm is not None:
                nh, sh = forcing.tracer_atm[i, 0], forcing.tracer_atm[i, 1]
            else:
                nh, sh = self.default_atm[name]
            patm = blend_hemispheres(tlat_deg, nh, sh)
            pv = xkw_ice * torch.sqrt(660.0 / schmidt_number(name, sst))
            csat = ap * solubility_0(name, sst, sss) * patm
            surf = 0.5 * (tracers_old[self.slot0 + i, 0]
                          + tracers_cur[self.slot0 + i, 0])
            fluxes.append(grid.RCALCT * pv * (csat - surf))
        return torch.stack(fluxes).to(cfg.torch_dtype)
