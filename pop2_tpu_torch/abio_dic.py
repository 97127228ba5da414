"""Abiotic DIC / DIC14 tracers with air-sea CO2 exchange.

Reference: ``source/abio_dic_dic14_mod.F90`` — abiotic dissolved inorganic
carbon (and radiocarbon) with OCMIP-style gas exchange: the carbonate
system (``co2calc``) gives surface [CO2*]; the flux is
PV * (CO2*_sat - CO2*) with piston velocity a U10^2 sqrt(660/Sc_CO2)
(xkw_coeff, Wanninkhof 2014) scaled by the open-water fraction; DIC14
decays with the 8267-yr radiocarbon e-folding time and exchanges with a
prescribed atmospheric Delta14C. Alkalinity is the reference's
salinity-proportional approximation (ALK = alk_bar * S / S_bar).

Tracer units: mol/m^3 (converted to mol/kg inside co2calc via the mean
density), fluxes in mol/m^3 * cm/s (STF convention). Plain PyTorch on the
tracers' device.
"""

from __future__ import annotations

import numpy as np
import torch

from pop2_tpu_torch import constants as const
from pop2_tpu_torch.co2calc import co2calc_surface, surface_coeffs
from pop2_tpu_torch.passive_tracers import TracerPackage

XKW_COEFF = 6.97e-9            # s/cm (pop_constants:115)
RHO_KGL = 1.026                # mean surface density (kg/l) for unit conv
C14_LAMBDA = 1.0 / (8267.0 * 365.0 * 86400.0)   # 1/s

#: Schmidt number polynomial for CO2 (Wanninkhof 2014)
SC_CO2 = (2116.8, -136.25, 4.7353, -0.092307, 0.0007555)

ALK_BAR = 2310.0e-6            # mol/kg at the reference salinity
S_BAR = 35.0


def schmidt_co2(sst):
    a, b, c, d, e = SC_CO2
    t = torch.clamp(sst, -2.0, 40.0)
    return a + t * (b + t * (c + t * (d + t * e)))


class AbioDIC(TracerPackage):
    """ABIO_DIC (+ABIO_DIC14) package (abio_dic_dic14_mod.F90)."""

    names = ("ABIO_DIC", "ABIO_DIC14")

    def __init__(self, pco2_atm: float = 284.7, d14c_atm: float = 0.0,
                 dic_init: float = 2.0):
        self.pco2_atm = pco2_atm     # uatm
        self.d14c_atm = d14c_atm     # permil
        self.dic_init = dic_init     # mol/m^3

    def init_values(self, cfg, grid):
        v = np.full((2, cfg.km, cfg.ny, cfg.nx), self.dic_init)
        return v * grid.kmask_t.cpu().numpy()[None]

    def set_sflux(self, cfg, grid, tracers_old, tracers_cur, forcing=None):
        sst = tracers_cur[0, 0]
        if forcing is None or forcing.u10_sqr is None:
            return torch.zeros((2,) + tuple(sst.shape),
                               dtype=cfg.torch_dtype, device=sst.device)
        sss_psu = tracers_cur[1, 0] * const.SALT_TO_PPT
        ifrac = (torch.clamp(forcing.ifrac, 0.0, 1.0)
                 if forcing.ifrac is not None else torch.zeros_like(sst))
        s0 = self.slot0
        dic = 0.5 * (tracers_old[s0, 0] + tracers_cur[s0, 0])   # mol/m^3
        dic14 = 0.5 * (tracers_old[s0 + 1, 0] + tracers_cur[s0 + 1, 0])

        dic_molkg = dic / (RHO_KGL * 1000.0)
        ta_molkg = ALK_BAR * sss_psu / S_BAR
        res = co2calc_surface(sst, sss_psu, dic_molkg, ta_molkg)
        co2star = res.co2star * RHO_KGL * 1000.0        # mol/m^3

        c = surface_coeffs(sst, sss_psu)
        co2star_sat = c.ff * (self.pco2_atm * 1.0e-6) * RHO_KGL * 1000.0

        pv = (XKW_COEFF * forcing.u10_sqr * (1.0 - ifrac)
              * torch.sqrt(660.0 / schmidt_co2(sst)))   # cm/s
        mask = grid.RCALCT
        flux_dic = mask * pv * (co2star_sat - co2star)

        # DIC14: exchange toward the atmospheric 14C/12C ratio
        # (abio_dic_dic14_mod; ratio-weighted saturation)
        r_atm = 1.0 + self.d14c_atm / 1000.0
        r_ocn = dic14 / torch.clamp(dic, min=1.0e-12)
        flux_dic14 = mask * pv * (co2star_sat * r_atm - co2star * r_ocn)
        return torch.stack([flux_dic, flux_dic14]).to(cfg.torch_dtype)

    def set_interior(self, cfg, grid, tracers_old, tracers_cur,
                     forcing=None):
        """Radioactive decay of DIC14 (no source for DIC)."""
        s0 = self.slot0
        zero = torch.zeros_like(tracers_cur[s0])
        decay = torch.where(grid.kmask_t, -C14_LAMBDA * tracers_cur[s0 + 1],
                            0.0)
        return torch.stack([zero, decay]).to(cfg.torch_dtype)
