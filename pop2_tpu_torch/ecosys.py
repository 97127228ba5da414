"""Native marine-ecosystem (BGC) tracer package.

Reference: the reference couples to the external MARBL library
(``source/ecosys_driver.F90`` holds the interface instances and repacks POP
columns for MARBL; ``Externals_POP.cfg:9-14`` pins marbl0.43.0), whose core
is the BEC model of Moore et al. (2004). This is the JAX package's
rebuild of that BEC-class ecosystem, term for term: three phytoplankton
functional types (small phyto with implicit calcifiers, diatoms,
diazotrophs) + one adaptive zooplankton, nutrient/light co-limitation with
dynamic Chl (Geider-style photoacclimation), Holling-III grazing,
particulate export with depth-resolved remineralization, nitrification,
CaCO3 and opal cycles, dissolved organic matter (with the refractory
pools), variable P:C and Fe:C quotas, water-column denitrification, an
explicit Fe-binding ligand, oxygen, sediment burial, and air-sea O2/CO2
exchange through the carbonate solver (``co2calc``) for DIC and the
alternative-CO2 pair: the 32 tracers of marbl0.43.0's default settings
(ecosys_driver.F90:107 tracer_cnt).

Every process is a whole-field (km, ny, nx) expression in plain PyTorch on
the tracers' device. The two pieces sequential in k are the light field's
cumulative attenuation (a ``cumsum`` over levels) and the sinking-particle
remineralization (``_sink_remin``, a loop down the levels over all columns
at once, five sweeps a step: POC, CaCO3, Si, Fe and P).

Units: mmol m^-3 for C/N/P/Si/O2 (Fe and ligand in nmol m^-3-scale units
chosen so half-saturations are O(1)); Chl in mg m^-3; ALK in meq m^-3.
Fluxes (STF) in [tracer] * cm/s, matching the framework convention.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pop2_tpu_torch import co2calc
from pop2_tpu_torch import constants as const
from pop2_tpu_torch.abio_dic import schmidt_co2
from pop2_tpu_torch.passive_tracers import TracerPackage

SPD = 86400.0  # seconds per day

# -- stoichiometry (Moore et al. 2004 Table 1; MARBL marbl_parms) -----------
Q_N_C = 16.0 / 117.0          # mol N per mol C (Redfield 117:16:1)
Q_P_C = 1.0 / 117.0
Q_FE_C_SP = 6.0e-3            # nmol Fe per mmol C (=6 umol/mol)
Q_FE_C_DIAT = 6.0e-3
Q_FE_C_DIAZ = 42.0e-3         # diazotrophs are Fe-hungry
# variable Fe:C (MARBL gQfe): the uptake quota declines from gQfe_0
# toward gQfe_min under iron limitation
GQFE_0 = {"sp": Q_FE_C_SP, "diat": Q_FE_C_DIAT, "diaz": Q_FE_C_DIAZ}
GQFE_MIN = {"sp": 2.5e-3, "diat": 2.5e-3, "diaz": 14.0e-3}
# sediment burial (Dunne et al. 2007 burial efficiency for POC/POP;
# MARBL caco3_bury_thres fixed-depth lysocline; constant deep opal burial)
CACO3_BURY_THRES = 3000.0e2   # cm: CaCO3 hitting shallower floors buried
SI_BURY_FRAC = 0.03
FLUX_TO_MMOL_M2_DAY = 864.0   # (mmol/m^3/s * cm) -> mmol/m^2/day
Q_SI_C = 0.137                # diatom Si:C
O2_PER_C = 170.0 / 117.0      # photosynthetic quotient
CACO3_FRAC = 0.07             # fraction of sp production calcified

# -- growth -------------------------------------------------------------------
PC_REF = {"sp": 3.0, "diat": 3.0, "diaz": 0.4}    # 1/day max C-spec growth
Q10 = 1.7
TREF = 30.0                   # degC for the Q10 function
ALPHA_PI = 0.3                # mmolC m^2 / (mgChl W day): PI-curve slope
THETA_N_MAX = {"sp": 2.5, "diat": 4.0, "diaz": 2.5}  # mgChl / mmolN

# half saturations (mmol m^-3; Fe in nmol m^-3)
K_NO3 = {"sp": 0.25, "diat": 0.5}
K_NH4 = {"sp": 0.01, "diat": 0.05}
K_PO4 = {"sp": 0.01, "diat": 0.05, "diaz": 0.02}
K_FE = {"sp": 0.03, "diat": 0.08, "diaz": 0.1}
K_SIO3 = 1.0

# -- losses -------------------------------------------------------------------
MORT = 0.1                    # 1/day linear phyto mortality
AGG_RATE = 0.01               # 1/day/(mmolC/m3) quadratic aggregation -> POC
GRAZE_MAX = {"sp": 3.3, "diat": 3.05, "diaz": 1.2}  # 1/day at Tref
K_GRAZE = 1.05                # mmolC/m3 Holling-III half saturation
GRAZE_EFF = 0.3               # fraction of grazing to zoo biomass
GRAZE_POC = 0.25              # fraction of grazing to sinking POC
GRAZE_DOC = 0.15              # fraction to DOC; remainder respired to DIC
Z_MORT = 0.1                  # 1/day linear zoo mortality -> DOM
Z_MORT2 = 0.4                 # 1/day/(mmolC/m3) quadratic -> POC
DOM_REMIN = 0.01              # 1/day DOC/DON/DOP remineralization
NITRIF_RATE = 0.06            # 1/day NH4 -> NO3 below the photic threshold
PAR_NITRIF = 1.0              # W/m2: nitrification light inhibition
FE_SCAVENGE = 0.12 / 365.0    # 1/day ambient Fe scavenging
FE_MAX_SCALE = 3.0            # scavenging enhancement at high Fe
O2_MIN = 4.0                  # mmol/m3 remin O2 half-saturation

# -- light & particles --------------------------------------------------------
PAR_FRAC = 0.45               # fraction of QSW that is PAR
K_W = 0.03e-2                 # 1/cm water attenuation (0.03 1/m)
K_CHL = 0.0073e-2             # 1/cm per mgChl/m3
POC_LENGTH = 13000.0          # cm remin length for POC (130 m)
CACO3_LENGTH = 60000.0        # cm
SI_LENGTH = 22000.0           # cm

# -- air-sea exchange ---------------------------------------------------------
XKW_COEFF = 6.97e-9           # s/cm (0.251 cm/hr per (m/s)^2)
#: O2 Schmidt number polynomial (Wanninkhof 2014)
SCHMIDT_O2 = (1920.4, -135.6, 5.2122, -0.10939, 0.00093777)
#: O2 saturation, Garcia & Gordon (1992) combined-fit coefficients
GG_A = (5.80871, 3.20291, 4.17887, 5.10006, -9.86643e-2, 3.80369)
GG_B = (-7.01577e-3, -7.70028e-3, -1.13864e-2, -9.51519e-3)
GG_C = -2.75915e-7

# -- MARBL-parity extensions --------------------------------------------------
# variable P:C quota (MARBL PquotaSlope model): uptake quota
#   gQp = clip(PQ_INT + PQ_SLOPE * PO4, PQ_MIN, PQ_MAX)   [mmolP/mmolC]
PQ_INT = 5.571e-3
PQ_SLOPE = 7.0e-3             # per (mmol PO4 / m^3)
PQ_MIN = 1.0 / 250.0
PQ_MAX = 1.0 / 59.0
# water-column denitrification: below-O2 remineralization consumes NO3 at
# the canonical 136:16 C:N (MARBL denitrif stoichiometry)
DENITRIF_C_N = 136.0 / 16.0   # mmol C per mmol NO3
K_NO3_DENIT = 1.0             # mmol/m^3 NO3 half-saturation of denitrif
# refractory DOM: a small share of DOM production, centuries-scale remin
DOCR_FRAC = 0.02
DOCR_REMIN = 1.0 / (16000.0 * 365.0)   # 1/day (MARBL ~16 kyr lifetime)
# explicit Fe-binding ligand (nmol-scale units, same as Fe)
LIG_PER_C = 5.0e-5            # ligand production per C remineralized
LIG_PHOTODEG = 0.02           # 1/day at PAR_LIG reference irradiance
PAR_LIG = 50.0                # W/m^2
FE_FREE_SCAV = 30.0 / 365.0   # 1/day scavenging of ligand-free Fe

TRACER_NAMES = (
    "PO4", "NO3", "SiO3", "NH4", "Fe", "Lig", "O2",
    "DIC", "DIC_ALT_CO2", "ALK", "ALK_ALT_CO2",
    "DOC", "DON", "DOP", "DOCr", "DONr", "DOPr",
    "spC", "spChl", "spFe", "spP", "spCaCO3",
    "diatC", "diatChl", "diatFe", "diatP", "diatSi",
    "diazC", "diazChl", "diazFe", "diazP",
    "zooC",
)
IDX = {n: i for i, n in enumerate(TRACER_NAMES)}


def o2_saturation(sst, sss):
    """O2 saturation concentration (mmol/m^3), Garcia & Gordon (1992)."""
    ts = torch.log((298.15 - sst) / (273.15 + sst))
    a = GG_A
    b = GG_B
    lnc = (a[0] + ts * (a[1] + ts * (a[2] + ts * (a[3] + ts * (a[4]
           + ts * a[5]))))
           + sss * (b[0] + ts * (b[1] + ts * (b[2] + ts * b[3])))
           + GG_C * sss ** 2)
    return torch.exp(lnc) * 44.661  # ml/l -> mmol/m^3


def schmidt_o2(sst):
    a, b, c, d, e = SCHMIDT_O2
    t = torch.clamp(sst, -2.0, 40.0)
    return a + t * (b + t * (c + t * (d + t * e)))


def _floor(x, lo: float = 1.0e-10):
    return torch.clamp(x, min=lo)


def _sink_remin(prod, dz3, kmt_mask, at_bottom, length, bury=None):
    """Depth-resolved remineralization of instantaneously-sinking particles,
    a loop down the levels over every column at once (the JAX package's
    downward ``lax.scan``):
      F_bot(k) = [F_top(k) + prod_k dz_k] * exp(-dz_k/length)
      remin_k  = (all flux lost in cell k) / dz_k
    The flux reaching the ocean floor is remineralized in the bottom cell
    minus the buried share ``bury``:
      None        — no burial (mass-conserving water column)
      "dunne"     — Dunne et al. (2007) burial efficiency
                    BE = 0.013 + 0.53 F^2/(7+F)^2, F in mmol m^-2 d^-1
                    (MARBL's POC burial coefficient)
      (ny, nx) tensor or scalar — a fixed burial fraction field
    Buried mass leaves the ocean, as MARBL's sediment interface does.

    prod: (km, ny, nx) production rate (mmol/m^3/s); dz3: (km, 1, 1) layer
    thickness; kmt_mask, at_bottom: (km, ny, nx) ocean cells and each
    column's bottom cell. Returns (remin (km, ny, nx), burial_flux (ny, nx)
    in mmol/m^3/s*cm)."""
    decay = torch.exp(-dz3 / length)
    f_top = torch.zeros_like(prod[0])
    buried = torch.zeros_like(prod[0])
    remin = []
    for k in range(prod.shape[0]):
        dz_k, mask_k, bot_k = dz3[k], kmt_mask[k], at_bottom[k]
        f_avail = f_top + prod[k] * dz_k
        if bury is None:
            bfrac = 0.0
        elif isinstance(bury, str) and bury == "dunne":
            fday = f_avail * FLUX_TO_MMOL_M2_DAY
            bfrac = 0.013 + 0.53 * fday ** 2 / (7.0 + fday) ** 2
        else:
            bfrac = bury
        bflux = torch.where(bot_k, f_avail * bfrac, 0.0) * mask_k
        f_bot = f_avail * decay[k]
        # the bottom cell absorbs the non-buried remainder; land passes
        # nothing
        f_bot = torch.where(bot_k, 0.0, f_bot) * mask_k
        remin.append(torch.where(mask_k, (f_avail - f_bot - bflux) / dz_k,
                                 0.0))
        f_top, buried = f_bot, buried + bflux
    return torch.stack(remin), buried


class PhytoRates(NamedTuple):
    photo_c: torch.Tensor    # C fixation (mmolC/m^3/s)
    no3_up: torch.Tensor     # NO3 uptake (mmolN/m^3/s)
    nh4_up: torch.Tensor
    graze: torch.Tensor      # grazing loss of C
    loss: torch.Tensor       # linear mortality loss of C
    agg: torch.Tensor        # aggregation loss of C -> POC
    photo_chl: torch.Tensor  # Chl synthesis (mgChl/m^3/s)
    qfe: torch.Tensor        # variable Fe:C uptake quota (nmol/mmolC)


class Ecosystem(TracerPackage):
    """BEC-class ecosystem package (MARBL-lite), the JAX package's."""

    names = TRACER_NAMES

    def __init__(self, fe_dust_flux: float = 1.0e-8,
                 pco2_atm: float = 284.7,
                 pco2_atm_alt: float = 284.7,
                 lburial: bool = True):
        #: surface iron deposition (nmol/m^3 * cm/s STF units)
        self.fe_dust_flux = fe_dust_flux
        self.pco2_atm = pco2_atm
        #: atmospheric pCO2 seen by the ALT_CO2 pair (e.g. held
        #: preindustrial to diagnose anthropogenic carbon, MARBL lecovars)
        self.pco2_atm_alt = pco2_atm_alt
        #: sediment burial at the sea floor (MARBL parity); False keeps a
        #: strictly mass-conserving water column
        self.lburial = lburial

    # -- initial condition ---------------------------------------------------
    def init_values(self, cfg, grid):
        # profiles in depth, masked into (n, km, ny, nx) in one pass at the
        # end (the JAX package fills the full arrays level by level: the
        # same values)
        v = np.zeros((len(self.names), cfg.km, 1, 1))
        zt = grid.vgrid.zt.cpu().numpy()[:, None, None] * 0.01  # m
        deep = 1.0 - np.exp(-zt / 800.0)
        v[IDX["PO4"]] = 0.5 + 2.0 * deep
        v[IDX["NO3"]] = 5.0 + 25.0 * deep
        v[IDX["SiO3"]] = 10.0 + 80.0 * deep
        v[IDX["NH4"]] = 0.01
        v[IDX["Fe"]] = 0.1 + 0.5 * deep        # nmol/m^3-scale units
        v[IDX["O2"]] = 250.0 - 100.0 * np.exp(-((zt - 800.0) / 600.0) ** 2)
        v[IDX["DIC"]] = 2000.0 + 300.0 * deep
        v[IDX["ALK"]] = 2300.0 + 100.0 * deep
        v[IDX["DOC"]] = 40.0 * np.exp(-zt / 300.0)
        v[IDX["DON"]] = Q_N_C * v[IDX["DOC"]]
        v[IDX["DOP"]] = Q_P_C * v[IDX["DOC"]]
        v[IDX["DOCr"]] = 16.0          # refractory background (deep DOC)
        v[IDX["DONr"]] = 1.8
        v[IDX["DOPr"]] = 0.03
        v[IDX["Lig"]] = 0.5 + 0.5 * deep  # nmol-scale, ~Fe magnitude
        v[IDX["DIC_ALT_CO2"]] = v[IDX["DIC"]]
        v[IDX["ALK_ALT_CO2"]] = v[IDX["ALK"]]
        photic = np.exp(-zt / 100.0)
        for p, q in (("sp", Q_FE_C_SP), ("diat", Q_FE_C_DIAT),
                     ("diaz", Q_FE_C_DIAZ)):
            c0 = 0.3 if p != "diaz" else 0.03
            v[IDX[p + "C"]] = c0 * photic
            v[IDX[p + "Chl"]] = (THETA_N_MAX[p] * 0.5 * Q_N_C
                                 * v[IDX[p + "C"]])
            v[IDX[p + "Fe"]] = q * v[IDX[p + "C"]]
            v[IDX[p + "P"]] = Q_P_C * v[IDX[p + "C"]]
        v[IDX["diatSi"]] = Q_SI_C * v[IDX["diatC"]]
        v[IDX["spCaCO3"]] = 0.03 * photic
        v[IDX["zooC"]] = 0.1 * photic
        return v * grid.kmask_t.cpu().numpy()[None]

    # -- interior sources ------------------------------------------------------
    def set_interior(self, cfg, grid, tracers_old, tracers_cur,
                     forcing=None):
        km = cfg.km
        s0 = self.slot0
        eco = tracers_cur[s0:s0 + len(self.names)]
        t = {n: torch.clamp(eco[i], min=0.0) for n, i in IDX.items()}
        temp = tracers_cur[0]
        mask = grid.kmask_t
        dz3 = grid.vgrid.dz.reshape(km, 1, 1)
        kidx = torch.arange(1, km + 1, dtype=grid.KMT.dtype,
                            device=temp.device).reshape(km, 1, 1)
        at_bottom = kidx == grid.KMT[None]

        tfunc = Q10 ** ((temp - TREF) / 10.0)

        # ---- light: PAR at layer centers ---------------------------------
        qsw = (forcing.shf_qsw if forcing is not None
               and forcing.shf_qsw is not None
               else torch.zeros_like(temp[0]))
        qsw = qsw / const.HFLUX_FACTOR  # degC cm/s (STF units) -> W/m^2
        chl_tot = t["spChl"] + t["diatChl"] + t["diazChl"]
        katt = (K_W + K_CHL * chl_tot) * dz3
        att_above = torch.cat([torch.zeros_like(katt[:1]),
                               torch.cumsum(katt, dim=0)[:-1]], dim=0)
        par = (PAR_FRAC * torch.clamp(qsw, min=0.0)[None]
               * torch.exp(-(att_above + 0.5 * katt)))

        src = {}

        # ---- per-class growth/loss ----------------------------------------
        def phyto(p):
            c = t[p + "C"]
            chl = t[p + "Chl"]
            theta = chl / _floor(c * Q_N_C)  # mgChl/mmolN
            pc_max = PC_REF[p] / SPD * tfunc
            # nutrient limitation
            if p == "diaz":
                n_lim = torch.ones_like(c)  # N2 fixation
            else:
                w_no3 = (t["NO3"] / K_NO3[p]) / (
                    1.0 + t["NO3"] / K_NO3[p] + t["NH4"] / K_NH4[p])
                w_nh4 = (t["NH4"] / K_NH4[p]) / (
                    1.0 + t["NO3"] / K_NO3[p] + t["NH4"] / K_NH4[p])
                n_lim = w_no3 + w_nh4
            p_lim = t["PO4"] / (t["PO4"] + K_PO4[p])
            fe_lim = t["Fe"] / (t["Fe"] + K_FE[p])
            nut = torch.minimum(torch.minimum(n_lim, p_lim), fe_lim)
            if p == "diat":
                nut = torch.minimum(nut, t["SiO3"] / (t["SiO3"] + K_SIO3))
            # light limitation (Geider PI curve)
            pcm = _floor(pc_max * nut, 1.0e-12)
            theta_c = chl / _floor(c)  # mgChl/mmolC
            l_lim = 1.0 - torch.exp(-ALPHA_PI / SPD * theta_c * par / pcm)
            mu = pc_max * nut * l_lim                # 1/s
            photo_c = mu * c
            # N uptake partitioning
            if p == "diaz":
                no3_up = nh4_up = torch.zeros_like(c)
            else:
                tot = _floor(w_no3 + w_nh4, 1.0e-12)
                no3_up = photo_c * Q_N_C * w_no3 / tot
                nh4_up = photo_c * Q_N_C * w_nh4 / tot
            # photoacclimation: Chl synthesis per N assimilated
            rho_chl = THETA_N_MAX[p] * torch.clamp(
                mu / _floor(ALPHA_PI / SPD * theta * Q_N_C * par
                            / _floor(c * Q_N_C)), max=1.0)
            photo_chl = rho_chl * photo_c * Q_N_C
            # losses
            graze = (GRAZE_MAX[p] / SPD * tfunc * t["zooC"]
                     * c ** 2 / (c ** 2 + K_GRAZE ** 2))
            loss = MORT / SPD * tfunc * c
            agg = AGG_RATE / SPD * c ** 2
            # variable Fe:C uptake quota (MARBL gQfe): declines from
            # gQfe_0 toward gQfe_min under iron limitation
            qfe = GQFE_MIN[p] + (GQFE_0[p] - GQFE_MIN[p]) * fe_lim
            return PhytoRates(photo_c, no3_up, nh4_up, graze, loss, agg,
                              photo_chl, qfe)

        rates = {"sp": phyto("sp"), "diat": phyto("diat"),
                 "diaz": phyto("diaz")}
        fe_q = {p: rates[p].qfe for p in rates}

        tot_photo = sum(r.photo_c for r in rates.values())
        tot_graze = sum(r.graze for r in rates.values())
        tot_loss = sum(r.loss for r in rates.values())
        tot_agg = sum(r.agg for r in rates.values())

        # ---- phytoplankton state updates ----------------------------------
        # variable P:C uptake quota (MARBL PquotaSlope model): P-rich water
        # raises the cellular quota toward PQ_MAX, oligotrophic water drops
        # it toward PQ_MIN
        gqp = torch.clamp(PQ_INT + PQ_SLOPE * t["PO4"], PQ_MIN, PQ_MAX)
        qp = {}
        for p, r in rates.items():
            cinv = 1.0 / _floor(t[p + "C"])
            qp[p] = t[p + "P"] * cinv        # realized quota (mmolP/mmolC)
            losses = r.graze + r.loss + r.agg
            src[p + "C"] = r.photo_c - losses
            # Chl and quota Fe/P follow the C losses proportionally
            src[p + "Chl"] = r.photo_chl - losses * t[p + "Chl"] * cinv
            src[p + "Fe"] = r.photo_c * fe_q[p] - losses * t[p + "Fe"] * cinv
            src[p + "P"] = r.photo_c * gqp - losses * t[p + "P"] * cinv
        diat_losses = (rates["diat"].graze + rates["diat"].loss
                       + rates["diat"].agg)
        src["diatSi"] = (rates["diat"].photo_c * Q_SI_C
                         - diat_losses * t["diatSi"] / _floor(t["diatC"]))
        # CaCO3 formation by small phyto; grazing/mortality routes the
        # shell to sinking CaCO3
        caco3_prod = CACO3_FRAC * rates["sp"].photo_c
        sp_caco3_loss = ((rates["sp"].graze + rates["sp"].loss
                          + rates["sp"].agg)
                         * t["spCaCO3"] / _floor(t["spC"]))
        src["spCaCO3"] = caco3_prod - sp_caco3_loss

        # ---- zooplankton ---------------------------------------------------
        z_loss = Z_MORT / SPD * tfunc * t["zooC"]
        z_loss2 = Z_MORT2 / SPD * t["zooC"] ** 2
        src["zooC"] = GRAZE_EFF * tot_graze - z_loss - z_loss2

        # ---- routing to POM / DOM / inorganic ------------------------------
        poc_prod = (GRAZE_POC * tot_graze + tot_agg + z_loss2
                    + 0.5 * tot_loss)
        doc_prod = GRAZE_DOC * tot_graze + 0.5 * tot_loss + z_loss
        resp = (1.0 - GRAZE_EFF - GRAZE_POC - GRAZE_DOC) * tot_graze

        o2_lim = t["O2"] / (t["O2"] + O2_MIN)
        # burial modes (MARBL sediment interface): Dunne BE for POC/POP,
        # fixed-depth lysocline threshold for CaCO3, constant opal burial
        if self.lburial:
            b_poc = "dunne"
            b_caco3 = (grid.HT < CACO3_BURY_THRES).to(grid.HT.dtype)
            b_si = SI_BURY_FRAC
        else:
            b_poc = b_caco3 = b_si = None
        poc_remin, _ = _sink_remin(poc_prod, dz3, mask, at_bottom,
                                   POC_LENGTH, bury=b_poc)
        caco3_remin, _ = _sink_remin(sp_caco3_loss, dz3, mask, at_bottom,
                                     CACO3_LENGTH, bury=b_caco3)
        si_sink = diat_losses * t["diatSi"] / _floor(t["diatC"])
        si_remin, _ = _sink_remin(si_sink, dz3, mask, at_bottom, SI_LENGTH,
                                  bury=b_si)
        fe_sink = sum((rates[p].graze + rates[p].loss + rates[p].agg)
                      * t[p + "Fe"] / _floor(t[p + "C"])
                      for p in rates)
        fe_remin, _ = _sink_remin(fe_sink, dz3, mask, at_bottom, POC_LENGTH)

        dom_remin = DOM_REMIN / SPD * tfunc * o2_lim
        doc_remin = dom_remin * t["DOC"]
        don_remin = dom_remin * t["DON"]
        dop_remin = dom_remin * t["DOP"]

        # refractory DOM: a small share of DOM production escapes the
        # semilabile pool and remineralizes on a centuries timescale
        # (MARBL's DOCr/DONr/DOPr)
        docr_prod = DOCR_FRAC * doc_prod
        docr_remin = DOCR_REMIN / SPD * t["DOCr"]
        donr_prod = DOCR_FRAC * Q_N_C * doc_prod
        donr_remin = DOCR_REMIN / SPD * t["DONr"]

        src["DOC"] = doc_prod - docr_prod - doc_remin
        src["DOCr"] = docr_prod - docr_remin
        src["DON"] = Q_N_C * doc_prod - donr_prod - don_remin
        src["DONr"] = donr_prod - donr_remin

        # ---- phosphorus routing (variable quotas) --------------------------
        # phyto P losses follow the C routing with each class's realized
        # quota; the zooplankton pool is Redfield, so the quota excess (or
        # deficit) of assimilated grazing exchanges directly with PO4
        resp_frac = 1.0 - GRAZE_EFF - GRAZE_POC - GRAZE_DOC
        sinkp_prod = (sum((GRAZE_POC * rates[p].graze + rates[p].agg
                           + 0.5 * rates[p].loss) * qp[p] for p in rates)
                      + z_loss2 * Q_P_C)
        dop_prod = (sum((GRAZE_DOC * rates[p].graze
                         + 0.5 * rates[p].loss) * qp[p] for p in rates)
                    + z_loss * Q_P_C)
        po4_direct = sum(
            (resp_frac * rates[p].graze) * qp[p]
            + GRAZE_EFF * rates[p].graze * (qp[p] - Q_P_C)
            for p in rates)
        dopr_prod = DOCR_FRAC * dop_prod
        dopr_remin = DOCR_REMIN / SPD * t["DOPr"]
        src["DOP"] = dop_prod - dopr_prod - dop_remin
        src["DOPr"] = dopr_prod - dopr_remin
        p_remin, _ = _sink_remin(sinkp_prod, dz3, mask, at_bottom,
                                 POC_LENGTH,
                                 bury="dunne" if self.lburial else None)

        # ---- nutrients ------------------------------------------------------
        nitrif = torch.where(par < PAR_NITRIF,
                             NITRIF_RATE / SPD * t["NH4"], 0.0)
        remin_c = poc_remin + doc_remin + resp + docr_remin
        # water-column denitrification (MARBL): the remineralization not
        # supported by O2 consumes NO3 at the 136:16 C:N stoichiometry,
        # shutting down as NO3 itself vanishes
        denit_c = (remin_c * (1.0 - o2_lim)
                   * t["NO3"] / (t["NO3"] + K_NO3_DENIT))
        denit_no3 = denit_c / DENITRIF_C_N
        no3_up = sum(r.no3_up for r in rates.values())
        nh4_up = sum(r.nh4_up for r in rates.values())
        src["NH4"] = (Q_N_C * (poc_remin + resp) + don_remin + donr_remin
                      - nh4_up - nitrif)
        src["NO3"] = nitrif - denit_no3 - no3_up
        src["PO4"] = (p_remin + dop_remin + dopr_remin + po4_direct
                      - sum(rates[p].photo_c for p in rates) * gqp)
        src["SiO3"] = si_remin - rates["diat"].photo_c * Q_SI_C
        # dissolved Fe: uptake into quotas, return via sinking-quota remin;
        # scavenging discriminates ligand-bound from free iron (MARBL's
        # explicit Lig tracer replaces the fixed ligand assumption)
        fe_free = torch.clamp(t["Fe"] - t["Lig"], min=0.0)
        fe_bound = t["Fe"] - fe_free
        scav = (FE_SCAVENGE / SPD * fe_bound
                * (1.0 + FE_MAX_SCALE * torch.clamp(t["Fe"], max=2.0) / 2.0)
                + FE_FREE_SCAV / SPD * fe_free)
        src["Fe"] = (fe_remin - scav
                     - sum(rates[p].photo_c * fe_q[p] for p in rates))
        # ligand: produced during remineralization, destroyed by photolysis
        # in the lit surface ocean
        src["Lig"] = (LIG_PER_C * remin_c
                      - LIG_PHOTODEG / SPD * (par / PAR_LIG) * t["Lig"])

        # ---- oxygen / carbon ------------------------------------------------
        # O2 consumption covers the oxic remin share; the anoxic share runs
        # on NO3 (denitrification above)
        src["O2"] = O2_PER_C * (tot_photo - remin_c * o2_lim)
        src["DIC"] = remin_c - tot_photo - caco3_prod + caco3_remin
        src["ALK"] = (no3_up - nh4_up - 2.0 * nitrif + denit_no3
                      - 2.0 * (caco3_prod - caco3_remin))
        # the alternative-CO2 pair sees identical interior sources; only the
        # air-sea boundary condition differs (set_sflux)
        src["DIC_ALT_CO2"] = src["DIC"]
        src["ALK_ALT_CO2"] = src["ALK"]

        out = torch.stack([torch.where(mask, src[n], 0.0)
                           for n in self.names])
        return out.to(cfg.torch_dtype)

    # -- surface fluxes --------------------------------------------------------
    def set_sflux(self, cfg, grid, tracers_old, tracers_cur, forcing=None):
        s0 = self.slot0
        sst = tracers_cur[0, 0]
        sss = tracers_cur[1, 0] * const.SALT_TO_PPT
        mask = grid.RCALCT
        flux = torch.zeros((len(self.names),) + tuple(sst.shape),
                           dtype=cfg.torch_dtype, device=sst.device)

        # iron dust deposition (MARBL reads a dust climatology; constant
        # default here, overridable per package instance)
        flux[IDX["Fe"]] = mask * self.fe_dust_flux

        u10sq = (forcing.u10_sqr if forcing is not None
                 and forcing.u10_sqr is not None else None)
        if u10sq is None:
            return flux
        ifrac = (forcing.ifrac if forcing.ifrac is not None
                 else torch.zeros_like(sst))
        xkw = (1.0 - torch.clamp(ifrac, 0.0, 1.0)) * XKW_COEFF * u10sq

        def surface(name):
            i = s0 + IDX[name]
            return 0.5 * (tracers_old[i, 0] + tracers_cur[i, 0])

        # O2 (mmol/m^3 * cm/s)
        pv_o2 = xkw * torch.sqrt(660.0 / schmidt_o2(sst))
        flux[IDX["O2"]] = mask * pv_o2 * (o2_saturation(sst, sss)
                                          - surface("O2"))

        # CO2 through the carbonate system (abio_dic pattern,
        # source/abio_dic_dic14_mod.F90 + co2calc.F90)
        sst_c = torch.clamp(sst, -2.0, 35.0)
        sss_c = torch.clamp(sss, 4.0, 40.0)
        pv_co2 = xkw * torch.sqrt(660.0 / schmidt_co2(sst))
        # flux = pv * (CO2*_sat - CO2*), CO2*_sat = ff * pCO2_atm
        # (abio_dic_dic14_mod.F90 flux form); mol/kg -> mmol/m^3 via 1.026e6
        ff = co2calc.surface_coeffs(sst_c, sss_c).ff
        # the ALT_CO2 pair exchanges with its own atmosphere (e.g. held
        # preindustrial); everything else identical
        for dic, alk, pco2 in (("DIC", "ALK", self.pco2_atm),
                               ("DIC_ALT_CO2", "ALK_ALT_CO2",
                                self.pco2_atm_alt)):
            res = co2calc.co2calc_surface(
                sst_c, sss_c,
                torch.clamp(surface(dic), 100.0, 4000.0) * 1.0e-6 / 1.026,
                torch.clamp(surface(alk), 100.0, 4000.0) * 1.0e-6 / 1.026)
            dco2star = ff * pco2 * 1.0e-6 - res.co2star
            flux[IDX[dic]] = mask * pv_co2 * dco2star * 1.026e6
        return flux

    def reset(self, cfg, grid, tracer_block):
        """Clip negatives produced by advection under/overshoots (MARBL
        applies the same floor via its tracer-bound enforcement)."""
        return torch.clamp(tracer_block, min=0.0) * grid.kmask_t[None]

    def surface_chl(self, tracer_cur):
        """(ny, nx) surface chlorophyll (mg/m^3): the three classes' Chl at
        the first level."""
        s0 = self.slot0
        return (tracer_cur[s0 + IDX["spChl"], 0]
                + tracer_cur[s0 + IDX["diatChl"], 0]
                + tracer_cur[s0 + IDX["diazChl"], 0])
