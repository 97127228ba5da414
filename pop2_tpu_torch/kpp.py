"""KPP vertical mixing (Large, McWilliams & Doney 1994), plain PyTorch.

Reference: ``source/vmix_kpp.F90`` (native POP path):
  * buoydiff       :3509   buoyancy differences (surface-layer-averaged ref)
  * ri_iwmix       :1428   shear instability + background + tidal mixing
  * ddmix          :3349   double diffusion (salt fingering, diffusive
                           convection)
  * bldepth        :2002   boundary-layer depth from the bulk Richardson
                           number, with the Ekman / Monin-Obukhov limits
  * wscale         :3234   Monin-Obukhov similarity velocity scales
  * blmix          :2767   boundary-layer profile, interior matching, ghat
  * smooth_hblt    :3699   1-1-4-1-1 spatial filter of HBLT
  * KPP_SRC        :1277   non-local transport as a tracer source

The reference's level loops become whole-column tensor expressions. Its
searches down the column (the first level whose bulk Richardson number
passes the critical one, the Ekman and Monin-Obukhov limits, the last ocean
level's value carried down) are first- or last-crossing searches over
fields computed at every level at once, and the picks at a column's
boundary-layer level are ``torch.gather`` along the level axis. The
surface-layer reference density of every target level is one batched
equation-of-state call over the (target, source) level pairs the grid
needs, contracted with the pair weights built once on the host.

Interface-indexed arrays (VISC/VDC) have shape (km+2, ny, nx) with index k
the reference's 0:km+1 (k = the interface below layer k). The tidal
diffusivity (``ri_iwmix``) takes the Jayne, Schmittner or Polzin method
(``tidal_mixing``), the Southern-Ocean floor and the lunar factor; the
near-inertial wave mixing (``blke``, ``niw_energy``, ``niw_mix``,
niw_mixing.F90) deposits its diffusivity below the boundary layer between
``bldepth`` and ``blmix``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from pop2_tpu_torch import constants as const
from pop2_tpu_torch import eos, sw_absorption, tidal_mixing
from pop2_tpu_torch.config import ModelConfig
from pop2_tpu_torch.grid import Grid, thickness_t
from pop2_tpu_torch.stencil import BC, tgrid_to_ugrid, ugrid_to_tgrid

VONKAR = 0.4
EPS = 1.0e-10
EPS2 = 1.0e-20

# velocity-scale fit constants (source/vmix_kpp.F90:188-194)
ZETA_M = -0.2
ZETA_S = -1.0
C_M = 8.38
C_S = 98.96
A_M = 1.26
A_S = -28.86

EPSSFC = 0.1              # nondimensional surface-layer extent (:109)
RICR = 0.3                # critical bulk Richardson number (:641)
CEKMAN = 0.7              # Ekman depth coefficient (:138)
CMONOB = 1.0              # Monin-Obukhov depth coefficient (:139)
CONCV = 1.7               # min convective factor (:140)
RIINFTY = 0.8             # shear-instability Ri limit (:152)
RRHO0 = 2.55              # double-diffusion density-ratio limit (:162)
DSFMAX = 1.0              # max salt-fingering diffusivity (:163)
CSTAR = 10.0              # nonlocal transport coefficient (:175)

VTC = float(np.sqrt(0.2 / C_S / EPSSFC)) / VONKAR ** 2   # (:458)
CG = CSTAR * VONKAR * (C_S * VONKAR * EPSSFC) ** (1.0 / 3.0)  # (:459)


class KPPStatics(NamedTuple):
    """Grid-dependent constants of the KPP pipeline, built once."""
    bckgrnd_vdc: torch.Tensor   # background diffusivity, (km,1,1) or
    bckgrnd_vvc: torch.Tensor   # (1,ny,nx) (kpp_lhoriz_varying_bckgrnd)
    uref_w: torch.Tensor        # (km, km) surface-layer averaging weights
    pair_k: torch.Tensor        # (P,) target level of each (k, m) pair
    pair_m: torch.Tensor        # (P,) source level
    pair_w: torch.Tensor        # (km, P) weights: RHOAVG_k = W @ rho_p
    tidal_coef: Optional[torch.Tensor] = None  # (km, ny, nx) Jayne or
    #                                            Schmittner coefficient
    tidal_socn: Optional[torch.Tensor] = None   # (km, ny, nx) SO floor
    tidal_polzin: Optional[tidal_mixing.PolzinStatics] = None
    niw_energy: Optional[torch.Tensor] = None   # (ny, nx) NIW flux from a
    #                                             file (erg/s/cm^2)


class KPPOut(NamedTuple):
    vdc: torch.Tensor      # (2, km, ny, nx) tracer diffusivities (T, S)
    vvc: torch.Tensor      # (km, ny, nx) viscosity on U points
    ghat_src: torch.Tensor  # (2, km, ny, nx) class VDC*GHAT for KPP_SRC
    hblt: torch.Tensor     # (ny, nx) boundary-layer depth (cm)
    kbl: torch.Tensor      # (ny, nx) int32, first level below hbl
    hmxl: torch.Tensor     # (ny, nx) diagnostic mixed-layer depth
    # interior-mixing diagnostics of the KVMIX/KVMIX_M/TPOWER/HMXL_DR tavg
    # fields (vmix_kpp.F90:1826-1868, 1947-1950, 1385-1417); tpower only
    # with the mixing-time density
    kvmix: Optional[torch.Tensor] = None     # (km, ny, nx)
    kvmix_m: Optional[torch.Tensor] = None   # (km, ny, nx)
    tpower: Optional[torch.Tensor] = None    # (km, ny, nx) erg/s/cm^3
    hmxl_dr: Optional[torch.Tensor] = None   # (ny, nx)


def _np(t) -> np.ndarray:
    return t.detach().double().cpu().numpy()


def _kidx(km: int, device):
    """1-based level index, (km, 1, 1) int32."""
    return torch.arange(1, km + 1, device=device,
                        dtype=torch.int32).reshape(km, 1, 1)


def _col(v):
    """A (n,) level vector as (n, 1, 1)."""
    return v.reshape(-1, 1, 1)


def background_vdc(cfg: ModelConfig, grid: Grid) -> np.ndarray:
    """Background internal-wave diffusivity (source/vmix_kpp.F90:544-632),
    NumPy, broadcastable to (km, ny, nx).

    Default: the vertical atan profile vdc1 + vdc2 atan(linv (zw - dpth)),
    shape (km, 1, 1). With ``kpp_lhoriz_varying_bckgrnd`` (the gx production
    default): the depth-independent Jochum (2009) latitude structure, the
    Gregg equatorial floor plus MacKinnon PSI gaussians at +-28.9 degrees
    plus a latitude-ramped vdc1, with the Banda Sea boxes set to
    ``bckgrnd_vdc_ban`` (:551-590); shape (1, ny, nx)."""
    zw = _np(grid.vgrid.zw)
    vdc1, vdc2 = cfg.bckgrnd_vdc, cfg.bckgrnd_vdc2
    if not cfg.kpp_lhoriz_varying_bckgrnd:
        dpth, linv = cfg.bckgrnd_vdc_dpth, cfg.bckgrnd_vdc_linv
        prof = vdc1 + vdc2 * np.arctan(linv * (zw - dpth))
        return prof[:, None, None]
    if vdc2 != 0.0:
        raise ValueError("lhoriz_varying_bckgrnd requires bckgrnd_vdc2 "
                         "== 0 (vmix_kpp.F90:518-521)")
    latd = _np(grid.TLAT) * const.RADIAN
    lond = _np(grid.TLON) * const.RADIAN
    lond = np.where(lond < 0.0, lond + 360.0, lond)
    psis = cfg.bckgrnd_vdc_psim * np.exp(-(0.4 * (latd + 28.9)) ** 2)
    psin = cfg.bckgrnd_vdc_psim * np.exp(-(0.4 * (latd - 28.9)) ** 2)
    vdc = cfg.bckgrnd_vdc_eq + psin + psis
    ramp = np.where(np.abs(latd) <= 10.0, (latd / 10.0) ** 2, 1.0)
    vdc = vdc + vdc1 * ramp
    banda = (((latd < -1.0) & (latd > -4.0)
              & (lond > 103.0) & (lond < 134.0))
             | ((latd <= -4.0) & (latd > -7.0)
                & (lond > 106.0) & (lond < 140.0))
             | ((latd <= -7.0) & (latd > -8.3)
                & (lond > 111.0) & (lond < 142.0)))
    vdc = np.where(banda, cfg.bckgrnd_vdc_ban, vdc)
    return vdc[None]


def build_statics(cfg: ModelConfig, grid: Grid) -> KPPStatics:
    """Background profiles, surface-layer weights and the tidal coefficient
    (source/vmix_kpp.F90:530-641, the kref logic of :2324-2349 and
    :3582-3603), on the grid's device in the config's dtype."""
    km = cfg.km
    zt, zw, dz = (_np(getattr(grid.vgrid, n)) for n in ("zt", "zw", "dz"))

    bck_vdc = background_vdc(cfg, grid)
    bck_vvc = cfg.prandtl * bck_vdc

    # surface-layer averaging weights of each target level
    uref_w = np.zeros((km, km))
    uref_w[0, 0] = 1.0
    pair_k, pair_m, weights = [], [], []
    for kl in range(1, km):  # 0-based target level
        surfthick = EPSSFC * zt[kl]
        kref = kl
        for ktmp in range(kl + 1):
            if zw[ktmp] >= surfthick:
                kref = ktmp
                break
        if kref == 0:
            uref_w[kl, 0] = 1.0
            pair_k.append(kl)
            pair_m.append(0)
            weights.append((kl, len(pair_k) - 1, 1.0))
        else:
            w_last = (surfthick - zw[kref - 1]) / surfthick
            uref_w[kl, kref] = w_last
            pair_k.append(kl)
            pair_m.append(kref)
            weights.append((kl, len(pair_k) - 1, w_last))
            for m in range(kref):
                uref_w[kl, m] = dz[m] / surfthick
                pair_k.append(kl)
                pair_m.append(m)
                weights.append((kl, len(pair_k) - 1, dz[m] / surfthick))
    pw = np.zeros((km, len(pair_k)))
    for krow, pcol, w in weights:
        pw[krow, pcol] = w

    dev, dt = grid.KMT.device, cfg.torch_dtype

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=dev,
                                                           dtype=dt)

    tidal = cfg.ltidal_mixing
    return KPPStatics(
        bckgrnd_vdc=t(bck_vdc), bckgrnd_vvc=t(bck_vvc), uref_w=t(uref_w),
        pair_k=torch.as_tensor(pair_k, dtype=torch.long, device=dev),
        pair_m=torch.as_tensor(pair_m, dtype=torch.long, device=dev),
        pair_w=t(pw), tidal_coef=_tidal_coef_field(cfg, grid, t),
        tidal_socn=(t(tidal_mixing.schmittner_socn_floor(cfg, grid))
                    if tidal and cfg.ltidal_schmittner_socn else None),
        tidal_polzin=(tidal_mixing.polzin_statics(cfg, grid)
                      if tidal and cfg.tidal_mixing_method == "polzin"
                      else None),
        niw_energy=_niw_energy_field(cfg, t))


def _tidal_coef_field(cfg, grid, to_tensor):
    """The static tidal coefficient of the method: Jayne's F(z) profile or
    Schmittner's sum over deeper levels; None without tidal mixing or under
    Polzin (whose profile is the step's)."""
    method = cfg.tidal_mixing_method
    if not cfg.ltidal_mixing or method == "polzin":
        return None
    if method == "schmittner":
        return to_tensor(tidal_mixing.build_tidal_coef_schmittner(cfg, grid))
    if method != "jayne":
        raise ValueError(f"tidal_mixing_method={method!r}")
    return to_tensor(tidal_mixing.build_tidal_coef(cfg, grid))


def _niw_energy_field(cfg, to_tensor):
    """The NIW energy flux of ``niw_energy_file`` (a POP binary record),
    W/m^2 -> erg/s/cm^2 (niw_mixing.F90:361-365); None without a file (the
    constant ``niw_energy_const`` applies)."""
    if not cfg.lniw_mixing or cfg.niw_energy_file is None:
        return None
    raw = np.fromfile(cfg.niw_energy_file, dtype=">f8")
    n = cfg.ny * cfg.nx
    if raw.size < n:
        raise ValueError("niw_energy_file too small")
    return to_tensor(1000.0 * raw[:n].reshape(cfg.ny, cfg.nx))


def _rho_full(T, S, press):
    """Full density with the reference's T >= -2 clamp
    (source/vmix_kpp.F90:3567)."""
    Tc = torch.clamp(T, min=-2.0)
    return eos.mwjf_rho(torch.clamp(Tc, -1000.0, 1000.0),
                        torch.clamp(S, 0.0, 1000.0), press)


def buoydiff(cfg: ModelConfig, grid: Grid, st: KPPStatics, trcr):
    """DBLOC (between adjacent levels) and DBSFC (level against the
    surface-layer average), (km, ny, nx) each
    (source/vmix_kpp.F90:3509-3626)."""
    km = cfg.km
    T, S = trcr[0], trcr[1]
    pz = grid.vgrid.pressz

    # each level's water at its own pressure, and the level above displaced
    # down one level
    rho_k = _rho_full(T, S, _col(pz))
    rho_km_disp = _rho_full(T[:-1], S[:-1], _col(pz[1:]))

    # rho(T_m, S_m, p_k) of every (k, m) pair of the surface-layer averages
    rho_pairs = _rho_full(T[st.pair_m], S[st.pair_m], _col(pz[st.pair_k]))
    rhoavg = torch.tensordot(st.pair_w, rho_pairs, dims=1)

    safe = torch.where(rho_k != 0.0, rho_k, 1.0)
    dbsfc = torch.where(rho_k != 0.0, const.GRAV * (1.0 - rhoavg / safe),
                        0.0)
    dbsfc[0] = 0.0

    dbloc = torch.zeros_like(rho_k)
    dbloc[:-1] = torch.where(
        rho_k[1:] != 0.0, const.GRAV * (1.0 - rho_km_disp / safe[1:]), 0.0)
    # zero at and below the column bottom: dbloc(k-1) = 0 where k-1 >= KMT
    kidx = _kidx(km - 1, T.device)
    dbloc[:-1] = torch.where(kidx >= grid.KMT[None], 0.0, dbloc[:-1])
    return dbloc, dbsfc


def wscale(sigma, hbl, ustar, bfsfc, want="both"):
    """Turbulent velocity scales (source/vmix_kpp.F90:3234-3342). All
    arguments broadcast; returns (wm, ws), either None where not wanted."""
    zetah = sigma * hbl * VONKAR * bfsfc
    zeta = zetah / (ustar ** 3 + EPS)
    wm = ws = None
    stable = VONKAR * ustar / (1.0 + 5.0 * zeta)
    if want in ("m", "both"):
        wm = torch.where(
            zeta >= 0.0, stable,
            torch.where(zeta >= ZETA_M,
                        VONKAR * ustar
                        * torch.clamp(1.0 - 16.0 * zeta, min=0.0) ** 0.25,
                        VONKAR * torch.clamp(A_M * ustar ** 3 - C_M * zetah,
                                             min=0.0) ** (1.0 / 3.0)))
    if want in ("s", "both"):
        ws = torch.where(
            zeta >= 0.0, stable,
            torch.where(zeta >= ZETA_S,
                        VONKAR * ustar
                        * torch.sqrt(torch.clamp(1.0 - 16.0 * zeta,
                                                 min=0.0)),
                        VONKAR * torch.clamp(A_S * ustar ** 3 - C_S * zetah,
                                             min=0.0) ** (1.0 / 3.0)))
    return wm, ws


def _fill_down(field, kmt):
    """Each column's value at its last ocean level carried down below it
    (zero in land columns): the reference's per-level carry
    (source/vmix_kpp.F90:1567)."""
    km = field.shape[0]
    k0 = torch.arange(km, device=field.device).reshape(km, 1, 1)
    idx = torch.clamp(torch.minimum(k0, kmt[None].long() - 1), min=0)
    out = torch.gather(field, 0, idx.expand(field.shape))
    return torch.where(kmt[None] > 0, out, 0.0)


def ri_iwmix(cfg: ModelConfig, grid: Grid, bc: BC, st: KPPStatics,
             dbloc, umix, vmix_, tidal_lnc=None):
    """Interior mixing: background, shear instability and, with
    ``ltidal_mixing``, the tidal diffusivity of the configured method (the
    static coefficient over N^2, or Polzin's profile of the step's N^2),
    raised to the Southern-Ocean floor where that is on and scaled by the
    lunar factor ``tidal_lnc`` (None is 1)
    (source/vmix_kpp.F90:1428-1995). Returns (visc, vdc, kvmix, kvmix_m):
    visc and vdc as (km+2, ny, nx) interface arrays (index k = reference
    k; 0 and km+1 zero padding for blmix), the KVMIX/KVMIX_M diagnostics
    (tidal + background interior diffusivity and viscosity, :1826-1868) as
    (km, ny, nx)."""
    km = cfg.km
    dzw = grid.vgrid.dzw

    du = umix - torch.cat([umix[1:], umix[-1:]])
    dv = vmix_ - torch.cat([vmix_[1:], vmix_[-1:]])
    vshear = ugrid_to_tgrid(du ** 2 + dv ** 2, bc)
    vshear[-1] = 0.0

    ri_loc = dbloc * _col(dzw[1:km + 1]) / (vshear + EPS)
    ri = _fill_down(ri_loc, grid.KMT)

    # 1-2-1 vertical smoothing where KMT >= 3 (:1579-1603)
    smooth_ok = (grid.KMT >= 3)[None]
    for _ in range(cfg.num_v_smooth_ri):
        ri_up = torch.cat([ri[:1], ri[:-1]])
        ri_dn = torch.cat([ri[1:], ri[-1:]])
        ri = torch.where(smooth_ok, 0.25 * ri_up + 0.5 * ri + 0.25 * ri_dn,
                         ri)

    fri = torch.clamp(torch.clamp(ri, min=0.0) / RIINFTY, max=1.0)
    fshear = cfg.rich_mix * (1.0 - fri * fri) ** 3
    shear = fshear if cfg.kpp_lrich else 0.0

    bck_vdc, bck_vvc = st.bckgrnd_vdc, st.bckgrnd_vvc
    ones = torch.ones_like(ri)
    if cfg.ltidal_mixing and (st.tidal_coef is not None
                              or st.tidal_polzin is not None):
        # kappa_tidal capped at tidal_mix_max (vmix_kpp.F90:1773-1835,
        # tidal_compute_diff :3046-3140)
        dzt = thickness_t(cfg, grid)
        dzt_kp1 = torch.cat([dzt[1:], dzt[-1:]])
        n2 = dbloc / (0.5 * (dzt + dzt_kp1))
        lnc = 1.0 if tidal_lnc is None else tidal_lnc
        if st.tidal_polzin is not None:
            tdiff = lnc * tidal_mixing.polzin_diff(cfg, grid,
                                                   st.tidal_polzin, n2)
        else:
            tdiff = torch.where(n2 > 0.0, lnc * st.tidal_coef / (n2 + EPS),
                                0.0)
        if st.tidal_socn is not None:
            # Schmittner's Southern-Ocean deep floor
            # (source/tidal_mixing.F90:1410-1435)
            tdiff = torch.maximum(tdiff, st.tidal_socn)
        tdiff = torch.clamp(tdiff, max=cfg.tidal_mix_max)
        pr = cfg.prandtl
        kvmix_m = pr * torch.clamp(bck_vvc / pr + tdiff,
                                   max=cfg.tidal_mix_max)
        kvmix = torch.clamp(bck_vdc + tdiff, max=cfg.tidal_mix_max)
        visc_k = kvmix_m + shear
        vdc_k = kvmix + shear
        kvmix = kvmix * ones
        kvmix_m = kvmix_m * ones
    else:
        visc_k = bck_vvc + shear
        vdc_k = bck_vdc + shear
        kvmix = bck_vdc * ones
        kvmix_m = bck_vvc * ones

    # zero at and below the sea floor (:1913-1921)
    below = _kidx(km, ri.device) >= grid.KMT[None]
    visc_k = torch.where(below, 0.0, visc_k)
    vdc_k = torch.where(below, 0.0, vdc_k)
    # KVMIX is set only for k < km (:1829-1842)
    kvmix[-1] = 0.0
    kvmix_m[-1] = 0.0

    zpad = torch.zeros_like(ri[:1])
    visc = torch.cat([zpad, visc_k, zpad])
    vdc = torch.cat([zpad, vdc_k, zpad])
    return visc, vdc, kvmix, kvmix_m


def ddmix(cfg: ModelConfig, grid: Grid, trcr, vdc_t, vdc_s):
    """Double-diffusive mixing (source/vmix_kpp.F90:3459-3497, native
    path). vdc_t/vdc_s are (km+2, ...) interface arrays; returns the
    updated pair (new tensors)."""
    km = cfg.km
    T, S = trcr[0], trcr[1]
    _, talpha, sbeta = eos.mwjf_rho(
        torch.clamp(torch.clamp(T, min=-2.0), -1000.0, 1000.0),
        torch.clamp(S, 0.0, 1000.0), _col(grid.vgrid.pressz),
        want_drhodt=True, want_drhods=True)

    def dn(f):
        return torch.cat([f[1:], f[-1:]])

    alphadt = -0.5 * (talpha + dn(talpha)) * (T - dn(T))
    betads = 0.5 * (sbeta + dn(sbeta)) * (S - dn(S))
    alphadt[-1] = 0.0
    betads[-1] = 0.0

    # salt fingering
    finger = (alphadt > betads) & (betads > 0.0)
    safe_b = torch.where(betads != 0.0, betads, 1.0)
    rrho = torch.clamp(alphadt / safe_b, max=RRHO0)
    diffdd_f = DSFMAX * (1.0 - (rrho - 1.0) / (RRHO0 - 1.0)) ** 3
    add_t = torch.where(finger, 0.7 * diffdd_f, 0.0)
    add_s = torch.where(finger, diffdd_f, 0.0)

    # diffusive convection
    dconv = (alphadt < 0.0) & (betads < 0.0) & (alphadt > betads)
    rrho_c = torch.where(dconv, alphadt / safe_b, 0.0)
    safe_r = torch.where(rrho_c != 0.0, rrho_c, 1.0)
    diffdd_c = torch.where(
        dconv,
        1.5e-2 * 0.909 * torch.exp(4.6 * torch.exp(
            -0.54 * (1.0 / safe_r - 1.0))), 0.0)
    prandtl = torch.where(dconv, 0.15 * rrho_c, 0.0)
    prandtl = torch.where(rrho_c > 0.5, (1.85 - 0.85 / safe_r) * rrho_c,
                          prandtl)
    add_t = add_t + diffdd_c
    add_s = add_s + prandtl * diffdd_c

    vdc_t = vdc_t.clone()
    vdc_s = vdc_s.clone()
    vdc_t[1:km + 1] += add_t
    vdc_s[1:km + 1] += add_s
    return vdc_t, vdc_s


def _radiative_bfsfc(cfg: ModelConfig, bo, bosol, depth_cm, chl_co=None):
    """BFSFC = BO + the radiative contribution absorbed above
    ``depth_cm`` (source/vmix_kpp.F90:2387-2416, 2706-2751); sw_absorption
    'none' is the reference's 'top-layer' (all shortwave absorbed above any
    depth)."""
    if cfg.sw_absorption == "jerlov":
        absorb = sw_absorption.sw_absorb_frac(depth_cm,
                                                    cfg.jerlov_water_type)
        return bo + bosol * (1.0 - absorb)
    if cfg.sw_absorption == "chlorophyll":
        trans = sw_absorption.chl_trans_at(chl_co, depth_cm)
        return bo + bosol * (1.0 - trans)
    return bo + bosol


def _first(cond):
    """(index of the first True along dim 0, whether there is one)."""
    return torch.argmax(cond.to(torch.uint8), dim=0), cond.any(dim=0)


def _pick(field, idx):
    """field[idx[y, x], y, x] of a (n, ny, nx) field."""
    return torch.gather(field, 0, idx[None].long()).squeeze(0)


def bldepth(cfg: ModelConfig, grid: Grid, bc: BC, st: KPPStatics,
            dbloc, dbsfc, trcr, umix, vmix_, stf, shf_qsw, smft, chl=None):
    """Boundary-layer depth from the bulk Richardson number
    (source/vmix_kpp.F90:2002-2760), with the ``kpp_lshort_wave``
    radiative buoyancy contribution (:2387-2416) and the ``kpp_lcheckekmo``
    Ekman / Monin-Obukhov limits (:2425-2453, 2676-2689).

    The reference walks down the column to the first level whose bulk
    Richardson number passes RICR, interpolating the crossing depth from
    that level and the two above; here every level's interpolated depth is
    formed at once and the first crossing picked. Returns (hblt, ustar,
    bfsfc, stable, kbl)."""
    km = cfg.km
    vg = grid.vgrid
    zt, dzw = vg.zt, vg.dzw
    dev = zt.device

    ustar = torch.clamp(torch.sqrt(torch.sqrt(smft[0] ** 2 + smft[1] ** 2)),
                        min=EPS)

    # surface buoyancy forcing (:2156-2179)
    rho1, talpha, sbeta = eos.mwjf_rho(
        torch.clamp(torch.clamp(trcr[0, 0], min=-2.0), -1000.0, 1000.0),
        torch.clamp(trcr[1, 0], 0.0, 1000.0), vg.pressz[0],
        want_drhodt=True, want_drhods=True)
    safe1 = torch.where(rho1 != 0.0, rho1, 1.0)
    bo = torch.where(rho1 != 0.0, const.GRAV
                     * (-talpha * stf[0] - sbeta * stf[1]) / safe1, 0.0)
    bosol = torch.where(rho1 != 0.0,
                        -const.GRAV * talpha * shf_qsw / safe1, 0.0)

    chl_co = None
    if cfg.kpp_lshort_wave and cfg.sw_absorption == "chlorophyll":
        if chl is None:
            chl = torch.full_like(bo, cfg.chl_const)
        chl_co = sw_absorption.chl_coeffs(grid, chl)

    # the surface buoyancy forcing at each level-centre depth; with
    # lshort_wave the radiative part absorbed above zt(kl) (:2387-2416)
    ztc = _col(zt)
    if cfg.kpp_lshort_wave:
        co = None if chl_co is None else tuple(c[None] for c in chl_co)
        bfsfc_all = _radiative_bfsfc(cfg, bo[None], bosol[None], ztc, co)
    else:
        bfsfc_all = bo[None].expand((km,) + bo.shape)
    stable_all = (bfsfc_all >= 0.0).to(bfsfc_all.dtype)
    bfsfc_all = bfsfc_all + stable_all * EPS

    # surface-layer-averaged reference velocities of every target level
    # (:2334-2349)
    uref = torch.tensordot(st.uref_w, umix, dims=1)
    vref = torch.tensordot(st.uref_w, vmix_, dims=1)
    work = (uref - umix) ** 2 + (vref - vmix_) ** 2
    # a T point takes the max of its 4 U corners (:2371-2378)
    vshear_all = torch.maximum(torch.maximum(work, bc.w(work)),
                               torch.maximum(bc.s(work), bc.sw(work)))

    _, ws_all = wscale(EPSSFC, ztc, ustar[None], bfsfc_all, want="s")
    b_frq = torch.sqrt(0.5 * (dbloc + torch.abs(dbloc) + EPS2)
                       / _col(dzw[1:km + 1]))
    wm_all = (ztc * ws_all * b_frq
              * ((VTC / RICR) * torch.clamp(2.1 - 200.0 * b_frq,
                                            min=CONCV)))

    kmt = grid.KMT
    kidx = _kidx(km, dev)
    zref_all = -EPSSFC * ztc / 2.0
    worknum = torch.where(kidx <= kmt[None], (zref_all + ztc) * dbsfc, 0.0)
    ri_bulk = worknum / (vshear_all + wm_all + EPS)

    # the crossing depth of every level kl = 2..km, interpolated through
    # kl and the two levels above (:2602-2638); the reference's walk
    # starts with zero Richardson numbers above level 2
    zero = torch.zeros_like(ri_bulk[:1])
    ri_dn = ri_bulk[1:]
    ri_up = torch.cat([zero, ri_bulk[1:km - 1]])
    ri_upper = torch.cat([zero, zero, ri_bulk[1:km - 2]])[:km - 1]
    zkl = ztc[1:]
    z_up = -ztc[:km - 1]
    z_upper = torch.cat([torch.zeros_like(ztc[:1]), -ztc[:km - 2]])
    ricr = RICR
    slope_up = (ri_upper - ri_up) / (z_up - z_upper)
    a_co = (ri_dn - ri_up - slope_up * (zkl + z_up)) / (z_up + zkl) ** 2
    b_co = slope_up + 2.0 * a_co * z_up
    c_co = ri_up + z_up * (a_co * z_up + slope_up) - ricr
    sqrt_arg = b_co ** 2 - 4.0 * a_co * c_co
    lin = (-z_up + (z_up + zkl) * (ricr - ri_up)
           / torch.where(ri_dn != ri_up, ri_dn - ri_up, EPS))
    use_lin = ((torch.abs(b_co) > EPS)
               & (torch.abs(a_co) / torch.clamp(torch.abs(b_co), min=EPS)
                  <= EPS)) | (sqrt_arg <= 0.0)
    quad = (-b_co + torch.sqrt(torch.clamp(sqrt_arg, min=0.0))) / (
        2.0 * torch.where(a_co != 0.0, a_co, EPS))
    hnew = torch.where(use_lin, lin, quad)
    first, found = _first((ri_dn > ricr) & (kidx[1:] <= kmt[None]))

    hblt0 = torch.where(kmt > 1, zt[torch.clamp(kmt - 1, min=0).long()],
                        zt[0])
    hblt0 = torch.where(kmt > 0, hblt0, 0.0)
    hblt = torch.where(found, _pick(hnew, first), hblt0)

    if cfg.kpp_lcheckekmo:
        hblt = _ekman_mo_limit(cfg, grid, hblt, ustar, bfsfc_all,
                               stable_all)

    # 1-1-4-1-1 smoothing, bottom clamp and KBL rebuild (:3699-3877)
    hblt, kbl = smooth_hblt(cfg, grid, bc, hblt)

    bfsfc, stable = bfsfc_all[0], stable_all[0]
    if cfg.kpp_lshort_wave:
        # stability and buoyancy forcing corrected for the shortwave
        # absorbed above the final boundary-layer depth (:2706-2751)
        bfsfc = _radiative_bfsfc(cfg, bo, bosol, hblt, chl_co)
        stable = (bfsfc >= 0.0).to(bfsfc.dtype)
        bfsfc = bfsfc + stable * EPS
    return hblt, ustar, bfsfc, stable, kbl


def _ekman_mo_limit(cfg, grid, hblt, ustar, bfsfc_all, stable_all):
    """The Ekman / Monin-Obukhov depth limit (lcheckekmo: in the level loop
    :2425-2453, applied at :2676-2689). The reference carries the Ekman
    depth (set at the first stable level) and the Monin-Obukhov limit (set
    at the last level whose depth brackets it) down the column; both are
    picked here from all levels at once."""
    zt = grid.vgrid.zt
    km = zt.shape[0]
    bottom = zt[km - 1]
    ustar3 = ustar ** 3
    # initial value at z_up = zgrid(1) from the surface level's forcing
    work0 = (stable_all[0] * CMONOB * ustar3 / VONKAR / bfsfc_all[0]
             + (1.0 - stable_all[0]) * bottom)
    hm_up0 = torch.where(work0 <= zt[0], zt[0] + EPS, work0)

    stb, bfs = stable_all[1:], bfsfc_all[1:]
    zkl, zupd = _col(zt[1:]), _col(zt[:-1])
    cek = CEKMAN * ustar / (torch.abs(grid.FCORT) + EPS)
    first_stable, any_stable = _first(stb > 0.5)
    hekman = torch.where(any_stable,
                         torch.maximum(zt[1:][first_stable], cek),
                         bottom + EPS)

    hm_dn = stb * CMONOB * ustar3 / VONKAR / bfs + (1.0 - stb) * bottom
    hm_up = torch.cat([hm_up0[None], hm_dn[:-1]])
    cond = (hm_dn <= zkl) & (hm_up > zupd)
    w = (hm_dn - hm_up) / (zkl - zupd)
    cand = (hm_dn - w * zkl) / (1.0 - w)
    last, any_hit = _first(cond.flip(0))
    hlimit = torch.where(any_hit, _pick(cand, km - 2 - last), bottom + EPS)

    hlimit = torch.minimum(hlimit, hekman)
    # the reference's where-loop over kl re-reads the updated HBLT, so only
    # the first satisfying kl fires; with ZKL frozen at its km-loop value
    # the bracket is (zt(1), zt(km)]
    applies = (hlimit < hblt) & (hlimit > zt[0]) & (hlimit <= bottom)
    return torch.where(applies, hlimit, hblt)


def smooth_hblt(cfg: ModelConfig, grid: Grid, bc: BC, hblt):
    """Masked 5-point filter of the boundary-layer depth, bottom clamp and
    KBL rebuild (source/vmix_kpp.F90:3797-3877). Returns (hblt, kbl)."""
    km = cfg.km
    zt = grid.vgrid.zt
    rc = grid.RCALCT
    cw = 0.125 * (bc.w(rc) > 0).to(rc.dtype)
    ce = 0.125 * (bc.e(rc) > 0).to(rc.dtype)
    cn = 0.125 * (bc.n(rc) > 0).to(rc.dtype)
    cs = 0.125 * (bc.s(rc) > 0).to(rc.dtype)
    cc = 1.0 - cw - ce - cn - cs
    sm = (cc * hblt + cw * bc.w(hblt) + ce * bc.e(hblt)
          + cs * bc.s(hblt) + cn * bc.n(hblt))
    hblt = torch.where(rc > 0.0, sm, hblt)

    # clamp to the local bottom depth
    kmt = grid.KMT
    zt_bottom = torch.where(kmt > 0, zt[torch.clamp(kmt - 1, min=0).long()],
                            zt[0])
    hblt = torch.maximum(torch.minimum(hblt, zt_bottom), zt[0])

    # KBL: the level k (>= 2) with zt(k-1) < HBLT <= zt(k)
    deeper = (hblt[None] > _col(zt)).sum(dim=0, dtype=torch.int32)
    kbl = torch.clamp(1 + deeper, 2, km)
    kbl = torch.where(kmt > 0, torch.minimum(kbl, torch.clamp(kmt, min=2)),
                      kbl)
    return hblt, kbl.to(torch.int32)


def blmix(cfg: ModelConfig, grid: Grid, st: KPPStatics, visc, vdc_t, vdc_s,
          hblt, ustar, bfsfc, stable, kbl):
    """Boundary-layer mixing profile, interior matching, the enhanced mixing
    at kbl-1 and the non-local coefficient ghat
    (source/vmix_kpp.F90:2900-3222, native path). visc/vdc_* are (km+2,
    ny, nx) interface arrays. Returns (visc, vdc_t, vdc_s, ghat) with ghat
    (km, ny, nx)."""
    km = cfg.km
    vg = grid.vgrid
    zt, dz, dzw = vg.zt, vg.dz, vg.dzw
    kbl = kbl.long()

    wm_h, ws_h = wscale(EPSSFC, hblt, ustar, bfsfc, want="both")

    # caseA: hbl above the top interface of cell kbl (:2924-2934)
    casea = (zt[kbl - 1] - 0.5 * dz[kbl - 1] - hblt >= 0.0).to(hblt.dtype)
    kn = torch.where(casea > 0.5, kbl - 1, kbl)   # 1..km

    eps_v = torch.full_like(dz[:1], EPS)
    hwide = torch.cat([eps_v, dz, eps_v])
    hw_k, hw_kp1 = hwide[kn], hwide[kn + 1]
    delhat = 0.5 * hw_k + zt[kn - 1] - hblt
    r = 1.0 - delhat / hw_k
    f1 = stable * 5.0 * bfsfc / (ustar ** 4 + EPS)

    def match(iface):
        """(slope, value) of the interior profile at hbl from the
        interfaces around KN."""
        v_km1, v_k, v_kp1 = (_pick(iface, kn + d) for d in (-1, 0, 1))
        dvdzup = (v_km1 - v_k) / hw_k
        dvdzdn = (v_k - v_kp1) / hw_kp1
        vp = 0.5 * ((1.0 - r) * (dvdzup + torch.abs(dvdzup))
                    + r * (dvdzdn + torch.abs(dvdzdn)))
        return vp, v_k + vp * delhat

    viscp, visch = match(visc)
    diftp, difth = match(vdc_t)
    difsp, difsh = match(vdc_s)

    gat1_m = visch / hblt / (wm_h + EPS)
    dat1_m = torch.clamp(-viscp / (wm_h + EPS) + f1 * visch, max=0.0)
    gat1_s = difsh / hblt / (ws_h + EPS)
    dat1_s = torch.clamp(-difsp / (ws_h + EPS) + f1 * difsh, max=0.0)
    gat1_t = difth / hblt / (ws_h + EPS)
    dat1_t = torch.clamp(-diftp / (ws_h + EPS) + f1 * difth, max=0.0)

    # shape function at every interface (:3073-3109)
    sigma_all = (_col(zt) + 0.5 * _col(dz)) / hblt[None]
    f1s = torch.clamp(sigma_all, max=EPSSFC)
    wm_all, ws_all = wscale(f1s, hblt[None], ustar[None], bfsfc[None],
                            want="both")

    def blprofile(w, gat1, dat1):
        s = sigma_all
        return (hblt[None] * w * s
                * (1.0 + s * ((s - 2.0) + (3.0 - 2.0 * s) * gat1[None]
                              + (s - 1.0) * dat1[None])))

    blmc_m = blprofile(wm_all, gat1_m, dat1_m)
    blmc_s = blprofile(ws_all, gat1_s, dat1_s)
    blmc_t = blprofile(ws_all, gat1_t, dat1_t)
    ghat = (1.0 - stable[None]) * CG / (ws_all * hblt[None] + EPS)

    # diffusivities at kbl-1 (:3117-3144)
    sig_km1 = torch.cat([eps_v, zt])[kbl - 1] / hblt
    f1k = torch.clamp(sig_km1, max=EPSSFC)
    wm1, ws1 = wscale(f1k, hblt, ustar, bfsfc, want="both")

    def dkm1_of(w, gat1, dat1):
        s = sig_km1
        return (hblt * w * s * (1.0 + s * ((s - 2.0) + (3.0 - 2.0 * s) * gat1
                                           + (s - 1.0) * dat1)))

    # enhanced mixing at k = kbl-1 (:3153-3198)
    kidx = _kidx(km, hblt.device)
    at_enh = kidx == (kbl - 1)[None]
    delhat_e = (hblt[None] - _col(zt)) / _col(dzw[1:km + 1])
    ca = casea[None]

    def enhance(blmc, dkm1, v_iface):
        enh = ((1.0 - delhat_e) * v_iface
               + delhat_e * ((1.0 - delhat_e) ** 2 * dkm1[None]
                             + delhat_e ** 2 * (ca * v_iface
                                                + (1.0 - ca) * blmc)))
        return torch.where(at_enh, enh, blmc)

    blmc_m = enhance(blmc_m, dkm1_of(wm1, gat1_m, dat1_m), visc[1:km + 1])
    blmc_s = enhance(blmc_s, dkm1_of(ws1, gat1_s, dat1_s), vdc_s[1:km + 1])
    blmc_t = enhance(blmc_t, dkm1_of(ws1, gat1_t, dat1_t), vdc_t[1:km + 1])
    ghat = torch.where(at_enh, (1.0 - ca) * ghat, ghat)

    # the boundary layer over the interior (:3207-3221)
    in_bl = kidx < kbl[None]

    def combine(iface, blmc):
        out = iface.clone()
        out[1:km + 1] = torch.where(in_bl, blmc, iface[1:km + 1])
        return out

    return (combine(visc, blmc_m), combine(vdc_t, blmc_t),
            combine(vdc_s, blmc_s), torch.where(in_bl, ghat, 0.0))


def hmxl_dr_diag(cfg: ModelConfig, grid: Grid, trcr):
    """Diagnostic mixed-layer depth from the density-threshold criterion
    (offset 0.03 kg/m^3 = 3e-5 g/cm^3), linearly interpolated between the
    bracketing level centres (HMXL_DR, source/vmix_kpp.F90:1385-1417)."""
    zt = grid.vgrid.zt
    T = torch.where(trcr[0] < -2.0, -2.0, trcr[0])
    # potential density: every level displaced to the level-1 pressure
    rho = eos.mwjf_rho(torch.clamp(T, -1000.0, 1000.0),
                       torch.clamp(trcr[1], 0.0, 1000.0), grid.vgrid.pressz[0])
    target = rho[0] + 3.0e-5
    rho_k, rho_kp1 = rho[:-1], rho[1:]
    k0, found = _first((target > rho_k) & (target <= rho_kp1))
    ztk, ztk1 = zt[k0], zt[k0 + 1]
    r_k, r_k1 = _pick(rho_k, k0), _pick(rho_kp1, k0)
    interp = ztk + (target - r_k) * (ztk1 - ztk) / (r_k1 - r_k + EPS)
    out = torch.where(found, interp, 0.0)
    return torch.where(grid.KMT == 1, zt[0], out)


def hmxl_diag(cfg: ModelConfig, grid: Grid, dbsfc):
    """Diagnostic mixed-layer depth from the maximum buoyancy-gradient
    criterion (source/vmix_kpp.F90:1319-1383)."""
    km = cfg.km
    zt = grid.vgrid.zt
    kmt = grid.KMT
    in_ocean = _kidx(km, zt.device) <= kmt[None]
    ztc = _col(zt)

    # pass 1: ustar = max_k dbsfc_k / zt_k; hmxl = the deepest ocean zt
    ratio = torch.where(in_ocean[1:], dbsfc[1:] / ztc[1:], 0.0)
    ustar = torch.clamp(ratio.max(dim=0).values, min=0.0)
    hmxl = torch.where(kmt == 1, zt[0], torch.where(
        kmt > 1, zt[torch.clamp(kmt - 1, min=0).long()], 0.0))

    # pass 2: the first k where the local gradient reaches the maximum ratio
    # (the reference resets USTAR to 0 after the first match)
    grad = (dbsfc[1:] - dbsfc[:-1]) / (ztc[1:] - ztc[:-1])
    grad = torch.where(ustar[None] > 0.0, grad, 0.0)
    grad_prev = torch.cat([torch.zeros_like(grad[:1]), grad[:-1]])
    dgrad = grad - grad_prev
    hit = (grad >= ustar[None]) & (dgrad != 0.0) & (ustar[None] > 0.0)
    bf = (grad - ustar[None]) / torch.where(dgrad != 0.0, dgrad, 1.0)
    zmid_dn = 0.5 * (ztc[1:] + ztc[:-1])
    zmid_up = torch.cat([(0.5 * zt[0]).reshape(1, 1, 1).expand_as(
        zmid_dn[:1]), zmid_dn[:-1]])
    hcand = zmid_dn * (1.0 - bf) + zmid_up * bf
    first, any_hit = _first(hit)
    return torch.where(any_hit, _pick(hcand, first), hmxl)


def blke(cfg: ModelConfig, grid: Grid, u, v, kbl):
    """Boundary-layer kinetic energy (erg/cm^2): 1/2 rho_sw (u^2 + v^2) dz
    summed over the levels k <= KBL (blke, source/vmix_kpp.F90:4072-4124)."""
    km = cfg.km
    ke = 0.5 * const.RHO_SW * (u ** 2 + v ** 2) * _col(grid.vgrid.dz)
    return torch.sum(torch.where(_kidx(km, u.device) <= kbl[None], ke, 0.0),
                     dim=0)


def niw_energy(cfg: ModelConfig, grid: Grid, st: KPPStatics, kbl,
               umix, vmix_, ucur=None, vcur=None):
    """The NIW energy input En (compute_niw_energy_flux,
    source/vmix_kpp.F90:3888-4065): under 'external' the file's flux or
    ``niw_energy_const``; under 'blke' 5 % of the step's change of the
    boundary-layer kinetic energy, zero within 5 degrees of the equator and
    cosine-tapered to 10."""
    coef = (cfg.niw_local_mixing_fraction * cfg.niw_mixing_efficiency
            * cfg.niw_obs2model_ratio
            * (1.0 - cfg.niw_boundary_layer_absorption) / const.RHO_FW)
    if cfg.niw_energy_type == "blke" and ucur is not None:
        ke_mix = blke(cfg, grid, umix, vmix_, kbl)
        ke_cur = blke(cfg, grid, ucur, vcur, kbl)
        en = torch.abs(0.05 * (ke_cur - ke_mix) / cfg.time.dtt)
        latd = grid.TLAT * const.RADIAN
        cosf = 0.5 * (torch.cos(2.0 * math.pi * latd / 10.0) + 1.0)
        en = torch.where(torch.abs(latd) < 5.0, 0.0,
                         torch.where(torch.abs(latd) < 10.0, en * cosf, en))
        return coef * en * grid.RCALCT
    if st.niw_energy is not None:
        return coef * st.niw_energy * grid.RCALCT
    return coef * (cfg.niw_energy_const * 1000.0) * grid.RCALCT


def niw_mix(cfg: ModelConfig, grid: Grid, st: KPPStatics, dbloc, hblt, kbl,
            visc, vdc_t, vdc_s, en=None):
    """Near-inertial-wave mixing (source/niw_mixing.F90 niw_mix :472-700):
    the energy flux En deposits a diffusivity En/N^2 below the boundary
    layer, decaying exponentially away from its base and normalized over
    the column; the boundary layer takes the value at KBL, which also caps
    the column, and ``niw_mix_max`` caps it all. ``visc``, ``vdc_t``,
    ``vdc_s`` are (km+2, ...) interface arrays as ``ri_iwmix``'s; returns
    new ones."""
    km = cfg.km
    zw = _col(grid.vgrid.zw)
    dzw = _col(grid.vgrid.dzw[1:km + 1])
    kidx = _kidx(km, dbloc.device)

    if en is None:
        en = niw_energy(cfg, grid, st, kbl, None, None)

    active = (kidx >= kbl[None]) & (kidx < grid.KMT[None])
    decay = torch.exp(-(zw - hblt[None]) / cfg.niw_vert_decay_scale)
    norm = torch.sum(torch.where(active, decay * dzw, 0.0), dim=0)

    n2 = dbloc / dzw
    kap_n2 = torch.where(n2 > 0.0,
                         en[None] / torch.where(n2 > 0.0, n2, 1.0), 0.0)
    norm_ok = norm > 0.0
    kvniw = torch.where(norm_ok[None] & active,
                        kap_n2 * decay
                        / torch.where(norm_ok, norm, 1.0)[None], 0.0)
    kvniw = torch.where(active, torch.clamp(
        torch.maximum(vdc_t[1:km + 1], kvniw), max=cfg.niw_mix_max), 0.0)
    # the value at KBL fills the boundary layer and caps the column
    w4 = torch.where((kbl >= 1) & (kbl <= km), _pick(
        kvniw, torch.clamp(kbl.long() - 1, 0, km - 1)), 0.0)[None]
    in_bl = kidx < kbl[None]

    def apply(vk, scale=1.0):
        mid = torch.where(active, scale * kvniw, vk[1:km + 1])
        mid = torch.where(in_bl, scale * w4, mid)
        out = vk.clone()
        out[1:km + 1] = torch.minimum(mid, scale * w4)
        return out

    return (apply(visc, cfg.prandtl), apply(vdc_t), apply(vdc_s))


def kpp_coeffs(cfg: ModelConfig, grid: Grid, bc: BC, st: KPPStatics,
               tmix, umix, vmix_, stf, shf_qsw, smft,
               convect_diff: float, convect_visc: float, chl=None,
               tidal_lnc=None, rhomix=None, ucur=None,
               vcur=None) -> KPPOut:
    """The KPP pipeline (driver: source/vmix_kpp.F90:918-1422), with the
    diagnostics the tavg fields read (TPOWER where the mixing-time density
    ``rhomix`` is given). ``ucur``/``vcur``, the current velocities, feed
    the 'blke' NIW energy."""
    km = cfg.km
    dbloc, dbsfc = buoydiff(cfg, grid, st, tmix)
    visc, vdc_s, kvmix, kvmix_m = ri_iwmix(cfg, grid, bc, st, dbloc, umix,
                                           vmix_, tidal_lnc=tidal_lnc)
    vdc_t = vdc_s
    if cfg.kpp_ldbl_diff:
        vdc_t, vdc_s = ddmix(cfg, grid, tmix, vdc_t, vdc_s)
    hblt, ustar, bfsfc, stable, kbl = bldepth(
        cfg, grid, bc, st, dbloc, dbsfc, tmix, umix, vmix_, stf, shf_qsw,
        smft, chl=chl)
    if cfg.lniw_mixing:
        en = niw_energy(cfg, grid, st, kbl, umix, vmix_, ucur, vcur)
        visc, vdc_t, vdc_s = niw_mix(cfg, grid, st, dbloc, hblt, kbl, visc,
                                     vdc_t, vdc_s, en=en)
    visc, vdc_t, vdc_s, ghat = blmix(cfg, grid, st, visc, vdc_t, vdc_s,
                                     hblt, ustar, bfsfc, stable, kbl)

    # interior convection (step-function form, BVSQcon = 0;
    # source/vmix_kpp.F90:1218-1242)
    kidx = _kidx(km, tmix.device)
    n2 = dbloc / _col(grid.vgrid.dzw[1:km + 1])
    fcon = (n2 <= 0.0).to(n2.dtype)
    conv_on = (kidx >= kbl[None]) & (kidx <= km - 1)
    conv_vvc = torch.where(conv_on, convect_visc * fcon, 0.0)
    conv_vdc = torch.where(conv_on, convect_diff * fcon, 0.0)

    below = kidx >= grid.KMT[None]
    visc_k = torch.where(below, 0.0, visc[1:km + 1] + conv_vvc)
    vdct_k = torch.where(below, 0.0, vdc_t[1:km + 1] + conv_vdc)
    vdcs_k = torch.where(below, 0.0, vdc_s[1:km + 1] + conv_vdc)
    for f in (visc_k, vdct_k, vdcs_k):
        f[-1] = 0.0

    # viscosity to the U grid (source/vmix_kpp.F90:1257-1263)
    vvc = tgrid_to_ugrid(visc_k, grid.AU0, grid.AUN, grid.AUE, grid.AUNE, bc)
    vvc = torch.where(kidx >= grid.KMU[None], 0.0, vvc)

    # the non-local source factor VDC*GHAT per class (:1293-1308)
    ghat_src = torch.stack([vdct_k * ghat, vdcs_k * ghat])

    # TPOWER = KVMIX * RHO * DBLOC / dzw, the energy vertical mixing uses
    # (:1947-1950)
    tpower = None
    if rhomix is not None:
        tpower = kvmix * rhomix * dbloc / _col(grid.vgrid.dzw[1:km + 1])
    return KPPOut(vdc=torch.stack([vdct_k, vdcs_k]), vvc=vvc,
                  ghat_src=ghat_src, hblt=hblt, kbl=kbl,
                  hmxl=hmxl_diag(cfg, grid, dbsfc), kvmix=kvmix,
                  kvmix_m=kvmix_m, tpower=tpower,
                  hmxl_dr=hmxl_dr_diag(cfg, grid, tmix))


def kpp_sources(cfg: ModelConfig, grid: Grid, ghat_src, stf):
    """The non-local transport tracer source KPP_SRC (nt, km, ny, nx)
    (source/vmix_kpp.F90:1293-1308 and add_kpp_sources :3633)."""
    nt = stf.shape[0]
    km = cfg.km
    mt2 = torch.clamp(torch.arange(nt, device=stf.device), max=1)
    vg = ghat_src[mt2]
    vg_up = torch.cat([torch.zeros_like(vg[:, :1]), vg[:, :-1]], dim=1)
    return stf[:, None] * grid.vgrid.dzr.reshape(1, km, 1, 1) * (vg_up - vg)
