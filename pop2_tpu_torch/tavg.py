"""Time-averaged history output (tavg).

Reference: ``source/tavg.F90`` (7985 lines) — a multi-stream registry of
accumulated fields written at stream frequencies, with the accumulators
checkpointed so running means survive restarts (:1570, :2325). The port's
copy of the JAX package's ``tavg.py``: the same registry (names, long names,
units, dimensions and methods), the same field formulas and the same files.

  * a registry of field functions (cfg, grid, state, aux) -> (ny, nx) or
    (km, ny, nx) tensors (the reference's scattered ``accumulate_tavg_field``
    calls become one accumulation pass over the requested fields),
  * per-field accumulation methods avg / min / max, matching the reference's
    ``tavg_method_avg|min|max`` (source/tavg.F90:353-360, e.g. XMXL is the
    max and TMXL the min of HMXL over the interval),
  * per-stream accumulators on the device, normalized and written on the
    host: NetCDF3 classic via scipy or netCDF-4 (``io/netcdf4.py``), with
    coordinates z_t/TLAT/TLONG like the reference's tavg files,
  * accumulator save/restore for exact-restart of running means.

What the port does differently, for ``Model.run_compiled``'s captured step
(``graphs.CapturedStep``), where the accumulation is part of a CUDA graph:

  * the accumulators are static: one device buffer a stream, each field a
    view of it, updated in place (``add_``, ``torch.minimum/maximum(...,
    out=)``); ``reset`` and ``restore_accumulators`` write into the same
    memory, so a captured graph and the stream always share it. A write
    reads the whole buffer to the host at once;
  * the intermediates that several fields share (the flux velocities, the
    advective tendency, the horizontal-diffusion tendency) are computed once
    an accumulation (``TavgAux.memo``, keyed on the state's buffers), where
    the JAX package relies on XLA's common-subexpression elimination;
  * an accumulation reads nothing from the host: the fields that depend on
    the grid and the config alone (the background diffusivity of VDC_BCK /
    VVC_BCK, the shortwave transmission at the layer tops) are built on the
    device when the stream is made and kept on the grid object, beside the
    kernel wrappers' operands.

``aux`` carries what the reference accumulates from inside the step: the
forcing and the step's extras (``step.extras``).

On a rank's block of a decomposition (``parallel.mesh``) a stream
accumulates the block (its fields evaluated with the block's config, their
shifts taking halos under the decomposition's scope) and a write gathers
every rank's buffer on rank 0 (one collective), which writes the whole
domain's file; the other ranks write nothing. The coordinates are gathered
once, when the stream is made.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from pop2_tpu_torch import constants as const, estuary
from pop2_tpu_torch.config import ModelConfig
from pop2_tpu_torch.grid import Grid
from pop2_tpu_torch.parallel import mesh as pmesh
from pop2_tpu_torch.state import State


class TavgAux(NamedTuple):
    """Step-internal quantities available to tavg field functions (the
    reference accumulates these from inside the physics routines)."""
    forcing: object = None
    bc: object = None
    hblt: Optional[torch.Tensor] = None   # (ny, nx) KPP boundary-layer depth
    hmxl: Optional[torch.Tensor] = None   # (ny, nx) mixed-layer depth
    vdc: Optional[torch.Tensor] = None    # (2, km, ny, nx) tracer diffusivity
    vvc: Optional[torch.Tensor] = None    # (km, ny, nx) viscosity
    kappa_isop: Optional[torch.Tensor] = None  # (km, ny, nx) Redi kappa
    kappa_thic: Optional[torch.Tensor] = None  # (km, ny, nx) GM bolus kappa
    hor_diff: Optional[torch.Tensor] = None    # (km, ny, nx) srf-bl horiz ah
    dia_depth: Optional[torch.Tensor] = None   # (ny, nx) GM diabatic depth
    tlt_thick: Optional[torch.Tensor] = None   # (ny, nx) transition thickness
    int_depth: Optional[torch.Tensor] = None   # (ny, nx) interior start depth
    tend_tracer: Optional[torch.Tensor] = None  # (nt, km, ny, nx) dT/dt
    hmxl_dr: Optional[torch.Tensor] = None     # (ny, nx) density-crit MLD
    kvmix: Optional[torch.Tensor] = None       # (km, ny, nx) interior vdc
    kvmix_m: Optional[torch.Tensor] = None     # (km, ny, nx) interior vvc
    tpower: Optional[torch.Tensor] = None      # (km, ny, nx) mixing energy
    rf_tend_tracer: Optional[torch.Tensor] = None  # (nt, km, ny, nx)
    # the shared intermediates of one accumulation (None: each field
    # computes its own)
    memo: Optional[dict] = None


@dataclasses.dataclass(frozen=True)
class FieldDef:
    name: str
    long_name: str
    units: str
    ndims: int                     # 2 or 3
    fn: Callable                   # (cfg, grid, state, aux) -> tensor
    method: str = "avg"            # avg | min | max (tavg.F90:353-360)


FIELDS: Dict[str, FieldDef] = {}


def _register(name, long_name, units, ndims, fn, method="avg"):
    FIELDS[name] = FieldDef(name, long_name, units, ndims, fn, method)


# ---------------------------------------------------------------------------
# helpers shared by several field functions
# ---------------------------------------------------------------------------

def _once(aux, key: str, state: State, fn):
    """``fn()``, computed once an accumulation: kept in ``aux.memo`` under
    ``key`` and the buffers of the state fields the shared intermediates
    read. Without a memo, ``fn()`` each time."""
    if aux.memo is None:
        return fn()
    k = (key,) + tuple(t.data_ptr() for t in (
        state.u_cur, state.v_cur, state.tracer_cur, state.tracer_old,
        state.psurf_cur, state.psurf_old, state.fw_old))
    if k not in aux.memo:
        aux.memo[k] = fn()
    return aux.memo[k]


def _kidx(km: int, device):
    """1-based level numbers as (km, 1, 1)."""
    return torch.arange(1, km + 1, dtype=torch.int32,
                        device=device).reshape(km, 1, 1)


def _col(v):
    """A (n,) level vector as (n, 1, 1)."""
    return v.reshape(-1, 1, 1)


def _flux_vel(cfg, grid, aux, state):
    """The tracer flux velocities from the state (the same comp_flux_vel the
    step ran, source/advection.F90:1970); dh/dt is a function of the state
    (surface_hgt.F90:131)."""
    from pop2_tpu_torch import advect, step as step_mod

    def fv():
        dh, _ = step_mod.dhdt(cfg, grid, aux.bc, state)
        return advect.comp_flux_vel(cfg, grid, aux.bc, state.u_cur,
                                    state.v_cur, dh)
    return _once(aux, "flux_vel", state, fv)


def _pd(cfg, grid, state):
    """Potential density: EOS of (T,S) at every level evaluated at the
    level-1 pressure (state(k,1,...), source/advection.F90:1845)."""
    from pop2_tpu_torch import eos
    pz = grid.vgrid.pressz
    pd = eos.state(cfg, pz[:1].expand_as(pz), state.tracer_cur[0],
                   state.tracer_cur[1], None,
                   fit=eos.fit_rows(grid.vgrid.poly, 0))
    return torch.where(grid.kmask_t, pd, 0.0)


def _q(cfg, grid, state):
    """Vertical gradient of density d(rho)/dz at level centers
    (source/advection.F90:1876-1920): rho of the level-(k-1)/(k+1) water
    displaced to level k, averaged with the in-situ value."""
    from pop2_tpu_torch import eos
    km = cfg.km
    T, S = state.tracer_cur[0], state.tracer_cur[1]
    pz = grid.vgrid.pressz
    r_k = state.rho_cur  # in-situ at own level
    # rho(T_{k-1}, S_{k-1}) at level-k pressure
    t_up = torch.cat([T[:1], T[:-1]], dim=0)
    s_up = torch.cat([S[:1], S[:-1]], dim=0)
    r_up = eos.state(cfg, pz, t_up, s_up, None, fit=grid.vgrid.poly)
    work3 = torch.cat([r_k[:1], (0.5 * (r_up + r_k))[1:]], dim=0)
    # rho(T_{k+1}, S_{k+1}) at level-k pressure; at the column bottom use r_k
    t_dn = torch.cat([T[1:], T[-1:]], dim=0)
    s_dn = torch.cat([S[1:], S[-1:]], dim=0)
    r_dn = eos.state(cfg, pz, t_dn, s_dn, None, fit=grid.vgrid.poly)
    at_bot = _kidx(km, T.device) == grid.KMT[None]
    work4 = torch.where(at_bot, r_k, 0.5 * (r_dn + r_k))
    dzr = _col(1.0 / grid.vgrid.dz)
    return torch.where(grid.kmask_t, (work3 - work4) * dzr, 0.0)


def _pv(cfg, grid, state, aux):
    """Potential vorticity Q*(curl(u,v)/TAREA + f_T)
    (source/advection.F90:1923-1926)."""
    from pop2_tpu_torch.stencil import zcurl
    q = _q(cfg, grid, state)
    crl = zcurl(state.u_cur, state.v_cur, grid.DXU, grid.DYU,
                grid.kmask_t, aux.bc)
    return q * (crl * grid.TAREA_R + grid.FCORT[None])


def _face_flux_e(cfg, grid, state, aux, n):
    """UET/UES: tracer flux across the east face, FUE*(T + T_east)
    (source/advection.F90:1743-1776; the flux velocities carry dz, so the
    partial-bottom-cell form with the 1/DZT factor is uniformly correct)."""
    fv = _flux_vel(cfg, grid, aux, state)
    dzr = _col(1.0 / grid.vgrid.dz)
    fue = 0.5 * fv.ute * grid.TAREA_R * dzr
    t = state.tracer_cur[n]
    return fue * (t + aux.bc.e(t))


def _face_flux_n(cfg, grid, state, aux, n):
    fv = _flux_vel(cfg, grid, aux, state)
    dzr = _col(1.0 / grid.vgrid.dz)
    fvn = 0.5 * fv.vtn * grid.TAREA_R * dzr
    t = state.tracer_cur[n]
    return fvn * (t + aux.bc.n(t))


def _face_flux_t(cfg, grid, state, aux, n):
    """WTT/WTS: tracer flux across the top face
    (source/advection.F90:1781-1790)."""
    fv = _flux_vel(cfg, grid, aux, state)
    t = state.tracer_cur[n]
    t_up = torch.cat([t[:1], t[:-1]], dim=0)
    dz2r = _col(0.5 / grid.vgrid.dz)
    out = dz2r * fv.wtk * (t + t_up)
    if cfg.sfc_layer == "varthick":
        out[0] = 0.0
    else:
        out[0] = fv.wtk[0] * t[0] / grid.vgrid.dz[0]
    return out


def _need(aux, attr, name):
    v = getattr(aux, attr, None)
    if v is None:
        raise ValueError(
            f"tavg field {name} needs step-internal '{attr}' — run through "
            f"Model (which passes step extras) or provide aux.{attr}")
    return v


def _sfc(cfg, grid, state, aux):
    return state.psurf_cur / const.GRAV


def _zeros2(cfg, grid):
    return torch.zeros((cfg.ny, cfg.nx), dtype=cfg.torch_dtype,
                       device=grid.KMT.device)


# ---------------------------------------------------------------------------
# registry — names/units follow the reference registrations
# (gx1v7_tavg_contents; define_tavg_field calls cited per group)
# ---------------------------------------------------------------------------

# -- sea surface / barotropic (surface_hgt.F90:90, barotropic.F90:152) ------
_register("SSH", "Sea Surface Height", "centimeter", 2, _sfc)
_register("SSH2", "SSH**2", "cm^2", 2,
          lambda c, g, s, a: (s.psurf_cur / const.GRAV) ** 2)
_register("SST", "Sea Surface Temperature", "degC", 2,
          lambda c, g, s, a: s.tracer_cur[0, 0])
_register("SST2", "SST**2", "degC^2", 2,
          lambda c, g, s, a: s.tracer_cur[0, 0] ** 2)
_register("SSS", "Sea Surface Salinity", "psu", 2,
          lambda c, g, s, a: s.tracer_cur[1, 0] * const.SALT_TO_PPT)
_register("SSS2", "SSS**2", "psu^2", 2,
          lambda c, g, s, a: (s.tracer_cur[1, 0] * const.SALT_TO_PPT) ** 2)
_register("SU", "Vertically Integrated U", "cm^2/s", 2,
          lambda c, g, s, a: g.HU * s.ubtrop_cur)
_register("SV", "Vertically Integrated V", "cm^2/s", 2,
          lambda c, g, s, a: g.HU * s.vbtrop_cur)


def _bsf(cfg, grid, state, aux):
    from pop2_tpu_torch.diagnostics import barotropic_streamfunction
    return barotropic_streamfunction(cfg, grid, state)


_register("BSF", "Diagnostic barotropic streamfunction", "Sv", 2, _bsf)

# -- prognostic 3-D fields (baroclinic.F90:2349, :772) -----------------------
_register("TEMP", "Potential Temperature", "degC", 3,
          lambda c, g, s, a: s.tracer_cur[0])
_register("SALT", "Salinity", "gram/gram", 3,
          lambda c, g, s, a: s.tracer_cur[1])
_register("TEMP2", "Temperature**2", "degC^2", 3,
          lambda c, g, s, a: s.tracer_cur[0] ** 2)
_register("SALT2", "Salinity**2", "(g/g)^2", 3,
          lambda c, g, s, a: s.tracer_cur[1] ** 2)
_register("UVEL", "Velocity in grid-x direction", "cm/s", 3,
          lambda c, g, s, a: s.u_cur)
_register("VVEL", "Velocity in grid-y direction", "cm/s", 3,
          lambda c, g, s, a: s.v_cur)
_register("UVEL2", "UVEL**2", "cm^2/s^2", 3,
          lambda c, g, s, a: s.u_cur ** 2)
_register("VVEL2", "VVEL**2", "cm^2/s^2", 3,
          lambda c, g, s, a: s.v_cur ** 2)
_register("KE", "Horizontal Kinetic Energy", "cm^2/s^2", 3,
          lambda c, g, s, a: 0.5 * (s.u_cur ** 2 + s.v_cur ** 2))
_register("UV", "UV velocity product", "cm^2/s^2", 3,
          lambda c, g, s, a: s.u_cur * s.v_cur)
_register("RHO", "In-situ density", "g/cm^3", 3,
          lambda c, g, s, a: s.rho_cur)
_register("PD", "Potential density ref to surface", "g/cm^3", 3,
          lambda c, g, s, a: _pd(c, g, s))
_register("RHO_VINT", "Vertical integral of in-situ density", "g/cm^2", 2,
          lambda c, g, s, a: torch.sum(_col(g.vgrid.dz) * s.rho_cur, dim=0))
_register("Q", "z-derivative of potential density", "g/cm^4", 3,
          lambda c, g, s, a: _q(c, g, s))
_register("PV", "Potential vorticity", "1/s", 3, _pv)

# -- vertical velocity and advective fluxes (advection.F90:1750-1799) --------
_register("WVEL", "Vertical velocity at top of T box", "cm/s", 3,
          lambda c, g, s, a: _flux_vel(c, g, a, s).wtk)
_register("WVEL2", "WVEL**2", "cm^2/s^2", 3,
          lambda c, g, s, a: _flux_vel(c, g, a, s).wtk ** 2)
_register("UET", "East flux of heat", "degC/s", 3,
          lambda c, g, s, a: _face_flux_e(c, g, s, a, 0))
_register("UES", "East flux of salt", "g/g/s", 3,
          lambda c, g, s, a: _face_flux_e(c, g, s, a, 1))
_register("VNT", "North flux of heat", "degC/s", 3,
          lambda c, g, s, a: _face_flux_n(c, g, s, a, 0))
_register("VNS", "North flux of salt", "g/g/s", 3,
          lambda c, g, s, a: _face_flux_n(c, g, s, a, 1))
_register("WTT", "Top flux of heat", "degC/s", 3,
          lambda c, g, s, a: _face_flux_t(c, g, s, a, 0))
_register("WTS", "Top flux of salt", "g/g/s", 3,
          lambda c, g, s, a: _face_flux_t(c, g, s, a, 1))

# -- forcing fields (forcing_shf.F90, forcing_sfwf.F90, forcing_ws.F90) -----
_register("SHF", "Total surface heat flux incl. shortwave", "W/m^2", 2,
          lambda c, g, s, a: _need(a, "forcing", "SHF").stf[0]
          / const.HFLUX_FACTOR)
_register("SHF_QSW", "Penetrating solar heat flux", "W/m^2", 2,
          lambda c, g, s, a: _need(a, "forcing", "SHF_QSW").shf_qsw
          / const.HFLUX_FACTOR)
_register("SFWF", "Virtual salt/freshwater flux", "kg/m^2/s", 2,
          lambda c, g, s, a: _need(a, "forcing", "SFWF").fw
          / const.FWFLUX_FACTOR)
_register("FW", "Freshwater flux", "cm/s", 2,
          lambda c, g, s, a: _need(a, "forcing", "FW").fw)
_register("TFW_T", "Heat content of freshwater flux", "degC*cm/s", 2,
          lambda c, g, s, a: _need(a, "forcing", "TFW_T").tfw[0])
_register("TFW_S", "Salt content of freshwater flux", "g/g*cm/s", 2,
          lambda c, g, s, a: _need(a, "forcing", "TFW_S").tfw[1])
_register("TAUX", "Windstress in grid-x direction",
          "dyn s/(cm g) momentum flux (stress/rho_sw)", 2,
          lambda c, g, s, a: _need(a, "forcing", "TAUX").smf[0])
_register("TAUY", "Windstress in grid-y direction",
          "dyn s/(cm g) momentum flux (stress/rho_sw)", 2,
          lambda c, g, s, a: _need(a, "forcing", "TAUY").smf[1])
_register("TAUX2", "Windstress**2 in grid-x direction", "(cm^2/s^2)^2", 2,
          lambda c, g, s, a: _need(a, "forcing", "TAUX2").smf[0] ** 2)
_register("TAUY2", "Windstress**2 in grid-y direction", "(cm^2/s^2)^2", 2,
          lambda c, g, s, a: _need(a, "forcing", "TAUY2").smf[1] ** 2)
_register("ATM_PRESS", "Atmospheric pressure", "dyn/cm^2", 2,
          lambda c, g, s, a: _need(a, "forcing", "ATM_PRESS").atm_press)


def _fcomp(attr, name):
    """An optional forcing field (the runoff, the ice fraction, the
    per-component coupler fluxes of forcing_coupled.F90's tavg calls): zero
    where the forcing holds None, as in the JAX package."""
    def fn(cfg, grid, state, aux):
        v = getattr(_need(aux, "forcing", name), attr)
        return _zeros2(cfg, grid) if v is None else v
    return fn


_register("ROFF_F", "River runoff flux", "kg/m^2/s", 2,
          _fcomp("roff_f", "ROFF_F"))
_register("IFRAC", "Ice fraction from coupler", "fraction", 2,
          _fcomp("ifrac", "IFRAC"))
_register("PREC_F", "Precipitation flux from coupler (rain+snow)",
          "kg/m^2/s", 2, _fcomp("prec_f", "PREC_F"))
_register("SNOW_F", "Snow flux from coupler", "kg/m^2/s", 2,
          _fcomp("snow_f", "SNOW_F"))
_register("EVAP_F", "Evaporation flux from coupler", "kg/m^2/s", 2,
          _fcomp("evap_f", "EVAP_F"))
_register("MELT_F", "Melt flux from coupler", "kg/m^2/s", 2,
          _fcomp("melt_f", "MELT_F"))
_register("IOFF_F", "Ice runoff flux due to coupler", "kg/m^2/s", 2,
          _fcomp("ioff_f", "IOFF_F"))
_register("SALT_F", "Salt flux from coupler", "kg(salt)/m^2/s", 2,
          _fcomp("salt_f", "SALT_F"))
_register("SENH_F", "Sensible heat flux from coupler", "W/m^2", 2,
          _fcomp("senh_f", "SENH_F"))
_register("LWUP_F", "Longwave up heat flux from coupler", "W/m^2", 2,
          _fcomp("lwup_f", "LWUP_F"))
_register("LWDN_F", "Longwave down heat flux from coupler", "W/m^2", 2,
          _fcomp("lwdn_f", "LWDN_F"))
_register("MELTH_F", "Ice melt heat flux from coupler", "W/m^2", 2,
          _fcomp("melth_f", "MELTH_F"))


# -- penetrating shortwave diagnostics (sw_absorption.F90:880-940) -----------
def _sw_trans_interfaces(cfg, grid):
    """Transmission at layer-top interfaces zw(0..km-1), (km,): 1 at the
    surface; Jerlov two-band decay below; top-layer absorption otherwise.
    Built once a grid and config (kept on the grid object)."""
    key = (f"_tavg_sw_trans:{cfg.sw_absorption}:{cfg.jerlov_water_type}:"
           f"{cfg.km}:{cfg.torch_dtype}")
    hit = grid.__dict__.get(key)
    if hit is None:
        km = cfg.km
        zw = grid.vgrid.zw.to(cfg.torch_dtype)
        if cfg.sw_absorption == "jerlov":
            from pop2_tpu_torch import sw_absorption as sw_mod
            tops = torch.cat([torch.zeros_like(zw[:1]), zw[:km - 1]])
            hit = sw_mod.sw_absorb_frac(tops, cfg.jerlov_water_type)
        else:
            hit = torch.zeros_like(zw[:km])
            hit[0] = 1.0
        grid.__dict__[key] = hit
    return hit


def _qsw_htp(cfg, grid, state, aux):
    f = _need(aux, "forcing", "QSW_HTP")
    trans = _sw_trans_interfaces(cfg, grid)
    below = trans[1] if cfg.km > 1 else 0.0
    return (f.shf_qsw * (trans[0] - below) / const.HFLUX_FACTOR
            * (grid.KMT > 0))


def _qsw_3d(cfg, grid, state, aux):
    f = _need(aux, "forcing", "QSW_3D")
    trans = _sw_trans_interfaces(cfg, grid)
    return torch.where(grid.kmask_t,
                       f.shf_qsw[None] * _col(trans) / const.HFLUX_FACTOR,
                       0.0)


def _qsw_hbl(cfg, grid, state, aux):
    f = _need(aux, "forcing", "QSW_HBL")
    hblt = _need(aux, "hblt", "QSW_HBL")
    if cfg.sw_absorption == "jerlov":
        from pop2_tpu_torch import sw_absorption as sw_mod
        absorb = sw_mod.sw_absorb_frac(hblt, cfg.jerlov_water_type)
        qsw = f.shf_qsw * (1.0 - absorb)
    else:
        qsw = f.shf_qsw
    return qsw / const.HFLUX_FACTOR * (grid.KMT > 0)


# -- tracer tendency components (baroclinic.F90 / advection.F90 /
#    horizontal_mix.F90 tavg accumulations). The advective and horizontal-
#    diffusive pieces are recomputed from the state exactly as the step
#    computed them (same functions); the total tendency and the implicit
#    vertical flux come from step extras / the step's diffusivity.
def _advection(cfg, grid, state, aux):
    """The advective tendency of every tracer, (nt, km, ny, nx); lw_lim
    advects the mixing-time tracers with the leapfrog step."""
    from pop2_tpu_torch import advect, baroclinic
    c2dtt = (baroclinic._timestep_arrays(cfg, grid, True)[0]
             if cfg.tadvect == "lw_lim" else None)
    return _once(aux, "advt", state, lambda: advect.advt(
        cfg, grid, aux.bc, _flux_vel(cfg, grid, aux, state),
        state.tracer_cur, tmix=state.tracer_old, c2dtt=c2dtt))


def _adv_3d(cfg, grid, state, aux, n):
    return -_advection(cfg, grid, state, aux)[n]


def _vint(cfg, grid, f3):
    return torch.sum(f3 * _col(grid.vgrid.dz), dim=0)


def _hdif_3d(cfg, grid, state, aux, n):
    """The horizontal-diffusion tendency of tracer ``n``: GM's (its flux
    assembly through the ``gm_cuda`` kernel on CUDA tensors) or the
    Laplacian's, of the mixing-time tracers (and GM's velocities)."""
    if cfg.hmix_tracer == "gm":
        from pop2_tpu_torch import gm as gm_mod
        gtk = _once(aux, "hdifft_gm", state, lambda: gm_mod.hdifft_gm(
            cfg, grid, aux.bc, None, state.tracer_old, hblt=aux.hblt,
            umix=state.u_old, vmix_m=state.v_old).gtk)
        return gtk[n]
    from pop2_tpu_torch import hmix
    return _once(aux, "hdifft", state, lambda: hmix.hdifft(
        cfg, grid, aux.bc, state.tracer_old))[n]


def _dia_impvf(cfg, grid, state, aux, n):
    """Diabatic implicit-vertical-diffusion flux across each level bottom
    face, VDC*(T_k - T_{k+1})/dzw of the updated tracers
    (source/vertical_mix.F90 tavg_DIA_IMPVF accumulation)."""
    vdc = _need(aux, "vdc", "DIA_IMPVF")[min(n, 1)]
    t = state.tracer_cur[n]
    t_kp1 = torch.cat([t[1:], t[-1:]], dim=0)
    km = cfg.km
    dzwr = _col(1.0 / grid.vgrid.dzw[1:km + 1])
    below = _kidx(km, t.device) < grid.KMT[None]
    return torch.where(below, vdc * (t - t_kp1) * dzwr, 0.0)


_register("TEND_TEMP", "Tendency of Potential Temperature", "degC/s", 3,
          lambda c, g, s, a: _need(a, "tend_tracer", "TEND_TEMP")[0])
_register("TEND_SALT", "Tendency of Salinity", "(g/g)/s", 3,
          lambda c, g, s, a: _need(a, "tend_tracer", "TEND_SALT")[1])
_register("ADV_3D_TEMP", "T Advection Tendency", "degC/s", 3,
          lambda c, g, s, a: _adv_3d(c, g, s, a, 0))
_register("ADV_3D_SALT", "S Advection Tendency", "(g/g)/s", 3,
          lambda c, g, s, a: _adv_3d(c, g, s, a, 1))
_register("ADVT", "Vertically-Integrated T Advection Tendency",
          "degC cm/s", 2,
          lambda c, g, s, a: _vint(c, g, _adv_3d(c, g, s, a, 0)))
_register("ADVS", "Vertically-Integrated S Advection Tendency",
          "(g/g) cm/s", 2,
          lambda c, g, s, a: _vint(c, g, _adv_3d(c, g, s, a, 1)))
_register("HDIFT", "Vertically-Integrated T Horizontal Diffusion Tendency",
          "degC cm/s", 2,
          lambda c, g, s, a: _vint(c, g, _hdif_3d(c, g, s, a, 0)))
_register("HDIFS", "Vertically-Integrated S Horizontal Diffusion Tendency",
          "(g/g) cm/s", 2,
          lambda c, g, s, a: _vint(c, g, _hdif_3d(c, g, s, a, 1)))
_register("DIA_IMPVF_TEMP", "T Diabatic Implicit Vertical Flux",
          "degC cm/s", 3, lambda c, g, s, a: _dia_impvf(c, g, s, a, 0))
_register("DIA_IMPVF_SALT", "S Diabatic Implicit Vertical Flux",
          "(g/g) cm/s", 3, lambda c, g, s, a: _dia_impvf(c, g, s, a, 1))


_register("QSW_HTP", "Solar short-wave heat flux in top layer", "W/m^2", 2,
          _qsw_htp)
_register("QSW_3D", "Solar short-wave heat flux at layer tops", "W/m^2", 3,
          _qsw_3d)
_register("QSW_HBL", "Solar short-wave heat flux in boundary layer",
          "W/m^2", 2, _qsw_hbl)

# -- ice formation (ice.F90 tavg_QICE) ---------------------------------------
_register("QICE", "Internal ocean heat used to form ice", "W/m^2", 2,
          lambda c, g, s, a: s.qice / const.HFLUX_FACTOR)
_register("AQICE", "Accumulated ice heat flux", "W/m^2", 2,
          lambda c, g, s, a: s.aqice / const.HFLUX_FACTOR)

# -- vertical-mixing internals (vmix_kpp.F90 bldepth/vmix_coeffs tavg) -------
_register("HBLT", "Boundary-Layer Depth", "centimeter", 2,
          lambda c, g, s, a: _need(a, "hblt", "HBLT"))
_register("XBLT", "Maximum Boundary-Layer Depth", "centimeter", 2,
          lambda c, g, s, a: _need(a, "hblt", "XBLT"), method="max")
_register("TBLT", "Minimum Boundary-Layer Depth", "centimeter", 2,
          lambda c, g, s, a: _need(a, "hblt", "TBLT"), method="min")
_register("HMXL", "Mixed-Layer Depth", "centimeter", 2,
          lambda c, g, s, a: _need(a, "hmxl", "HMXL"))
_register("XMXL", "Maximum Mixed-Layer Depth", "centimeter", 2,
          lambda c, g, s, a: _need(a, "hmxl", "XMXL"), method="max")
_register("TMXL", "Minimum Mixed-Layer Depth", "centimeter", 2,
          lambda c, g, s, a: _need(a, "hmxl", "TMXL"), method="min")
_register("VDC_T", "Vertical diffusivity, temperature class", "cm^2/s", 3,
          lambda c, g, s, a: _need(a, "vdc", "VDC_T")[0])
_register("VDC_S", "Vertical diffusivity, salinity class", "cm^2/s", 3,
          lambda c, g, s, a: _need(a, "vdc", "VDC_S")[1])
_register("VVC", "Vertical viscosity", "cm^2/s", 3,
          lambda c, g, s, a: _need(a, "vvc", "VVC"))


def _bck_vdc(cfg, grid):
    """Background internal-wave diffusivity field, (km, ny, nx)
    (vmix_kpp.F90:544-632 via kpp.background_vdc: the atan profile or the
    lhoriz_varying latitude structure). Built once a grid and config (kept
    on the grid object)."""
    params = (cfg.bckgrnd_vdc, cfg.bckgrnd_vdc2, cfg.bckgrnd_vdc_dpth,
              cfg.bckgrnd_vdc_linv, cfg.kpp_lhoriz_varying_bckgrnd,
              cfg.bckgrnd_vdc_psim, cfg.bckgrnd_vdc_eq, cfg.bckgrnd_vdc_ban,
              cfg.km, cfg.torch_dtype)
    key = f"_tavg_bck_vdc:{params!r}"
    hit = grid.__dict__.get(key)
    if hit is None:
        from pop2_tpu_torch import kpp as kpp_mod
        prof = torch.as_tensor(kpp_mod.background_vdc(cfg, grid)).to(
            dtype=cfg.torch_dtype, device=grid.KMT.device)
        hit = torch.where(grid.kmask_t, prof.expand(cfg.km, cfg.ny, cfg.nx),
                          0.0)
        grid.__dict__[key] = hit
    return hit


_register("KAPPA_ISOP", "Isopycnal (Redi) diffusivity (cell avg of the "
          "tapered half-cell values)", "cm^2/s", 3,
          lambda c, g, s, a: _need(a, "kappa_isop", "KAPPA_ISOP"))
_register("KAPPA_THIC", "Thickness (GM bolus) diffusivity (cell avg)",
          "cm^2/s", 3,
          lambda c, g, s, a: _need(a, "kappa_thic", "KAPPA_THIC"))
_register("HOR_DIFF", "Horizontal diffusivity in the surface diabatic "
          "layer (cell avg)", "cm^2/s", 3,
          lambda c, g, s, a: _need(a, "hor_diff", "HOR_DIFF"))
_register("DIA_DEPTH", "Depth of the Diabatic Region at the Surface",
          "centimeter", 2,
          lambda c, g, s, a: _need(a, "dia_depth", "DIA_DEPTH"))
_register("TLT", "Transition Layer Thickness", "centimeter", 2,
          lambda c, g, s, a: _need(a, "tlt_thick", "TLT"))
_register("INT_DEPTH", "Depth at which the Interior Region Starts",
          "centimeter", 2,
          lambda c, g, s, a: _need(a, "int_depth", "INT_DEPTH"))
_register("VDC_BCK", "Background vertical tracer diffusivity",
          "cm^2/s", 3, lambda c, g, s, a: _bck_vdc(c, g))
_register("VVC_BCK", "Background vertical viscosity", "cm^2/s", 3,
          lambda c, g, s, a: c.prandtl * _bck_vdc(c, g))
_register("KVMIX", "Vertical diabatic diffusivity due to Tidal Mixing + "
          "background", "cm^2/s", 3,
          lambda c, g, s, a: _need(a, "kvmix", "KVMIX"))
_register("KVMIX_M", "Vertical viscosity due to Tidal Mixing + "
          "background", "cm^2/s", 3,
          lambda c, g, s, a: _need(a, "kvmix_m", "KVMIX_M"))
_register("TPOWER", "Energy Used by Vertical Mixing", "erg/s/cm^3", 3,
          lambda c, g, s, a: _need(a, "tpower", "TPOWER"))

# density-criterion mixed-layer depths (HMXL_DR, QL 150526,
# vmix_kpp.F90:1385-1417) + the stream-2 duplicate registrations of the
# mixed-layer fields (gx1v7_tavg_contents '2 HMXL_DR_2' etc.)
_register("HMXL_DR", "Mixed-Layer Depth (density)", "centimeter", 2,
          lambda c, g, s, a: _need(a, "hmxl_dr", "HMXL_DR"))
_register("HMXL_DR2", "Mixed-Layer Depth squared (density)",
          "centimeter^2", 2,
          lambda c, g, s, a: _need(a, "hmxl_dr", "HMXL_DR2") ** 2)
_register("XMXL_DR", "Maximum Mixed-Layer Depth (density)", "centimeter",
          2, lambda c, g, s, a: _need(a, "hmxl_dr", "XMXL_DR"),
          method="max")
_register("TMXL_DR", "Minimum Mixed-Layer Depth (density)", "centimeter",
          2, lambda c, g, s, a: _need(a, "hmxl_dr", "TMXL_DR"),
          method="min")
_register("HMXL_DR_2", "Mixed-Layer Depth (density, stream 2)",
          "centimeter", 2,
          lambda c, g, s, a: _need(a, "hmxl_dr", "HMXL_DR_2"))
_register("HMXL_2", "Mixed-Layer Depth (stream 2)", "centimeter", 2,
          lambda c, g, s, a: _need(a, "hmxl", "HMXL_2"))
_register("XMXL_2", "Maximum Mixed-Layer Depth (stream 2)", "centimeter",
          2, lambda c, g, s, a: _need(a, "hmxl", "XMXL_2"), method="max")


def _qflux(c, g, s, a):
    """Internal ocean heat flux due to ice formation (W/m^2): the heat
    extracted by frazil formation this step, QICE/dt converted by the
    hflux factor (ice.F90 QFLUX; the reference holds QFLUX constant
    between ice timesteps — here the per-step equivalent)."""
    return torch.where(g.kmask_t[0],
                       -s.qice / c.time.dtt / const.HFLUX_FACTOR, 0.0)


_register("QFLUX", "Internal Ocean Heat Flux Due to Ice Formation",
          "watt/m^2", 2, _qflux)


def _dtemp(c, g, s, a, sign):
    d = s.tracer_cur[0, 0] - s.tracer_old[0, 0]
    return (torch.clamp(d, min=0.0) if sign > 0
            else torch.clamp(d, max=0.0))


_register("dTEMP_POS_2D", "max positive temperature timestep diff",
          "degC", 2, lambda c, g, s, a: _dtemp(c, g, s, a, +1))
_register("dTEMP_NEG_2D", "min negative temperature timestep diff",
          "degC", 2, lambda c, g, s, a: _dtemp(c, g, s, a, -1))


def _resid(c, g, s, a, n, factor):
    """Free-surface residual flux (RESID_T/RESID_S,
    source/baroclinic.F90:2416-2431): DH * tracer / conversion at the
    surface; identically zero under the variable-thickness surface layer
    (the reference only accumulates it for rigid/oldfree)."""
    if c.sfc_layer == "varthick":
        return torch.zeros_like(s.psurf_cur)
    from pop2_tpu_torch import step as step_mod
    dh, _ = step_mod.dhdt(c, g, a.bc, s)
    return torch.where(g.kmask_t[0], dh * s.tracer_cur[n, 0] * factor, 0.0)


_register("RESID_T", "Free-Surface Residual Flux (T)", "watt/m^2", 2,
          lambda c, g, s, a: _resid(c, g, s, a, 0,
                                    1.0 / const.HFLUX_FACTOR))
_register("RESID_S", "Free-Surface Residual Flux (S)", "kg/m^2/s", 2,
          lambda c, g, s, a: _resid(c, g, s, a, 1,
                                    1.0 / const.SALINITY_FACTOR))

# weak-restoring virtual salt flux: nonzero only under the
# 'partially-coupled' sfwf formulation (source/forcing.F90:560-571
# sets WORK = c0 otherwise); the coupled path carries no weak restoring
_register("SFWF_WRST", "Virtual Salt Flux due to weak restoring",
          "kg/m^2/s", 2, lambda c, g, s, a: torch.zeros_like(s.psurf_cur))

_register("RF_TEND_TEMP", "Robert Filter Tendency for TEMP", "degC/s", 3,
          lambda c, g, s, a: _need(a, "rf_tend_tracer", "RF_TEND_TEMP")[0])
_register("RF_TEND_SALT", "Robert Filter Tendency for SALT", "msu/s", 3,
          lambda c, g, s, a: _need(a, "rf_tend_tracer", "RF_TEND_SALT")[1])


def _estuary_exch_flux(c, g, s, a, n):
    """Vertical tracer flux across the EBM upper/lower layer interface
    (FLUX_EXCH_INTRF, source/estuary_vsf_mod.F90:727-751): zero unless
    ``lestuary_exch`` is set with a runoff in the forcing."""
    if not c.lestuary_exch or a.forcing is None \
            or a.forcing.roff_f is None:
        return torch.zeros_like(s.psurf_cur)
    w_up, w_lo = estuary.device_layer_weights(c, g, s.tracer_cur.dtype)
    _, flux = estuary.exchange_circulation(c, g, s.tracer_cur,
                                           a.forcing.roff_f, w_up, w_lo,
                                           want_flux=True)
    return flux[n]


_register("T_FLUX_EXCH_INTRF", "Vertical Temperature Flux Across "
          "Upper/Lower Layer Interface (From EBM)", "degC*cm/s", 2,
          lambda c, g, s, a: _estuary_exch_flux(c, g, s, a, 0))
_register("S_FLUX_EXCH_INTRF", "Vertical Salt Flux Across Upper/Lower "
          "Layer Interface (From EBM)", "msu*cm/s", 2,
          lambda c, g, s, a: _estuary_exch_flux(c, g, s, a, 1))


def _roff_vsf(c, g, s, a):
    """Surface virtual salt flux from river runoff (S_FLUX_ROFF_VSF_SRF,
    source/estuary_vsf_mod.F90:416-424): zero unless ``lestuary_exch`` is
    set with a runoff in the forcing."""
    if not c.lestuary_exch or a.forcing is None \
            or a.forcing.roff_f is None:
        return torch.zeros_like(s.psurf_cur)
    return estuary.river_vsf(c, g, a.forcing.roff_f, s.tracer_cur[1, 0])


_register("S_FLUX_ROFF_VSF_SRF", "Surface Salt Virtual Salt Flux "
          "Associated with Rivers (From VSF)", "msu*cm/s", 2, _roff_vsf)

#: the fields whose values depend on the grid and the config alone: their
#: tensors are built when a stream holding them is made
_STATIC = {"VDC_BCK": _bck_vdc, "VVC_BCK": _bck_vdc,
           "QSW_HTP": _sw_trans_interfaces, "QSW_3D": _sw_trans_interfaces}


def build_statics(cfg: ModelConfig, grid: Grid, contents) -> None:
    """Build (once, on the grid's device) the grid- and config-only tensors
    the fields of ``contents`` read, so that no accumulation builds them,
    and the host copy of the files' coordinates."""
    for name in contents:
        if name in _STATIC:
            _STATIC[name](cfg, grid)
    _coords(grid)


def _np(t) -> np.ndarray:
    """A NumPy copy of ``t`` (never a view of a CPU tensor's memory, which
    the accumulators' reset would overwrite)."""
    return t.detach().to("cpu", copy=True).numpy()


def _coords(grid):
    """(z_t in cm, TLAT and TLONG in degrees) as NumPy, read from the
    device once a grid object (kept on it): a write reads nothing else of
    the grid from the device. On a block grid the whole domain's, gathered
    on every rank (collective: a stream calls it when it is made)."""
    hit = grid.__dict__.get("_tavg_coords")
    if hit is None:
        d = pmesh.of_grid(grid)
        if pmesh.over_ranks(d):
            from pop2_tpu_torch.parallel.multihost import to_host_replicated

            def whole(t):
                return to_host_replicated(t.detach(), d).copy()
        else:
            whole = _np
        hit = (_np(grid.vgrid.zt), whole(grid.TLAT) * const.RADIAN,
               whole(grid.TLON) * const.RADIAN)
        grid.__dict__["_tavg_coords"] = hit
    return hit


def field_config(cfg: ModelConfig, mesh) -> ModelConfig:
    """The config a stream's fields are evaluated with: ``cfg`` on the
    whole domain, the block's (``mesh.block_cfg``) on a rank's block."""
    return (pmesh.block_cfg(cfg, mesh.rows, mesh.cols)
            if pmesh.over_ranks(mesh) else cfg)


def write_fields_netcdf(cfg, grid, fname: str, contents, arrays,
                        step_number: int = 0) -> str:
    """Shared stream writer with z_t/TLAT/TLONG coordinates (the
    reference's io_netcdf.F90/io_pio.F90 field-writing path). ``arrays``
    maps field name -> NumPy array shaped per FIELDS[name].ndims.
    cfg.tavg_fmt_out selects NetCDF3-classic ('nc', scipy) or
    netCDF-4/HDF5 ('nc4', chunked + compressed, io/netcdf4.py). Fields are
    written as float32."""
    if getattr(cfg, "tavg_fmt_out", "nc") == "nc4":
        return _write_fields_nc4(cfg, grid, fname, contents, arrays,
                                 step_number)
    from scipy.io import netcdf_file
    z_t, lat, lon = _coords(grid)
    with netcdf_file(fname, "w") as f:
        f.createDimension("time", 1)
        f.createDimension("z_t", cfg.km)
        f.createDimension("nlat", cfg.ny)
        f.createDimension("nlon", cfg.nx)

        zt = f.createVariable("z_t", "d", ("z_t",))
        zt[:] = z_t
        zt.units = b"centimeters"
        tlat = f.createVariable("TLAT", "d", ("nlat", "nlon"))
        tlat[:] = lat
        tlat.units = b"degrees_north"
        tlon = f.createVariable("TLONG", "d", ("nlat", "nlon"))
        tlon[:] = lon
        tlon.units = b"degrees_east"
        tvar = f.createVariable("time", "d", ("time",))
        tvar[:] = [float(step_number)]
        tvar.units = b"steps"

        for n in contents:
            d = FIELDS[n]
            arr = np.asarray(arrays[n])
            dims = (("time", "z_t", "nlat", "nlon") if arr.ndim == 3
                    else ("time", "nlat", "nlon"))
            v = f.createVariable(n, "f", dims)
            v[:] = arr[None].astype(np.float32)
            v.units = d.units.encode()
            v.long_name = d.long_name.encode()
    return fname


def _write_fields_nc4(cfg, grid, fname, contents, arrays,
                      step_number: int = 0) -> str:
    """netCDF-4 flavor of write_fields_netcdf (io/netcdf4.py)."""
    from pop2_tpu_torch.io.netcdf4 import write_netcdf4
    z_t, lat, lon = _coords(grid)
    dims = {"time": 1, "z_t": cfg.km, "nlat": cfg.ny, "nlon": cfg.nx}
    variables = {
        "z_t": (("z_t",), z_t, {"units": "centimeters"}),
        "time": (("time",), np.asarray([float(step_number)]),
                 {"units": "steps"}),
        "TLAT": (("nlat", "nlon"), lat, {"units": "degrees_north"}),
        "TLONG": (("nlat", "nlon"), lon, {"units": "degrees_east"}),
    }
    for n in contents:
        d = FIELDS[n]
        arr = np.asarray(arrays[n])[None].astype(np.float32)
        vdims = (("time", "z_t", "nlat", "nlon") if arr.ndim == 4
                 else ("time", "nlat", "nlon"))
        variables[n] = (vdims, arr,
                        {"units": d.units, "long_name": d.long_name})
    return write_netcdf4(fname, dims, variables,
                         global_attrs={"title": "pop2_tpu tavg",
                                       "source": "pop2_tpu"})


class TavgStream:
    """One output stream: a set of fields accumulated every step and written
    every ``freq_steps`` steps (reference stream mechanism,
    source/tavg.F90:482-1568). The accumulators are views of one buffer on
    the grid's device, updated in place (see the module's docstring).
    ``cfg``: the whole domain's; ``mesh``: the decomposition whose block
    ``grid`` is (None: the whole domain)."""

    def __init__(self, cfg: ModelConfig, grid: Grid, contents: List[str],
                 freq_steps: int, outfile_prefix: str = "tavg", mesh=None):
        unknown = [n for n in contents if n not in FIELDS]
        if unknown:
            raise KeyError(f"unknown tavg fields: {unknown} "
                           f"(available: {sorted(FIELDS)})")
        self.cfg = cfg
        self.grid = grid
        self.mesh = mesh
        self.field_cfg = fcfg = field_config(cfg, mesh)
        self.contents = list(contents)
        self.freq_steps = freq_steps
        self.prefix = outfile_prefix
        self.flag_name = None
        self.nsamples = 0
        self._defs = [FIELDS[n] for n in dict.fromkeys(self.contents)]
        shapes = {d.name: ((fcfg.km, fcfg.ny, fcfg.nx) if d.ndims == 3
                           else (fcfg.ny, fcfg.nx)) for d in self._defs}
        sizes = {n: int(np.prod(s)) for n, s in shapes.items()}
        self.buffer = torch.empty(sum(sizes.values()),
                                  dtype=cfg.torch_dtype,
                                  device=grid.KMT.device)
        self.sums: Dict[str, torch.Tensor] = {}
        self._spans = {}
        start = 0
        for n, shape in shapes.items():
            self._spans[n] = (start, start + sizes[n], shape)
            self.sums[n] = self.buffer[start:start + sizes[n]].view(shape)
            start += sizes[n]
        self.reset()
        build_statics(fcfg, grid, self.contents)

    def accumulate_fields(self, state: State,
                          aux: TavgAux = TavgAux()) -> None:
        """Add one sample of every field into the accumulators, in place,
        with the shared intermediates computed once (in ``aux.memo``, which
        the streams of one step may share; a new one if it is None). Device
        work only: no host read, no host value (``graphs.CapturedStep``
        captures it)."""
        cfg, grid = self.field_cfg, self.grid
        if aux.memo is None:
            aux = aux._replace(memo={})
        for d in self._defs:
            val = d.fn(cfg, grid, state, aux)
            acc = self.sums[d.name]
            if d.method == "min":
                torch.minimum(acc, val, out=acc)
            elif d.method == "max":
                torch.maximum(acc, val, out=acc)
            else:
                acc.add_(val)

    def accumulate(self, state: State, aux: TavgAux = TavgAux()) -> None:
        self.accumulate_fields(state, aux)
        self.nsamples += 1

    @property
    def ready(self) -> bool:
        return self.nsamples >= self.freq_steps

    def reset(self) -> None:
        """Start a new interval: the averages' sums at zero, the minima and
        maxima at -+finfo.max/4, written into the same buffer."""
        big = torch.finfo(self.cfg.torch_dtype).max / 4
        for d in self._defs:
            acc = self.sums[d.name]
            acc.fill_(big if d.method == "min"
                      else -big if d.method == "max" else 0.0)
        self.nsamples = 0

    def averages(self) -> Optional[Dict[str, np.ndarray]]:
        """{field: NumPy array}: the sums over ``nsamples`` (the minima and
        maxima as they are), from one read of the device buffer. On a
        rank's block every rank's buffer is gathered (collective) and rank 0
        gets the whole domain's fields; the other ranks get None. The
        blocks of a one-process mesh gather on the device, where block 0
        joins every field; the device is read once."""
        norm = 1.0 / max(self.nsamples, 1)
        if pmesh.over_ranks(self.mesh):
            parts = self.mesh.comm.gather(self.buffer)
            if parts is None:
                return None
            from pop2_tpu_torch.parallel.multihost import join_blocks
            wholes = [join_blocks([p[lo:hi].view(shape) for p in parts],
                                  self.mesh)
                      for lo, hi, shape in (self._spans[n]
                                            for n in self.contents)]
            del parts
            host = _np(torch.cat([w.reshape(-1) for w in wholes]))
            fields, at = {}, 0
            for n, w in zip(self.contents, wholes):
                fields[n] = host[at:at + w.numel()].reshape(tuple(w.shape))
                at += w.numel()
            del wholes
        else:
            host = _np(self.buffer)
            fields = {n: host[lo:hi].reshape(shape)
                      for n, (lo, hi, shape) in self._spans.items()}
        out = {}
        for n in self.contents:
            a = fields[n]
            out[n] = a if FIELDS[n].method in ("min", "max") else a * norm
        return out

    def write(self, path: str, step_number: int = 0) -> str:
        """Write the normalized averages (NetCDF3 classic or netCDF-4 by
        cfg.tavg_fmt_out); returns the path. On a rank's block every rank
        calls it, and rank 0 writes the whole domain's file."""
        fname = f"{path}/{self.prefix}.{step_number:08d}.nc" \
            if not path.endswith(".nc") else path
        arrays = self.averages()
        if arrays is not None:
            write_fields_netcdf(self.cfg, self.grid, fname, self.contents,
                                arrays, step_number)
        return fname

    # -- accumulator checkpointing (read_tavg/write_tavg,
    #    source/tavg.F90:2325,1570); on a rank's block, the block's --
    def save_accumulators(self):
        return {"nsamples": self.nsamples,
                **{f"sum_{k}": _np(v) for k, v in self.sums.items()}}

    def restore_accumulators(self, data) -> None:
        """Copy saved sums into the accumulators (the same buffer); the
        saved fields must be this stream's."""
        saved = {k[4:]: v for k, v in data.items() if k.startswith("sum_")}
        if set(saved) != set(self.sums):
            raise ValueError(f"saved accumulators {sorted(saved)} are not "
                             f"this stream's {sorted(self.sums)}")
        for k, v in saved.items():
            self.sums[k].copy_(torch.as_tensor(np.asarray(v)))
        self.nsamples = int(data["nsamples"])
