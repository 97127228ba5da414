"""Overflow (marginal-sea outflow) parameterization.

Reference: ``source/overflows.F90`` — the Briegleb, Danabasoglu & Large
(2010) scheme: regional averages over inflow/source/entrainment regions
(ovf_reg_avgs :3558-3747), the source/entrainment transport law
(ovf_transports :3754-4182):

    g'_s = g (rho_s - rho_i)/rho_sw,   M_s = g'_s h_u^2 / (2 f)
    g'_e = g (rho_sed - rho_e)/rho_sw, U_geo = g'_e alpha / f
    h_geo from  (f W/2) h^2 + (f W h_s/2 + 2 c_d U_avg x_se
                 - M_s f/(2 U_geo)) h - f M_s h_s/(2 U_geo) = 0
    F_geo = U_geo / sqrt(g'_e h_geo),  phi = 1 - F_geo^(-2/3)
    M_e = M_s phi/(1-phi),  M_p = M_s + M_e,
    T_p = (1-phi) T_s + phi T_e  (same for every tracer)

product-water insertion at the neutrally-buoyant product set
(ovf_loc_prd :4189-4681), sidewall momentum (ovf_UV :4848 +
ovf_UV_solution :5884) and the barotropic couplings
(ovf_rhs_brtrpc_momentum :5068, ovf_rhs_brtrpc_continuity :5381).

As in the JAX package, the overflow enters as a conservative closed-circuit
tracer exchange over statically cropped region slices: product cells are
relaxed toward the product mixture at rate M_p/V_p while source and
entrainment cells receive the implied return flow. Regions and sidewall
points come from config boxes and point data (``config.OverflowSpec``),
which ``io.input_templates.read_overflows`` reads from the reference's
``overflows_infile``. Region masks are kept cropped to their bounding boxes.

The statics are built once on the host in float64 and moved to the grid's
device. The region volumes and areas the transport law's stability cap
reads are host floats and device tensors both, so a step reads no value
back from the device; the product-set selection stays on the device.

On a rank's block of a decomposition (``parallel.mesh``) the statics are
built on the whole domain and cut (``decompose_statics``): the regions keep
their global boxes, the ZX/ZY map is cut to the block and each sidewall
momentum table keeps the points the block owns, in block indices. A step
fetches every region's crop of the tracers from the blocks that hold it
(``Decomposition.fetch``, one exchange), so every rank forms the whole
domain's region means from the same values in the same order; each block
then adds the region tendencies, footprints and sidewall shifts at the
points it owns.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from pop2_tpu_torch import constants as const
from pop2_tpu_torch import eos
from pop2_tpu_torch.config import ModelConfig, RegionBox
from pop2_tpu_torch.grid import Grid, _np_shift, pressure_bars, thickness_t
from pop2_tpu_torch.parallel import mesh as pmesh


class RegionData(NamedTuple):
    """One overflow region, cropped to its static bounding box."""
    box: Tuple[int, int, int, int, int, int]  # (k0,k1,j0,j1,i0,i1) incl.
    mask: torch.Tensor    # (dk, dj, di) {0,1} including the ocean mask
    vol: torch.Tensor     # () region volume (cm^3)
    fmask: torch.Tensor   # (dj, di) column footprint {0,1}
    area: torch.Tensor    # () footprint area (cm^2)
    vol_host: float       # vol and area as host floats
    area_host: float
    wvol: torch.Tensor    # (dk, dj, di) cell volumes in the model's dtype


class OverflowStatics(NamedTuple):
    regions: tuple          # (n_ovf)(4) nested RegionData (inf,src,ent,prd)
    press_s: torch.Tensor   # (n_ovf,) pressure at source depth (bars)
    press_e: torch.Tensor   # (n_ovf,)
    fs: torch.Tensor        # (n_ovf,) coriolis parameter
    params: torch.Tensor    # (n_ovf, 6) Ws, hu, xse, alpha, cd, hs
    # the stability cap's volumes and areas of the source, entrainment and
    # (smallest) product region of each overflow, (n_ovf, 3)
    cap_vol: torch.Tensor
    cap_area: torch.Tensor
    # --- point-data extensions (None when the specs carry only boxes) ---
    # product-set adjacent regions (ovf_loc_prd / adj_prd,
    # source/overflows.F90:830-873)
    sets: Optional[tuple] = None        # (n_ovf)(S_o) RegionData
    set_press: Optional[tuple] = None   # (n_ovf)(S_o) tensors of bars
    # sidewall momentum point tables (ovf_UV/ovf_U_column,
    # source/overflows.F90:4848-5061, 6072-6189), one per component
    mom_u: Optional[dict] = None
    mom_v: Optional[dict] = None
    # ZX/ZY barotropic-forcing renormalization map
    # (ovf_rhs_brtrpc_momentum, :5068-5224)
    zren: Optional[torch.Tensor] = None  # (ny, nx)


REG_INF, REG_SRC, REG_ENT, REG_PRD = 0, 1, 2, 3

# orientation -> (di, dj) of the adjacent active cell (i_adv/j_adv,
# source/overflows.F90:419-458); orientation 1=+x, 2=+y, 3=-x, 4=-y
_ADJ = {1: (1, 0), 2: (0, 1), 3: (-1, 0), 4: (0, -1)}


def _u_point(i, j, orient, nx):
    """U-point (i_u, j_u) on the sidewall of T-cell (i, j) for the given
    orientation (0-based; source/overflows.F90:419-458)."""
    if orient == 1:
        return i, j
    if orient == 2:
        return (i - 1) % nx, j
    if orient == 3:
        return (i - 1) % nx, j - 1
    if orient == 4:
        return i, j - 1
    raise ValueError(f"bad orientation {orient}")


def _walls(spec):
    """Every sidewall point of an overflow: source, entrainment, then each
    product set."""
    yield from spec.src_pts
    yield from spec.ent_pts
    for pts in spec.prd_sets:
        yield from pts


def wet_regions(cfg: ModelConfig, kmt: np.ndarray) -> None:
    """With the internal topography, make the overflow regions and the
    cells beside the sidewall points wet (in place on ``kmt`` (ny, nx)):
    the regions are defined on the real grids' bathymetry, where they are
    wet by construction."""
    ny, nx, km = cfg.ny, cfg.nx, cfg.km
    for spec in cfg.overflows:
        for box in (spec.inf, spec.src, spec.ent, spec.prd):
            sl = kmt[box.jmin:box.jmax + 1, box.imin:box.imax + 1]
            kmt[box.jmin:box.jmax + 1, box.imin:box.imax + 1] = \
                np.maximum(sl, min(box.kmax + 1, km))
        for (i, j, k0, orient) in _walls(spec):
            di, dj = _ADJ[orient]
            ja, ia = j + dj, (i + di) % nx
            if 0 <= ja < ny:
                kmt[ja, ia] = max(kmt[ja, ia], min(k0 + 1, km))


def _region_volumes(cfg, grid, box):
    """The cropped cell volumes the region means weight by, formed on the
    device in the model's dtype (the whole domain's thickness and TAREA)."""
    k0, k1, j0, j1, i0, i1 = box
    dz = thickness_t(cfg, grid)[k0:k1 + 1]
    if dz.shape[1] != 1:  # 3-D layer thickness
        dz = dz[:, j0:j1 + 1, i0:i1 + 1]
    return dz * grid.TAREA[None, j0:j1 + 1, i0:i1 + 1]


def _region_data(cfg, grid, vol3, kmask, tarea, box,
                 name) -> RegionData:
    k0, k1, j0, j1, i0, i1 = (box.kmin, box.kmax, box.jmin, box.jmax,
                              box.imin, box.imax)
    m = kmask[k0:k1 + 1, j0:j1 + 1, i0:i1 + 1].astype(np.float64)
    vol = float((m * vol3[k0:k1 + 1, j0:j1 + 1, i0:i1 + 1]).sum())
    if vol <= 0.0:
        raise ValueError(f"overflow region {name} has no ocean cells")
    fm = (m.max(axis=0) > 0).astype(np.float64)
    area = float((fm * tarea[j0:j1 + 1, i0:i1 + 1]).sum())

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64)).to(
            device=grid.KMT.device, dtype=cfg.torch_dtype)
    box = (k0, k1, j0, j1, i0, i1)
    return RegionData(box=box, mask=t(m), vol=t(vol), fmask=t(fm),
                      area=t(area), vol_host=vol, area_host=area,
                      wvol=_region_volumes(cfg, grid, box))


def region_mask3(cfg: ModelConfig, st: OverflowStatics, o: int,
                 r: int) -> np.ndarray:
    """Dense (km, ny, nx) {0,1} mask of region ``r`` of overflow ``o``
    (from the cropped statics; for tests and diagnostics)."""
    rd = st.regions[o][r]
    k0, k1, j0, j1, i0, i1 = rd.box
    out = np.zeros((cfg.km, cfg.ny, cfg.nx))
    out[k0:k1 + 1, j0:j1 + 1, i0:i1 + 1] = rd.mask.double().cpu().numpy()
    return out


def footprint2(cfg: ModelConfig, rd: RegionData) -> np.ndarray:
    """Dense (ny, nx) footprint of a RegionData."""
    k0, k1, j0, j1, i0, i1 = rd.box
    out = np.zeros((cfg.ny, cfg.nx))
    out[j0:j1 + 1, i0:i1 + 1] = rd.fmask.double().cpu().numpy()
    return out


def validate_geometry(cfg: ModelConfig):
    """Check every overflow's kmt-change records against the topography
    before the changes, and drop the overflows that disagree (strict mode
    raises). The reference's init_overflows_kmt counts KMT /= korg
    mismatches and aborts the run (source/overflows.F90:1196-1275); the JAX
    package warns and deactivates instead, so a model on a generated
    topography keeps running, and so does this. Returns a (possibly
    reduced) config."""
    checked = [s for s in cfg.overflows if s.kmt_changes]
    if not checked:
        return cfg
    from pop2_tpu_torch.grid import build_grid
    kmt0 = build_grid(cfg.with_(overflows=()), "cpu").KMT.numpy()
    active, dropped = [], []
    for spec in cfg.overflows:
        bad = sum(1 for (i, j, old, new) in spec.kmt_changes
                  if kmt0[j, i] != old)
        if bad:
            if cfg.overflow_geometry_strict:
                raise ValueError(
                    f"overflow '{spec.name}': {bad} kmt-change records "
                    "disagree with the topography "
                    "(init_overflows_kmt contract)")
            dropped.append(f"{spec.name} ({bad} kmt mismatches)")
        else:
            active.append(spec)
    if dropped:
        warnings.warn(
            "deactivating overflows inconsistent with the topography: "
            + ", ".join(dropped), stacklevel=2)
        cfg = cfg.with_(overflows=tuple(active))
    return cfg


def _host(t) -> np.ndarray:
    return t.double().cpu().numpy()


def build_statics(cfg: ModelConfig, grid: Grid) -> OverflowStatics:
    device = grid.KMT.device
    n = len(cfg.overflows)
    kmask = grid.kmask_t.cpu().numpy()
    tarea = _host(grid.TAREA)
    vol3 = _host(thickness_t(cfg, grid)) * tarea[None] * kmask
    zt = _host(grid.vgrid.zt)
    press_s, press_e, fs = np.zeros(n), np.zeros(n), np.zeros(n)
    params = np.zeros((n, 6))

    regions = []
    for o, spec in enumerate(cfg.overflows):
        row = []
        for r, box in enumerate((spec.inf, spec.src, spec.ent, spec.prd)):
            row.append(_region_data(cfg, grid, vol3, kmask, tarea, box,
                                    f"{spec.name}:{r}"))
        regions.append(tuple(row))
        press_s[o] = pressure_bars(zt[spec.src.kmin] * const.MPERCM)
        press_e[o] = pressure_bars(zt[spec.ent.kmin] * const.MPERCM)
        fs[o] = 2.0 * const.OMEGA * np.sin(np.deg2rad(spec.lat))
        params[o] = (spec.width, spec.source_thick, spec.distnc_str_ssb,
                     spec.bottom_slope, spec.bottom_drag,
                     spec.source_thick * 2.0 / 3.0)

    with_pts = [bool(s.prd_sets) for s in cfg.overflows]
    if any(with_pts) and not all(with_pts):
        raise ValueError("mixing point-data and box-only overflow specs "
                         "is not supported")
    extra = (_point_statics(cfg, grid, vol3, kmask, tarea)
             if any(with_pts) else {})

    # the stability cap's source, entrainment and product volumes and
    # areas; with product sets the smallest set's
    cap_vol, cap_area = np.zeros((n, 3)), np.zeros((n, 3))
    for o in range(n):
        prd = (extra["sets"][o] if extra else (regions[o][REG_PRD],))
        cap_vol[o] = (regions[o][REG_SRC].vol_host,
                      regions[o][REG_ENT].vol_host,
                      min(rd.vol_host for rd in prd))
        cap_area[o] = (regions[o][REG_SRC].area_host,
                       regions[o][REG_ENT].area_host,
                       min(rd.area_host for rd in prd))

    def t(a):
        return torch.as_tensor(a).to(device=device, dtype=cfg.torch_dtype)
    return OverflowStatics(
        regions=tuple(regions), press_s=t(press_s),
        press_e=t(press_e), fs=t(fs), params=t(params), cap_vol=t(cap_vol),
        cap_area=t(cap_area), **extra)


def _point_statics(cfg: ModelConfig, grid: Grid, vol3, kmask, tarea):
    """Statics derived from the overflows_infile point data: product-set
    adjacent regions, sidewall momentum tables, and the ZX/ZY
    renormalization map."""
    device = grid.KMT.device
    ny, nx = cfg.ny, cfg.nx
    zt = _host(grid.vgrid.zt)
    dz = _host(grid.vgrid.dz)
    kmu = grid.KMU.cpu().numpy()
    hu_col = _host(grid.HU)
    dyu = _host(grid.DYU)
    dxu = _host(grid.DXU)

    mom_u = {k: [] for k in ("j", "i", "k0", "kind", "ovf", "setid",
                             "sign", "g", "dz_k", "dz_below", "hu")}
    mom_v = {k: [] for k in mom_u}
    zren = np.ones((ny, nx))

    def add_mom(pts, kind, o, setid, sgn_uv):
        """Register sidewall momentum points. ``sgn_uv`` maps orientation
        to the velocity sign (src/ent flow INTO the box: -U for orient 1;
        prd flows OUT: +U for orient 1; source/overflows.F90:4916-5042).
        One corner per wall is inactive (ufrc = 1/(npts-1), :4905)."""
        npts = len(pts)
        if npts < 2:
            raise ValueError("overflow sidewall needs >= 2 points "
                             "(source/overflows.F90:409)")
        ufrc = 1.0 / (npts - 1)
        for m, (i, j, k0, orient) in enumerate(pts):
            # inactive corner: last point for orients 1/4, first for 2/3
            if orient in (1, 4) and m == npts - 1:
                continue
            if orient in (2, 3) and m == 0:
                continue
            iu, ju = _u_point(i, j, orient, nx)
            if ju < 0 or ju >= ny:
                continue
            tab = mom_u if orient in (1, 3) else mom_v
            span = dyu if orient in (1, 3) else dxu
            kmu_p = int(kmu[ju, iu])
            if kmu_p <= 0:
                continue
            # the JAX package's geometry-consistency gate (no reference
            # analogue): a sidewall conduit taller than the resolved column
            # would amplify the barotropic flow every step; such points
            # leave the momentum and renormalization coupling, their
            # transport still enters through qsurf
            dz_sidewall = float(dz[kmu_p:k0 + 1].sum())
            if dz_sidewall > hu_col[ju, iu]:
                continue
            # ZX/ZY renormalization at this column (:5133-5140)
            if hu_col[ju, iu] > 0:
                zren[ju, iu] = (hu_col[ju, iu]
                                / (hu_col[ju, iu] + dz_sidewall))
            tab["j"].append(ju)
            tab["i"].append(iu)
            tab["k0"].append(k0)
            tab["kind"].append(kind)
            tab["ovf"].append(o)
            tab["setid"].append(setid)
            tab["sign"].append(sgn_uv * (1.0 if orient in (1, 2) else -1.0))
            tab["g"].append(ufrc / (dz[k0] * span[ju, iu]))
            tab["dz_k"].append(float(dz[k0]))
            # below the topography but above the overflow (:6130-6134)
            tab["dz_below"].append(float(dz[kmu_p:k0].sum()))
            tab["hu"].append(float(hu_col[ju, iu]))

    sets, set_press = [], []
    for o, spec in enumerate(cfg.overflows):
        # src/ent sidewalls: velocity points INTO the box (sign -1 for
        # orients 1/2); product walls flow OUT (+1)
        add_mom(spec.src_pts, 0, o, -1, -1.0)
        add_mom(spec.ent_pts, 1, o, -1, -1.0)
        row, prow = [], []
        for m, pts in enumerate(spec.prd_sets):
            add_mom(pts, 2, o, m, 1.0)
            # adjacent active cells of this product set (adj_prd boxes,
            # source/overflows.F90:830-873): bounding box of the points
            # shifted by the orientation offset
            ii = [(p[0] + _ADJ[p[3]][0]) % nx for p in pts]
            jj = [p[1] + _ADJ[p[3]][1] for p in pts]
            kk = [p[2] for p in pts]
            box = RegionBox(kmin=min(kk), kmax=max(kk), jmin=min(jj),
                            jmax=max(jj), imin=min(ii), imax=max(ii))
            row.append(_region_data(cfg, grid, vol3, kmask, tarea, box,
                                    f"{spec.name}:prd_set{m}"))
            k_mid = (min(kk) + max(kk)) // 2
            prow.append(float(pressure_bars(zt[k_mid] * const.MPERCM)))
        sets.append(tuple(row))
        set_press.append(torch.tensor(prow, dtype=cfg.torch_dtype,
                                      device=device))

    def pack(tab):
        return {k: torch.as_tensor(np.asarray(v)).to(
            device=device,
            dtype=(torch.long if k in ("j", "i", "k0", "kind", "ovf",
                                       "setid") else cfg.torch_dtype))
            for k, v in tab.items()}

    return dict(sets=tuple(sets), set_press=tuple(set_press),
                mom_u=pack(mom_u), mom_v=pack(mom_v),
                zren=torch.as_tensor(zren).to(device=device,
                                              dtype=cfg.torch_dtype))


def _decomposition():
    d = pmesh.active()
    return d if pmesh.over_ranks(d) else None


def decompose_statics(st: Optional[OverflowStatics],
                      d) -> Optional[OverflowStatics]:
    """``st`` (built on the whole domain) for ``d``'s block: the ZX/ZY map
    cut to the block, each sidewall momentum table's points the block owns
    (their order kept) in block indices; the regions keep their global
    boxes."""
    if st is None:
        return None

    def own(tab):
        if tab is None:
            return None
        j, i = tab["j"], tab["i"]
        keep = (j >= d.j0) & (j < d.j1) & (i >= d.i0) & (i < d.i1)
        out = {k: v[keep] for k, v in tab.items()}
        out["j"], out["i"] = out["j"] - d.j0, out["i"] - d.i0
        return out
    return st._replace(zren=d.slab(st.zren), mom_u=own(st.mom_u),
                       mom_v=own(st.mom_v))


def _crops(rds, tracer):
    """Each region's crop of ``tracer`` (nt, km, ny, nx), its whole box: on
    a rank's block fetched from the blocks that hold it, in one exchange
    for all of ``rds``."""
    d = _decomposition()
    if d is None:
        return [tracer[:, k0:k1 + 1, j0:j1 + 1, i0:i1 + 1]
                for k0, k1, j0, j1, i0, i1 in (rd.box for rd in rds)]
    boxes = [(j0, j1 + 1, i0, i1 + 1, False)
             for _, _, j0, j1, i0, i1 in (rd.box for rd in rds)]
    got = d.fetch([tracer], lambda b: boxes, ("overflows",) + tuple(boxes))
    return [g[:, rd.box[0]:rd.box[1] + 1] for (g,), rd in zip(got, rds)]


def _region_tavg(rd: RegionData, crop):
    """Masked volume-weighted tracer means over one cropped region from
    its crop of the tracers: (nt,) vector."""
    return torch.einsum("kji,kji,nkji->n", rd.mask, rd.wvol, crop) / rd.vol


def _region_means(rds, tracer):
    return [_region_tavg(rd, c) for rd, c in zip(rds, _crops(rds, tracer))]


def transports(cfg: ModelConfig, grid: Grid, st: OverflowStatics, tracer):
    """Regional averages and (Ms, Me, Mp, phi, tracer averages) for every
    overflow (ovf_reg_avgs + ovf_transports). tracer: (nt, km, ny, nx).
    Returns (ms, me, mp, phi, tavg) with tavg (n_ovf, 4, nt)."""
    means = iter(_region_means([rd for row in st.regions for rd in row],
                               tracer))
    tavg = torch.stack([torch.stack([next(means) for _ in row])
                        for row in st.regions])            # (n, 4, nt)

    t_i, s_i = tavg[:, REG_INF, 0], tavg[:, REG_INF, 1]
    t_s, s_s = tavg[:, REG_SRC, 0], tavg[:, REG_SRC, 1]
    t_e, s_e = tavg[:, REG_ENT, 0], tavg[:, REG_ENT, 1]

    rho_i = eos.state_at_level(cfg, st.press_s, t_i, s_i)
    rho_s = eos.state_at_level(cfg, st.press_s, t_s, s_s)
    rho_sed = eos.state_at_level(cfg, st.press_e, t_s, s_s)
    rho_e = eos.state_at_level(cfg, st.press_e, t_e, s_e)

    ws, hu, xse, alpha, cd, hs = st.params.unbind(1)
    f = st.fs
    gp_s = const.GRAV * (rho_s - rho_i) / const.RHO_SW
    ms = torch.where(gp_s > 0.0, gp_s * hu * hu / (2.0 * f), 0.0)
    us = ms / (hs * ws)
    gp_e = const.GRAV * (rho_sed - rho_e) / const.RHO_SW
    gp_e_safe = torch.where(gp_e > 0.0, gp_e, 1.0)
    ugeo = gp_e_safe * alpha / f
    uavg = 0.5 * (us + ugeo)
    a = f * ws / 2.0
    b = (f * ws * hs / 2.0 + 2.0 * cd * uavg * xse
         - ms * f / (2.0 * ugeo))
    c = -f * ms * hs / (2.0 * ugeo)
    disc = torch.clamp(b * b - 4.0 * a * c, min=0.0)
    hgeo = torch.clamp((-b + torch.sqrt(disc)) / (2.0 * a), min=1.0e-10)
    fgeo = ugeo / torch.sqrt(gp_e_safe * hgeo)
    phi = torch.where((gp_e > 0.0) & (ms > 0.0),
                      1.0 - torch.clamp(fgeo, min=1.0e-10) ** (-2.0 / 3.0),
                      0.0)
    phi = torch.clamp(phi, 0.0, 0.999)
    me = torch.where(phi > 0.0, ms * phi / (1.0 - phi), 0.0)
    mp = ms + me

    # the JAX package's stability cap (no reference analogue): the explicit
    # region relaxation in ``tendency`` and the surface-flux injection in
    # ``qsurf`` are stable only while (M/V) c2dt << 1 and M/A stays modest,
    # which a generated topography with a small region box can break.
    # (ms, me, mp) are rescaled jointly per overflow, keeping mp = ms + me,
    # the phi split and qsurf's global zero sum
    r_max = 0.25 / (2.0 * cfg.time.dtt)   # 1/s, rate cap
    q_max = 0.5                           # cm/s, surface-flux cap
    scale = torch.ones_like(ms)
    eps = torch.ones((), dtype=ms.dtype, device=ms.device)
    for col, m_ in enumerate((ms, me, mp)):
        md = torch.maximum(m_, eps)
        scale = torch.minimum(scale, r_max * st.cap_vol[:, col] / md)
        scale = torch.minimum(scale, q_max * st.cap_area[:, col] / md)
    return ms * scale, me * scale, mp * scale, phi, tavg


def product_set_selection(cfg: ModelConfig, grid: Grid,
                          st: OverflowStatics, tracer, trans):
    """Neutral-buoyancy product-set selection (ovf_loc_prd,
    source/overflows.F90:4313-4360): scanning sets from deep to shallow,
    the product inserts one set below the deepest set whose ambient water
    is lighter than the product (set 0 if the product is lighter than all
    ambients). The ambient density is the equation of state of the
    regional-average T, S at the set's mid-level pressure, as in the JAX
    package.

    Returns (sel, sets_tavg): sel (n,) int64 on the device; sets_tavg
    nested tuple (n)(S_o) of (nt,) per-set adjacent-region tracer means."""
    ms, me, mp, phi, tavg = trans
    t_mix = ((1.0 - phi)[:, None] * tavg[:, REG_SRC]
             + phi[:, None] * tavg[:, REG_ENT])

    sels, sets_tavg = [], []
    means = iter(_region_means([rd for row in st.sets for rd in row],
                               tracer))
    for o, row in enumerate(st.sets):
        s_o = len(row)
        avgs = tuple(next(means) for _ in row)
        sets_tavg.append(avgs)
        if s_o == 1:
            sels.append(torch.zeros((), dtype=torch.long,
                                    device=tracer.device))
            continue
        press = st.set_press[o]                             # (S_o,)
        rho_p = eos.state_at_level(cfg, press, t_mix[o, 0], t_mix[o, 1])
        rho_adj = eos.state_at_level(
            cfg, press, torch.stack([a[0] for a in avgs]),
            torch.stack([a[1] for a in avgs]))
        m_idx = torch.arange(s_o, device=tracer.device)
        denser = (rho_p > rho_adj) & (m_idx < s_o - 1)
        deepest = torch.where(denser, m_idx, -1).max()
        sels.append(torch.where(deepest >= 0, deepest + 1, 0))
    return torch.stack(sels), tuple(sets_tavg)


def _owned(rd: RegionData):
    """(rows and columns of the block, the same of the region's crop) where
    the region's box meets this block (the whole box on the whole domain);
    None where they do not meet."""
    _, _, j0, j1, i0, i1 = rd.box
    d = _decomposition()
    if d is None:
        return (slice(j0, j1 + 1), slice(i0, i1 + 1)), (slice(None),) * 2
    a, b = max(j0, d.j0), min(j1 + 1, d.j1)
    c, e = max(i0, d.i0), min(i1 + 1, d.i1)
    if a >= b or c >= e:
        return None
    return ((slice(a - d.j0, b - d.j0), slice(c - d.i0, e - d.i0)),
            (slice(a - j0, b - j0), slice(c - i0, e - i0)))


def _add_region(out, rd: RegionData, rate):
    """Add rate (nt,) times a cropped region's mask to ``out`` in place, at
    the points this block holds."""
    at = _owned(rd)
    if at is None:
        return
    (rows, cols), (mr, mc) = at
    k0, k1 = rd.box[:2]
    out[:, k0:k1 + 1, rows, cols] += (rate[:, None, None, None]
                                      * rd.mask[None, :, mr, mc])


def tendency(cfg: ModelConfig, grid: Grid, st: OverflowStatics, tracer,
             trans=None, sel=None, sets_tavg=None):
    """Conservative closed-circuit overflow tracer tendency
    (nt, km, ny, nx): product cells are relaxed toward the source/
    entrainment mixture at rate M_p/V_p; source and entrainment cells
    receive the implied return flow at M_s/V_s and M_e/V_e. With point
    data the product enters the neutrally-buoyant product set's adjacent
    cells (ovf_loc_prd + ovf_advt product insertion); otherwise the prd
    region box.

    ``trans``: the step's ``transports(...)`` (shared with the barotropic
    injection); ``sel``/``sets_tavg`` its ``product_set_selection(...)``."""
    if trans is None:
        trans = transports(cfg, grid, st, tracer)
    ms, me, mp, phi, tavg = trans
    t_src = tavg[:, REG_SRC]       # (n, nt)
    t_ent = tavg[:, REG_ENT]
    t_mix = (1.0 - phi)[:, None] * t_src + phi[:, None] * t_ent
    if st.sets is not None and sel is None:
        sel, sets_tavg = product_set_selection(cfg, grid, st, tracer, trans)

    out = torch.zeros_like(tracer)
    for o in range(len(st.regions)):
        src_rd = st.regions[o][REG_SRC]
        ent_rd = st.regions[o][REG_ENT]
        if st.sets is not None:
            row = st.sets[o]
            onehot = [(sel[o] == m).to(tracer.dtype)
                      for m in range(len(row))]
            t_prd = sum(g * a for g, a in zip(onehot, sets_tavg[o]))
            v_prd = sum(g * rd.vol for g, rd in zip(onehot, row))
        else:
            t_prd = tavg[o, REG_PRD]
            v_prd = st.regions[o][REG_PRD].vol

        _add_region(out, src_rd, (ms[o] / src_rd.vol) * (t_prd - t_src[o]))
        _add_region(out, ent_rd, (me[o] / ent_rd.vol) * (t_prd - t_ent[o]))
        r_prd = (mp[o] / v_prd) * (t_mix[o] - t_prd)
        if st.sets is not None:
            for g, rd in zip(onehot, st.sets[o]):
                _add_region(out, rd, g * r_prd)
        else:
            _add_region(out, st.regions[o][REG_PRD], r_prd)
    return out


def qsurf(cfg: ModelConfig, grid: Grid, st: OverflowStatics, trans,
          sel=None):
    """Vertically-integrated prescribed overflow transports as an equivalent
    surface volume-flux field (cm/s, positive into the column): the JAX
    package's form of the reference's barotropic continuity injection
    (ovf_rhs_brtrpc_continuity + the prescribed sidewall transports of
    ovf_UV_solution, source/overflows.F90:5068-5120, :5381, :5884). M_p
    arrives in the product columns while M_s + M_e leaves the source and
    entrainment columns; globally sum(q * TAREA) = M_p - M_s - M_e = 0."""
    ms, me, mp, _, _ = trans
    q = torch.zeros((cfg.ny, cfg.nx), dtype=cfg.torch_dtype,
                    device=ms.device)

    def add_fp(rd: RegionData, rate):
        at = _owned(rd)
        if at is not None:
            (rows, cols), (mr, mc) = at
            q[rows, cols] += rate * rd.fmask[mr, mc]

    for o in range(len(st.regions)):
        if st.sets is not None and sel is not None:
            for m, rd in enumerate(st.sets[o]):
                g = (sel[o] == m).to(q.dtype)
                add_fp(rd, g * mp[o] / rd.area)
        else:
            rd = st.regions[o][REG_PRD]
            add_fp(rd, mp[o] / rd.area)
        add_fp(st.regions[o][REG_SRC],
               -ms[o] / st.regions[o][REG_SRC].area)
        add_fp(st.regions[o][REG_ENT],
               -me[o] / st.regions[o][REG_ENT].area)
    return q


def momentum_adjust(cfg: ModelConfig, grid: Grid, st: OverflowStatics,
                    trans, sel, u_new, v_new, ubtrop_new, vbtrop_new):
    """Sidewall momentum sources: the column renormalization shift of
    ovf_UV + ovf_UV_solution (source/overflows.F90:4848-5061, 5884-6189)
    applied to the active part of each sidewall U-column,
        du = -((Uovf - ubar)*dz_kovf - ubar*dz_below)/HU.
    Returns new (u, v); the arguments are not written. Point tables may
    repeat a column: the shifts add (``index_put_`` accumulating)."""
    ms, me, mp, _, _ = trans
    m3 = torch.stack([ms, me, mp], dim=1)                # (n, 3)
    km = cfg.km

    def apply(tab, vel, vbar):
        if tab is None or tab["j"].shape[0] == 0:
            return vel
        jj, ii = tab["j"], tab["i"]
        m_p = m3[tab["ovf"], tab["kind"]]                # (P,)
        gate = torch.where(tab["setid"] < 0, 1.0,
                           (sel[tab["ovf"]] == tab["setid"]).to(vel.dtype))
        # the JAX package's physical-speed clamps (no reference analogue)
        # on the prescribed sidewall velocity and the per-step shift
        uovf = torch.clamp(tab["sign"] * m_p * tab["g"], -100.0, 100.0)
        ubar = vbar[jj, ii]
        delta = gate * ((uovf - ubar) * tab["dz_k"]
                        - ubar * tab["dz_below"]) / tab["hu"]
        delta = torch.clamp(delta, -25.0, 25.0)
        kmu_p = grid.KMU[jj, ii]                          # (P,)
        kidx = torch.arange(km, device=vel.device)[:, None]
        colmask = (kidx < kmu_p[None]).to(vel.dtype)      # (km, P)
        kk = kidx.expand(km, jj.shape[0])
        return vel.index_put((kk, jj.expand(km, -1), ii.expand(km, -1)),
                             -delta[None] * colmask, accumulate=True)

    return (apply(st.mom_u, u_new, ubtrop_new),
            apply(st.mom_v, v_new, vbtrop_new))


def modified_hu(cfg: ModelConfig, grid: Grid) -> np.ndarray:
    """HU extended down the overflow sidewall columns (ovf_HU,
    source/overflows.F90:5730-5880): at every src/ent/prd sidewall U-point
    the column depth becomes HU + sum(dz, KMU+1..k_ovf). All points take
    part (the 'inactive corner' is a momentum-weighting device only).
    Host-side init work; returns (ny, nx) float64."""
    nx = cfg.nx
    dz = _host(grid.vgrid.dz)
    kmu = grid.KMU.cpu().numpy()
    hu = _host(grid.HU)
    hum = hu.copy()
    for spec in cfg.overflows:
        for (i, j, k0, orient) in _walls(spec):
            iu, ju = _u_point(i, j, orient, nx)
            if ju < 0 or ju >= cfg.ny:
                continue
            kmu_p = int(kmu[ju, iu])
            # Fortran k = KMU+1 .. k_ovf (1-based) == dz[kmu_p : k0+1]
            dz_sidewall = float(dz[kmu_p:k0 + 1].sum())
            if dz_sidewall > hu[ju, iu]:
                continue  # the geometry-consistency gate of add_mom
            hum[ju, iu] = hu[ju, iu] + dz_sidewall
    return hum


def solvers_9pt(cfg: ModelConfig, grid: Grid) -> Grid:
    """The barotropic 9-point operator weights rebuilt from the
    overflow-modified HU (ovf_solvers_9pt, source/overflows.F90:5515-5728):
    the solver prep's weight assembly (source/POP_SolversMod.F90:786-816)
    with HUM in place of HU. Returns a Grid with btrop_{ne,n,e,c_indep}
    replaced; masks and the residual norm are untouched, as in the
    reference."""
    if not cfg.overflows or not any(s.prd_sets for s in cfg.overflows):
        return grid
    ew, ns = cfg.ew_boundary, cfg.ns_boundary

    def sh(f, di, dj):
        return _np_shift(f, di, dj, ew, ns, 0.0, "center", "scalar")

    hum = modified_hu(cfg, grid)
    dxur, dyur = _host(grid.DXUR), _host(grid.DYUR)
    dxu, dyu = _host(grid.DXU), _host(grid.DYU)
    xW = 0.25 * hum * dxur * dyu
    yW = 0.25 * hum * dyur * dxu
    wNE = xW + yW
    a_se = sh(xW, 0, -1) + sh(yW, 0, -1)
    a_nw = sh(wNE, -1, 0)
    a_sw = sh(wNE, -1, -1)

    def t(a):
        return torch.as_tensor(a).to(device=grid.KMT.device,
                                     dtype=cfg.torch_dtype)
    return grid.replace(
        btrop_ne=t(wNE),
        btrop_e=t(xW + sh(xW, 0, -1) - yW - sh(yW, 0, -1)),
        btrop_n=t(yW + sh(yW, -1, 0) - xW - sh(xW, -1, 0)),
        btrop_c_indep=t(-(wNE + a_se + a_nw + a_sw)))
