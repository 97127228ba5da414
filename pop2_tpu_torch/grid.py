"""Grid generation: horizontal/vertical metrics, topography, masks, operator
coefficients.

Replaces the reference's ``source/grid.F90`` plus the stencil coefficient
setup of ``source/hmix_del2.F90:287-404`` and
``source/POP_SolversMod.F90:771-820``. Everything is generated on the host in
float64 NumPy and converted to tensors on the requested device at the very
end, as one frozen dataclass. There are no blocks and no ghost cells: the
global array is the layout, and land is handled with masks.

Internal grid recipes follow the reference exactly so numerical parity tests
can run with no input files:
  * horizontal lat/lon grid   source/grid.F90:1187-1307
  * vertical thickness profile source/grid.F90:1549-1709
  * idealized topography       source/grid.F90:1921-2025
  * depth fields / landmasks   source/grid.F90:973-1051, 2537-2596
  * T<->U averaging weights    source/grid.F90:2882-2932
  * reference pressure         source/state_mod.F90:1724-1766

The port carries the internal generators and the POP-format files
(``io/grid_files.py``: the 7-record horizontal grid with its tripole DYU
correction, ANGLE and the ANGLET formed from it; the vertical-grid text
file; the KMT record, clipped to [0, km] and closed at closed edges), with
a closed or tripole north edge (northward shifts of the host fields fold
with the field's location and kind, as the JAX package's) and the
anisotropic-viscosity statics on ``Grid.aniso``; the overflows' wet regions
on the internal topography and their kmt pop-ups on every topography; and
partial bottom cells (the bottom level's thickness from a
``bottom_cell_file`` or the full one) with the two planes of the bottom
level's thickness the kernels read (``bottom_planes``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from pop2_tpu_torch import constants as const
from pop2_tpu_torch import eos
from pop2_tpu_torch._tree import TensorTree
from pop2_tpu_torch.config import ModelConfig
from pop2_tpu_torch.stencil import BC
from pop2_tpu_torch.supported import check_supported


@dataclass(frozen=True)
class VGrid(TensorTree):
    """Vertical grid tensors, all shape (km,) except dzw/dzwr (km+1,).

    dzw[k] spans midpoint of layer k to midpoint of layer k+1 with the
    reference's 0..km indexing folded as dzw[0] = surface half-layer
    (source/grid.F90:786-803).
    """
    dz: torch.Tensor
    c2dz: torch.Tensor
    dzr: torch.Tensor
    dz2r: torch.Tensor
    zt: torch.Tensor
    zw: torch.Tensor
    dzw: torch.Tensor    # (km+1,), dzw[0] is the reference's dzw(0)
    dzwr: torch.Tensor   # (km+1,)
    pressz: torch.Tensor  # reference pressure (bars) at layer midpoints
    # the polynomial equation of state's fit of pressz (eos.polynomial_fit;
    # None under another equation of state)
    poly: Optional[eos.PolyFit] = None


@dataclass(frozen=True)
class Grid(TensorTree):
    """All time-invariant grid fields. Horizontal arrays are (ny, nx);
    3-D masks are (km, ny, nx)."""

    # horizontal metrics (cm) — source/grid.F90:122-135
    DXU: torch.Tensor
    DYU: torch.Tensor
    DXT: torch.Tensor
    DYT: torch.Tensor
    DXUR: torch.Tensor
    DYUR: torch.Tensor
    DXTR: torch.Tensor
    DYTR: torch.Tensor
    HTN: torch.Tensor
    HTE: torch.Tensor
    HUS: torch.Tensor
    HUW: torch.Tensor
    ULAT: torch.Tensor
    ULON: torch.Tensor
    TLAT: torch.Tensor
    TLON: torch.Tensor
    ANGLE: torch.Tensor
    ANGLET: torch.Tensor
    FCOR: torch.Tensor
    FCORT: torch.Tensor
    UAREA: torch.Tensor
    TAREA: torch.Tensor
    UAREA_R: torch.Tensor
    TAREA_R: torch.Tensor
    HT: torch.Tensor
    HU: torch.Tensor
    HUR: torch.Tensor

    # topography / masks
    KMT: torch.Tensor       # (ny, nx) int32: deepest ocean level at T points
    KMU: torch.Tensor       # (ny, nx) int32
    RCALCT: torch.Tensor    # (ny, nx) 1/0 mask of surface ocean T points
    RCALCU: torch.Tensor
    kmask_t: torch.Tensor   # (km, ny, nx) bool: level k (0-based) < KMT
    kmask_u: torch.Tensor   # (km, ny, nx) bool

    # T->U area-averaging weights — source/grid.F90:2920-2928
    AU0: torch.Tensor
    AUN: torch.Tensor
    AUE: torch.Tensor
    AUNE: torch.Tensor

    # del2 stencil coefficients — source/hmix_del2.F90:287-404, 611-634
    DTN: torch.Tensor
    DTS: torch.Tensor
    DTE: torch.Tensor
    DTW: torch.Tensor
    DUC: torch.Tensor
    DUN: torch.Tensor
    DUS: torch.Tensor
    DUE: torch.Tensor
    DUW: torch.Tensor
    DMC: torch.Tensor
    DMN: torch.Tensor
    DMS: torch.Tensor
    DME: torch.Tensor
    DMW: torch.Tensor
    DUM: torch.Tensor
    KXU: torch.Tensor
    KYU: torch.Tensor

    # neighbor depth fields for tracer-mixing land BCs
    # (source/grid.F90:2580-2591)
    KMTN: torch.Tensor
    KMTS: torch.Tensor
    KMTE: torch.Tensor
    KMTW: torch.Tensor

    # barotropic 9-pt operator weights — source/POP_SolversMod.F90:771-820
    btrop_ne: torch.Tensor
    btrop_n: torch.Tensor
    btrop_e: torch.Tensor
    btrop_c_indep: torch.Tensor

    # checkerboard null-space removal fields (source/barotropic.F90:164-229)
    checker: torch.Tensor   # +/-1 checkerboard, zero on land
    constnt: torch.Tensor   # 1 on open ocean, zero on land
    rcheck: torch.Tensor    # scalar
    rconst: torch.Tensor    # scalar

    vgrid: VGrid

    # global area of ocean T cells (scalar), normalization for diagnostics
    area_t: torch.Tensor
    volume_t: torch.Tensor
    # solver residual normalization sum((TAREA**2)[ocean])
    # (source/POP_SolversMod.F90:888-898)
    residual_norm: torch.Tensor

    # partial-bottom-cell thicknesses (None under full cells): the layers'
    # thickness at T and U points, equal to dz but at the column's bottom
    # level, and the thickness of that level, DZBT = DZT[KMT-1] and
    # DZBU = DZU[KMU-1] (dz[0] on land), the planes the kernels read
    DZT: Optional[torch.Tensor] = None   # (km, ny, nx)
    DZU: Optional[torch.Tensor] = None
    DZBT: Optional[torch.Tensor] = None  # (ny, nx)
    DZBU: Optional[torch.Tensor] = None
    # anisotropic-viscosity statics (hmix_momentum='aniso')
    aniso: Optional["AnisoStatics"] = None
    # the topographic-stress equilibrium velocities (ltopostress;
    # source/topostress.F90:119-235), (ny, nx) at U points
    TSU: Optional[torch.Tensor] = None
    TSV: Optional[torch.Tensor] = None


def pressure_bars(depth_m: np.ndarray) -> np.ndarray:
    """Pressure (bars) from depth (m); Levitus-mean hydrostatic fit
    (source/state_mod.F90:1765-1766)."""
    return (0.059808 * (np.exp(-0.025 * depth_m) - 1.0)
            + 0.100766 * depth_m + 2.28405e-7 * depth_m ** 2)


def _vert_grid_internal(km: int, zmax: float = 5500.0, dz_sfc: float = 25.0,
                        dz_deep: float = 400.0) -> np.ndarray:
    """Layer thicknesses (m) via bisection on the Gaussian profile parameter
    (source/grid.F90:1549-1709)."""

    def compute_dz(zlength: float) -> np.ndarray:
        dz = np.zeros(km)
        depth = 0.0
        for k in range(km):
            dz[k] = dz_deep - (dz_deep - dz_sfc) * np.exp(-(depth / zlength) ** 2)
            depth += dz[k]
        return dz

    eps = 1.0e-10
    zl0, zl1 = eps, zmax
    d0 = compute_dz(zl0).sum()
    d1 = compute_dz(zl1).sum()
    if (d0 - zmax) * (d1 - zmax) > 0.0:
        raise ValueError(
            f"internal vertical grid: km={km} cannot integrate to {zmax} m "
            f"(range [{d0:.0f}, {d1:.0f}] m); use vert_grid='uniform'")
    dz = compute_dz(zl1)
    while (zl1 - zl0) / zmax > eps:
        zl = zl0 + 0.5 * (zl1 - zl0)
        dz = compute_dz(zl)
        d = dz.sum()
        if (d0 - zmax) * (d - zmax) < 0.0:
            zl1, d1 = zl, d
        else:
            zl0, d0 = zl, d
    # the reference keeps the profile from the LAST midpoint evaluated
    # inside the loop (grid.F90:1616-1640: dz is a module array filled by
    # compute_dz); do the same rather than refining once more
    return dz


def _topography_internal(ulat_deg: np.ndarray, ulon_deg: np.ndarray,
                         km: int) -> np.ndarray:
    """Idealized-continent KMT field (source/grid.F90:1957-1988)."""
    lond = np.where(ulon_deg < 0.0, ulon_deg + 360.0, ulon_deg)
    latd = ulat_deg
    kmt = np.full(latd.shape, km, dtype=np.int32)
    kmt[(latd > -35.0) & (lond > 210.0) & (lond < 250.0)] = 0
    kmt[(latd > 25.0) & (lond > 210.0) & (lond < 330.0)] = 0
    # the reference's third box (lond>210 & lond<150) is empty; kept for parity
    kmt[(latd > -60.0) & (lond > 110.0) & (lond < 150.0)] = 0
    kmt[np.abs(latd) > 75.0] = 0
    return kmt


def _np_fold_row(f: np.ndarray, n: int, loc: str, kind: str) -> np.ndarray:
    """Host-side tripole ghost row ny-1+n (the NumPy mirror of
    ``tripole.fold_rows``; mpi/POP_HaloMod.F90:1961-2050)."""
    sign = -1.0 if kind == "vector" else 1.0
    ny = f.shape[0]
    if loc == "center":
        return sign * f[ny - n, ::-1]
    if loc == "necorner":
        return sign * np.roll(f[ny - 1 - n, ::-1], -1)
    if loc == "eface":
        return sign * np.roll(f[ny - n, ::-1], -1)
    if loc == "nface":
        return sign * f[ny - 1 - n, ::-1]
    raise ValueError(f"unknown location {loc}")


def _np_shift(f: np.ndarray, di: int, dj: int, ew: str, ns: str,
              fill=0.0, loc: str = "center",
              kind: str = "scalar") -> np.ndarray:
    """Host-side shift: result[j,i] = f[j+dj, i+di]; closed edges take
    ``fill``, cyclic edges wrap. On a tripole north edge a northward shift
    fills the ghost rows from the fold of the field's location and kind
    (fold first, then the east-west shift, as ghost cells are indexed)."""
    if ns == "tripole" and dj > 0:
        g = np.roll(np.asarray(f, dtype=np.float64), -dj, axis=0)
        ny = f.shape[0]
        for n in range(1, dj + 1):
            g[ny - 1 - dj + n, :] = _np_fold_row(f, n, loc, kind)
        if di != 0:
            g = _np_shift(g, di, 0, ew, ns, fill)
        return g
    if ns == "tripole":
        ns = "closed"  # the south edge of a tripole grid is closed
    g = np.roll(f, (-dj, -di), axis=(0, 1))
    if ns == "closed" and dj != 0:
        if dj > 0:
            g[-dj:, :] = fill
        else:
            g[:(-dj), :] = fill
    if ew == "closed" and di != 0:
        if di > 0:
            g[:, -di:] = fill
        else:
            g[:, :(-di)] = fill
    return g


def _tpoints_from_upoints(ULAT, ULON, sh):
    """T-point lat/lon as the Cartesian 4-point average of the surrounding
    U points, with linear extrapolation on the south row
    (source/grid.F90:2939-3104 calc_tpoints)."""
    z = np.cos(ULAT)
    x = np.cos(ULON) * z
    y = np.sin(ULON) * z
    z = np.sin(ULAT)
    tx = 0.25 * (x + sh(x, -1, 0) + sh(x, 0, -1) + sh(x, -1, -1))
    ty = 0.25 * (y + sh(y, -1, 0) + sh(y, 0, -1) + sh(y, -1, -1))
    tz = 0.25 * (z + sh(z, -1, 0) + sh(z, 0, -1) + sh(z, -1, -1))
    da = np.maximum(np.sqrt(tx ** 2 + ty ** 2 + tz ** 2), 1e-30)
    TLAT = np.arcsin(np.clip(tz / da, -1.0, 1.0))
    TLON = np.where((tx != 0.0) | (ty != 0.0), np.arctan2(ty, tx), 0.0)
    TLON[0, :] = TLON[1, :]
    TLAT[0, :] = 2.0 * TLAT[1, :] - TLAT[2, :]
    TLON = np.where(TLON > const.PI2, TLON - const.PI2, TLON)
    TLON = np.where(TLON < 0.0, TLON + const.PI2, TLON)
    return TLAT, TLON


def _anglet_from_angle(ANGLE, UAREA, TAREA_R, sh):
    """ANGLET as the area-weighted 4-point average of ANGLE with branch-cut
    adjustment (source/grid.F90:686-726); south row zeroed."""
    at0 = UAREA * 0.25 * TAREA_R
    ats = sh(UAREA, 0, -1) * 0.25 * TAREA_R
    atw = sh(UAREA, -1, 0) * 0.25 * TAREA_R
    atsw = sh(UAREA, -1, -1) * 0.25 * TAREA_R
    a0 = ANGLE
    aw, as_, asw = sh(ANGLE, -1, 0), sh(ANGLE, 0, -1), sh(ANGLE, -1, -1)
    neg = a0 < 0.0
    aw = np.where(neg & (np.abs(aw - a0) > const.PI), aw - const.PI2, aw)
    as_ = np.where(neg & (np.abs(as_ - a0) > const.PI), as_ - const.PI2, as_)
    asw = np.where(neg & (np.abs(asw - a0) > const.PI), asw - const.PI2, asw)
    ANGLET = a0 * at0 + aw * atw + as_ * ats + asw * atsw
    ANGLET[0, :] = 0.0
    return ANGLET


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; asking for a CUDA device on a
    machine without one is an error, never a silent CPU run."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the port runs on a CUDA device by default and none is "
            "available; pass device='cpu' for the plain PyTorch path")
    return device


def vertical_dz(cfg: ModelConfig) -> np.ndarray:
    """Layer thicknesses (cm), float64, of the config's internal, uniform
    or file vertical grid (``io.grid_files.read_vert_grid``)."""
    if cfg.vert_grid == "internal":
        return _vert_grid_internal(cfg.km) * const.CMPERM
    if cfg.vert_grid == "uniform":
        return np.full(cfg.km, 5500.0 / cfg.km) * const.CMPERM
    if cfg.vert_grid == "file":
        from pop2_tpu_torch.io import grid_files
        return grid_files.read_vert_grid(cfg.vert_grid_file, cfg.km)
    raise ValueError(f"unknown vert_grid option {cfg.vert_grid}")


def build_grid(cfg: ModelConfig, device="cuda") -> Grid:
    """Generate the full grid for the given config, from the internal
    analytic generators or from POP-format grid files
    (``io/grid_files.py``), in float64 NumPy, and return it as tensors of
    the config's dtype on ``device`` (the GPU unless the caller asks for
    the CPU)."""
    check_supported(cfg)
    device = resolve_device(device)
    nx, ny, km = cfg.nx, cfg.ny, cfg.km
    ew, ns = cfg.ew_boundary, cfg.ns_boundary

    def sh(f, di, dj, fill=0.0, loc="center", kind="scalar"):
        return _np_shift(f, di, dj, ew, ns, fill, loc, kind)

    if cfg.horiz_grid == "internal":
        # ---- analytic lat/lon grid (source/grid.F90:1226-1298) ---------
        dlon = 360.0 / nx
        dlat = 180.0 / ny
        i = np.arange(1, nx + 1)
        j = np.arange(1, ny + 1)
        ulon_deg = i * dlon
        ulon_deg = np.where(ulon_deg > 180.0, ulon_deg - 360.0, ulon_deg)
        ulat_deg = -90.0 + j * dlat
        ULON = np.broadcast_to(ulon_deg[None, :] / const.RADIAN,
                               (ny, nx)).copy()
        ULAT = np.broadcast_to(ulat_deg[:, None] / const.RADIAN,
                               (ny, nx)).copy()
        lathalf_deg = -90.0 + (j - 0.5) * dlat

        dx_cm = dlon * const.RADIUS / const.RADIAN
        dy_cm = dlat * const.RADIUS / const.RADIAN
        HTE = np.full((ny, nx), dy_cm)
        HUW = np.full((ny, nx), dy_cm)
        DYT = np.full((ny, nx), dy_cm)
        DYU = np.full((ny, nx), dy_cm)
        HTN = dx_cm * np.cos(ULAT)
        DXU = HTN.copy()
        # HUS uses the analytic midpoint latitude (grid.F90:1283 lathalf),
        # independent of the averaged TLAT below
        HUS = dx_cm * np.cos(lathalf_deg[:, None] / const.RADIAN
                             ) * np.ones((1, nx))
        # DXT(j) = dx * p5*(cos(ULAT(j)) + cos(ULAT(j-1))); j-1 wraps to ny
        # for j=1 as in the reference (source/grid.F90:1261-1287)
        cos_ulat = np.cos(ULAT)
        cos_ulat_jm1 = np.roll(cos_ulat, 1, axis=0)
        DXT = dx_cm * 0.5 * (cos_ulat + cos_ulat_jm1)
        ANGLE = np.zeros((ny, nx))
    elif cfg.horiz_grid == "file":
        # ---- POP 7-record binary grid file (grid.F90:1314-1542) --------
        from pop2_tpu_torch.io import grid_files
        hg = grid_files.read_horiz_grid(cfg.horiz_grid_file, ny, nx)
        ULAT, ULON = hg["ULAT"], hg["ULON"]
        HTN, HTE = hg["HTN"], hg["HTE"]
        HUS, HUW = hg["HUS"], hg["HUW"]
        ANGLE = hg["ANGLE"]
        DXU = 0.5 * (HTN + sh(HTN, 1, 0))
        DXT = 0.5 * (HTN + sh(HTN, 0, -1))
        DYT = 0.5 * (HTE + sh(HTE, -1, 0))
        DYU = 0.5 * (HTE + sh(HTE, 0, 1, loc="eface"))
        if ns == "tripole":
            DYU[-1, :] = HTE[-1, :]  # tripole correction (grid.F90:1490-1497)
    else:
        raise ValueError(f"unknown horiz_grid option {cfg.horiz_grid}")

    # T-point coordinates via the Cartesian 4-point average, exactly as
    # the reference's calc_tpoints does for every grid option
    # (source/grid.F90:2939-3104) — NOT the analytic midpoint, which
    # differs from the spherical average by O(1e-5) rad near the poles.
    TLAT, TLON = _tpoints_from_upoints(ULAT, ULON, sh)

    # guard against zero/negative spacings (land; the reference sets them
    # to 1, the file grid's floor, the internal grid keeps a tighter one)
    floor = 1.0 if cfg.horiz_grid == "file" else 1.0e-20
    HTN = np.where(HTN <= 0.0, floor, HTN)
    HTE = np.where(HTE <= 0.0, floor, HTE)
    HUS = np.where(HUS <= 0.0, floor, HUS)
    HUW = np.where(HUW <= 0.0, floor, HUW)
    DXU = np.where(DXU <= 0.0, floor, DXU)
    DYU = np.where(DYU <= 0.0, floor, DYU)
    DXT = np.where(DXT <= 0.0, floor, DXT)
    DYT = np.where(DYT <= 0.0, floor, DYT)

    DXUR, DYUR = 1.0 / DXU, 1.0 / DYU
    DXTR, DYTR = 1.0 / DXT, 1.0 / DYT
    UAREA = DXU * DYU
    TAREA = DXT * DYT
    UAREA_R, TAREA_R = 1.0 / UAREA, 1.0 / TAREA
    ANGLET = (_anglet_from_angle(ANGLE, UAREA, TAREA_R, sh)
              if cfg.horiz_grid == "file" else np.zeros((ny, nx)))

    # Coriolis (source/grid.F90:1154-1172)
    if cfg.lconst_coriolis:
        FCOR = np.full((ny, nx), cfg.coriolis_val)
        FCORT = np.full((ny, nx), cfg.coriolis_val)
    else:
        FCOR = 2.0 * const.OMEGA * np.sin(ULAT)
        FCORT = 2.0 * const.OMEGA * np.sin(TLAT)

    # ---- vertical grid -----------------------------------------------------
    dz = vertical_dz(cfg)
    # derived vertical quantities (source/grid.F90:786-803)
    dzw = np.zeros(km + 1)
    dzw[0] = 0.5 * dz[0]
    dzw[km] = 0.5 * dz[km - 1]
    dzw[1:km] = 0.5 * (dz[:-1] + dz[1:])
    zw = np.cumsum(dz)
    zt = np.zeros(km)
    zt[0] = dzw[0]
    zt[1:] = zt[0] + np.cumsum(dzw[1:km])
    c2dz = 2.0 * dz
    dzr, dz2r = 1.0 / dz, 1.0 / c2dz
    dzwr = 1.0 / dzw
    pressz = pressure_bars(zt * const.MPERCM)

    # ---- topography --------------------------------------------------------
    if cfg.topography == "internal":
        KMT = _topography_internal(ULAT * const.RADIAN, ULON * const.RADIAN,
                                   km)
        if cfg.flat_bottom:
            KMT = np.where(KMT != 0, km, 0).astype(np.int32)
    elif cfg.topography == "file":
        from pop2_tpu_torch.io import grid_files
        KMT = grid_files.read_topography(cfg.topography_file, ny, nx)
        KMT = np.clip(KMT, 0, km).astype(np.int32)
        if ns == "closed":
            KMT[0, :] = 0
            KMT[-1, :] = 0
        if ew == "closed":
            KMT[:, 0] = 0
            KMT[:, -1] = 0
    else:
        raise ValueError(f"unknown topography option {cfg.topography}")

    # topography smoothing (smooth_topography, source/grid.F90:2393-2530):
    # 9-pt [1 2 1; 2 4 2; 1 2 1] average of the ocean-only depth field,
    # then rebuild KMT from the smoothed depths
    for _ in range(cfg.n_topo_smooth):
        zw_pad0 = np.concatenate([[0.0], np.cumsum(dz)])
        ht_s = zw_pad0[KMT]
        nb = (KMT > 0).astype(np.float64)
        htnew = np.where(KMT > 0, ht_s, 0.0)

        def s9(f):
            return (4.0 * f
                    + 2.0 * (sh(f, 1, 0) + sh(f, -1, 0)
                             + sh(f, 0, 1) + sh(f, 0, -1))
                    + sh(f, 1, 1) + sh(f, 1, -1)
                    + sh(f, -1, 1) + sh(f, -1, -1))
        work = s9(htnew)
        iwork = s9(nb)
        htnew = np.where((KMT != 0) & (iwork != 0),
                         work / np.maximum(iwork, 1e-30), 0.0)
        zt_v = np.zeros(km)
        zt_v[0] = 0.5 * dz[0]
        zt_v[1:] = zt_v[0] + np.cumsum(0.5 * (dz[:-1] + dz[1:]))
        kmt_new = np.array(KMT)
        for k in range(km - 1):
            kmt_new = np.where((htnew > zt_v[k]) & (htnew <= zt_v[k + 1]),
                               k + 1, kmt_new)
        kmt_new = np.where(htnew > zt_v[km - 1], km, kmt_new)
        KMT = kmt_new.astype(np.int32)

    # with the internal topography, make the overflow regions (defined on
    # the real grids' bathymetry, where topography files are wet by
    # construction) wet so the parameterization has ocean cells to act on;
    # then, on every topography, the overflows' kmt "pop-up" changes
    # (init_overflows_kmt, source/overflows.F90:1196-1275), which carve the
    # source and product channels below the resolved topography
    if cfg.overflows:
        KMT = np.array(KMT, dtype=np.int32)
        if cfg.topography == "internal":
            from pop2_tpu_torch.overflows import wet_regions  # imports grid
            wet_regions(cfg, KMT)
        for spec in cfg.overflows:
            for (i, j, kmt_old, kmt_new) in spec.kmt_changes:
                KMT[j, i] = kmt_new

    # KMU = min of 4 surrounding KMTs (source/grid.F90:978-985)
    KMU = np.minimum(np.minimum(KMT, sh(KMT, 1, 0)),
                     np.minimum(sh(KMT, 0, 1), sh(KMT, 1, 1))).astype(np.int32)

    # depth at T, U points (source/grid.F90:1024-1043)
    zw_pad = np.concatenate([[0.0], zw])
    HT = zw_pad[KMT]
    HU = zw_pad[KMU]

    DZT = DZU = None
    if cfg.partial_bottom_cells:
        DZT, DZU, HT, HU = partial_bottom_cells(
            cfg, dz, zw_pad, KMT, KMU, bottom_cells(cfg, dz, KMT))

    HUR = np.where(HU > 0.0, 1.0 / np.where(HU > 0.0, HU, 1.0), 0.0)

    # landmasks (source/grid.F90:2555-2571)
    RCALCT = (KMT >= 1).astype(np.float64)
    RCALCU = (KMU >= 1).astype(np.float64)
    kidx = np.arange(1, km + 1)[:, None, None]
    kmask_t = kidx <= KMT[None, :, :]
    kmask_u = kidx <= KMU[None, :, :]

    KMTN = sh(KMT, 0, 1).astype(np.int32)
    KMTS = sh(KMT, 0, -1).astype(np.int32)
    KMTE = sh(KMT, 1, 0).astype(np.int32)
    KMTW = sh(KMT, -1, 0).astype(np.int32)

    # T->U averaging weights (source/grid.F90:2920-2928)
    AU0 = TAREA * 0.25 * UAREA_R
    AUN = sh(TAREA, 0, 1) * 0.25 * UAREA_R
    AUE = sh(TAREA, 1, 0) * 0.25 * UAREA_R
    AUNE = sh(TAREA, 1, 1) * 0.25 * UAREA_R

    # ---- del2 operator coefficients (AMF = AHF = 1) ------------------------
    # tracers (source/hmix_del2.F90:619-634)
    w1 = HTN / HUW
    DTN = w1 * TAREA_R
    DTS = sh(w1, 0, -1) * TAREA_R
    w1 = HTE / HUS
    DTE = w1 * TAREA_R
    DTW = sh(w1, -1, 0) * TAREA_R

    # momentum (source/hmix_del2.F90:317-404)
    w1 = (HUS / HTE)
    DUS = w1 * UAREA_R
    DUN = sh(w1, 0, 1, loc="eface") * UAREA_R
    w1 = (HUW / HTN)
    DUW = w1 * UAREA_R
    DUE = sh(w1, 1, 0) * UAREA_R
    DUC = -(DUN + DUS + DUE + DUW)

    KXU = (sh(HUW, 1, 0) - HUW) * UAREA_R
    KYU = (sh(HUS, 0, 1, loc="eface") - HUS) * UAREA_R

    # kxt/kyt are x-/y-directional metric derivatives: they change sign
    # under the tripole's 180-degree fold (kind='vector')
    kxt = (HTE - sh(HTE, -1, 0)) * TAREA_R
    w2 = 0.5 * (kxt + sh(kxt, 0, 1, kind="vector"))
    DXKX = (sh(w2, 1, 0) - w2) * DXUR
    w2 = 0.5 * (kxt + sh(kxt, 1, 0))
    DYKX = (sh(w2, 0, 1, loc="eface", kind="vector") - w2) * DYUR

    kyt = (HTN - sh(HTN, 0, -1)) * TAREA_R
    w2 = 0.5 * (kyt + sh(kyt, 1, 0))
    DYKY = (sh(w2, 0, 1, loc="eface", kind="vector") - w2) * DYUR
    w2 = 0.5 * (kyt + sh(kyt, 0, 1, kind="vector"))
    DXKY = (sh(w2, 1, 0) - w2) * DXUR

    DUM = -(DXKX + DYKY + 2.0 * (KXU ** 2 + KYU ** 2))
    DMC = DXKY - DYKX
    DME = 2.0 * KYU / (HTN + sh(HTN, 1, 0))
    DMN = -2.0 * KXU / (HTE + sh(HTE, 0, 1, loc="eface"))
    DMW = -DME
    DMS = -DMN

    # ---- barotropic 9-pt operator weights ----------------------------------
    # (source/POP_SolversMod.F90:786-816); xW/yW live on U points, weights on
    # T points gather the 4 surrounding U corners.
    xW = 0.25 * HU * DXUR * DYU
    yW = 0.25 * HU * DYUR * DXU
    wNE = xW + yW
    a_se = sh(xW, 0, -1) + sh(yW, 0, -1)
    a_nw = sh(wNE, -1, 0)
    a_sw = sh(wNE, -1, -1)
    btrop_ne = wNE
    btrop_e = xW + sh(xW, 0, -1) - yW - sh(yW, 0, -1)
    btrop_n = yW + sh(yW, -1, 0) - xW - sh(xW, -1, 0)
    btrop_c_indep = -(wNE + a_se + a_nw + a_sw)

    # checkerboard/constant null-space removal (source/barotropic.F90:177-226)
    # global indices are 1-based in the reference: n = i_glob + j_glob
    ig = np.arange(1, nx + 1)[None, :]
    jg = np.arange(1, ny + 1)[:, None]
    checker = (2 * ((ig + jg) % 2) - 1).astype(np.float64)
    checker = np.broadcast_to(checker, (ny, nx)).copy()
    constnt = RCALCT.copy()
    checker = checker * RCALCT
    sum_check = checker.sum()
    sum_const = constnt.sum()
    acheck = (checker * TAREA).sum() / (constnt * TAREA).sum()
    denom = sum_const - acheck * sum_check
    rcheck = acheck / denom
    rconst = 1.0 / denom

    area_t = np.sum(TAREA * RCALCT)
    volume_t = np.sum(TAREA * HT * RCALCT)
    residual_norm = 1.0 / np.sum(TAREA ** 2 * RCALCT)

    dt = cfg.torch_dtype

    def f(a):
        return torch.as_tensor(np.asarray(a, np.float64)).to(
            device=device, dtype=dt)

    def fi(a):
        return torch.as_tensor(np.asarray(a, np.int32)).to(device)

    def fb(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device)

    pz = f(pressz)
    vgrid = VGrid(dz=f(dz), c2dz=f(c2dz), dzr=f(dzr), dz2r=f(dz2r),
                  zt=f(zt), zw=f(zw), dzw=f(dzw), dzwr=f(dzwr),
                  pressz=pz, poly=eos.polynomial_fit(cfg, pz))

    aniso = None
    if cfg.hmix_momentum == "aniso":
        aniso = build_aniso(cfg, HTN, HTE, DXU, DYU, DXUR, DYUR, ULAT, KMU,
                            device)
    TSU = TSV = None
    if cfg.ltopostress:
        TSU, TSV = (f(a) for a in build_topostress(
            cfg, HT, KMT, KMU, TLAT, FCORT, DXUR, DYUR, HUR))

    pbc = {}
    if DZT is not None:
        pbc = dict(zip(("DZT", "DZU", "DZBT", "DZBU"), (f(a) for a in (
            DZT, DZU, *bottom_planes(dz, DZT, DZU, KMT, KMU)))))
    return Grid(
        aniso=aniso, TSU=TSU, TSV=TSV, **pbc,
        DXU=f(DXU), DYU=f(DYU), DXT=f(DXT), DYT=f(DYT),
        DXUR=f(DXUR), DYUR=f(DYUR), DXTR=f(DXTR), DYTR=f(DYTR),
        HTN=f(HTN), HTE=f(HTE), HUS=f(HUS), HUW=f(HUW),
        ULAT=f(ULAT), ULON=f(ULON), TLAT=f(TLAT), TLON=f(TLON),
        ANGLE=f(ANGLE), ANGLET=f(ANGLET), FCOR=f(FCOR), FCORT=f(FCORT),
        UAREA=f(UAREA), TAREA=f(TAREA), UAREA_R=f(UAREA_R),
        TAREA_R=f(TAREA_R), HT=f(HT), HU=f(HU), HUR=f(HUR),
        KMT=fi(KMT), KMU=fi(KMU), RCALCT=f(RCALCT), RCALCU=f(RCALCU),
        kmask_t=fb(kmask_t), kmask_u=fb(kmask_u),
        AU0=f(AU0), AUN=f(AUN), AUE=f(AUE), AUNE=f(AUNE),
        DTN=f(DTN), DTS=f(DTS), DTE=f(DTE), DTW=f(DTW),
        DUC=f(DUC), DUN=f(DUN), DUS=f(DUS), DUE=f(DUE), DUW=f(DUW),
        DMC=f(DMC), DMN=f(DMN), DMS=f(DMS), DME=f(DME), DMW=f(DMW),
        DUM=f(DUM), KXU=f(KXU), KYU=f(KYU),
        KMTN=fi(KMTN), KMTS=fi(KMTS), KMTE=fi(KMTE), KMTW=fi(KMTW),
        btrop_ne=f(btrop_ne), btrop_n=f(btrop_n), btrop_e=f(btrop_e),
        btrop_c_indep=f(btrop_c_indep),
        checker=f(checker), constnt=f(constnt),
        rcheck=f(rcheck), rconst=f(rconst),
        vgrid=vgrid,
        area_t=f(area_t), volume_t=f(volume_t),
        residual_norm=f(residual_norm),
    )


def _np_shift3(f, di, dj, ew, ns):
    """``_np_shift`` of every level of a (km, ny, nx) array."""
    return np.stack([_np_shift(f[k], di, dj, ew, ns) for k in
                     range(f.shape[0])])


def bottom_cells(cfg: ModelConfig, dz, KMT):
    """DZBC, the bottom level's thickness (ny, nx), float64 NumPy
    (read_bottom_cell, source/grid.F90:2116): one big-endian float64 record
    of ``cfg.bottom_cell_file`` (ValueError if the file is shorter), or the
    full dz(KMT) without a file."""
    ny, nx = cfg.ny, cfg.nx
    if cfg.bottom_cell_file is not None:
        raw = np.fromfile(cfg.bottom_cell_file, dtype=">f8")
        if raw.size < ny * nx:
            raise ValueError("bottom_cell_file too small")
        return raw[:ny * nx].reshape(ny, nx).astype(np.float64)
    return np.where(KMT > 0, dz[np.maximum(KMT, 1) - 1], dz[0])


def partial_bottom_cells(cfg: ModelConfig, dz, zw_pad, KMT, KMU, DZBC):
    """(DZT, DZU, HT, HU), float64 NumPy, under partial bottom cells
    (source/grid.F90:917-1010) with the bottom level's thickness DZBC: DZT
    is dz but DZBC at k = KMT, DZU the least of the four surrounding DZT
    down to KMU and dz below it, and the depths HT, HU reach the bottom
    cells' floors."""
    ny, nx, km = cfg.ny, cfg.nx, cfg.km
    kidx1 = np.arange(1, km + 1)[:, None, None]
    DZT = np.where(kidx1 == KMT[None], DZBC[None],
                   dz[:, None, None] * np.ones((km, ny, nx)))
    ew, ns = cfg.ew_boundary, cfg.ns_boundary
    DZU = np.minimum(np.minimum(DZT, _np_shift3(DZT, 1, 0, ew, ns)),
                     np.minimum(_np_shift3(DZT, 0, 1, ew, ns),
                                _np_shift3(DZT, 1, 1, ew, ns)))
    DZU = np.where(kidx1 > KMU[None], dz[:, None, None], DZU)
    HT = np.where(KMT > 0, zw_pad[np.maximum(KMT - 1, 0)] + DZBC, 0.0)
    dzu_bot = np.take_along_axis(DZU, np.maximum(KMU - 1, 0)[None],
                                 axis=0)[0]
    HU = np.where(KMU > 0, zw_pad[np.maximum(KMU - 1, 0)] + dzu_bot, 0.0)
    return DZT, DZU, HT, HU


def bottom_planes(dz, DZT, DZU, KMT, KMU):
    """(DZBT, DZBU): the thickness of each column's bottom level at T and U
    points, DZT[KMT-1] and DZU[KMU-1], dz[0] on land (no level to divide
    by). Asserts what lets a kernel read a plane in place of the 3-D
    field: DZT and DZU equal dz at every level but the bottom one."""
    out = []
    for D, kmax in ((DZT, KMT), (DZU, KMU)):
        D, kmax = np.asarray(D, np.float64), np.asarray(kmax)
        kb = np.maximum(kmax - 1, 0)[None]
        plane = np.where(kmax > 0, np.take_along_axis(D, kb, axis=0)[0],
                         dz[0])
        off = np.arange(D.shape[0])[:, None, None] != kmax[None] - 1
        if not np.array_equal(D[off], np.broadcast_to(
                np.asarray(dz)[:, None, None], D.shape)[off]):
            raise AssertionError("a partial-cell thickness differs from dz "
                                 "off the column's bottom level")
        out.append(plane)
    return out


def build_aniso(cfg: ModelConfig, HTN, HTE, DXU, DYU, DXUR, DYUR, ULAT,
                KMU, device):
    """The anisotropic-viscosity statics of a grid from its fields."""
    from pop2_tpu_torch import hmix_aniso  # deferred: imports grid
    return hmix_aniso.build_statics(cfg, grid_bc(cfg), HTN, HTE, DXU, DYU,
                                    DXUR, DYUR, ULAT, KMU, device)


def build_topostress(cfg: ModelConfig, HT, KMT, KMU, TLAT, FCORT, DXUR,
                     DYUR, HUR):
    """(TSU, TSV), the Neptune topographic-stress velocities, float64 NumPy
    (source/topostress.F90:119-301): the depth smoothed ``nsmooth_topo``
    times by a 9-point filter over ocean points, the streamfunction
    TSP = -f L^2 H with the length scale L from 12 km at the equator to 3 km
    at the poles, and its gradient at the U corners."""
    def sh(f, di, dj):
        return _np_shift(f, di, dj, cfg.ew_boundary, cfg.ns_boundary)

    HT, KMT, KMU = (np.asarray(a) for a in (HT, KMT, KMU))
    htnew = np.asarray(HT, np.float64).copy()
    wet = (KMT > 0).astype(np.float64)

    def s9(f):
        return (4.0 * f
                + 2.0 * (sh(f, 1, 0) + sh(f, -1, 0) + sh(f, 0, 1)
                         + sh(f, 0, -1))
                + sh(f, 1, 1) + sh(f, 1, -1) + sh(f, -1, 1) + sh(f, -1, -1))

    for _ in range(cfg.nsmooth_topo):
        nb = s9(wet)
        htnew = np.where((KMT > 0) & (nb > 0),
                         s9(htnew * wet) / np.where(nb > 0, nb, 1.0), 0.0)
    tslse, tslsp = 12.0e5, 3.0e5
    scale = tslsp + (tslse - tslsp) * (0.5 + 0.5 * np.cos(2.0 * TLAT))
    tsp = np.where(KMT > 0, -FCORT * scale ** 2 * htnew, 0.0)
    t_ne, t_n, t_e = sh(tsp, 1, 1), sh(tsp, 0, 1), sh(tsp, 1, 0)
    TSV = DXUR * 0.5 * HUR * (t_ne - tsp - t_n + t_e)
    TSU = -DYUR * 0.5 * HUR * (t_ne - tsp + t_n - t_e)
    return np.where(KMU > 0, TSU, 0.0), np.where(KMU > 0, TSV, 0.0)


def thickness_t(cfg: ModelConfig, grid: Grid):
    """Layer thickness at T points: (km, ny, nx) under partial bottom
    cells, else a (km, 1, 1) broadcast of dz."""
    if grid.DZT is not None:
        return grid.DZT
    return grid.vgrid.dz.reshape(cfg.km, 1, 1)


def thickness_u(cfg: ModelConfig, grid: Grid):
    if grid.DZU is not None:
        return grid.DZU
    return grid.vgrid.dz.reshape(cfg.km, 1, 1)


def grid_bc(cfg: ModelConfig) -> BC:
    return BC(ew=cfg.ew_boundary, ns=cfg.ns_boundary)
