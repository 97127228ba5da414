"""Generator for gx-class POP grid/topography input files.

The port's copy of the JAX package's ``gridgen.py``: the same seed and
dimensions write byte-identical files.

The real gx3v7/gx1v7 production input files are CESM inputdata (not
redistributable), so the file-grid code path needs generated stand-ins
that carry the same structure: latitudinally-refined spacing, proper
metric records in the 7-record binary layout (source/grid.F90:1314-1542),
a 60-level stretched vertical grid, and an earthlike KMT with continents,
shelves, and a mid-basin ridge (the cost/branch profile of real
topography). Recipes follow the reference's internal generators
(source/grid.F90:1226-1298 horizontal, :1616-1680 vertical) with the
equatorial refinement the gx grids add.

Writers come from io/grid_files.py; everything here is plain NumPy on the
host (grid building is init-time work).
"""

from __future__ import annotations

import os

import numpy as np

from pop2_tpu_torch import constants as const
from pop2_tpu_torch.io.grid_files import (write_horiz_grid, write_topography,
                                    write_vert_grid)


def gx_lat_spacing(ny: int, lat_s: float = -78.0, lat_n: float = 89.0,
                   eq_refine: float = 0.4) -> np.ndarray:
    """U-point latitudes (degrees) with equatorial refinement: the gx grids
    shrink dlat near the equator to ~0.5x the midlatitude value (gx3v7:
    1.9-3.4 degrees). ``eq_refine`` is the equatorial fraction of the
    uniform spacing."""
    j = np.arange(1, ny + 1)
    # grid-point density ~ (eq_refine + (1-eq_refine)*cos^2(phi)): maximal
    # at the equator (fine dlat), dropping to eq_refine at the poles; the
    # inverse CDF places the ny U-latitudes accordingly
    phi0 = np.linspace(-0.5 * np.pi, 0.5 * np.pi, 4096)
    w = eq_refine + (1.0 - eq_refine) * np.cos(phi0) ** 2
    cum = np.concatenate([[0.0], np.cumsum(w)])
    cum /= cum[-1]
    phi_grid = np.interp(j / ny, cum, np.linspace(0.0, 1.0, 4097))
    return lat_s + (lat_n - lat_s) * phi_grid


def gx_vert_dz(km: int, depth_cm: float = 5.5e5,
               dz_sfc_cm: float = 1.0e3) -> np.ndarray:
    """Stretched layer thicknesses: ~10 m surface layers thickening toward
    the abyss (the gx 60-level grid shape), integrating to ``depth_cm``.
    Hyperbolic-tangent profile normalized to the target depth."""
    k = np.arange(km)
    prof = 1.0 + np.tanh((k - 0.35 * km) / (0.2 * km))
    dz = dz_sfc_cm + prof * (depth_cm / km)
    dz *= depth_cm / dz.sum()
    return dz


def gx_topography(ny: int, nx: int, km: int, dz_cm: np.ndarray,
                  seed: int = 0) -> np.ndarray:
    """Earthlike KMT: two idealized continents with shelves, a polar
    land cap in the south (Antarctica analogue), a mid-basin ridge, and
    random seamounts. Depth field -> KMT against the layer interfaces."""
    rng = np.random.RandomState(seed)
    lon = np.linspace(0.0, 2.0 * np.pi, nx, endpoint=False)[None, :]
    lat01 = np.linspace(0.0, 1.0, ny)[:, None]          # 0 = south

    depth = np.full((ny, nx), 5.52e5)                   # abyssal plain (cm)
    # mid-basin ridge
    depth -= 2.0e5 * np.exp(-((lon - np.pi) / 0.35) ** 2)
    # two meridional continents with sloped shelves
    for lon0, width in ((0.35 * np.pi, 0.55), (1.55 * np.pi, 0.65)):
        d = np.minimum(np.abs(lon - lon0),
                       2.0 * np.pi - np.abs(lon - lon0))
        shelf = np.clip((d - width) / 0.12, -1.0, 1.0)
        land = 0.5 * (1.0 - shelf)                      # 1 inside continent
        lat_mask = np.exp(-((lat01 - 0.6) / 0.45) ** 2)
        depth -= 7.5e5 * land * lat_mask
    # southern polar cap
    depth -= 8.0e5 * np.exp(-(lat01 / 0.09) ** 2)
    # shelves shallow toward the northern boundary
    depth *= np.clip((1.0 - lat01) / 0.04, 0.0, 1.0) ** 0.25
    # seamounts
    for _ in range(20):
        j0, i0 = rng.randint(0, ny), rng.randint(0, nx)
        jj = (np.arange(ny)[:, None] - j0) / 3.0
        ii = (np.arange(nx)[None, :] - i0) / 3.0
        depth -= 1.5e5 * np.exp(-(jj ** 2 + ii ** 2))

    zw = np.cumsum(dz_cm)
    kmt = np.searchsorted(zw, np.clip(depth, 0.0, zw[-1]),
                          side="right").astype(np.int32)
    kmt = np.clip(kmt, 0, km)
    kmt[kmt < 3] = np.where(kmt[kmt < 3] > 1, 3, 0)     # min 3 ocean levels
    return kmt


def generate_gx_files(outdir: str, nx: int, ny: int, km: int,
                      seed: int = 0) -> dict:
    """Write horiz/vert/topography files for an (nx, ny, km) gx-class grid;
    returns {'horiz': path, 'vert': path, 'topo': path}."""
    os.makedirs(outdir, exist_ok=True)
    ulat_deg = gx_lat_spacing(ny)
    dlon = 360.0 / nx
    i = np.arange(1, nx + 1)
    ulon_deg = i * dlon
    ulon_deg = np.where(ulon_deg > 180.0, ulon_deg - 360.0, ulon_deg)

    ULAT = np.broadcast_to(ulat_deg[:, None] / const.RADIAN,
                           (ny, nx)).copy()
    ULON = np.broadcast_to(ulon_deg[None, :] / const.RADIAN,
                           (ny, nx)).copy()

    # metric lengths (cm) following the internal recipes
    # (source/grid.F90:1261-1298): HTN/HUS along latitude circles scale
    # with cos(lat); HTE/HUW follow the (varying) latitude spacing
    dx_cm = dlon * const.RADIUS / const.RADIAN
    ulat_jm1 = np.concatenate([[2.0 * ulat_deg[0] - ulat_deg[1]],
                               ulat_deg[:-1]])
    dlat_deg = ulat_deg - ulat_jm1
    dy_cm = dlat_deg * const.RADIUS / const.RADIAN
    lathalf = 0.5 * (ulat_deg + ulat_jm1)

    HTN = dx_cm * np.cos(ULAT)
    HUS = dx_cm * np.cos(lathalf[:, None] / const.RADIAN) * np.ones((1, nx))
    HTE = np.broadcast_to(dy_cm[:, None], (ny, nx)).copy()
    HUW = HTE.copy()
    ANGLE = np.zeros((ny, nx))

    dz = gx_vert_dz(km)
    kmt = gx_topography(ny, nx, km, dz, seed=seed)

    paths = {
        "horiz": os.path.join(outdir, f"horiz_grid.{nx}x{ny}.ieeer8"),
        "vert": os.path.join(outdir, f"in_depths.{km}.dat"),
        "topo": os.path.join(outdir, f"topography.{nx}x{ny}.ieeei4"),
    }
    write_horiz_grid(paths["horiz"], {
        "ULAT": ULAT, "ULON": ULON, "HTN": HTN, "HTE": HTE,
        "HUS": HUS, "HUW": HUW, "ANGLE": ANGLE})
    write_vert_grid(paths["vert"], dz)
    write_topography(paths["topo"], kmt)
    return paths
