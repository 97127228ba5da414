"""Seeded sample inputs: production-shaped isopycnal slopes for checks of the
GM/Redi path, a stepped bottom with ocean across a tripole fold for checks
of the kernels' north edge, partial bottom cells, a depth-acceleration
profile, and the climatologies of a forced run. The CPU tests
hand them to this package and to its reference, the GPU smoke test to the
kernels and their plain versions."""

from __future__ import annotations

import numpy as np
import torch

from pop2_tpu_torch import gm
from pop2_tpu_torch.grid import _np_shift, bottom_planes, partial_bottom_cells


def stratified_tracers(kmask_t, zt, tlat, nt, seed, dtype=np.float64,
                       noise=0.1):
    """(nt, km, ny, nx) NumPy tracers with a stratified T/S profile (warm
    surface, e-folding over 800 m, a meridional gradient and seeded noise of
    ``noise`` K), so that the isopycnal slopes are production-shaped, points
    on the vertical-density-difference clamp included; further tracers are
    1 + noise. Masked to ocean."""
    rng = np.random.RandomState(seed)
    mask = np.asarray(kmask_t)
    km, ny, nx = mask.shape
    zt, lat = np.asarray(zt, np.float64), np.asarray(tlat, np.float64)
    tprof = 2.0 + 16.0 * np.exp(-zt / 8.0e4)
    fields = [
        tprof[:, None, None] + 1.5 * np.cos(2 * lat)[None]
        + noise * rng.randn(km, ny, nx),
        0.0347 + 5.0e-5 * np.sin(3 * lat)[None]
        + 2.0e-4 * noise * rng.randn(km, ny, nx)]
    for _ in range(nt - 2):
        fields.append(1.0 + 2.0 * noise * rng.randn(km, ny, nx))
    return (np.stack(fields) * mask).astype(dtype)


def grid_tracers(cfg, grid, seed, noise=0.1):
    """``stratified_tracers`` on a grid of this package, as a tensor of the
    config's dtype on the grid's device."""
    tracers = stratified_tracers(
        grid.kmask_t.cpu().numpy(), grid.vgrid.zt.double().cpu().numpy(),
        grid.TLAT.double().cpu().numpy(), cfg.nt, seed, noise=noise)
    return torch.as_tensor(tracers).to(device=grid.KMT.device,
                                       dtype=cfg.torch_dtype)


def flux_operands(cfg, grid, bc, ts_range, tmix, levels=(2, 5)):
    """Production-shaped operands of the flux assembly, in its argument
    order (tx, ty, tz, slx, sly, sf_slx, sf_sly, kisop, hor_diff): slopes of
    the tracers ``tmix``, tapered diffusivities under a boundary layer that
    deepens towards the equator from level ``levels[0]`` to ``levels[1]``
    (0-based), a streamfunction with 0.8 of the isopycnal diffusivity."""
    km = cfg.km
    vg = grid.vgrid
    shallow, deep = vg.zt[levels[0]], vg.zt[levels[1]]
    tx, ty, tz, slx, sly = gm._slopes(cfg, grid, bc, ts_range, tmix)
    sla = gm._sla(cfg, grid, slx, sly)
    hblt = ((shallow + (deep - shallow)
             * (0.5 + 0.5 * torch.cos(2 * grid.TLAT))) * (grid.KMT > 0))
    tap_isop, tap_thic = gm._tapers(cfg, grid, sla, hblt)
    kisop = tap_isop * cfg.gm_ah_bolus
    kthic = tap_thic * (0.8 * cfg.gm_ah_bolus)
    hor_diff = torch.where(vg.zt.reshape(1, km, 1, 1) <= hblt,
                           cfg.gm_ah_bkg_srfbl * (1.0 - tap_isop), 0.0)
    in_mask = grid.kmask_t[None, None]
    dz = vg.dz.reshape(km, 1, 1)
    sf_slx = torch.where(in_mask, kthic[None] * slx * dz, 0.0)
    sf_sly = torch.where(in_mask, kthic[None] * sly * dz, 0.0)
    return tuple(t.contiguous() for t in (tx, ty, tz, slx, sly, sf_slx,
                                          sf_sly, kisop, hor_diff))


def fold_bottom_kmt(kmt, km, seed):
    """A seeded stepped bottom of 2..km levels inside the ocean of ``kmt``
    (ny, nx), with ocean opened across the two top rows (the internal grid
    makes them land, which would hide the tripole fold from every check):
    NumPy int32."""
    kmt = np.asarray(kmt)
    ny, nx = kmt.shape
    rng = np.random.RandomState(seed)
    jj, ii = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    depth = 0.55 + 0.45 * np.sin(2 * np.pi * (ii / nx + rng.rand())) \
        * np.cos(2 * np.pi * (jj / ny + rng.rand()))
    depth += 0.15 * rng.randn(ny, nx)
    ocean = kmt > 0
    ocean[-2:] = True
    return np.where(ocean, np.clip(np.rint(depth * km), 2, km),
                    0).astype(np.int32)


def bottom_leaves(kmt, zw, ew, ns):
    """The grid leaves derived from a bottom ``kmt`` (ny, nx) that the
    kernels and the plain chains read, NumPy, with the shifts of the grid
    (a tripole fold included): KMT, KMU, HT, HU, HUR, RCALCT, RCALCU,
    kmask_t, kmask_u, KMTN, KMTS, KMTE, KMTW. ``zw``: (km,) bottom depths."""
    kmt = np.asarray(kmt).astype(np.int32)
    km = len(zw)

    def sh(f, di, dj):
        return _np_shift(f, di, dj, ew, ns).astype(np.int32)

    kmu = np.minimum(np.minimum(kmt, sh(kmt, 1, 0)),
                     np.minimum(sh(kmt, 0, 1), sh(kmt, 1, 1)))
    zw_pad = np.concatenate([[0.0], np.asarray(zw, np.float64)])
    hu = zw_pad[kmu]
    kidx = np.arange(1, km + 1)[:, None, None]
    return dict(
        KMT=kmt, KMU=kmu, HT=zw_pad[kmt], HU=hu,
        HUR=np.where(hu > 0, 1.0 / np.where(hu > 0, hu, 1.0), 0.0),
        RCALCT=(kmt >= 1).astype(np.float64),
        RCALCU=(kmu >= 1).astype(np.float64),
        kmask_t=kidx <= kmt[None], kmask_u=kidx <= kmu[None],
        KMTN=sh(kmt, 0, 1), KMTS=sh(kmt, 0, -1), KMTE=sh(kmt, 1, 0),
        KMTW=sh(kmt, -1, 0))


def fold_grid(cfg, grid, seed):
    """``grid`` (a tripole grid of this package) on ``fold_bottom_kmt``'s
    bottom, its derived leaves recomputed through the fold; the barotropic
    operator weights are left as they are (the kernels do not read them)."""
    new = bottom_leaves(
        fold_bottom_kmt(grid.KMT.cpu().numpy(), cfg.km, seed),
        grid.vgrid.zw.double().cpu().numpy(), cfg.ew_boundary,
        cfg.ns_boundary)
    dev = grid.KMT.device
    return grid.replace(**{
        name: torch.as_tensor(np.ascontiguousarray(a)).to(
            device=dev, dtype=getattr(grid, name).dtype)
        for name, a in new.items()})


def bottom_cell_thickness(kmt, dz, seed, low=0.25, high=1.0):
    """A seeded DZBC (ny, nx), float64 NumPy: each ocean column's bottom
    level ``f`` times its full thickness dz[KMT-1], ``f`` uniform in [low,
    high]; dz[0] on land."""
    kmt, dz = np.asarray(kmt), np.asarray(dz, np.float64)
    frac = np.random.RandomState(seed).uniform(low, high, kmt.shape)
    return np.where(kmt > 0, frac * dz[np.maximum(kmt, 1) - 1], dz[0])


def write_bottom_cells(path, kmt, dz, seed):
    """Write ``bottom_cell_thickness`` as the reference's bottom-cell file
    (one big-endian float64 record) to ``path``; returns ``path``."""
    np.ascontiguousarray(bottom_cell_thickness(kmt, dz, seed),
                         dtype=">f8").tofile(path)
    return path


def with_bottom_cells(cfg, grid, seed):
    """``grid`` (of this package) under partial bottom cells of
    ``bottom_cell_thickness`` on its own KMT: DZT, DZU and the bottom
    planes DZBT, DZBU, through its north edge (a fold included); HT, HU
    and the operators built from them are left as they are (the kernels
    and their plain versions read the thicknesses alone)."""
    kmt, kmu = grid.KMT.cpu().numpy(), grid.KMU.cpu().numpy()
    dz = grid.vgrid.dz.double().cpu().numpy()
    zw_pad = np.concatenate([[0.0], grid.vgrid.zw.double().cpu().numpy()])
    dzt, dzu, _, _ = partial_bottom_cells(
        cfg, dz, zw_pad, kmt, kmu, bottom_cell_thickness(kmt, dz, seed))
    fields = (dzt, dzu, *bottom_planes(dz, dzt, dzu, kmt, kmu))
    return grid.replace(**{
        name: torch.as_tensor(np.ascontiguousarray(a)).to(
            device=grid.KMT.device, dtype=grid.vgrid.dz.dtype)
        for name, a in zip(("DZT", "DZU", "DZBT", "DZBU"), fields)})


def open_top_face(grid):
    """``grid`` with the top row's north-face length HTN set to the grid's
    largest. The internal grid's top row lies on the pole, where HTN is all
    but zero, so no north-face flux crosses the tripole fold there and a
    check of a kernel's fold would not see the ghost row's weights; the
    kernels and their plain versions read the same grid, so their
    comparison stays exact."""
    htn = grid.HTN.clone()
    htn[-1] = htn.max()
    return grid.replace(HTN=htn)


def open_top_dxu(grid):
    """``grid`` with the top U row's east-west length DXU set to the grid's
    largest. The internal grid's top U row lies on the pole, where DXU is
    all but zero, so the north-face transport of the top T row, vtn = (v DXU
    dz + its west neighbour's) / 2, is too, and a check of the tracer
    kernel's fold would see the rows past the fold only through the second
    row down; the kernel and its plain version read the same grid, so their
    comparison stays exact."""
    dxu = grid.DXU.clone()
    dxu[-1] = dxu.max()
    return grid.replace(DXU=dxu)


def depth_accel_profile(zt, depth=1000.0e2, deepest=2.0):
    """A ``dttxcel`` for depth acceleration (``laccel``) over level centres
    ``zt`` (cm): 1 down to ``depth``, then rising linearly with depth to
    ``deepest`` at the bottom level (the shape of the reference's
    accel_file profiles for spin-up)."""
    zt = np.asarray(zt, np.float64)
    ramp = np.clip((zt - depth) / (zt[-1] - depth), 0.0, 1.0)
    return tuple(float(1.0 + (deepest - 1.0) * r) for r in ramp)


def coast_points(kmt) -> np.ndarray:
    """(ny, nx) bool: ocean cells with a land neighbour to the north,
    south, east or west (the rows beyond the grid's edges count as land,
    the columns wrap)."""
    ocean = np.asarray(kmt) > 0
    pad = np.pad(ocean, ((1, 1), (0, 0)))
    land_nb = ~(pad[2:] & pad[:-2] & np.roll(ocean, 1, axis=1)
                & np.roll(ocean, -1, axis=1))
    return ocean & land_nb


def forcing_climatology(kmask_t, tlat, sst, sss, seed):
    """Seeded monthly climatologies and static fields of a forced run (the
    bulk-NCEP heat and freshwater fluxes, a monthly wind stress, the
    chlorophyll, river runoff, a marginal sea, the interior restoring
    targets' noise), host NumPy float64, plausible for the surface state
    (``sst`` degC, ``sss`` msu, each (ny, nx)):

    - ``taux``, ``tauy`` (12, ny, nx) at U points, dyn/cm^2: an easterly
      and westerly pattern in latitude with a seasonal swing;
    - ``windspd`` 3-12 m/s, ``tair`` 3 K below to 1 K above the SST (K),
      ``qair`` at 60-90 % of saturation (kg/kg), ``qsw`` 0-300 W/m^2,
      ``cldfrac`` 0.2-0.9, ``sst`` the SST and ``sss`` the SSS with noise
      of 0.3 K and 0.1 psu, ``precip`` 1-4 mm/day (kg/m^2/s),
      ``chl`` 0.05-2 mg/m^3, each (12, ny, nx);
    - ``roff`` (ny, nx): 0.1-1 mm/day (kg/m^2/s) at about half of the
      coast points (``coast_points``), zero elsewhere;
    - ``ms_mask`` (ny, nx) a 3x3 marginal sea inside the ocean, and
      ``ms_points`` the two ocean points two cells west and east of it;
    - ``t_noise``, ``s_noise`` (km, ny, nx): 0.1 K and 0.02 psu of noise
      for the interior restoring targets."""
    rng = np.random.RandomState(seed)
    mask = np.asarray(kmask_t)
    km, ny, nx = mask.shape
    kmt = mask.sum(axis=0)
    lat = np.asarray(tlat, np.float64)
    sst = np.asarray(sst, np.float64)
    sss = np.asarray(sss, np.float64)
    phase = 2.0 * np.pi * (np.arange(12) + 0.5) / 12.0
    season = np.sin(phase)[:, None, None] * np.sin(lat)[None]

    def noise(scale):
        return scale * rng.randn(12, ny, nx)

    def uniform(low, high):
        return rng.uniform(low, high, (12, ny, nx))

    out = {
        "taux": -np.cos(3.0 * lat)[None] + 0.3 * season + noise(0.1),
        "tauy": 0.2 * np.sin(2.0 * lat)[None] + noise(0.05),
        "windspd": np.clip(7.5 + 3.0 * season + noise(1.0), 3.0, 12.0),
        "tair": sst[None] + 273.15 + uniform(-3.0, 1.0),
    }
    out["qair"] = (uniform(0.6, 0.9) * 640380.0
                   / np.exp(5107.4 / out["tair"]) / 1.2)
    out.update(
        qsw=np.clip(150.0 + 100.0 * np.cos(lat)[None] * (1.0 + season)
                    + noise(20.0), 0.0, 300.0),
        cldfrac=uniform(0.2, 0.9),
        sst=sst[None] + noise(0.3),
        sss=sss[None] + noise(1.0e-4),
        precip=uniform(1.0, 4.0) / 86400.0,
        chl=np.exp(uniform(np.log(0.05), np.log(2.0))))
    coast = coast_points(kmt)
    rivers = coast & (rng.rand(ny, nx) < 0.5)
    out["roff"] = np.where(rivers, rng.uniform(0.1, 1.0, (ny, nx)),
                           0.0) / 86400.0
    # the marginal sea: a 3x3 box whose 3x7 surroundings are ocean
    inner = [(j, i) for j in range(1, ny - 1) for i in range(3, nx - 3)
             if (kmt[j - 1:j + 2, i - 3:i + 4] > 0).all()]
    j, i = inner[rng.randint(len(inner))]
    ms = np.zeros((ny, nx))
    ms[j - 1:j + 2, i - 1:i + 2] = 1.0
    out.update(ms_mask=ms, ms_points=[(j, i - 2), (j, i + 2)],
               t_noise=0.1 * rng.randn(km, ny, nx) * mask,
               s_noise=2.0e-5 * rng.randn(km, ny, nx) * mask)
    return out
