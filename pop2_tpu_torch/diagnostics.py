"""Runtime scalar diagnostics, CFL monitors, transports, BSF and MOC.

Reference: ``source/diagnostics.F90`` (global means/tendencies
``diag_global_*`` :1174, printed table ``diag_print`` :1777, section
transports ``diag_transport`` :2010, CFL monitors :2262-2837, ``check_KE``
blow-up guard :3260), ``source/diag_bsf.F90`` (barotropic streamfunction)
and ``source/diags_on_lat_aux_grid.F90`` (meridional overturning and heat
transport on an auxiliary latitude grid).

The reductions run on the state's device; the functions that return a
table (``global_diagnostics``, ``cfl_numbers``, ``section_transport``, ...)
read their scalars to the host with ``float()``, the fields
(``barotropic_streamfunction``) and the binned profiles stay tensors.
``global_diagnostics`` is its own formula (SSH weighted by the ocean
area, the salinity in psu), not ``Model.diagnostics``.

On a block grid of a decomposition (``parallel.mesh``) the means, maxima,
CFL numbers and the binned transports reduce over every block, so every
rank reads the whole domain's values. A section's transport sums, on each
block, the part of the section (global indices) the block holds, with the
b4b sum (on the whole domain too), so its bits do not depend on the
decomposition; the streamfunction's sum along y runs over the whole
column on every rank, its column strip fetched from the blocks below and
above, so its order is the whole domain's.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch

from pop2_tpu_torch import constants as const
from pop2_tpu_torch.config import ModelConfig
from pop2_tpu_torch.grid import Grid, grid_bc, thickness_u
from pop2_tpu_torch.parallel import mesh as pmesh
from pop2_tpu_torch.reductions import global_max, global_sum, slab_total
from pop2_tpu_torch.state import State


class TransportSection(NamedTuple):
    """One diag_transport section (source/diagnostics.F90:2010): 0-based
    inclusive index bounds and the orientation ('zonal'/'merid')."""
    imin: int
    imax: int
    jmin: int
    jmax: int
    kmin: int
    kmax: int
    orient: str
    name: str


def global_diagnostics(cfg: ModelConfig, grid: Grid, state: State,
                       prev: Optional[State] = None) -> Dict[str, float]:
    """Volume-weighted global means and rates of change
    (diag_global_preupdate/afterupdate, source/diagnostics.F90:1174-1770)."""
    with pmesh.grid_scope(grid):
        return _global_diagnostics(cfg, grid, state, prev)


def _global_diagnostics(cfg, grid, state, prev):
    g = grid
    dz = g.vgrid.dz.reshape(-1, 1, 1)
    wt_u = torch.where(g.kmask_u, dz * g.UAREA, 0.0)
    wt_t = torch.where(g.kmask_t, dz * g.TAREA, 0.0)
    uvol = global_sum(wt_u)
    tvol = global_sum(wt_t)

    ke = 0.5 * global_sum(wt_u * (state.u_cur ** 2 + state.v_cur ** 2)) \
        / uvol
    tmean = global_sum(wt_t * state.tracer_cur[0]) / tvol
    smean = global_sum(wt_t * state.tracer_cur[1]) / tvol
    out = {
        "KE": float(ke),
        "TEMP_mean": float(tmean),
        "SALT_mean_psu": float(smean) * const.SALT_TO_PPT,
        "SSH_rms_cm": float(torch.sqrt(
            global_sum((state.psurf_cur / const.GRAV) ** 2 * g.RCALCT
                       * g.TAREA) / global_sum(g.RCALCT * g.TAREA))),
        "UVEL_max": float(global_max(torch.abs(state.u_cur))),
        "WVEL_like_divmax": float(global_max(torch.abs(state.psurf_cur))
                                  / const.GRAV),
    }
    if prev is not None:
        dt = cfg.time.dtt
        out["dTEMP_dt_per_day"] = (
            float(global_sum(wt_t * (state.tracer_cur[0]
                                     - prev.tracer_cur[0])) / tvol)
            / dt * 86400.0)
    return out


def cfl_numbers(cfg: ModelConfig, grid: Grid, state: State
                ) -> Dict[str, float]:
    """Maximum advective / diffusive CFL numbers (cfl_advect :2262,
    cfl_vdiff :2500, cfl_hdiff :2700, cfl_check :2837)."""
    dt = cfg.time.dtt
    u, v = state.u_cur, state.v_cur
    cfl_x = torch.abs(u) * dt * grid.DXUR
    cfl_y = torch.abs(v) * dt * grid.DYUR
    with pmesh.grid_scope(grid):
        out = {
            "cfl_advect_x": float(global_max(cfl_x)),
            "cfl_advect_y": float(global_max(cfl_y)),
        }
        hd = None
        if cfg.hmix_momentum == "del2":
            hd = 4.0 * cfg.auto_am * (grid.DXUR ** 2 + grid.DYUR ** 2) * dt
        elif cfg.hmix_momentum == "del4":
            hd = (16.0 * abs(cfg.am4)
                  * (grid.DXUR ** 2 + grid.DYUR ** 2) ** 2 * dt)
        if hd is not None:
            out["cfl_hdiff"] = float(global_max(
                torch.where(grid.kmask_u[0], hd, 0.0)))
    return out


def check_ke(cfg: ModelConfig, grid: Grid, state: State,
             ke_limit: float = 100.0) -> float:
    """Blow-up guard (source/diagnostics.F90:3260); raises on violation."""
    ke = global_diagnostics(cfg, grid, state)["KE"]
    if not math.isfinite(ke) or ke > ke_limit:
        raise FloatingPointError(
            f"KE blow-up: KE={ke} exceeds {ke_limit} cm^2/s^2")
    return ke


def zonal_transport(cfg: ModelConfig, grid: Grid, state: State,
                    i_index: int) -> float:
    """Volume transport (Sv) through the meridional section at x-index i
    (diag_transport, source/diagnostics.F90:2010-2260 simplified to full
    meridional sections)."""
    dz = grid.vgrid.dz.reshape(-1, 1)
    d = pmesh.of_grid(grid)
    i = i_index
    if d is not None and d.comm is not None:  # the block's own column
        i = i_index - d.i0 if d.i0 <= i_index < d.i1 else None
    if i is None:
        tr = torch.zeros((), dtype=state.u_cur.dtype,
                         device=state.u_cur.device)
    else:
        u = state.u_cur[:, :, i]
        hte_like = grid.DYU[:, i]
        mask = grid.kmask_u[:, :, i]
        tr = torch.sum(torch.where(mask, u * dz * hte_like[None, :], 0.0))
    with pmesh.grid_scope(grid):
        tr = slab_total(tr)
    return float(tr) * 1.0e-12  # cm^3/s -> Sv


def section_transport(cfg: ModelConfig, grid: Grid, state: State,
                      section) -> tuple:
    """Volume/heat/salt transport through one section (diag_transport,
    source/diagnostics.F90:2010-2255). ``section``: a ``TransportSection``
    (or any object with its fields: 0-based inclusive bounds and 'zonal' /
    'merid'). Returns (mass_Sv, heat_PW, salt_Svppt) floats.

    The B-grid face transports follow :2124-2155: through the east face
    of T-cell (i,j), MASS = 0.5*(U(i,j)DYU(i,j) + U(i,j-1)DYU(i,j-1))*dzu
    with the tracer face average 0.5*(T(i+1,j)+T(i,j)); through the north
    face, the (i-1, j+1) analogues. The neighbours are the stencil's shifts
    (on a block grid with their halos); the section's points are summed
    with the b4b sum, whose bits are the same on any decomposition."""
    dzu = thickness_u(cfg, grid)
    T, S = state.tracer_cur[0], state.tracer_cur[1]
    bc = grid_bc(cfg)
    with pmesh.grid_scope(grid) as d:
        if section.orient.startswith("merid"):
            # zonal (U) transport through a meridional section (MASS_M)
            uh = torch.where(grid.kmask_u,
                             state.u_cur * grid.DYU[None] * dzu, 0.0)
            mass = 0.5 * (uh + bc.s(uh))
            tf = 0.5 * (bc.e(T) + T)
            sf = 0.5 * (bc.e(S) + S)
        else:
            # meridional (V) transport through a zonal section (MASS_Z)
            vh = torch.where(grid.kmask_u,
                             state.v_cur * grid.DXU[None] * dzu, 0.0)
            mass = 0.5 * (vh + bc.w(vh))
            tf = 0.5 * (bc.n(T) + T)
            sf = 0.5 * (bc.n(S) + S)
        km, ny, nx = mass.shape
        dev = mass.device
        jg = torch.arange(ny, device=dev)
        ig = torch.arange(nx, device=dev)
        if pmesh.over_ranks(d):  # the block's global rows and columns
            jg, ig = jg + d.j0, ig + d.i0
        kg = torch.arange(km, device=dev)
        inside = (((kg >= section.kmin) & (kg <= section.kmax))[:, None,
                                                                None]
                  & ((jg >= section.jmin) & (jg <= section.jmax))[:, None]
                  & ((ig >= section.imin) & (ig <= section.imax)))

        def total(x):
            return global_sum(torch.where(inside, x, 0.0), b4b=True)
        heat, salt, mass = total(mass * tf), total(mass * sf), total(mass)
    return (float(mass) * const.MASS_TO_SV,
            float(heat) * const.HEAT_TO_PW,
            float(salt) * const.SALT_TO_SVPPT)


def barotropic_streamfunction(cfg: ModelConfig, grid: Grid,
                              state: State) -> torch.Tensor:
    """Barotropic streamfunction psi (Sv) by meridional integration of the
    vertically-integrated zonal transport (diagnostic analogue of
    source/diag_bsf.F90 without the elliptic inversion):
    psi(i,j) = -sum_{j'<=j} U_btrop*HU*DYU. On a block grid every rank
    fetches its columns' whole strip (one exchange) and sums it from the
    south edge, in the whole domain's order."""
    uh = grid.HU * state.ubtrop_cur * grid.DYU * grid.RCALCU
    with pmesh.grid_scope(grid) as d:
        if pmesh.over_ranks(d):
            (strip,), = d.fetch([uh], lambda b: [(0, b.ny, b.i0, b.i1,
                                                  False)], "bsf_columns")
            psi = -torch.cumsum(strip, dim=0)[d.j0:d.j1]
        else:
            psi = -torch.cumsum(uh, dim=0)
    return psi * 1.0e-12


def _lat_bins(grid: Grid, nlat_bins: int, dtype):
    """(edges in degrees as NumPy, one-hot (ny, nx, nbins) of each U
    column's bin): the auxiliary latitude grid, its edges evenly spaced as
    torch.linspace gives them (jnp.linspace interpolates and may round an
    edge to the other side of a latitude that lies on it)."""
    lat = (grid.ULAT * const.RADIAN).double()
    edges = torch.linspace(-90.0, 90.0, nlat_bins + 1, dtype=torch.float64,
                           device=lat.device)
    # the first edge not below the latitude, less one
    idx = torch.clamp(torch.searchsorted(edges, lat.contiguous()) - 1, 0,
                      nlat_bins - 1)
    one_hot = torch.nn.functional.one_hot(idx, nlat_bins).to(dtype)
    return edges.cpu().numpy(), one_hot


def moc_streamfunction(cfg: ModelConfig, grid: Grid, state: State,
                       nlat_bins: int = 36):
    """Meridional overturning circulation on an auxiliary latitude grid
    (diags_on_lat_aux_grid.F90): zonally/latitudinally binned northward
    transport, cumulated from the bottom. Returns (lat_edges_deg,
    moc[km, nbins]) in Sv."""
    dz = grid.vgrid.dz.reshape(-1, 1, 1)
    vdx = torch.where(grid.kmask_u, state.v_cur * grid.DXU * dz, 0.0)
    edges, one_hot = _lat_bins(grid, nlat_bins, vdx.dtype)
    vt = torch.einsum("kyx,yxb->kb", vdx, one_hot)  # northward transport
    with pmesh.grid_scope(grid):
        vt = slab_total(vt)
    moc = torch.flip(torch.cumsum(torch.flip(vt, (0,)), dim=0), (0,)) \
        * 1.0e-12
    return edges, moc


def meridional_transport(cfg: ModelConfig, grid: Grid, state: State,
                         nlat_bins: int = 36):
    """Northward heat and salt transport on the auxiliary latitude grid
    (diags_on_lat_aux_grid.F90 N_HEAT/N_SALT): zonally binned
    sum of v * T * dz * dx, advective part. Returns
    (lat_edges_deg, heat_pw[nbins], salt_sv_ppt[nbins])."""
    bc = grid_bc(cfg)
    dz = thickness_u(cfg, grid)
    with pmesh.grid_scope(grid):
        # tracer at the U point's latitude: average the two T rows around
        # the U row (B-grid; the reference interpolates to the aux grid)
        t_u = torch.stack([0.5 * (state.tracer_cur[n]
                                  + bc.n(state.tracer_cur[n]))
                           for n in range(2)])
        vdx = torch.where(grid.kmask_u, state.v_cur * grid.DXU * dz, 0.0)
        edges, one_hot = _lat_bins(grid, nlat_bins, vdx.dtype)
        heat = slab_total(torch.einsum("kyx,yxb->b", vdx * t_u[0], one_hot))
        salt = slab_total(torch.einsum("kyx,yxb->b", vdx * t_u[1], one_hot))
    # heat: degC cm^3/s -> PW via rho cp; salt: msu cm^3/s -> Sv*ppt
    heat_pw = heat * const.RHO_SW * const.CP_SW * 1.0e-22
    salt_svppt = salt * const.SALT_TO_PPT * 1.0e-12
    return edges, heat_pw, salt_svppt


def diag_print(cfg: ModelConfig, grid: Grid, state: State, step: int,
               prev: Optional[State] = None,
               solver_iters: Optional[int] = None) -> str:
    """Formatted per-interval diagnostics table
    (diag_print, source/diagnostics.F90:1777)."""
    d = global_diagnostics(cfg, grid, state, prev)
    c = cfl_numbers(cfg, grid, state)
    lines = [f"Step {step:8d}  global diagnostics:"]
    for k, v in {**d, **c}.items():
        lines.append(f"  {k:<22s} {v: .10e}")
    if solver_iters is not None:
        lines.append(f"  {'solver_iterations':<22s} {solver_iters:d}")
    return "\n".join(lines)

