"""The fused tracer tendency: CUDA kernel, wrapper and plain version.

Replaces the TPU kernel ``tracer_pallas.py`` (``_kernel`` /
``tracer_tendency_tiles``) with ``csrc/tracer.cu``:

    ft = ah*Del2(tmix) - L_adv(trcr; u, v, dh) + D_v(told; vdc, stf)

On an H100 the tendency is bound by bytes: u, v, the two diffusivity classes
and trcr, told, ft per tracer, (4 + 3 nt) distinct 3-D fields on the model's
path (tmix is told on a leapfrog step and trcr on an Euler step), against
some 60 flops per output value. The plain version materializes the six
flux-velocity fields and every shifted operand in device memory. The kernel
reads each operand once: a block is a 2-D tile of columns in a frame of
one column (two for upwind3) that walks down k, stages the levels ahead in
shared memory by asynchronous copies, forms every column's face fluxes
once a level and hands them to its neighbours through shared memory, and
carries the tracers, the old tracers and the top fluxes of the level down
k in registers (see the note in ``csrc/tracer.cu``). ``launch_plan``
chooses the tile and its shared memory in plain Python; a launch carries
at most ``MAX_GROUP`` tracers (a template parameter of the kernel, so the
carries stay in registers), and above that the wrapper launches groups
(``tracer_groups``). Float32 and float64.

Two modes, chosen by ``cfg.hmix_tracer``: ``'del2'`` fuses the Laplacian
mixing (``with_del2=True``, the dynamical-core path); ``'gm'`` and
``'del4'`` leave the horizontal mixing to the GM kernels or to the plain
biharmonic operator (``hmix.hdifft_del4``) and compute advection + vertical
diffusion only (``with_del2=False``), a separate instance of the kernel that
does not read ``tmix``: (4 + 2 nt) fields of traffic. Centered or upwind3
(QUICKEST) advection, closed or tripole north edge (the frame's rows past
the north edge copied from the folded columns), 1-D layer thickness
(``tile_mode``), full or partial bottom cells. Upwind3 runs the tile in a
frame of two columns
(``UPW_HALO``): each column also forms its east- and north-face QUICKEST
values once a level and publishes them, from the 12 horizontal coefficient
planes of ``advect.upwind3_planes`` (staged once a tile) and a level
table of the vertical grid's spacings and the 6 vertical coefficient rows
of ``advect.upwind3_vert_coeffs`` (``upwind3_operands``), both formed
here. Under partial bottom cells (``Grid.DZBT`` set) the ``PBC`` instances
also read KMU and the bottom level's thickness at T and U points, three
(ny, nx) planes (counter ``launches_pbc``); the plain version reads the
grid's 3-D DZT/DZU through ``thickness_t``/``thickness_u``.
"""

from __future__ import annotations

import torch

from pop2_tpu_torch import _cuda_build as cb
from pop2_tpu_torch import advect, hmix, vmix
from pop2_tpu_torch.grid import grid_bc
from pop2_tpu_torch.parallel import mesh as pmesh

#: kernel launches so far (a plain counter; reset it to measure a run)
launches = 0
#: launches of the partial-bottom-cell (PBC) instances
launches_pbc = 0
#: the mode counters ``graphs.CapturedStep`` keeps exact under replay
MODE_COUNTERS = ("launches_pbc",)

MAX_GROUP = 2  # tracers a launch (kMaxGroup of csrc/tracer.cu)
TILE_COLS = 32  # interior columns a tile row (kFrameCols: one warp)
TILE_ROWS = 8  # interior rows a tile (kRows of csrc/tracer.cu)
HALO = 1  # columns of the tile's frame on each side (kHalo)
UPW_HALO = 2  # the frame of upwind3 advection (kUpwHalo)
UPW_COEF = 6  # QUICKEST values a face (kUpwCoef)


def tracer_groups(nt: int):
    """[(n0, ng)]: the launches that cover nt tracers, each ng <=
    MAX_GROUP tracers from n0; one launch for nt <= MAX_GROUP."""
    if nt < 1:
        raise ValueError(f"tracer tendency of {nt} tracers")
    return [(n0, min(MAX_GROUP, nt - n0)) for n0 in range(0, nt, MAX_GROUP)]


def smem_values(ng: int, del2: bool, rows: int,
                upwind3: bool = False, pbc: bool = False) -> int:
    """Values of shared memory a tile of ``rows`` rows takes for a group of
    ``ng`` tracers (``TracerLayout::kValues`` and
    ``TracerUpwLayout::kValues`` of csrc/tracer.cu, which chip_smoke.py
    holds this against). Centered advection: the DYU, DXU frame planes,
    three staged levels (u, v, ng trcr and, with the Laplacian, ng tmix
    frame planes; ng told and ng diffusivity tile planes) and two buffers of
    the published ute, vtn. Upwind3 (a frame of UPW_HALO): once a tile DYU,
    DXU on the face region (the tile with its S row and W column), KMT on
    the frame, the S row's and W column's coefficients and TAREA_R, the
    tile's own 12 coefficient planes; two buffers of each ring, every one
    of period two: frame levels (u, v on the face region, ng trcr on the
    frame), centre levels (what a level reads besides its carries: ng told
    of the level below, ng diffusivities, ng trcr two levels down on the
    tile, and with the Laplacian ng tmix on the frame) and the published
    ute, vtn and each tracer's east- and north-face values (face
    region). Partial bottom cells (``pbc``): centered advection two more
    frame planes (KMU and DZBU), upwind3 DZBU on the face region and KMU
    there as bytes, counted in 4-byte values."""
    tile = TILE_COLS * rows
    if not upwind3:
        plane = (TILE_COLS + 2 * HALO) * (rows + 2 * HALO)
        level = (2 + ng * (2 if del2 else 1)) * plane + 2 * ng * tile
        return (4 if pbc else 2) * plane + 3 * level + 2 * 2 * plane
    plane = (TILE_COLS + 2 * UPW_HALO) * (rows + 2 * UPW_HALO)
    face = (TILE_COLS + 1) * (rows + 1)
    once = (2 * face + plane + (UPW_COEF + 1) * (TILE_COLS + rows)
            + 2 * UPW_COEF * tile)
    frame = 2 * face + ng * plane
    centre = 3 * ng * tile + (ng * plane if del2 else 0)
    extra = face + (face + 3) // 4 if pbc else 0
    return once + 2 * (frame + centre + (2 + 2 * ng) * face) + extra


def launch_plan(value_bytes: int, ng: int, del2: bool,
                upwind3: bool = False, pbc: bool = False):
    """(block shape (TILE_COLS, rows), dynamic shared memory bytes) of a
    tracer kernel launch for a group of ``ng`` tracers in values of
    ``value_bytes``, with the Laplacian or without, centered or upwind3
    advection, full or partial bottom cells (the north edge does not change
    the plan). Raises for what the kernel does not take: a group over
    MAX_GROUP, values other than float32 or float64, or a tile over the
    card's 227 KB."""
    if value_bytes not in (4, 8):
        raise TypeError(f"kernels take float32 or float64, got "
                        f"{value_bytes}-byte values")
    if not 1 <= ng <= MAX_GROUP:
        raise NotImplementedError(
            f"tracer kernel carries at most {MAX_GROUP} tracers a launch, "
            f"got {ng} (tracer_groups splits more)")
    smem = smem_values(ng, del2, TILE_ROWS, upwind3, pbc) * value_bytes
    cb.check_smem(smem, f"tracer tile ({TILE_COLS} x {TILE_ROWS}, "
                        f"ng={ng}, del2={del2}, upwind3={upwind3}, "
                        f"pbc={pbc})")
    return (TILE_COLS, TILE_ROWS), smem


def tile_mode(cfg):
    """(upwind3, fold): the kernel instance a configuration runs, upwind3
    advection in a frame of UPW_HALO or centered advection in one of HALO,
    with a tripole north edge or a closed one."""
    return cfg.tadvect == "upwind3", cfg.ns_boundary == "tripole"


def upwind3_operands(cfg, grid, dtype, device):
    """(upw (12, ny, nx), lev (km, 11)): the QUICKEST coefficient planes of
    the east and north faces, and the level table, a row a level of what
    the upwind3 kernel reads there: dz, dzr, dz2r, dzwr2 (``vmix.dzwr2``),
    the vertical coefficients talfzp .. tdelzm, one address a level, and
    1/dz rounded once in ``dtype``, from which the kernel forms its
    quotients by dz as a division rounds them (``dzr`` is rounded in
    float64 first). Built at the first launch on a ``Grid`` object and kept
    on it."""
    hit = grid.__dict__.get("_upwind3_operands")
    if hit is None:
        vg = grid.vgrid
        x, y, _, _ = advect.upwind3_planes(grid, grid_bc(cfg))
        cols = (vg.dz, vg.dzr, vg.dz2r, vmix.dzwr2(grid),
                *advect.upwind3_vert_coeffs(vg.dz))
        lev = torch.stack(cols, dim=1).to(device=device, dtype=dtype)
        hit = (torch.stack(x + y).to(device=device, dtype=dtype)
               .contiguous(),
               torch.cat([lev, 1.0 / lev[:, :1]], dim=1).contiguous())
        grid.__dict__["_upwind3_operands"] = hit
    return hit


def _check_mode(cfg, grid):
    todo = []
    if cfg.tadvect == "lw_lim":
        todo.append("tadvect='lw_lim' (no kernel instance: baroclinic."
                    "driver runs it plain, as the JAX package does)")
    elif cfg.tadvect not in ("centered", "upwind3"):
        todo.append(f"tadvect={cfg.tadvect!r}")
    if cfg.hmix_tracer not in ("del2", "gm", "del4"):
        todo.append(f"hmix_tracer={cfg.hmix_tracer!r} (with_del2=False "
                    "beside a mixing scheme that is not ported)")
    if cfg.ns_boundary not in ("closed", "tripole"):
        todo.append(f"ns_boundary={cfg.ns_boundary!r}")
    if cfg.ew_boundary not in ("cyclic", "closed"):
        todo.append(f"ew_boundary={cfg.ew_boundary!r}")
    if todo:
        raise NotImplementedError(
            "tracer tendency kernel mode not ported yet (ROADMAP.md Queue 2 "
            "kernel 2): " + "; ".join(todo))


def with_del2(cfg) -> bool:
    """Whether the Laplacian mixing is fused into the tendency."""
    return cfg.hmix_tracer == "del2"


def tracer_tendency_plain(cfg, grid, u, v, trcr, tmix, told, vdc, stf, dh):
    """Plain PyTorch version: [hdifft_del2] - advt(comp_flux_vel) + vdifft,
    the chain of source/baroclinic.F90:1902 (tracer_update), with centered
    or upwind3 advection; the Laplacian only in the ``with_del2`` mode."""
    bc = grid_bc(cfg)
    fv = advect.comp_flux_vel(cfg, grid, bc, u, v, dh)
    ft = -advect.advt(cfg, grid, bc, fv, trcr)
    if with_del2(cfg):
        ft = hmix.hdifft(cfg, grid, bc, tmix) + ft
    return ft + vmix.vdifft(cfg, grid, vdc, told, stf)


@pmesh.halo_wrapped(pmesh.HALO_MAX)
def tracer_tendency(cfg, grid, u, v, trcr, tmix, told, vdc, stf, dh):
    """ft (nt, km, ny, nx) for u, v (km, ny, nx); trcr, tmix, told
    (nt, km, ny, nx); vdc (2, km, ny, nx); stf (nt, ny, nx); dh (ny, nx).
    CUDA tensors go through the kernel, CPU tensors through the plain
    version."""
    global launches, launches_pbc
    _check_mode(cfg, grid)
    if not trcr.is_cuda:
        return tracer_tendency_plain(cfg, grid, u, v, trcr, tmix, told, vdc,
                                     stf, dh)
    nt, km, ny, nx = trcr.shape
    dev, dt = trcr.device, trcr.dtype
    del2 = with_del2(cfg)
    upw3, fold = tile_mode(cfg)
    pbc = grid.DZBT is not None
    groups = [(n0, ng) + launch_plan(trcr.element_size(), ng, del2, upw3,
                                     pbc)
              for n0, ng in tracer_groups(nt)]
    vg = grid.vgrid
    dz = vg.dz
    dzwr2 = vmix.dzwr2(grid)
    f3, f4, f2 = (km, ny, nx), (nt, km, ny, nx), (ny, nx)
    for name, t, shape in (
            ("u", u, f3), ("v", v, f3), ("trcr", trcr, f4),
            ("tmix", tmix, f4), ("told", told, f4),
            ("vdc", vdc, (2, km, ny, nx)), ("stf", stf, (nt, ny, nx)),
            ("dh", dh, f2), ("DYU", grid.DYU, f2), ("DXU", grid.DXU, f2),
            ("TAREA_R", grid.TAREA_R, f2), ("DTN", grid.DTN, f2),
            ("DTS", grid.DTS, f2), ("DTE", grid.DTE, f2),
            ("DTW", grid.DTW, f2), ("dz", dz, (km,))):
        cb.check_operand(name, t, shape, dt, dev)
    cb.check_operand("KMT", grid.KMT, f2, torch.int32, dev)
    if pbc:
        cb.check_operand("KMU", grid.KMU, f2, torch.int32, dev)
        cb.check_operand("DZBT", grid.DZBT, f2, dt, dev)
        cb.check_operand("DZBU", grid.DZBU, f2, dt, dev)
    upw, lev = (upwind3_operands(cfg, grid, dt, dev) if upw3
                else (dz, dz))  # centered advection reads neither
    out = torch.empty_like(trcr)
    lib = cb.lib()
    for n0, ng, (_, rows), smem in groups:
        err = lib.pop2_tracer(
            cb.dtype_code(trcr), int(del2), nt, n0, ng, km, ny, nx,
            int(cfg.ew_boundary == "cyclic"),
            pmesh.kernel_fold(cfg, ny) if fold else 0, int(upw3),
            int(cfg.sfc_layer == "varthick"), rows, smem,
            u.data_ptr(), v.data_ptr(), trcr.data_ptr(), tmix.data_ptr(),
            told.data_ptr(), vdc.data_ptr(), stf.data_ptr(), dh.data_ptr(),
            grid.KMT.data_ptr(), grid.DYU.data_ptr(), grid.DXU.data_ptr(),
            grid.TAREA_R.data_ptr(), grid.DTN.data_ptr(),
            grid.DTS.data_ptr(), grid.DTE.data_ptr(), grid.DTW.data_ptr(),
            dz.data_ptr(), vg.dzr.data_ptr(), vg.dz2r.data_ptr(),
            dzwr2.data_ptr(), upw.data_ptr(), lev.data_ptr(),
            float(cfg.auto_ah), out.data_ptr(),
            *((grid.KMU.data_ptr(), grid.DZBT.data_ptr(),
               grid.DZBU.data_ptr()) if pbc else (0, 0, 0)),
            cb.stream_ptr())
        cb.check_launch(err, "tracer_tendency")
        launches += 1
        if pbc:
            launches_pbc += 1
    return out
