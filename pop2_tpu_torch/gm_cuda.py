"""GM/Redi flux assembly: CUDA kernel, wrapper and plain version.

Replaces the TPU kernel ``gm_pallas.py`` (``_kernel`` /
``flux_assembly_tiles``, entry ``flux_assembly_tiles_wrapper``) with
``csrc/gm_flux.cu``: the tracer tendency GTK and the vertical diffusivity
VDC_GM from the tracer face/vertical differences, the quarter-cell slopes,
the merged streamfunction and the isopycnal and horizontal diffusivities
(source/hmix_gm.F90:1720-2080).

On an H100 the assembly is bound by bytes: 3 nt difference fields and 20
weight-source fields in, nt + 1 out. The plain version materializes the
effective diffusivities, the skew weights, three flux fields per tracer and
every shifted copy in device memory. The kernel reads each value once a
level: a block is a 2-D tile of columns in a one-column frame that walks
down k; every frame column forms its weights once a level from the unpacked
fields and hands them to its neighbours through shared memory; the
differences are staged by asynchronous copies two levels ahead; the
vertical-flux carries of all tracers lie in shared memory (see the note in
``csrc/gm_flux.cu``; the arithmetic of a level is ``csrc/gm_flux.cuh``,
which the fused chain kernel shares). ``launch_plan`` chooses the tile and
its shared memory in plain Python. Both ``cancellation`` branches, float32
and float64, a closed or tripole north edge (the fold is read inside the
kernel: the frame's ghost row from the folded columns, the ghost row's
south-face skew weights as the folded north face's with the sign flipped,
as ``flux_assembly_plain`` forms them through ``BC.n_partner``).

Isotropic or anisotropic diffusivities (``gm_aniso``: the x faces take
``kisop``, the y faces ``kisop_y``; the ``ANISO`` instances read both and
publish two effective diffusivities, one a direction). 1-D layer thickness,
under partial bottom cells too: the JAX package computes GM on vgrid.dz
there (ROADMAP.md Queue 3).
"""

from __future__ import annotations

import torch

from pop2_tpu_torch import _cuda_build as cb
from pop2_tpu_torch import launch_counts
from pop2_tpu_torch.parallel import mesh as pmesh

#: kernel launches so far (a plain counter; reset it to measure a run)
launches = 0
#: of those, launches of the tripole-row (``FOLD``) instance
launches_fold = 0
#: of those, launches of an anisotropic (``ANISO``) instance
launches_aniso = 0
#: the mode counters ``graphs.CapturedStep`` keeps exact under replay
MODE_COUNTERS = ("launches_fold", "launches_aniso")

MAX_TRACERS = 16  # kMaxTracers of csrc/gm_flux.cuh
TILE_COLS = 32  # columns a tile row (kFrameCols: one warp)
# The model's tracers, T and S, have an instance of the kernel with their
# count a compile-time constant on a tile of TILE_ROWS rows; any other count
# takes NARROW_ROWS rows, whose staged levels of up to MAX_TRACERS tracers
# fit a block (kFluxTracersFixed, kFluxRows, kFluxRowsNarrow).
MODEL_TRACERS = 2
TILE_ROWS = 8
NARROW_ROWS = 2
HALO = 1  # columns of the tile's frame on each side


def tracer_groups(nt: int):
    """[(n0, n)]: the flux assembly's launches that cover ``nt`` tracers,
    each n <= MAX_TRACERS from n0, as few as the cap allows (each launch
    forms the weights again) and as even as the count allows
    (``_cuda_build.even_groups``: 39 are 13 + 13 + 13, whose narrow tiles
    keep 4 / 2 blocks an SM in float32 / float64); one launch for nt <=
    MAX_TRACERS."""
    if nt < 1:
        raise ValueError(f"GM flux assembly of {nt} tracers")
    return cb.even_groups(nt, MAX_TRACERS)


def tile_rows(nt: int) -> int:
    """Rows of the flux-assembly tile for ``nt`` tracers."""
    return TILE_ROWS if nt == MODEL_TRACERS else NARROW_ROWS


def smem_values(nt: int, cancellation: bool, aniso: bool = False) -> int:
    """Values of shared memory the tile takes for ``nt`` tracers: three
    staged levels of each tracer's tx, ty (and, for the skew terms, tz)
    frame planes, two buffers of the published weights (weff alone with
    ``cancellation``, else weff and the four faces' two skew weights; with
    ``aniso`` a second weff, the y faces'), and the tracers' vertical-flux
    carries (``flux_smem_values`` of csrc/gm_flux.cu, which chip_smoke.py
    holds this against)."""
    rows = tile_rows(nt)
    plane = (TILE_COLS + 2 * HALO) * (rows + 2 * HALO)
    diffs, pub = (2, 1) if cancellation else (3, 9)
    pub += int(bool(aniso))
    return (3 * nt * diffs * plane + 2 * pub * plane
            + nt * TILE_COLS * rows)


def launch_plan(value_bytes: int, nt: int, cancellation: bool,
                aniso: bool = False):
    """(block shape (TILE_COLS, rows), dynamic shared memory bytes) of a
    flux-assembly launch for ``nt`` tracers in values of ``value_bytes``,
    isotropic or anisotropic (``aniso``); ``nt`` is a group of
    ``tracer_groups``. Raises for what the kernel does not take: nt over
    MAX_TRACERS (``tracer_groups`` splits more), values other than float32
    or float64, or a tile over the card's 227 KB."""
    if value_bytes not in (4, 8):
        raise TypeError(f"kernels take float32 or float64, got "
                        f"{value_bytes}-byte values")
    if not 1 <= nt <= MAX_TRACERS:
        raise NotImplementedError(
            f"GM flux-assembly kernel carries at most {MAX_TRACERS} tracers "
            f"a launch, got {nt}")
    rows = tile_rows(nt)
    smem = smem_values(nt, cancellation, aniso) * value_bytes
    cb.check_smem(smem, f"GM flux tile ({TILE_COLS} x {rows}, nt={nt}, "
                  f"aniso={bool(aniso)})")
    return (TILE_COLS, rows), smem


def _check_mode(cfg, grid):
    todo = []
    if cfg.ns_boundary not in ("closed", "tripole"):
        todo.append(f"ns_boundary={cfg.ns_boundary!r}")
    if cfg.ew_boundary not in ("cyclic", "closed"):
        todo.append(f"ew_boundary={cfg.ew_boundary!r}")
    if todo:
        raise NotImplementedError(
            "GM flux-assembly kernel mode not ported yet (ROADMAP.md Queue 2 "
            "kernel 6): " + "; ".join(todo))


def level_below(f, dim=0, repeat_last=False):
    """f at level k+1 along ``dim``; below the last level zero, or the last
    level again."""
    n = f.shape[dim]
    tail = f.narrow(dim, n - 1, 1)
    if not repeat_last:
        tail = torch.zeros_like(tail)
    return torch.cat([f.narrow(dim, 1, n - 1), tail], dim=dim)


def flux_assembly_plain(cfg, grid, bc, tx, ty, tz, slx, sly, sf_slx, sf_sly,
                        kisop, hor_diff, cancellation: bool, kisop_y=None):
    """Plain PyTorch version: (GTK (nt, km, ny, nx), VDC_GM (km, ny, nx)),
    term for term the JAX package's ``flux_assembly_jnp``.

    tx, ty, tz: (nt, km, ny, nx) masked east/north face differences and
    tz[:, k] = T(k-1) - T(k); slx, sly, sf_slx, sf_sly: (face, half, km, ny,
    nx) slopes and merged streamfunction (face 0 = east/north, 1 =
    west/south; half 0 = top, 1 = bottom); kisop, hor_diff: (half, km, ny,
    nx); kisop_y: the y faces' isopycnal diffusivity of anisotropic GM
    (kisop is then the x faces'), kisop itself when None."""
    kisop_x = kisop
    if kisop_y is None:
        kisop_y = kisop
    km = cfg.km
    vg = grid.vgrid
    dz = vg.dz.reshape(km, 1, 1)
    dzr = vg.dzr.reshape(km, 1, 1)
    kidx = torch.arange(1, km + 1, device=tx.device,
                        dtype=torch.int32).reshape(km, 1, 1)

    hyx = grid.HTE / grid.HUS
    hxy = grid.HTN / grid.HUW
    hyxw = bc.w(hyx)
    hxys = bc.s(hxy)

    # effective vertical diffusivity VDC_GM (source/hmix_gm.F90:1720-1750),
    # |S|^2 split by direction so the anisotropic diffusivities weight
    # their own slope components
    km_mask = (kidx < grid.KMT[None]).to(tx.dtype)
    quad_x = hyx * slx[0, 1] ** 2 + hyxw * slx[1, 1] ** 2
    quad_y = hxy * sly[0, 1] ** 2 + hxys * sly[1, 1] ** 2
    quad_x_kp1 = hyx * slx[0, 0] ** 2 + hyxw * slx[1, 0] ** 2
    quad_y_kp1 = hxy * sly[0, 0] ** 2 + hxys * sly[1, 0] ** 2
    kisop_x_ktp_kp1 = level_below(kisop_x[0])
    kisop_y_ktp_kp1 = level_below(kisop_y[0])
    dz_kp1 = level_below(dz, repeat_last=True)
    dzw_k = vg.dzw[1:km + 1].reshape(km, 1, 1)
    vdc_gm = (dzw_k * km_mask * grid.TAREA_R
              * (dz * 0.25 * (kisop_x[1] * quad_x + kisop_y[1] * quad_y)
                 + dz_kp1 * 0.25
                 * (kisop_x_ktp_kp1 * level_below(quad_x_kp1)
                    + kisop_y_ktp_kp1 * level_below(quad_y_kp1))))
    vdc_gm[-1] = 0.0

    # horizontal fluxes (source/hmix_gm.F90:1805-1895)
    in_c = kidx <= grid.KMT[None]
    cx = torch.where(in_c & (kidx <= grid.KMTE[None]), 0.25 * hyx, 0.0)
    cy = torch.where(in_c & (kidx <= grid.KMTN[None]), 0.25 * hxy, 0.0)

    keff_x = kisop_x + hor_diff
    keff_y = kisop_y + hor_diff
    wx = keff_x[0] + keff_x[1]                  # ktp + kbt at (i, j)
    wy = keff_y[0] + keff_y[1]
    fx = dz * cx * tx * (wx + bc.e(wx))
    fy = dz * cy * ty * (wy + bc.n(wy))

    # skew contribution; zero when the isopycnal and thickness diffusivities
    # are equal and equally tapered ('cancellation', :970-983; the
    # directional factors scale both alike, which keeps it)
    tz_kp1 = level_below(tz, 1, repeat_last=True)
    if not cancellation:
        w1 = kisop_x[0] * slx[0, 0] * dz - sf_slx[0, 0]
        w2 = kisop_x[1] * slx[0, 1] * dz - sf_slx[0, 1]
        w3 = bc.e(kisop_x[0] * slx[1, 0] * dz - sf_slx[1, 0])
        w4 = bc.e(kisop_x[1] * slx[1, 1] * dz - sf_slx[1, 1])
        fx = fx - cx * (w1 * tz + w2 * tz_kp1 + w3 * bc.e(tz)
                        + w4 * bc.e(tz_kp1))
        w1 = kisop_y[0] * sly[0, 0] * dz - sf_sly[0, 0]
        w2 = kisop_y[1] * sly[0, 1] * dz - sf_sly[0, 1]
        # tripole: the south-face weights' ghost row is the fold of the
        # north-face ones with the sign flipped (the faces swap under the
        # 180-degree rotation, source/hmix_gm.F90 SLY(:,j+1,jsouth))
        w3 = bc.n_partner(kisop_y[0] * sly[1, 0] * dz - sf_sly[1, 0], w1,
                          "center", "vector")
        w4 = bc.n_partner(kisop_y[1] * sly[1, 1] * dz - sf_sly[1, 1], w2,
                          "center", "vector")
        fy = fy - cy * (w1 * tz + w2 * tz_kp1 + w3 * bc.n(tz)
                        + w4 * bc.n(tz_kp1))

    # vertical flux at the bottom of each cell (source/hmix_gm.F90:1900-2080)
    # split by direction so the anisotropic diffusivities weight their own
    # components
    def cross_x(sl_x, txl):
        return sl_x[0] * hyx * txl + sl_x[1] * hyxw * bc.w(txl)

    def cross_y(sl_y, tyl):
        return sl_y[0] * hxy * tyl + sl_y[1] * hxys * bc.s(tyl)

    def kcross(kx, ky, sl_x, sl_y, txl, tyl):
        return kx * cross_x(sl_x, txl) + ky * cross_y(sl_y, tyl)

    tx_kp1 = level_below(tx, 1, repeat_last=True)
    ty_kp1 = level_below(ty, 1, repeat_last=True)
    slx_ktp_kp1 = level_below(slx[:, 0], 1)
    sly_ktp_kp1 = level_below(sly[:, 0], 1)
    if cancellation:
        work = (dz * kcross(kisop_x[1], kisop_y[1], slx[:, 1], sly[:, 1],
                            tx, ty)
                + dz_kp1 * kcross(kisop_x_ktp_kp1, kisop_y_ktp_kp1,
                                  slx_ktp_kp1, sly_ktp_kp1, tx_kp1, ty_kp1))
        fz = -km_mask * 0.5 * work
    else:
        work = (dz * kcross(kisop_x[1], kisop_y[1], slx[:, 1], sly[:, 1],
                            tx, ty)
                + cross_x(sf_slx[:, 1], tx) + cross_y(sf_sly[:, 1], ty)
                + dz_kp1 * kcross(kisop_x_ktp_kp1, kisop_y_ktp_kp1,
                                  slx_ktp_kp1, sly_ktp_kp1, tx_kp1, ty_kp1)
                + cross_x(level_below(sf_slx[:, 0], 1), tx_kp1)
                + cross_y(level_below(sf_sly[:, 0], 1), ty_kp1))
        fz = -km_mask * 0.25 * work
    fz[:, -1] = 0.0
    fz_top = torch.cat([torch.zeros_like(fz[:, :1]), fz[:, :-1]], dim=1)

    gtk = ((fx - bc.w(fx) + fy - bc.s(fy) + fz_top - fz)
           * dzr * grid.TAREA_R)
    return torch.where(grid.kmask_t[None], gtk, 0.0), vdc_gm


def kernel_statics(grid):
    """The kernel's operands that depend on the grid alone: ``(hyx, hxy,
    lev)`` = HTE/HUS, HTN/HUW and the (3, km) level scalars dz, 1/dz,
    dzw below the level. Built at the first launch on a ``Grid`` object and
    kept on it."""
    hit = grid.__dict__.get("_gm_flux_statics")
    if hit is None:
        vg = grid.vgrid
        km = vg.dz.shape[0]
        hit = ((grid.HTE / grid.HUS).contiguous(),
               (grid.HTN / grid.HUW).contiguous(),
               torch.stack([vg.dz, vg.dzr, vg.dzw[1:km + 1]]).contiguous())
        grid.__dict__["_gm_flux_statics"] = hit
    return hit


@pmesh.halo_wrapped(pmesh.HALO_MAX)
def flux_assembly(cfg, grid, bc, tx, ty, tz, slx, sly, sf_slx, sf_sly,
                  kisop, hor_diff, cancellation: bool, kisop_y=None):
    """(GTK, VDC_GM); arguments as ``flux_assembly_plain``. CUDA tensors go
    through the kernel (its ``ANISO`` instance where ``kisop_y`` is given),
    one launch for each group of ``tracer_groups`` (the first writes
    VDC_GM); CPU tensors through the plain version."""
    _check_mode(cfg, grid)
    if not tx.is_cuda:
        return flux_assembly_plain(cfg, grid, bc, tx, ty, tz, slx, sly,
                                   sf_slx, sf_sly, kisop, hor_diff,
                                   cancellation, kisop_y=kisop_y)
    nt, km, ny, nx = tx.shape
    dev, dt = tx.device, tx.dtype
    aniso = kisop_y is not None
    groups = [(n0, n) + launch_plan(tx.element_size(), n, bool(cancellation),
                                    aniso)
              for n0, n in tracer_groups(nt)]
    lib = cb.lib()
    hyx, hxy, lev = kernel_statics(grid)
    f4, f5, f2 = (nt, km, ny, nx), (2, 2, km, ny, nx), (ny, nx)
    for name, t, shape in (
            ("tx", tx, f4), ("ty", ty, f4), ("tz", tz, f4),
            ("slx", slx, f5), ("sly", sly, f5), ("sf_slx", sf_slx, f5),
            ("sf_sly", sf_sly, f5), ("kisop", kisop, (2, km, ny, nx)),
            ("hor_diff", hor_diff, (2, km, ny, nx)), ("hyx", hyx, f2),
            ("hxy", hxy, f2), ("TAREA_R", grid.TAREA_R, f2)) + (
            (("kisop_y", kisop_y, (2, km, ny, nx)),) if aniso else ()):
        cb.check_operand(name, t, shape, dt, dev)
    cb.check_operand("KMT", grid.KMT, f2, torch.int32, dev)
    gtk = torch.empty_like(tx)
    vdc = torch.empty((km, ny, nx), dtype=dt, device=dev)
    for g, (n0, n, (_, rows), smem) in enumerate(groups):
        err = lib.pop2_gm_flux(
            cb.dtype_code(tx), n, km, ny, nx,
            int(cfg.ew_boundary == "cyclic"),
            pmesh.kernel_fold(cfg, ny), int(bool(cancellation)),
            int(aniso), rows, smem, tx[n0].data_ptr(), ty[n0].data_ptr(),
            tz[n0].data_ptr(), slx.data_ptr(), sly.data_ptr(),
            sf_slx.data_ptr(), sf_sly.data_ptr(), kisop.data_ptr(),
            kisop_y.data_ptr() if aniso else None, hor_diff.data_ptr(),
            grid.KMT.data_ptr(), hyx.data_ptr(), hxy.data_ptr(),
            grid.TAREA_R.data_ptr(), lev.data_ptr(), gtk[n0].data_ptr(),
            vdc.data_ptr() if g == 0 else None, cb.stream_ptr())
        cb.check_launch(err, "gm flux_assembly")
        launch_counts.add(__name__)
        launch_counts.add(__name__, "launches_fold",
                          int(cfg.ns_boundary == "tripole"))
        launch_counts.add(__name__, "launches_aniso", int(aniso))
    return gtk, vdc
