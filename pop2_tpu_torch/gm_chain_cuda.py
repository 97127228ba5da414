"""The GM chain after the slopes, fused with the flux assembly: CUDA kernel,
wrapper, plain version, and the model-facing entry ``hdifft_chain``.

Replaces the TPU kernel ``gm_chain_pallas.py`` (``_kernel`` /
``chain_tiles``, entry ``hdifft_chain``) with ``csrc/gm_chain.cu``. With the
transition layer on and const or bfre diffusivities of one type, a step runs

    slope kernel (``gm_slope_cuda.slopes``)
      -> transition-layer search kernel (``gm_tlt_cuda``) from the diabatic
         depth (the KPP boundary layer, smoothed, or the first layer) and
         plain bfre vertical profile (``gm.kappa_vertical_bfre``)
      -> chain kernel: notanh tapers, diffusivities with the deep floors,
         merged streamfunction, vertical transition profile, skew-flux
         weights, per-tracer flux divergence GTK and VDC_GM, optionally the
         diagnostic columns kappa_isop / kappa_thic / hor_diff, and with
         ``lsubmeso`` the submesoscale streamfunction folded into the merged
         one (``with_sm``: 2-D amplitudes from ``submeso.amplitudes`` times
         the vertical shape, formed in the kernel).

On an H100 the chain kernel is bound by bytes: nt + 11 fields in, nt + 1
(+ 3) out. The plain version is ``gm.assemble`` with the plain flux
assembly: some 60 full-field intermediates in device memory. The kernel keeps
all of them on chip: a block is a 2-D tile of columns with a one-column halo
that walks down k, stages each level by asynchronous copies one level ahead,
computes every column's weights once a level and hands them to the
neighbours through shared memory (see the note in ``csrc/gm_chain.cu``).
``launch_plan`` chooses the tile and its shared memory in plain Python.
Float32 and float64. A launch carries at most MAX_TRACERS tracers; ``chain``
launches more in groups (``tracer_groups``, sized for two blocks an SM
where that leaves groups of half the cap or more): each group's launch
forms the tracer-independent weights again, and only the first writes
VDC_GM and the diagnostic columns.

Closed or tripole north edge: on a tripole grid the tile's ghost-row
threads form the folded column's weights (its submesoscale amplitudes
included) and publish the south-face ones as the north face's with the sign
flipped (``BC.n_partner``). The 1-D layer thickness under partial bottom
cells too: the JAX package computes GM on vgrid.dz there (ROADMAP.md
Queue 3).
"""

from __future__ import annotations

import ctypes

import torch

from pop2_tpu_torch import _cuda_build as cb
from pop2_tpu_torch import launch_counts
from pop2_tpu_torch import gm, gm_cuda, gm_slope_cuda, gm_tlt_cuda, submeso
from pop2_tpu_torch.gm_cuda import flux_assembly_plain
from pop2_tpu_torch.parallel import mesh as pmesh

#: kernel launches so far (a plain counter; reset it to measure a run)
launches = 0
#: of those, launches that write the diagnostic columns (``want_diags``)
launches_with_diags = 0
#: the mode counters ``graphs.CapturedStep`` keeps exact under replay
MODE_COUNTERS = ("launches_with_diags",)

#: rows of the per-level scalar table (csrc/gm_chain.cu reads the same)
LEV_ROWS = ("DZ", "DZR", "DZWKP", "RDT", "RDB", "TRT", "TRB", "DZWR")

MAX_TRACERS = gm_cuda.MAX_TRACERS  # kMaxTracers of csrc/gm_flux.cuh
TILE_COLS = 32  # columns a tile row, halo included (kTileCols: one warp)
# tile rows, halo included, by value size (at most the kernel's kMaxRows)
_ROWS = {4: 8, 8: 6}


#: planes of the submesoscale operand: amplitudes of faces e, w, n, s and
#: the mixed-layer depth (``submeso.amplitudes``)
SM_PLANES = 5


def tracer_groups(nt: int, value_bytes: int, sm: bool = False):
    """[(n0, n)]: the chain kernel's launches that cover ``nt`` tracers in
    values of ``value_bytes``, with the submesoscale fold-in or without
    (``sm``). The cap of a group is the largest tracer count whose tile
    leaves room for two blocks an SM; where that is under half of
    MAX_TRACERS (float64 with the fold-in: two tracers), MAX_TRACERS, with
    one block an SM: each launch forms the weights again, so groups of a
    few tracers cost more than the second block wins. The groups are as
    even as the count allows (``_cuda_build.even_groups``). prod_bgc's 39:
    8 + 8 + 8 + 8 + 7 in float32 (6.34 ms back to back on an H100, against
    8.17 for 13 + 13 + 13 and 7.54 for 16 + 16 + 7), 13 + 13 + 13 in float64
    (12.52 ms; 16 + 16 + 7 12.49, 8 + 8 + 8 + 8 + 7 14.82). One launch for
    nt at or under the cap."""
    if nt < 1:
        raise ValueError(f"GM chain of {nt} tracers")
    rows = _ROWS[value_bytes]
    share = cb.SMEM_PER_SM // 2 - cb.SMEM_RESERVED_PER_BLOCK
    cap = max([n for n in range(1, MAX_TRACERS + 1)
               if smem_values(n, sm) * TILE_COLS * rows * value_bytes
               <= share] or [0])
    if cap < MAX_TRACERS // 2:
        cap = MAX_TRACERS
    return cb.even_groups(nt, cap)


def smem_values(nt: int, sm: bool = False) -> int:
    """Values of shared memory a tile column holds with ``nt`` tracers: 19
    constants (24 with the submesoscale fold-in ``sm``: its five planes),
    two staged levels of 11 planes, two buffers of 9 published weights, and
    per tracer a ring of four levels and the vertical-flux carry
    (``chain_smem_values`` of csrc/gm_chain.cu, which chip_smoke.py holds
    this against)."""
    return 19 + (SM_PLANES if sm else 0) + 2 * 11 + 2 * 9 + (4 + 1) * nt


def launch_plan(value_bytes: int, nt: int, sm: bool = False):
    """(block shape (TILE_COLS, rows), dynamic shared memory bytes) of a
    chain kernel launch for ``nt`` tracers (a group of ``tracer_groups``)
    in values of ``value_bytes``, with the submesoscale fold-in or without
    (``sm``).

    A block is a tile of TILE_COLS x rows columns, the outer ring a halo:
    (TILE_COLS - 2) x (rows - 2) columns a block are computed. Raises for
    what the kernel does not take: nt over MAX_TRACERS (``tracer_groups``
    splits more), values other than float32 or float64, or a tile over the
    card's 227 KB."""
    if value_bytes not in _ROWS:
        raise TypeError(f"kernels take float32 or float64, got "
                        f"{value_bytes}-byte values")
    if not 1 <= nt <= MAX_TRACERS:
        raise NotImplementedError(
            f"GM chain kernel carries at most {MAX_TRACERS} tracers a "
            f"launch, got {nt} (tracer_groups splits more)")
    rows = _ROWS[value_bytes]
    smem = smem_values(nt, sm) * TILE_COLS * rows * value_bytes
    cb.check_smem(smem, f"GM chain tile ({TILE_COLS} x {rows}, nt={nt}, "
                  f"sm={bool(sm)})")
    return (TILE_COLS, rows), smem


def available(cfg, grid) -> bool:
    """The fused chain applies: transition layer on, isotropic const or bfre
    diffusivities of one type, the MWJF equation of state that the slope
    kernel evaluates (as the TPU kernel's ``available`` and the slope
    kernel's it requires)."""
    return (cfg.gm_transition_layer
            and cfg.state_choice == "mwjf"
            and cfg.gm_aniso is None
            and cfg.gm_kappa_isop_type == cfg.gm_kappa_thic_type
            and cfg.gm_kappa_isop_type in ("const", "bfre"))


def _check_mode(cfg, grid):
    todo = []
    if not available(cfg, grid):
        todo.append("a GM configuration outside the chain (transition layer "
                    "off, anisotropic, kappa types other than one of "
                    "const/bfre, or an equation of state other than MWJF): "
                    "gm.hdifft_gm carries those")
    if cfg.ns_boundary not in ("closed", "tripole"):
        todo.append(f"ns_boundary={cfg.ns_boundary!r}")
    if cfg.ew_boundary not in ("cyclic", "closed"):
        todo.append(f"ew_boundary={cfg.ew_boundary!r}")
    if todo:
        raise NotImplementedError(
            "GM chain kernel mode not ported yet (ROADMAP.md Queue 2 "
            "kernel 5): " + "; ".join(todo))


def level_scalars(grid):
    """(8, km) per-level scalars: dz, 1/dz, dzw below the level, the
    reference depths of the top / bottom quarter of the cell, the taper test
    depths zt(k+1) / zw(k+1), and 1/dzw below the level. They depend on the
    grid alone: built once and kept on the Grid object."""
    hit = grid.__dict__.get("_gm_chain_lev")
    if hit is None:
        vg = grid.vgrid
        km = vg.dz.shape[0]
        trt = gm._down(vg.zt, repeat_last=True).clone()
        trt[km - 1] = vg.zw[km - 1]
        hit = torch.stack([
            vg.dz, 1.0 / vg.dz, vg.dzw[1:km + 1], vg.zt - 0.25 * vg.dz,
            vg.zt + 0.25 * vg.dz, trt, gm._down(vg.zw, repeat_last=True),
            vg.dzwr[1:km + 1]]).contiguous()
        grid.__dict__["_gm_chain_lev"] = hit
    return hit


def chain_plain(cfg, grid, bc, tmix, slp, sla, kv, tlt,
                want_diags: bool = True, sm=None):
    """Plain PyTorch version: (gtk, vdc_gm, diags) from the slope kernel's
    outputs, the vertical profile ``kv`` (km, ny, nx; ones for const kappa),
    the transition-layer fields and, with the submesoscale fold-in, its
    amplitudes ``sm`` (5, ny, nx; ``submeso.amplitudes``). ``diags`` is (3,
    km, ny, nx) = kappa_isop, kappa_thic, hor_diff, or None. With ``sm`` the
    tendency is GM's plus the submesoscale skew flux of the streamfunction
    the amplitudes give (``submeso.gtk``), as the JAX package adds
    ``submeso_tendency`` to ``hdifft_gm``."""
    slx, sly = gm_slope_cuda.unpack_slopes(slp)
    tx, ty, tz = gm.tracer_diffs(cfg, grid, bc, tmix)
    kappa_isop, kappa_thic, kappa_equal, _ = gm.kappa_fields(
        cfg, grid, bc, None, tmix, kappa_vert=kv)
    out = gm.assemble(cfg, grid, bc, tx, ty, tz, slx, sly, sla, tlt,
                      kappa_isop, kappa_thic, kappa_equal, kv,
                      flux=flux_assembly_plain)
    gtk = out.gtk
    if sm is not None:
        sfx, sfy = submeso.sf_from_amps(grid, sm)
        gtk = gtk + submeso.gtk(cfg, grid, bc, sfx, sfy, tx, ty, tz)
    diags = (torch.stack([out.kappa_isop, out.kappa_thic, out.hor_diff])
             if want_diags else None)
    return gtk, out.vdc_gm, diags


def kernel_flags(cfg, want_diags: bool, sm: bool = False) -> int:
    """The template instance of the kernel: bit 0 bfre kappa, bit 1 the
    diagnostic columns, bit 2 equal slope limits, bit 3 the submesoscale
    fold-in."""
    return (int(cfg.gm_kappa_isop_type == "bfre")
            | int(bool(want_diags)) << 1
            | int(cfg.gm_slm_r == cfg.gm_slm_b) << 2
            | int(bool(sm)) << 3)


def launch_args(cfg, grid, tmix, slp, sla, kv, tlt, gtk, vdc=None,
                diags=None, sm=None):
    """Check the operands of a kernel launch on the tracers ``tmix`` (a
    group) into ``gtk`` (its rows of the output), writing VDC_GM into
    ``vdc`` and the diagnostic columns into ``diags`` where given. Returns
    (head, tail): the arguments of ``pop2_gm_chain`` before the launch
    plan's rows and shared memory (dtype, nt, km, ny, nx, cyclic, fold,
    flags, hd_const) and after it (the parameters, the operand and output
    pointers, the stream)."""
    nt, km, ny, nx = tmix.shape
    dev, dt = tmix.device, tmix.dtype
    lev = level_scalars(grid)
    hyx, hxy, _ = gm_cuda.kernel_statics(grid)
    f3, f2 = (km, ny, nx), (ny, nx)
    for name, t, shape in (
            ("tmix", tmix, (nt,) + f3), ("gtk", gtk, (nt,) + f3),
            ("slp", slp, (8,) + f3),
            ("sla", sla, (2,) + f3), ("kv", kv, f3),
            ("lev", lev, (cb.lib().pop2_gm_chain_lev_rows(), km)),
            ("hyx", hyx, f2), ("hxy", hxy, f2),
            ("TAREA_R", grid.TAREA_R, f2),
            ("diabatic_depth", tlt.diabatic_depth, f2),
            ("thickness", tlt.thickness, f2),
            ("interior_depth", tlt.interior_depth, f2)) + (
            (("vdc", vdc, f3),) if vdc is not None else ()) + (
            (("diags", diags, (3,) + f3),) if diags is not None else ()):
        cb.check_operand(name, t, shape, dt, dev)
    for name, t in (("KMT", grid.KMT), ("k_level", tlt.k_level),
                    ("ztw", tlt.ztw)):
        cb.check_operand(name, t, f2, torch.int32, dev)
    if sm is not None:
        cb.check_operand("sm", sm, (SM_PLANES,) + f2, dt, dev)
    params = (ctypes.c_double * 8)(
        cfg.gm_slm_r, cfg.gm_slm_b, cfg.gm_ah, cfg.gm_ah_bolus,
        cfg.gm_kappa_isop_deep, cfg.gm_kappa_thic_deep, cfg.gm_ah_bkg_srfbl,
        cfg.gm_ah_bkg_bottom)
    head = (cb.dtype_code(tmix), nt, km, ny, nx,
            int(cfg.ew_boundary == "cyclic"),
            pmesh.kernel_fold(cfg, ny),
            kernel_flags(cfg, diags is not None, sm is not None),
            int(bool(cfg.gm_use_const_ah_bkg_srfbl)))

    def ptr(t):
        return t.data_ptr() if t is not None else None
    tail = (params, lev.data_ptr(), tmix.data_ptr(), slp.data_ptr(),
            sla.data_ptr(), kv.data_ptr(), hyx.data_ptr(), hxy.data_ptr(),
            grid.TAREA_R.data_ptr(), tlt.diabatic_depth.data_ptr(),
            tlt.thickness.data_ptr(), tlt.interior_depth.data_ptr(),
            grid.KMT.data_ptr(), tlt.k_level.data_ptr(), tlt.ztw.data_ptr(),
            ptr(sm), gtk.data_ptr(), ptr(vdc), ptr(diags), cb.stream_ptr())
    return head, tail


@pmesh.halo_wrapped(pmesh.HALO_MAX)
def chain(cfg, grid, bc, tmix, slp, sla, kv, tlt, want_diags: bool = True,
          sm=None):
    """(gtk, vdc_gm, diags); arguments as ``chain_plain``. CUDA tensors go
    through the kernel, one launch for each group of ``tracer_groups``
    (the first writes VDC_GM and, with ``want_diags``, the diagnostic
    columns); CPU tensors through the plain version."""
    _check_mode(cfg, grid)
    if not tmix.is_cuda:
        return chain_plain(cfg, grid, bc, tmix, slp, sla, kv, tlt,
                           want_diags, sm)
    nt, km, ny, nx = tmix.shape
    vb, with_sm = tmix.element_size(), sm is not None
    groups = [(n0, n) + launch_plan(vb, n, with_sm)
              for n0, n in tracer_groups(nt, vb, with_sm)]
    gtk = torch.empty_like(tmix)
    vdc = torch.empty((km, ny, nx), dtype=tmix.dtype, device=tmix.device)
    diags = (torch.empty((3, km, ny, nx), dtype=tmix.dtype,
                         device=tmix.device) if want_diags else None)
    lib = cb.lib()
    for g, (n0, n, (_, rows), smem) in enumerate(groups):
        first = g == 0
        head, tail = launch_args(cfg, grid, tmix[n0:n0 + n], slp, sla, kv,
                                 tlt, gtk[n0:n0 + n],
                                 vdc if first else None,
                                 diags if first else None, sm)
        err = lib.pop2_gm_chain(*head, rows, smem, *tail)
        cb.check_launch(err, "gm chain")
        launch_counts.add(__name__)
        launch_counts.add(__name__, "launches_with_diags",
                          int(first and want_diags))
    return gtk, vdc, diags


def hdifft_chain(cfg, grid, bc, ts_range, tmix, hblt=None, hmxl=None,
                 want_diags: bool = True) -> gm.GMOut:
    """The fused GM tendency, with the submesoscale one folded in under
    ``lsubmeso``: slope kernel -> transition-layer search kernel and plain
    bfre profile -> chain kernel. ``hblt``, ``hmxl``: KPP's boundary-layer
    and mixed-layer depths (the first layer without KPP). On CPU tensors the
    kernels are their plain versions."""
    _check_mode(cfg, grid)
    slp, sla, n2 = gm_slope_cuda.slopes(cfg, grid, bc, ts_range, tmix)

    tlt = gm_tlt_cuda.transition_layer(
        cfg, grid, gm.diabatic_depth(cfg, grid, bc, hblt), sla,
        gm._rossby_radius(grid))
    if cfg.gm_kappa_isop_type == "bfre":
        kv = gm.kappa_vertical_bfre(cfg, grid, ts_range, tmix,
                                    tlt.interior_depth, n2=n2)
    else:
        kv = torch.ones_like(n2)
    sm = (submeso.amplitudes(cfg, grid, bc, ts_range, tmix, hmxl)
          if cfg.lsubmeso else None)

    gtk, vdc, diags = chain(cfg, grid, bc, tmix, slp, sla, kv, tlt,
                            want_diags, sm)
    return gm.GMOut(
        gtk=gtk, vdc_gm=vdc,
        kappa_isop=diags[0] if want_diags else None,
        kappa_thic=diags[1] if want_diags else None,
        hor_diff=diags[2] if want_diags else None,
        dia_depth=tlt.diabatic_depth, tlt_thick=tlt.thickness,
        int_depth=tlt.interior_depth)
