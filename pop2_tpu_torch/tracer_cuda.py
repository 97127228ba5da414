"""The fused tracer tendency: CUDA kernel, wrapper and plain version.

Replaces the TPU kernel ``tracer_pallas.py`` (``_kernel`` /
``tracer_tendency_tiles``) with ``csrc/tracer.cu``:

    ft = ah*Del2(tmix) - L_adv(trcr; u, v, dh) + D_v(told; vdc, stf)

On an H100 the tendency is bound by bytes: u, v, the two diffusivity classes
and trcr, told, ft per tracer, (4 + 3 nt) distinct 3-D fields on the model's
path (tmix is told on a leapfrog step and trcr on an Euler step), against
some 60 flops per output value. The plain version materializes the six
flux-velocity fields and every shifted operand in device memory; the kernel
gives one thread to each (j, i) column, loops over k with the continuity
cumsum in registers, and recomputes the west/south face fluxes from the
neighbours' velocities so nothing but the operands and the result crosses
device memory (see the note in ``csrc/tracer.cu``). Float32 and float64.

Two modes, chosen by ``cfg.hmix_tracer``: ``'del2'`` fuses the Laplacian
mixing (``with_del2=True``, the dynamical-core path); ``'gm'`` leaves the
horizontal mixing to the GM kernels and computes advection + vertical
diffusion only (``with_del2=False``), a separate instance of the kernel that
does not read ``tmix``: (4 + 2 nt) fields of traffic. Centered advection,
closed north-south boundary, 1-D layer thickness. The other modes of the TPU
kernel (upwind3, tripole north edge) raise ``NotImplementedError``; they are
extensions of this kernel listed in ROADMAP.md Queue 2.
"""

from __future__ import annotations

import torch

from pop2_tpu_torch import _cuda_build as cb
from pop2_tpu_torch import advect, hmix, vmix
from pop2_tpu_torch.grid import grid_bc

#: kernel launches so far (a plain counter; reset it to measure a run)
launches = 0


def _check_mode(cfg, grid):
    todo = []
    if cfg.tadvect != "centered":
        todo.append(f"tadvect={cfg.tadvect!r} (upwind3 mode)")
    if cfg.hmix_tracer not in ("del2", "gm"):
        todo.append(f"hmix_tracer={cfg.hmix_tracer!r} (with_del2=False "
                    "beside a mixing scheme that is not ported)")
    if cfg.ns_boundary != "closed":
        todo.append(f"ns_boundary={cfg.ns_boundary!r} (tripole north edge)")
    if cfg.ew_boundary not in ("cyclic", "closed"):
        todo.append(f"ew_boundary={cfg.ew_boundary!r}")
    if grid.DZT is not None:
        todo.append("3-D layer thickness")
    if todo:
        raise NotImplementedError(
            "tracer tendency kernel mode not ported yet (ROADMAP.md Queue 2 "
            "kernel 2): " + "; ".join(todo))


def with_del2(cfg) -> bool:
    """Whether the Laplacian mixing is fused into the tendency."""
    return cfg.hmix_tracer == "del2"


def tracer_tendency_plain(cfg, grid, u, v, trcr, tmix, told, vdc, stf, dh):
    """Plain PyTorch version: [hdifft_del2] - advt_centered(comp_flux_vel)
    + vdifft, the chain of source/baroclinic.F90:1902 (tracer_update); the
    Laplacian only in the ``with_del2`` mode."""
    bc = grid_bc(cfg)
    fv = advect.comp_flux_vel(cfg, grid, bc, u, v, dh)
    ft = -advect.advt(cfg, grid, bc, fv, trcr)
    if with_del2(cfg):
        ft = hmix.hdifft(cfg, grid, bc, tmix) + ft
    return ft + vmix.vdifft(cfg, grid, vdc, told, stf)


def tracer_tendency(cfg, grid, u, v, trcr, tmix, told, vdc, stf, dh):
    """ft (nt, km, ny, nx) for u, v (km, ny, nx); trcr, tmix, told
    (nt, km, ny, nx); vdc (2, km, ny, nx); stf (nt, ny, nx); dh (ny, nx).
    CUDA tensors go through the kernel, CPU tensors through the plain
    version."""
    global launches
    _check_mode(cfg, grid)
    if not trcr.is_cuda:
        return tracer_tendency_plain(cfg, grid, u, v, trcr, tmix, told, vdc,
                                     stf, dh)
    nt, km, ny, nx = trcr.shape
    dev, dt = trcr.device, trcr.dtype
    vg = grid.vgrid
    dz = vg.dz
    dz_kp1 = torch.cat([dz[1:], dz[-1:]])
    dzwr2 = 1.0 / (0.5 * (dz + dz_kp1))
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
    out = torch.empty_like(trcr)
    err = cb.lib().pop2_tracer(
        cb.dtype_code(trcr), int(with_del2(cfg)), nt, km, ny, nx,
        int(cfg.ew_boundary == "cyclic"), int(cfg.sfc_layer == "varthick"),
        u.data_ptr(), v.data_ptr(), trcr.data_ptr(), tmix.data_ptr(),
        told.data_ptr(), vdc.data_ptr(), stf.data_ptr(), dh.data_ptr(),
        grid.KMT.data_ptr(), grid.DYU.data_ptr(), grid.DXU.data_ptr(),
        grid.TAREA_R.data_ptr(), grid.DTN.data_ptr(), grid.DTS.data_ptr(),
        grid.DTE.data_ptr(), grid.DTW.data_ptr(), dz.data_ptr(),
        vg.dzr.data_ptr(), vg.dz2r.data_ptr(), dzwr2.data_ptr(),
        float(cfg.auto_ah), out.data_ptr(), cb.stream_ptr())
    cb.check_launch(err, "tracer_tendency")
    launches += 1
    return out
