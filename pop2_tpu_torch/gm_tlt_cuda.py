"""The transition-layer search of GM: CUDA kernel, wrapper, launch plan.

A kernel of the port alone: the JAX package runs the search as jnp scans
between its two GM kernels (``gm_chain_pallas.hdifft_chain``), and its
plain version here is ``gm.transition_layer`` (the three passes of
``hmix_gm.F90:3183-3434`` as loops of whole-field operations that end at the
deepest level any column still searches). Under KPP the diabatic depth is
the boundary layer, so the search runs deep and those loops become dozens
of small launches a level, held back by the host. ``csrc/gm_tlt.cu`` gives
each column a thread that walks it with the passes' state in registers and
stops at the column's own depth; the integer outputs (K_LEVEL, ZTW) equal
the plain version's. Float32 and float64.
"""

from __future__ import annotations

import torch

from pop2_tpu_torch import _cuda_build as cb
from pop2_tpu_torch import gm

#: kernel launches so far (a plain counter; reset it to measure a run)
launches = 0

THREADS = 128  # kTltThreads of csrc/gm_tlt.cu: columns a block


def launch_plan(ny: int, nx: int, km: int):
    """(blocks, threads a block) of a launch over ny x nx columns of km
    levels: one thread a column, no shared memory. Raises for an empty
    grid."""
    if min(ny, nx, km) < 1:
        raise ValueError(f"transition-layer search over {ny} x {nx} columns "
                         f"of {km} levels")
    return -(-ny * nx // THREADS), THREADS


def level_depths(grid):
    """(2, km): zt and zw, the kernel's level table; built once a Grid
    object and kept on it."""
    hit = grid.__dict__.get("_gm_tlt_lev")
    if hit is None:
        hit = torch.stack([grid.vgrid.zt, grid.vgrid.zw]).contiguous()
        grid.__dict__["_gm_tlt_lev"] = hit
    return hit


def transition_layer(cfg, grid, diabatic_depth, sla, rb) -> gm.TLT:
    """``gm.transition_layer``: CUDA tensors go through the kernel, CPU
    tensors through the plain version."""
    global launches
    km, ny, nx = sla.shape[1:]
    launch_plan(ny, nx, km)
    if not sla.is_cuda:
        return gm.transition_layer(cfg, grid, diabatic_depth, sla, rb)
    dev, dt = sla.device, sla.dtype
    code = cb.dtype_code(sla)
    dd = diabatic_depth.contiguous()
    lev = level_depths(grid)
    f2 = (ny, nx)
    for name, t, shape in (("sla", sla, (2, km, ny, nx)), ("dd", dd, f2),
                           ("rb", rb, f2), ("lev", lev, (2, km))):
        cb.check_operand(name, t, shape, dt, dev)
    cb.check_operand("KMT", grid.KMT, f2, torch.int32, dev)
    thick = torch.empty(f2, dtype=dt, device=dev)
    idp = torch.empty_like(thick)
    klev = torch.empty(f2, dtype=torch.int32, device=dev)
    ztw = torch.empty_like(klev)
    err = cb.lib().pop2_gm_tlt(
        code, km, ny, nx, lev.data_ptr(), dd.data_ptr(),
        sla.data_ptr(), rb.data_ptr(), grid.KMT.data_ptr(),
        thick.data_ptr(), idp.data_ptr(), klev.data_ptr(), ztw.data_ptr(),
        cb.stream_ptr())
    cb.check_launch(err, "gm transition-layer search")
    launches += 1
    return gm.TLT(diabatic_depth=dd, thickness=thick, interior_depth=idp,
                  k_level=klev, ztw=ztw)
