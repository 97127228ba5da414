"""The isopycnal-slope chain of GM: CUDA kernel, wrapper and plain version.

Replaces the TPU kernel ``gm_slope_pallas.py`` (``_kernel`` /
``slopes_tiles``, entry ``slopes_raw``) with ``csrc/gm_slope.cu``. From the
mixing-time T and S it produces, in one pass,

    slp  (8, km, ny, nx)  quarter-cell slopes, plane 2*face + half with the
                          faces east, west, north, south (= ``gm._slopes``'
                          slx then sly, flattened)
    sla  (2, km, ny, nx)  absolute-slope measure + eps (top, bottom half)
    n2   (km, ny, nx)     max(0, -g * displaced density difference / dzw)

On an H100 the chain is bound by bytes: 2 fields in, 11 out. The plain
version writes the two expansion coefficients (twice: at the level's own and
at the displaced pressure), the face and vertical density differences and
every shifted operand to device memory, some 25 field passes; the kernel
evaluates the MWJF derivatives in registers from per-level coefficients
(``level_coeffs``) and writes only the results. A block is a 2-D tile of
columns in a one-column frame that walks down k and stages T and S of the
frame by asynchronous copies three levels ahead (see the note in
``csrc/gm_slope.cu``); ``launch_plan`` chooses the tile and its shared
memory in plain Python. Float32 and float64.

MWJF equation of state, closed or tripole north edge (the frame's ghost row
is the fold of the top row: T and S are copied from the mapped columns),
1-D layer thickness (under partial bottom cells too, as the JAX package
computes GM; ROADMAP.md Queue 3); the other modes raise
``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np
import torch

from pop2_tpu_torch import _cuda_build as cb
from pop2_tpu_torch import constants as const
from pop2_tpu_torch import eos, gm
from pop2_tpu_torch.parallel import mesh as pmesh

#: kernel launches so far (a plain counter; reset it to measure a run)
launches = 0

#: rows of the per-level coefficient table (csrc/gm_slope.cu reads the same)
COEF_ROWS = ("N00A", "N02A", "N10A", "D00A", "D01A", "D03A",
             "N00B", "N02B", "N10B", "D00B", "D01B", "D03B",
             "TMIN", "TMAX", "SMIN", "SMAX", "DZWT", "DZWB", "DZWR")

TILE_COLS = 32  # columns a tile row (kFrameCols: one warp)
TILE_ROWS = 8  # rows a tile (kSlopeRows of csrc/gm_slope.cu)
HALO = 1  # columns of the tile's frame on each side
RING = 4  # staged levels held at once (kSlopeRing)


def smem_values(rows: int) -> int:
    """Values of shared memory a tile of ``rows`` rows takes: a ring of
    RING staged levels, each the T and S frame planes and the level's row
    of the coefficient table (``SlopeLayout::kValues`` of
    csrc/gm_slope.cu, which chip_smoke.py holds this against)."""
    plane = (TILE_COLS + 2 * HALO) * (rows + 2 * HALO)
    return RING * (2 * plane + len(COEF_ROWS))


def launch_plan(value_bytes: int):
    """(block shape (TILE_COLS, rows), dynamic shared memory bytes) of a
    slope kernel launch in values of ``value_bytes``. Raises for what the
    kernel does not take: values other than float32 or float64, or a tile
    over the card's 227 KB."""
    if value_bytes not in (4, 8):
        raise TypeError(f"kernels take float32 or float64, got "
                        f"{value_bytes}-byte values")
    smem = smem_values(TILE_ROWS) * value_bytes
    cb.check_smem(smem, f"GM slope tile ({TILE_COLS} x {TILE_ROWS})")
    return (TILE_COLS, TILE_ROWS), smem


def _check_mode(cfg, grid):
    todo = []
    if cfg.state_choice != "mwjf":
        todo.append(f"state_choice={cfg.state_choice!r} (the kernel "
                    "evaluates the MWJF derivatives)")
    if cfg.ns_boundary not in ("closed", "tripole"):
        todo.append(f"ns_boundary={cfg.ns_boundary!r}")
    if cfg.ew_boundary not in ("cyclic", "closed"):
        todo.append(f"ew_boundary={cfg.ew_boundary!r}")
    if todo:
        raise NotImplementedError(
            "GM slope kernel mode not ported yet (ROADMAP.md Queue 2 "
            "kernel 4): " + "; ".join(todo))


def level_coeffs(cfg, grid, ts_range):
    """(19, km) per-level scalars in the grid's dtype: the pressure-dependent
    MWJF polynomial coefficients at p(k) (set A) and at p(k+1) (set B, the
    displaced parcel), the T/S clip bounds, and dzw above / below the level
    and 1/dzw below. Computed on the host in float64; built once per
    (grid, ts_range) and kept on the Grid object."""
    hit = grid.__dict__.get("_gm_slope_coeffs")
    if hit is not None and hit[0] is ts_range:
        return hit[1]
    km = cfg.km
    vg = grid.vgrid
    pz = vg.pressz.double().cpu().numpy()
    out = np.zeros((len(COEF_ROWS), km))
    for base, pref in ((0, pz), (6, np.concatenate([pz[1:], pz[-1:]]))):
        p = 10.0 * pref  # bars -> the dbar-like pressure of the fit
        out[base + 0] = eos.MWJF_NP0S0T0 + p * (eos.MWJF_NP1S0T0
                                                + p * eos.MWJF_NP2S0T0)
        out[base + 1] = eos.MWJF_NP0S0T2 + p * (eos.MWJF_NP1S0T2
                                                + p * eos.MWJF_NP2S0T2)
        out[base + 2] = eos.MWJF_NP0S1T0 + p * eos.MWJF_NP1S1T0
        out[base + 3] = eos.MWJF_DP0S0T0 + p * eos.MWJF_DP1S0T0
        out[base + 4] = eos.MWJF_DP0S0T1 + p ** 3 * eos.MWJF_DP3S0T1
        out[base + 5] = eos.MWJF_DP0S0T3 + p ** 2 * eos.MWJF_DP2S0T3
    if cfg.state_range_opt == "enforce" and ts_range is not None:
        for row, t in zip(range(12, 16), ts_range):
            out[row] = t.double().cpu().numpy().ravel()
    else:
        out[12], out[13] = -1000.0, 1000.0
        out[14], out[15] = 0.0, 1000.0
    dzw = vg.dzw.double().cpu().numpy()
    out[16], out[17], out[18] = dzw[0:km], dzw[1:km + 1], 1.0 / dzw[1:km + 1]
    coef = torch.as_tensor(out).to(device=vg.dz.device, dtype=vg.dz.dtype)
    grid.__dict__["_gm_slope_coeffs"] = (ts_range, coef)
    return coef


def unpack_slopes(slp):
    """(slx, sly) in ``gm``'s (face, half, km, ny, nx) layout: views."""
    return (slp[:4].reshape((2, 2) + slp.shape[1:]),
            slp[4:].reshape((2, 2) + slp.shape[1:]))


def slopes_plain(cfg, grid, bc, ts_range, tmix):
    """Plain PyTorch version: (slp, sla, n2) from ``gm._slopes``,
    ``gm._sla`` and ``gm.buoyancy_frequency``."""
    _, _, _, slx, sly = gm._slopes(cfg, grid, bc, ts_range, tmix[:2])
    sla = gm._sla(cfg, grid, slx, sly)
    n2 = gm.buoyancy_frequency(cfg, grid, ts_range, tmix)
    slp = torch.cat([slx.reshape((4,) + slx.shape[2:]),
                     sly.reshape((4,) + sly.shape[2:])])
    return slp, sla, n2


@pmesh.halo_wrapped(pmesh.HALO_MAX)
def slopes(cfg, grid, bc, ts_range, tmix):
    """(slp, sla, n2) for tmix (nt, km, ny, nx), of which T and S (the
    first two tracers) are read. CUDA tensors go through the kernel, CPU
    tensors through the plain version."""
    global launches
    _check_mode(cfg, grid)
    if not tmix.is_cuda:
        return slopes_plain(cfg, grid, bc, ts_range, tmix)
    nt, km, ny, nx = tmix.shape
    dev, dt = tmix.device, tmix.dtype
    if nt < 2:
        raise ValueError("tmix needs temperature and salinity")
    (_, rows), smem = launch_plan(tmix.element_size())
    coef = level_coeffs(cfg, grid, ts_range)
    f2 = (ny, nx)
    lib = cb.lib()
    for name, t, shape in (
            ("tmix", tmix, (nt, km, ny, nx)), ("DXT", grid.DXT, f2),
            ("DYT", grid.DYT, f2),
            ("coef", coef, (lib.pop2_gm_slope_coef_rows(), km))):
        cb.check_operand(name, t, shape, dt, dev)
    cb.check_operand("KMT", grid.KMT, f2, torch.int32, dev)
    slp = torch.empty((8, km, ny, nx), dtype=dt, device=dev)
    sla = torch.empty((2, km, ny, nx), dtype=dt, device=dev)
    n2 = torch.empty((km, ny, nx), dtype=dt, device=dev)
    err = lib.pop2_gm_slopes(
        cb.dtype_code(tmix), km, ny, nx, int(cfg.ew_boundary == "cyclic"),
        pmesh.kernel_fold(cfg, ny), rows, smem, float(const.GRAV),
        coef.data_ptr(), tmix.data_ptr(),
        grid.KMT.data_ptr(), grid.DXT.data_ptr(), grid.DYT.data_ptr(),
        slp.data_ptr(), sla.data_ptr(), n2.data_ptr(), cb.stream_ptr())
    cb.check_launch(err, "gm slopes")
    launches += 1
    return slp, sla, n2
