"""Build and load the hand-written CUDA kernels.

The sources under ``csrc/`` are compiled at first use with ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface and loaded with
``ctypes``: no PyTorch headers, so the build takes seconds. Each source is
compiled by its own ``nvcc`` process, all started together, then linked. The
library goes into ``_build/`` beside this file (git-ignored), named by a hash
of the sources and flags, so an edit rebuilds and an unchanged tree reuses.

Nothing here runs at import: machines without ``nvcc`` or a GPU import the
package freely and use the plain PyTorch versions on CPU tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
SOURCES = ("thomas.cu", "tracer.cu", "clinic.cu", "gm_slope.cu",
           "gm_chain.cu", "gm_flux.cu", "gm_tlt.cu")
HEADERS = ("common.cuh", "gm_flux.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
#: seconds the last call of ``lib()`` spent compiling (0.0 if it reused)
build_seconds = 0.0

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}

# Dynamic shared memory a block may take on an H100 (227 KB of the SM's 228;
# the launch planners keep under it). The library's pop2_max_dynamic_smem
# reads the card's own figure; chip_smoke.py holds the two together.
SMEM_PER_BLOCK = 232448
# Shared memory of an SM (228 KB), of which the card keeps 1 KB a block.
SMEM_PER_SM = 233472
SMEM_RESERVED_PER_BLOCK = 1024


def even_groups(n: int, cap: int):
    """[(n0, m)]: ``n`` items in the fewest launches of at most ``cap``
    each, as even as the count allows (five under a cap of 4 are 3 + 2, not
    4 + 1; 39 under 16 are 13 + 13 + 13): the largest launch sets the
    shared memory a block takes, and the smaller slab keeps more blocks an
    SM."""
    ngroups = -(-n // cap)
    base, extra = divmod(n, ngroups)
    out, n0 = [], 0
    for g in range(ngroups):
        m = base + (g < extra)
        out.append((n0, m))
        n0 += m
    return out


def check_smem(smem: int, what: str) -> None:
    """Raise where a block would need more shared memory than the card
    gives one block."""
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"{what}: {smem} bytes of shared memory a block, "
                         f"the card gives at most {SMEM_PER_BLOCK} (227 KB)")


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in HEADERS + SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _build(so_path: Path) -> None:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = so_path.stem
    procs = []
    for name in SOURCES:
        obj = BUILD_DIR / f"{tag}_{Path(name).stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, objs, failed = [], [], []
    for name, obj, proc in procs:  # wait for all, so none outlives a failure
        out, _ = proc.communicate()
        log.append(f"==> {name}\n{out}")
        objs.append(str(obj))
        if proc.returncode != 0:
            failed.append(name)
    (BUILD_DIR / f"{tag}.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
    tmp = so_path.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *objs],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if link.returncode != 0:
        raise RuntimeError("linking the kernel library failed:\n"
                           + link.stdout)
    os.replace(tmp, so_path)  # atomic: a concurrent loader sees all or none
    for obj in objs:
        os.remove(obj)


def _declare(lib) -> None:
    p, i, l, d = (ctypes.c_void_p, ctypes.c_int, ctypes.c_long,
                  ctypes.c_double)
    lib.pop2_thomas.argtypes = [i, i, i, l, i, l] + [p] * 8
    lib.pop2_thomas.restype = i
    lib.pop2_thomas_blocks_per_sm.argtypes = [i, i, i, l, i]
    lib.pop2_gm_chain_blocks_per_sm.argtypes = [i, i, i, l]
    lib.pop2_gm_chain_smem_values.argtypes = [i, i]
    lib.pop2_gm_slope_blocks_per_sm.argtypes = [i, l]
    lib.pop2_gm_flux_blocks_per_sm.argtypes = [i, i, i, i, i, l]
    lib.pop2_gm_flux_smem_values.argtypes = [i, i, i]
    lib.pop2_gm_flux_tile_rows.argtypes = [i]
    lib.pop2_tracer.argtypes = [i] * 13 + [l] + [p] * 22 + [d] + [p] * 5
    lib.pop2_tracer.restype = i
    lib.pop2_tracer_blocks_per_sm.argtypes = [i, i, i, i, i, l, i]
    lib.pop2_tracer_smem_values.argtypes = [i, i, i, i]
    lib.pop2_clinic.argtypes = [i] * 8 + [l] + [p] * 17 + [d] * 4 + [p] * 6
    lib.pop2_clinic_blocks_per_sm.argtypes = [i, i, l, i]
    lib.pop2_clinic_smem_values.argtypes = [i, i]
    lib.pop2_clinic_tile_rows.argtypes = [i]
    lib.pop2_clinic.restype = i
    lib.pop2_gm_slopes.argtypes = [i] * 7 + [l, d] + [p] * 9
    lib.pop2_gm_slopes.restype = i
    lib.pop2_gm_chain.argtypes = [i] * 10 + [l] + [p] * 20
    lib.pop2_gm_chain.restype = i
    lib.pop2_gm_flux.argtypes = [i] * 10 + [l] + [p] * 18
    lib.pop2_gm_flux.restype = i
    lib.pop2_gm_tlt.argtypes = [i] * 4 + [p] * 10
    lib.pop2_gm_tlt.restype = i
    lib.pop2_gm_tlt_blocks_per_sm.argtypes = [i]
    for count in ("pop2_clinic_g2d_count", "pop2_gm_slope_coef_rows",
                  "pop2_gm_chain_lev_rows", "pop2_gm_flux_max_tracers",
                  "pop2_thomas_blocks_per_sm", "pop2_thomas_max_rhs",
                  "pop2_gm_chain_blocks_per_sm", "pop2_gm_chain_smem_values",
                  "pop2_tracer_blocks_per_sm", "pop2_tracer_smem_values",
                  "pop2_tracer_max_group", "pop2_tracer_tile_rows",
                  "pop2_clinic_blocks_per_sm", "pop2_clinic_smem_values",
                  "pop2_clinic_tile_rows", "pop2_max_dynamic_smem",
                  "pop2_gm_slope_blocks_per_sm", "pop2_gm_slope_smem_values",
                  "pop2_gm_slope_tile_rows", "pop2_gm_flux_blocks_per_sm",
                  "pop2_gm_flux_smem_values", "pop2_gm_flux_tile_rows",
                  "pop2_gm_tlt_threads", "pop2_gm_tlt_blocks_per_sm"):
        getattr(lib, count).restype = i


def lib():
    """The loaded kernel library, built first if its sources changed."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    so_path = BUILD_DIR / f"libpop2_{_source_hash()}.so"
    build_seconds = 0.0
    if not so_path.exists():
        t0 = time.perf_counter()
        _build(so_path)
        build_seconds = time.perf_counter() - t0
    handle = ctypes.CDLL(str(so_path))
    _declare(handle)
    _lib = handle
    return _lib


def build_log() -> str:
    """What nvcc printed (registers, spills) for the loaded library."""
    path = BUILD_DIR / f"libpop2_{_source_hash()}.log"
    return path.read_text() if path.exists() else ""


def dtype_code(t: torch.Tensor) -> int:
    try:
        return _DTYPE_CODE[t.dtype]
    except KeyError:
        raise TypeError(f"kernels take float32 or float64, got {t.dtype}")


def check_operand(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    """Raise on what a kernel does not take: wrong device, dtype, shape, or a
    non-contiguous tensor."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def check_launch(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: kernel launch failed with CUDA error "
                           f"{err}")


def stream_ptr() -> int:
    return torch.cuda.current_stream().cuda_stream
