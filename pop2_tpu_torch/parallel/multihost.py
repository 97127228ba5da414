"""Ranks: the process group, whole fields to and from blocks, and
``spawn_ranks``.

Counterpart of the JAX package's ``parallel/multihost.py``: where JAX
brings up one process per host and assembles global arrays from
process-local data, the port runs one process per block of a (py, px)
mesh (``mesh.Decomposition``) over ``torch.distributed``, and a rank's
block of a field is its share of the global array.

* ``initialize_distributed``: ``init_process_group`` with the address
  (``file://`` or ``tcp://localhost:<port>``), world size, rank and
  backend given, and the rank's device set (a card a rank under NCCL).
  The caller chooses the backend; nothing switches it: ``nccl`` where each
  rank has a card of its own, ``gloo`` where ranks run on the CPU or share
  one card (NCCL refuses two ranks on one device). A rank's fields live on
  the card unless ``device='cpu'`` is asked for, as the tests do.
* ``global_mesh``, ``make_global_array`` (a whole field scattered to the
  ranks' blocks), ``to_host_replicated`` (the blocks gathered into a whole
  NumPy field on every rank), ``gather_to_root`` (on one rank, which
  writes the output files) and ``process_local_slice``.
* ``spawn_ranks``: a function run in ``world_size`` fresh processes joined
  by a ``file://`` store in a temporary directory (never a fixed TCP port),
  one intra-op thread each; their results come back to the caller. The
  tests and ``chip_smoke.py`` share it.
"""

from __future__ import annotations

import functools
import importlib
import os
import pickle
import subprocess
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from pop2_tpu_torch.parallel.mesh import (Decomposition, make_mesh,
                                          over_ranks, tree_map)

_DEVICE: Optional[torch.device] = None


def initialize_distributed(init_method: str, world_size: int, rank: int,
                           backend: str = "gloo", device="cuda") -> int:
    """Join the process group (idempotent: returns the rank). ``device``:
    where this rank's fields live, 'cpu' or 'cuda'; under NCCL rank r takes
    card r, under gloo every rank the current card."""
    import torch.distributed as dist
    global _DEVICE
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: 'gloo' or 'nccl'")
    if dist.is_initialized():
        return dist.get_rank()
    device = torch.device(device)
    if device.type == "cuda":
        index = rank if backend == "nccl" else torch.cuda.current_device()
        torch.cuda.set_device(index)
        device = torch.device("cuda", index)
    elif backend == "nccl":
        raise ValueError("NCCL moves device tensors: device='cuda'")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    _DEVICE = device
    # a first collective every rank joins (NCCL builds its communicator
    # here, before any batch of point-to-point operations)
    dist.barrier()
    return rank


def local_device() -> torch.device:
    """The device ``initialize_distributed`` gave this rank."""
    if _DEVICE is None:
        raise RuntimeError("initialize_distributed first")
    return _DEVICE


def default_device() -> torch.device:
    """Where a rank's fields go unless a caller names a device: the device
    ``initialize_distributed`` gave the rank, else the card."""
    return _DEVICE or torch.device("cuda")


def global_mesh(cfg) -> Decomposition:
    """This rank's block of ``cfg`` on ``cfg.mesh_shape`` over the process
    group (the JAX package's mesh over the global device list)."""
    return make_mesh(cfg.mesh_shape, cfg.ny, cfg.nx,
                     tripole=cfg.ns_boundary == "tripole",
                     cyclic=cfg.ew_boundary == "cyclic")


def make_global_array(data, mesh: Decomposition, src: int = 0,
                      device=None):
    """This rank's block of a whole field (the reference's scatter_global,
    mpi/gather_scatter.F90:1348): rank ``src`` holds ``data`` (NumPy or a
    tensor; the other ranks pass None) and sends every rank its block. On
    ``device``, by default the one ``initialize_distributed`` gave the rank
    (the card where none was given)."""
    import torch.distributed as dist
    device = torch.device(device) if device is not None else default_device()
    if mesh.comm is None:
        return torch.as_tensor(data).to(device)
    if mesh.rank == src:
        whole = torch.as_tensor(data)
        meta = [tuple(whole.shape), whole.dtype]
    else:
        meta = [None, None]
    dist.broadcast_object_list(meta, src=src)
    shape, dtype = meta
    block = shape[:-2] + (mesh.rows, mesh.cols)
    # NCCL moves device tensors, gloo host tensors
    wire = device if mesh.comm.backend == "nccl" else torch.device("cpu")
    parts = None
    if mesh.rank == src:
        parts = [mesh.block(r).slab(whole).contiguous().to(wire)
                 for r in range(mesh.py * mesh.px)]
    out = torch.empty(block, dtype=dtype, device=wire)
    dist.scatter(out, parts, src=src)
    return out.to(device)


def to_host_replicated(t, mesh: Decomposition) -> np.ndarray:
    """The blocks of ``t`` gathered into the whole NumPy field on every
    rank (gather_global, mpi/gather_scatter.F90:74, with every rank
    receiving it; a tensor without horizontal axes comes back as it is)."""
    if mesh.comm is None or not mesh.is_block(t):
        return t.detach().cpu().numpy()
    parts = [p.cpu() for p in mesh.comm.all_gather(t.detach())]
    return join_blocks(parts, mesh).numpy()


def join_blocks(parts, mesh: Decomposition):
    """The whole field from every rank's block (``parts``, in rank order,
    each (..., rows, cols))."""
    rows = [torch.cat(list(parts[ry * mesh.px:(ry + 1) * mesh.px]), dim=-1)
            for ry in range(mesh.py)]
    return torch.cat(rows, dim=-2)


def gather_to_root(t, mesh: Decomposition, root: int = 0):
    """The blocks of ``t`` gathered into the whole NumPy field on rank
    ``root`` (gather_global, mpi/gather_scatter.F90:74), None on the other
    ranks; on the whole domain ``t`` as NumPy. One collective: every rank
    calls it."""
    if not over_ranks(mesh):
        return t.detach().cpu().numpy()
    parts = mesh.comm.gather(t.detach(), root)
    return None if parts is None else join_blocks(parts, mesh).numpy()


def process_local_slice(global_shape, mesh: Decomposition):
    """The index block of a whole field of ``global_shape`` that this rank
    holds: each rank reads only its rows and columns of a file."""
    lead = (slice(None),) * (len(global_shape) - 2)
    return lead + (slice(mesh.j0, mesh.j1), slice(mesh.i0, mesh.i1))


_CHILD = """
import os, pickle, sys
tmp, rank, world, backend, device, threads = sys.argv[1:7]
import torch
torch.set_num_threads(int(threads))
from pop2_tpu_torch.parallel import multihost
multihost._child(tmp, int(rank), int(world), backend, device)
"""


def _child(tmp: str, rank: int, world: int, backend: str, device: str):
    import torch.distributed as dist
    initialize_distributed("file://" + os.path.join(tmp, "store"), world,
                           rank, backend, device)
    with open(os.path.join(tmp, "call.pkl"), "rb") as f:
        module, name, args, kwargs = pickle.load(f)
    fn = functools.reduce(getattr, name.split("."),
                          importlib.import_module(module))
    out = fn(*args, **kwargs)
    out = tree_map(lambda t: t.detach().cpu(), out)
    with open(os.path.join(tmp, f"result{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def spawn_ranks(fn, world_size: int, backend: str = "gloo", device="cuda",
                args=(), kwargs=None, timeout: float = 900.0,
                threads: int = 1):
    """``fn(*args, **kwargs)`` in ``world_size`` fresh processes, each a
    rank of one process group (``initialize_distributed`` on a
    ``file://`` store in a temporary directory) on ``device`` (the card
    unless 'cpu' is asked for), with
    ``threads`` intra-op threads. ``fn`` is named by its module and
    qualified name, so it must be importable (the processes see this
    package and ``fn``'s module's directory); arguments and results are
    pickled, tensors in the results moved to the CPU. Returns the ranks'
    results in rank order. A rank that fails or outlives ``timeout``
    seconds stops every rank and raises with its output's end."""
    mod = sys.modules[fn.__module__]
    paths = [os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))]
    if getattr(mod, "__file__", None):
        paths.append(os.path.dirname(os.path.abspath(mod.__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        paths + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                 if p])
    env["OMP_NUM_THREADS"] = str(threads)
    with tempfile.TemporaryDirectory(prefix="pop2_ranks_") as tmp:
        with open(os.path.join(tmp, "call.pkl"), "wb") as f:
            pickle.dump((fn.__module__, fn.__qualname__, tuple(args),
                         dict(kwargs or {})), f)
        logs = [open(os.path.join(tmp, f"log{r}.txt"), "w+")
                for r in range(world_size)]
        procs = [subprocess.Popen(
            [sys.executable, "-c", _CHILD, tmp, str(r), str(world_size),
             backend, str(device), str(threads)], env=env,
            stdout=logs[r], stderr=subprocess.STDOUT)
            for r in range(world_size)]
        deadline = time.monotonic() + timeout
        failed = None
        try:
            while any(p.poll() is None for p in procs):
                bad = [r for r, p in enumerate(procs)
                       if p.poll() not in (None, 0)]
                if bad or time.monotonic() > deadline:
                    failed = bad[0] if bad else None
                    break
                time.sleep(0.05)
            else:
                bad = [r for r, p in enumerate(procs) if p.returncode]
                failed = bad[0] if bad else None
                if not bad:
                    results = []
                    for r in range(world_size):
                        with open(os.path.join(tmp, f"result{r}.pkl"),
                                  "rb") as f:
                            results.append(pickle.load(f))
                    return results
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for log in logs:
                log.close()
        what = ("timed out" if failed is None
                else f"rank {failed} exited {procs[failed].returncode}")
        tails = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"log{r}.txt")) as f:
                tails.append(f"-- rank {r}:\n{f.read()[-3000:]}")
        raise RuntimeError(f"spawn_ranks({fn.__qualname__}, {world_size}): "
                           f"{what}; the ranks' output:\n" + "\n".join(tails))
