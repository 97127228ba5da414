"""Sharded checkpoints: every rank writes its own block.

Counterpart of the JAX package's ``io/sharded_restart.py``, which keeps
every shard on its owning process through orbax (a JAX library): here each
rank of a decomposition (``parallel.mesh``) writes its block of every
``State`` field as NumPy, beside a JSON record of the global dims, the
decomposition (py, px, the block's rows and columns) and
``nsteps_total``; rank 0 writes the pointer file. Reading works onto the
same or another (py, px): each rank reads only the blocks that overlap its
own. A dims mismatch raises ``ValueError``, as the JAX package's does.

Layout: ``<directory>/<nsteps_total>/block<r>.npz`` and ``block<r>.json``
for r in 0..py*px-1, and ``<directory>/rpointer.ocn.sharded`` holding the
latest step. Checkpoints of y slabs in the earlier layout (``slab<r>``
files, whose record names ``py`` and the slab's rows) are read too.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from pop2_tpu_torch.config import ModelConfig
from pop2_tpu_torch.grid import resolve_device
from pop2_tpu_torch.parallel.mesh import Decomposition
from pop2_tpu_torch.state import State

POINTER_FILE = "rpointer.ocn.sharded"


def _bounds(cfg: ModelConfig, mesh: Optional[Decomposition]):
    """(rank, ranks, j0, j1, i0, i1) of this rank's block (the whole
    domain without a mesh)."""
    if mesh is None:
        return 0, 1, 0, cfg.ny, 0, cfg.nx
    return (mesh.rank, mesh.py * mesh.px, mesh.j0, mesh.j1, mesh.i0,
            mesh.i1)


def write_sharded_restart(directory: str, state: State, nsteps_total: int,
                          cfg: ModelConfig,
                          mesh: Optional[Decomposition] = None) -> str:
    """Write this rank's block of ``state`` (the whole state without a
    ``mesh``) at step ``nsteps_total``; returns the checkpoint directory.
    Every rank of the mesh calls it (collective: it ends at a barrier)."""
    directory = os.path.abspath(directory)
    step_dir = os.path.join(directory, str(nsteps_total))
    os.makedirs(step_dir, exist_ok=True)
    rank, ranks, j0, j1, i0, i1 = _bounds(cfg, mesh)
    np.savez(os.path.join(step_dir, f"block{rank}.npz"),
             **{f.name: getattr(state, f.name).detach().cpu().numpy()
                for f in dataclasses.fields(State)})
    meta = {"nsteps_total": nsteps_total, "nx": cfg.nx, "ny": cfg.ny,
            "km": cfg.km, "nt": cfg.nt, "ranks": ranks, "rank": rank,
            "j0": j0, "j1": j1, "i0": i0, "i1": i1}
    with open(os.path.join(step_dir, f"block{rank}.json"), "w") as f:
        json.dump(meta, f)
    if rank == 0:
        with open(os.path.join(directory, POINTER_FILE), "w") as f:
            f.write(f"{nsteps_total}\n")
    if mesh is not None and mesh.comm is not None:
        mesh.comm.barrier()
    return step_dir


def _metas(step_dir: str, cfg: ModelConfig):
    """(file prefix, [each block's record]) of a checkpoint's step
    directory: ``block<r>`` files, or the ``slab<r>`` files of y slabs
    written before blocks (a record of ``py`` slabs, each every column)."""
    if not os.path.exists(os.path.join(step_dir, "block0.json")) and \
            os.path.exists(os.path.join(step_dir, "slab0.json")):
        prefix, count = "slab", "py"
    else:
        prefix, count = "block", "ranks"
    with open(os.path.join(step_dir, f"{prefix}0.json")) as f:
        ranks = json.load(f)[count]
    metas = []
    for r in range(ranks):
        with open(os.path.join(step_dir, f"{prefix}{r}.json")) as f:
            meta = json.load(f)
        if prefix == "slab":
            meta.update(i0=0, i1=cfg.nx)
        metas.append(meta)
    return prefix, metas


def read_sharded_restart(directory: str, cfg: ModelConfig,
                         step: Optional[int] = None,
                         mesh: Optional[Decomposition] = None,
                         device="cuda") -> Tuple[State, int]:
    """(state, nsteps_total) of this rank's block of ``mesh`` (the whole
    domain without one), on ``device``, from a checkpoint written on any
    (py, px): the latest step (the pointer file's) unless ``step`` is
    given."""
    device = resolve_device(device)
    directory = os.path.abspath(directory)
    if step is None:
        with open(os.path.join(directory, POINTER_FILE)) as f:
            step = int(f.read().strip())
    step_dir = os.path.join(directory, str(step))
    prefix, metas = _metas(step_dir, cfg)
    for dim in ("nx", "ny", "km", "nt"):
        if int(metas[0][dim]) != getattr(cfg, dim):
            raise ValueError(f"sharded restart {dim}={metas[0][dim]} != "
                             f"config {getattr(cfg, dim)}")
    _, _, j0, j1, i0, i1 = _bounds(cfg, mesh)
    fields = {}
    for meta in metas:
        lo, hi = max(j0, meta["j0"]), min(j1, meta["j1"])
        left, right = max(i0, meta["i0"]), min(i1, meta["i1"])
        if lo >= hi or left >= right:
            continue  # no point of this block is ours: not read
        shape = (meta["j1"] - meta["j0"], meta["i1"] - meta["i0"])
        with np.load(os.path.join(step_dir,
                                  f"{prefix}{meta['rank']}.npz")) as z:
            for f in dataclasses.fields(State):
                a = z[f.name]
                if a.ndim >= 2 and a.shape[-2:] == shape:
                    out = fields.get(f.name)
                    if out is None:
                        out = fields[f.name] = np.zeros(
                            a.shape[:-2] + (j1 - j0, i1 - i0), a.dtype)
                    out[..., lo - j0:hi - j0, left - i0:right - i0] = a[
                        ..., lo - meta["j0"]:hi - meta["j0"],
                        left - meta["i0"]:right - meta["i0"]]
                else:
                    fields.setdefault(f.name, a)
    state = State(**{name: torch.as_tensor(a).to(device)
                     for name, a in fields.items()})
    return state, int(metas[0]["nsteps_total"])
