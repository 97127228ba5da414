"""Sharded checkpoints: every rank writes its own slab.

Counterpart of the JAX package's ``io/sharded_restart.py``, which keeps
every shard on its owning process through orbax (a JAX library): here each
rank of a decomposition (``parallel.mesh``) writes its y slab of every
``State`` field as NumPy, beside a JSON record of the global dims, the
decomposition (py, the slab's rows) and ``nsteps_total``; rank 0 writes
the pointer file. Reading works onto the same or another number of slabs:
each rank reads only the slabs whose rows overlap its own. A dims mismatch
raises ``ValueError``, as the JAX package's does.

Layout: ``<directory>/<nsteps_total>/slab<r>.npz`` and ``slab<r>.json`` for
r in 0..py-1, and ``<directory>/rpointer.ocn.sharded`` holding the latest
step.
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


def write_sharded_restart(directory: str, state: State, nsteps_total: int,
                          cfg: ModelConfig,
                          mesh: Optional[Decomposition] = None) -> str:
    """Write this rank's slab of ``state`` (the whole state without a
    ``mesh``) at step ``nsteps_total``; returns the checkpoint directory.
    Every rank of the mesh calls it (collective: it ends at a barrier)."""
    directory = os.path.abspath(directory)
    step_dir = os.path.join(directory, str(nsteps_total))
    os.makedirs(step_dir, exist_ok=True)
    rank, py = (mesh.rank, mesh.py) if mesh is not None else (0, 1)
    j0, j1 = (mesh.j0, mesh.j1) if mesh is not None else (0, cfg.ny)
    np.savez(os.path.join(step_dir, f"slab{rank}.npz"),
             **{f.name: getattr(state, f.name).detach().cpu().numpy()
                for f in dataclasses.fields(State)})
    meta = {"nsteps_total": nsteps_total, "nx": cfg.nx, "ny": cfg.ny,
            "km": cfg.km, "nt": cfg.nt, "py": py, "rank": rank, "j0": j0,
            "j1": j1}
    with open(os.path.join(step_dir, f"slab{rank}.json"), "w") as f:
        json.dump(meta, f)
    if rank == 0:
        with open(os.path.join(directory, POINTER_FILE), "w") as f:
            f.write(f"{nsteps_total}\n")
    if mesh is not None and mesh.comm is not None:
        mesh.comm.barrier()
    return step_dir


def read_sharded_restart(directory: str, cfg: ModelConfig,
                         step: Optional[int] = None,
                         mesh: Optional[Decomposition] = None,
                         device="cuda") -> Tuple[State, int]:
    """(state, nsteps_total) of this rank's slab of ``mesh`` (the whole
    domain without one), on ``device``, from a checkpoint written on any
    number of slabs: the latest step (the pointer file's) unless ``step``
    is given."""
    device = resolve_device(device)
    directory = os.path.abspath(directory)
    if step is None:
        with open(os.path.join(directory, POINTER_FILE)) as f:
            step = int(f.read().strip())
    step_dir = os.path.join(directory, str(step))
    with open(os.path.join(step_dir, "slab0.json")) as f:
        py = json.load(f)["py"]
    metas = []
    for r in range(py):
        with open(os.path.join(step_dir, f"slab{r}.json")) as f:
            metas.append(json.load(f))
    for dim in ("nx", "ny", "km", "nt"):
        if int(metas[0][dim]) != getattr(cfg, dim):
            raise ValueError(f"sharded restart {dim}={metas[0][dim]} != "
                             f"config {getattr(cfg, dim)}")
    j0, j1 = (mesh.j0, mesh.j1) if mesh is not None else (0, cfg.ny)
    pieces = {}
    for meta in metas:
        lo, hi = max(j0, meta["j0"]), min(j1, meta["j1"])
        if lo >= hi:
            continue  # no row of this slab is ours: not read
        with np.load(os.path.join(step_dir,
                                  f"slab{meta['rank']}.npz")) as z:
            for f in dataclasses.fields(State):
                a = z[f.name]
                if a.ndim >= 2 and a.shape[-2:] == (
                        meta["j1"] - meta["j0"], cfg.nx):
                    a = a[..., lo - meta["j0"]:hi - meta["j0"], :]
                    pieces.setdefault(f.name, []).append(a)
                else:
                    pieces.setdefault(f.name, [a])
    fields = {name: torch.as_tensor(
        np.concatenate(parts, axis=-2) if len(parts) > 1 else parts[0])
        for name, parts in pieces.items()}
    state = State(**{name: t.to(device) for name, t in fields.items()})
    return state, int(metas[0]["nsteps_total"])
