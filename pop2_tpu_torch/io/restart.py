"""Exact-restart checkpointing.

The port's copy of the JAX package's ``io/restart.py``, in the same file
format, so that a checkpoint written by either package resumes in the
other. Reference: ``source/restart.F90`` — the reference dumps all three
time levels of the prognostic state plus FW_OLD and module extras, with
pointer files recording the latest restart path (:255-275). Here the
checkpoint is the full two-level ``State`` plus the step counter; restart
is exact (bitwise) because the state is the step's whole carry.

Format: one .npz per checkpoint + a JSON sidecar of metadata, plus a pointer
file mirroring the reference's ``rpointer.ocn.restart`` mechanism.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Tuple

import numpy as np
import torch

from pop2_tpu_torch.config import ModelConfig
from pop2_tpu_torch.grid import resolve_device
from pop2_tpu_torch.state import State

POINTER_FILE = "rpointer.ocn.restart"


def write_restart(path: str, state: State, nsteps_total: int,
                  cfg: ModelConfig, pointer_dir: str = None,
                  compressed: bool = True) -> str:
    """Write a checkpoint; returns the file path written. ``compressed``
    False stores the arrays as they are (an .npz either way: a full-size
    state compresses at tens of MB/s)."""
    arrays = {f.name: getattr(state, f.name).detach().cpu().numpy()
              for f in dataclasses.fields(State)}
    fname = path if path.endswith(".npz") else path + ".npz"
    (np.savez_compressed if compressed else np.savez)(fname, **arrays)
    meta = {
        "nsteps_total": nsteps_total,
        "nx": cfg.nx, "ny": cfg.ny, "km": cfg.km, "nt": cfg.nt,
        "dtype": cfg.dtype,
    }
    with open(fname + ".json", "w") as f:
        json.dump(meta, f)
    pdir = pointer_dir or os.path.dirname(os.path.abspath(fname))
    with open(os.path.join(pdir, POINTER_FILE), "w") as f:
        f.write(fname + "\n")
    return fname


def read_restart(path: str, cfg: ModelConfig, template: State = None,
                 device="cuda") -> Tuple[State, int]:
    """Read a checkpoint (or follow a pointer file's directory); returns
    (state, nsteps_total) with the state on ``device``. Shapes are validated
    against the config.

    ``template`` enables read fallbacks (the reference's
    ``io_read_fallback_mod``, source/io_read_fallback_mod.F90: registered
    per-field defaults so adding a tracer package or a new state field
    does not break resumption from older checkpoints):
      - a State field absent from the checkpoint is taken from the
        template (e.g. ``model.initial_state()``);
      - a checkpoint written with fewer tracers (meta nt < cfg.nt) has
        its tracer axes padded from the template's extra slots, and the
        Robert-filter conservation memory is invalidated so it re-primes.
    Without a template the read is strict.
    """
    device = resolve_device(device)
    if os.path.isdir(path):
        with open(os.path.join(path, POINTER_FILE)) as f:
            path = f.read().strip()
    with open(path + ".json") as f:
        meta = json.load(f)
    strict_dims = ("nx", "ny", "km") if template is not None else (
        "nx", "ny", "km", "nt")
    for dim in strict_dims:
        if meta[dim] != getattr(cfg, dim):
            raise ValueError(
                f"restart {dim}={meta[dim]} != config {getattr(cfg, dim)}")
    nt_ckpt = int(meta["nt"])
    if template is not None and nt_ckpt > cfg.nt:
        raise ValueError(f"restart nt={nt_ckpt} > config {cfg.nt}: "
                         "dropping tracers needs an explicit subset")
    pad_nt = cfg.nt - nt_ckpt
    dt = cfg.torch_dtype
    kwargs = {}
    with np.load(path) as data:
        for f_ in dataclasses.fields(State):
            name = f_.name
            if name not in data.files:
                if template is None:
                    raise KeyError(f"restart is missing field {name} "
                                   "(pass template= for read fallbacks)")
                kwargs[name] = getattr(template, name).to(device)
                continue
            arr = data[name]
            if pad_nt and name in ("tracer_old", "tracer_cur", "rf_s_prev"):
                tmpl = getattr(template, name).detach().cpu().numpy()
                arr = np.concatenate([arr, tmpl[nt_ckpt:cfg.nt]], axis=0)
            t = torch.as_tensor(arr)
            if t.is_floating_point():
                t = t.to(dt)
            kwargs[name] = t.to(device)
    if pad_nt:
        # new tracers have no conservation history: re-prime the filter
        kwargs["rf_s_prev_valid"] = torch.zeros((), dtype=dt, device=device)
    return State(**kwargs), int(meta["nsteps_total"])
