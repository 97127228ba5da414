"""Carrying state across: NumPy dictionaries <-> the port's Grid/State/Forcing.

The JAX package's ``Grid``, ``State`` and ``Forcing`` have the same leaf
names as the port's. Handing their leaves over as a dict of NumPy arrays
keyed by field name (nested leaves dotted, ``vgrid.dz``) lets both packages
step from identical inputs (the parity tests do this) without either
importing the other.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import numpy as np
import torch

from pop2_tpu_torch import eos
from pop2_tpu_torch.config import ModelConfig
from pop2_tpu_torch.forcing import Forcing
from pop2_tpu_torch.grid import (Grid, VGrid, bottom_planes, build_aniso,
                                 build_topostress, resolve_device)
from pop2_tpu_torch.state import State


def _from_numpy(cls, fields: Mapping[str, np.ndarray], cfg: ModelConfig,
                device):
    names = [f.name for f in dataclasses.fields(cls)]
    optional = {f.name for f in dataclasses.fields(cls) if f.default is None}
    missing = [n for n in names if n not in fields and n not in optional]
    if missing:
        raise KeyError(f"{cls.__name__} fields missing: {missing}")
    dt = cfg.torch_dtype
    device = resolve_device(device)
    return cls(**{n: torch.tensor(np.asarray(fields[n])).to(
        device=device, dtype=dt) for n in names if n in fields})


def state_from_numpy(fields: Mapping[str, np.ndarray], cfg: ModelConfig,
                     device="cuda") -> State:
    """A ``State`` on ``device`` (the GPU unless the caller asks for the
    CPU; no GPU raises) in the config's dtype from a dict of NumPy arrays
    keyed by field name; extra keys are ignored."""
    return _from_numpy(State, fields, cfg, device)


def forcing_from_numpy(fields: Mapping[str, np.ndarray], cfg: ModelConfig,
                       device="cuda") -> Forcing:
    """A ``Forcing`` on ``device`` (default as ``state_from_numpy``) from a
    dict of NumPy arrays. The port's ``Forcing`` has every field of the JAX
    package's, so a key that names none of them raises ``KeyError``:
    nothing is dropped."""
    known = {f.name for f in dataclasses.fields(Forcing)}
    unknown = sorted(set(fields) - known)
    if unknown:
        raise KeyError(f"not fields of Forcing: {unknown}")
    return _from_numpy(Forcing, fields, cfg, device)


def state_to_numpy(state) -> Dict[str, np.ndarray]:
    """Every tensor leaf of a ``State`` (or ``Forcing``) as a NumPy array."""
    return {name: t.detach().cpu().numpy() for name, t in state.leaves()}


def grid_from_numpy(leaves: Mapping[str, np.ndarray], cfg: ModelConfig,
                    device="cuda") -> Grid:
    """The port's ``Grid`` on ``device`` (default as ``state_from_numpy``)
    from a dict of NumPy arrays keyed by leaf name: floating leaves in the
    config's dtype, integer leaves as int32, masks as bool. The
    anisotropic-viscosity statics are built again from the grid's own
    fields (``hmix_aniso.build_statics``), not taken from the dict; the
    topographic-stress velocities TSU/TSV are taken from it where it holds
    them, and under ``ltopostress`` built from the grid's fields where it
    does not; the partial-bottom-cell thicknesses DZT/DZU are taken from it
    where it holds them, with the bottom planes DZBT/DZBU formed from
    them."""
    device = resolve_device(device)
    dt = cfg.torch_dtype

    def tensor(a):
        a = np.array(a)  # a writable copy; 0-d leaves stay 0-d
        t = torch.as_tensor(a)
        if a.dtype == np.bool_:
            return t.to(device)
        if np.issubdtype(a.dtype, np.integer):
            return t.to(device=device, dtype=torch.int32)
        return t.to(device=device, dtype=dt)

    def fields(cls, prefix, skip=()):
        names = [f.name for f in dataclasses.fields(cls)
                 if f.name not in skip]
        missing = [n for n in names if prefix + n not in leaves]
        if missing:
            raise KeyError(f"{cls.__name__} fields missing: {missing}")
        return {n: tensor(leaves[prefix + n]) for n in names}

    kw = fields(Grid, "", skip=("vgrid", "DZT", "DZU", "DZBT", "DZBU",
                                "aniso", "TSU", "TSV"))
    vg = fields(VGrid, "vgrid.", skip=("poly",))
    kw["vgrid"] = VGrid(**vg, poly=eos.polynomial_fit(cfg, vg["pressz"]))
    if leaves.get("DZT") is not None and leaves.get("DZU") is not None:
        thick = [np.asarray(leaves[n], np.float64) for n in ("DZT", "DZU")]
        planes = bottom_planes(
            np.asarray(leaves["vgrid.dz"], np.float64), *thick,
            *(np.asarray(leaves[n]) for n in ("KMT", "KMU")))
        kw.update(zip(("DZT", "DZU", "DZBT", "DZBU"),
                      (tensor(a) for a in (*thick, *planes))))
    if "TSU" in leaves and "TSV" in leaves:
        kw["TSU"], kw["TSV"] = tensor(leaves["TSU"]), tensor(leaves["TSV"])
    elif cfg.ltopostress:
        kw["TSU"], kw["TSV"] = (tensor(a) for a in build_topostress(
            cfg, *(np.asarray(leaves[n], np.float64) for n in (
                "HT", "KMT", "KMU", "TLAT", "FCORT", "DXUR", "DYUR",
                "HUR"))))
    if cfg.hmix_momentum == "aniso":
        kw["aniso"] = build_aniso(
            cfg, *(leaves[n] for n in ("HTN", "HTE", "DXU", "DYU", "DXUR",
                                       "DYUR", "ULAT", "KMU")), device)
    return Grid(**kw)
