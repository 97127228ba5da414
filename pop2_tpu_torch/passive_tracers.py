"""Passive-tracer framework.

Reference: ``source/passive_tracers.F90`` (the uniform per-package API every
tracer module implements: init / interior source / surface flux / reset,
:207-1562) and ``source/iage_mod.F90`` (the simplest package). Tracers
occupy slots 2.. (0-based) of the tracer array, after TEMP and SALT.

A package is a small object whose functions return whole (n, km, ny, nx)
source fields or (n, ny, nx) surface fluxes on the tracers' device; the
framework stacks them. The port carries every package of the JAX
package: the ideal age, the CFC and SF6 gas tracers (``gas_tracers``), the
impulse-response tracer, the abiotic DIC/DIC14 (``abio_dic``) and the
32-tracer ecosystem (``ecosys``), whose surface chlorophyll is the model's
under ``chl_option='model'`` (``PassiveTracers.model_chl``).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from pop2_tpu_torch.config import ModelConfig
from pop2_tpu_torch.grid import Grid

SECONDS_IN_YEAR = 365.0 * 86400.0


class TracerPackage:
    """Base class: the reference's per-module API
    (source/passive_tracers.F90:768-1306)."""

    #: tracer names provided by this package, in slot order
    names: Sequence[str] = ()
    #: this package's first slot in the tracer array (set by PassiveTracers)
    slot0 = 2

    def n_tracers(self) -> int:
        return len(self.names)

    def init_values(self, cfg: ModelConfig, grid: Grid) -> np.ndarray:
        """(n, km, ny, nx) initial fields, NumPy float64."""
        return np.zeros((self.n_tracers(), cfg.km, cfg.ny, cfg.nx))

    def set_interior(self, cfg: ModelConfig, grid: Grid, tracers_old,
                     tracers_cur, forcing=None):
        """(n, km, ny, nx) interior source terms (dT/dt units)."""
        return torch.zeros((self.n_tracers(), cfg.km, cfg.ny, cfg.nx),
                           dtype=cfg.torch_dtype, device=tracers_cur.device)

    def set_sflux(self, cfg: ModelConfig, grid: Grid, tracers_old,
                  tracers_cur, forcing=None):
        """(n, ny, nx) surface fluxes (STF units)."""
        return torch.zeros((self.n_tracers(), cfg.ny, cfg.nx),
                           dtype=cfg.torch_dtype, device=tracers_cur.device)

    def reset(self, cfg: ModelConfig, grid: Grid, tracer_block):
        """Post-update adjustment (e.g. a surface reset) of the
        (n, km, ny, nx) block of this package's tracers at the new time;
        returns the block, a new tensor where it changes anything."""
        return tracer_block


class IdealAge(TracerPackage):
    """Ideal-age tracer: ages 1 yr/yr in the interior, reset to zero in the
    surface layer (source/iage_mod.F90:325-415)."""

    names = ("IAGE",)

    def set_interior(self, cfg, grid, tracers_old, tracers_cur,
                     forcing=None):
        src = grid.kmask_t.to(cfg.torch_dtype) / SECONDS_IN_YEAR
        return src[None]

    def reset(self, cfg, grid, tracer_block):
        return torch.cat([torch.zeros_like(tracer_block[:, :1]),
                          tracer_block[:, 1:]], dim=1)


class IRF(TracerPackage):
    """Impulse-response-function tracer (source/IRF_mod.F90): a passive
    dye initialized as a unit impulse in a box, advected and mixed with no
    interior sources. The default impulse fills the surface layer of the
    domain's central quarter."""

    names = ("IRF",)

    def init_values(self, cfg, grid):
        v = np.zeros((1, cfg.km, cfg.ny, cfg.nx))
        v[0, 0, cfg.ny // 4:3 * cfg.ny // 4 + 1,
          cfg.nx // 4:3 * cfg.nx // 4 + 1] = 1.0
        return v * grid.kmask_t.cpu().numpy()[None]


def _make_cfc():
    from pop2_tpu_torch.gas_tracers import GasTracers
    return GasTracers(("CFC11", "CFC12"))


def _make_sf6():
    from pop2_tpu_torch.gas_tracers import GasTracers
    return GasTracers(("SF6",))


def _make_abio_dic():
    from pop2_tpu_torch.abio_dic import AbioDIC
    return AbioDIC()


def _make_ecosys():
    from pop2_tpu_torch.ecosys import Ecosystem
    return Ecosystem()


REGISTRY = {
    "iage": IdealAge,
    "cfc": _make_cfc,      # source/cfc_mod.F90
    "sf6": _make_sf6,      # source/sf6_mod.F90
    "irf": IRF,            # source/IRF_mod.F90
    "abio_dic": _make_abio_dic,  # source/abio_dic_dic14_mod.F90
    "ecosys": _make_ecosys,      # source/ecosys_driver.F90 (MARBL/BEC)
}


class PassiveTracers:
    """Stacked view over the active packages; slot 0 of the stacked source
    array is tracer index 2 of the model state."""

    def __init__(self, cfg: ModelConfig, packages: Sequence):
        """packages: names from REGISTRY or TracerPackage instances (a
        package built with other parameters, ``convert.package_from_numpy``);
        an unknown name raises ``KeyError``."""
        self.packages: List[TracerPackage] = [
            p if isinstance(p, TracerPackage) else REGISTRY[p]()
            for p in packages]
        self.names: List[str] = []
        for p in self.packages:
            p.slot0 = 2 + len(self.names)
            self.names.extend(p.names)
        if 2 + len(self.names) != cfg.nt:
            raise ValueError(
                f"cfg.nt={cfg.nt} but packages provide {len(self.names)} "
                f"tracers (need nt = 2 + that)")

    def init_values(self, cfg, grid) -> np.ndarray:
        if not self.packages:
            return np.zeros((0, cfg.km, cfg.ny, cfg.nx))
        return np.concatenate(
            [p.init_values(cfg, grid) for p in self.packages], axis=0)

    def set_interior(self, cfg, grid, tracers_old, tracers_cur,
                     forcing=None):
        return torch.cat(
            [p.set_interior(cfg, grid, tracers_old, tracers_cur,
                            forcing=forcing)
             for p in self.packages], dim=0)

    def set_sflux(self, cfg, grid, tracers_old, tracers_cur, forcing=None):
        return torch.cat(
            [p.set_sflux(cfg, grid, tracers_old, tracers_cur, forcing)
             for p in self.packages], dim=0)

    def model_chl(self, tracer_cur):
        """Surface chlorophyll (mg/m^3) of the ecosystem package when it is
        active (the reference's 'model' chl_option resolves the
        model_chlorophyll named field, source/sw_absorption.F90:332-345);
        None otherwise."""
        from pop2_tpu_torch.ecosys import Ecosystem
        for p in self.packages:
            if isinstance(p, Ecosystem):
                return p.surface_chl(tracer_cur)
        return None

    def reset(self, cfg, grid, tracer_new):
        """The per-package resets applied to the full (nt, ...) new-time
        array; returns a new tensor (the argument is not written)."""
        blocks, i = [tracer_new[:2]], 2
        for p in self.packages:
            n = p.n_tracers()
            blocks.append(p.reset(cfg, grid, tracer_new[i:i + n]))
            i += n
        return torch.cat(blocks, dim=0)
