"""Instantaneous snapshot streams: history and movie files.

Reference: ``source/history.F90`` (full-field instantaneous snapshots every
``history_freq``) and ``source/movie.F90`` (2-D slices — surface level of
3-D fields — at ``movie_freq``). Both reuse the tavg field registry and the
shared NetCDF writer; unlike tavg there is no accumulation, so a write is a
host-side sample of the current state at a due step (each field read from
the device in turn). On a rank's block of a decomposition each field is
evaluated on the block and gathered on rank 0 (a collective a field),
which writes the whole domain's file.
"""

from __future__ import annotations

from typing import List

from pop2_tpu_torch.config import ModelConfig
from pop2_tpu_torch.grid import Grid, grid_bc
from pop2_tpu_torch.parallel.multihost import gather_to_root
from pop2_tpu_torch.state import State
from pop2_tpu_torch.tavg import (FIELDS, TavgAux, _coords, field_config,
                                 write_fields_netcdf)


class HistoryStream:
    """Instantaneous full-field snapshots (history.F90). ``cfg``: the
    whole domain's; ``mesh``: the decomposition whose block ``grid`` is
    (None: the whole domain)."""

    def __init__(self, cfg: ModelConfig, grid: Grid, contents: List[str],
                 freq_steps: int, outfile_prefix: str = "pop2_tpu.h",
                 mesh=None):
        unknown = [n for n in contents if n not in FIELDS]
        if unknown:
            raise ValueError(f"unknown history fields {unknown}")
        self.cfg, self.grid, self.mesh = cfg, grid, mesh
        self.field_cfg = field_config(cfg, mesh)
        _coords(grid)  # gathered now, on every rank
        self.contents = list(contents)
        self.freq_steps = int(freq_steps)
        self.prefix = outfile_prefix
        self.aux = TavgAux(bc=grid_bc(cfg))  # Model refreshes with extras

    def due(self, step_number: int) -> bool:
        return self.freq_steps > 0 and step_number % self.freq_steps == 0

    def _field(self, name: str, state: State, aux: TavgAux):
        """The whole domain's field as NumPy (None on a rank other than
        0 of a decomposition)."""
        return gather_to_root(FIELDS[name].fn(self.field_cfg, self.grid,
                                              state, aux), self.mesh)

    def _sample(self, state: State):
        aux = self.aux._replace(memo={})
        return {n: self._field(n, state, aux) for n in self.contents}

    def write(self, path: str, state: State, step_number: int) -> str:
        """Write the snapshot; returns the path. On a rank's block every
        rank calls it, and rank 0 writes the whole domain's file."""
        fname = f"{path}/{self.prefix}.{step_number:08d}.nc"
        arrays = self._sample(state)
        if all(a is not None for a in arrays.values()):
            write_fields_netcdf(self.cfg, self.grid, fname, self.contents,
                                arrays, step_number)
        return fname


class MovieStream(HistoryStream):
    """2-D snapshot stream: 3-D fields are sampled at a fixed level
    (movie.F90; default the surface)."""

    def __init__(self, cfg: ModelConfig, grid: Grid, contents: List[str],
                 freq_steps: int, level: int = 0,
                 outfile_prefix: str = "pop2_tpu.m", mesh=None):
        super().__init__(cfg, grid, contents, freq_steps, outfile_prefix,
                         mesh)
        self.level = level

    def _sample(self, state: State):
        aux = self.aux._replace(memo={})
        out = {}
        for n in self.contents:
            arr = self._field(n, state, aux)
            out[n] = (arr[self.level] if arr is not None and arr.ndim == 3
                      else arr)
        return out
