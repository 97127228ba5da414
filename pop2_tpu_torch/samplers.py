"""In-situ diagnostic samplers: hydrographic sections, current meters,
surface drifters.

Reference: ``source/hydro_sections.F90`` (T/S profiles at observation
lines), ``source/current_meters.F90`` (point time series of velocity),
``source/drifters.F90`` (Lagrangian surface drifters advected by the model
flow). The reference splits the work across block owners; here columns are
gathered with static indices (one gather per sample set, on the state's
device) and drifters are advected on the host with the surface velocity at
the nearest U point, in lat/lon space. Sampling happens between steps: the
current meters and the drifters read the device."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from pop2_tpu_torch import constants as const
from pop2_tpu_torch.config import ModelConfig
from pop2_tpu_torch.grid import Grid
from pop2_tpu_torch.state import State


def _deg(t: torch.Tensor) -> np.ndarray:
    return t.detach().double().cpu().numpy() * const.RADIAN


def nearest_column(grid: Grid, lat_deg: float, lon_deg: float,
                   upoint: bool = False) -> Tuple[int, int]:
    """(j, i) of the T (or U) column nearest to a lat/lon in degrees."""
    lat = _deg(grid.ULAT if upoint else grid.TLAT)
    lon = _deg(grid.ULON if upoint else grid.TLON)
    return _nearest(lat, lon, lat_deg, lon_deg)


def _nearest(lat, lon, lat_deg, lon_deg) -> Tuple[int, int]:
    dlon = (lon - lon_deg + 180.0) % 360.0 - 180.0
    d2 = (lat - lat_deg) ** 2 + (np.cos(np.deg2rad(lat)) * dlon) ** 2
    j, i = np.unravel_index(np.argmin(d2), lat.shape)
    return int(j), int(i)


def _index(values, device) -> torch.Tensor:
    return torch.as_tensor(values, dtype=torch.long, device=device)


class HydroSection:
    """T/S profiles along a list of lat/lon points
    (hydro_sections.F90)."""

    def __init__(self, grid: Grid, points: Sequence[Tuple[float, float]],
                 name: str = "section"):
        self.name = name
        idx = [nearest_column(grid, la, lo) for (la, lo) in points]
        self.jj = _index([j for j, _ in idx], grid.KMT.device)
        self.ii = _index([i for _, i in idx], grid.KMT.device)

    def sample(self, state: State):
        """dict of (npts, km) profiles at the section columns."""
        return {
            "TEMP": state.tracer_cur[0][:, self.jj, self.ii].T,
            "SALT": state.tracer_cur[1][:, self.jj, self.ii].T
            * const.SALT_TO_PPT,
        }


class CurrentMeters:
    """Velocity/temperature time series at fixed moorings
    (current_meters.F90). Points: (lat, lon, k)."""

    def __init__(self, grid: Grid,
                 points: Sequence[Tuple[float, float, int]]):
        idx = [nearest_column(grid, la, lo, upoint=True)
               for (la, lo, _) in points]
        device = grid.KMT.device
        self.jj = _index([j for j, _ in idx], device)
        self.ii = _index([i for _, i in idx], device)
        self.kk = _index([k for (_, _, k) in points], device)
        self.records: List[np.ndarray] = []

    def sample(self, state: State):
        u = state.u_cur[self.kk, self.jj, self.ii]
        v = state.v_cur[self.kk, self.jj, self.ii]
        rec = torch.stack([u, v], dim=-1).detach().cpu().numpy()
        self.records.append(rec)
        return rec

    def series(self) -> np.ndarray:
        """(nsteps, npts, 2) recorded (u, v)."""
        return np.stack(self.records) if self.records else \
            np.zeros((0, len(self.kk), 2))


class Drifters:
    """Lagrangian surface drifters (drifters.F90): positions in degrees,
    advected by the surface velocity at the nearest U point."""

    def __init__(self, cfg: ModelConfig, grid: Grid,
                 positions: Sequence[Tuple[float, float]]):
        self.cfg = cfg
        self.grid = grid
        self.lat = np.array([p[0] for p in positions], dtype=np.float64)
        self.lon = np.array([p[1] for p in positions], dtype=np.float64)
        self._ulat = _deg(grid.ULAT)
        self._ulon = _deg(grid.ULON)

    def _sample_uv(self, state: State):
        """Nearest-U-point surface velocity per drifter (the reference
        interpolates within the owning block; nearest-point sampling keeps
        the host-side update O(ndrifters))."""
        u = state.u_cur[0].detach().cpu().numpy()
        v = state.v_cur[0].detach().cpu().numpy()
        us, vs = [], []
        for n in range(len(self.lat)):
            j, i = _nearest(self._ulat, self._ulon, self.lat[n],
                            self.lon[n])
            us.append(u[j, i])
            vs.append(v[j, i])
        return np.array(us), np.array(vs)

    def advance(self, state: State, dt_seconds: float):
        """One Euler step of drifter positions (degrees)."""
        u, v = self._sample_uv(state)  # cm/s
        coslat = np.maximum(np.cos(np.deg2rad(self.lat)), 0.05)
        self.lon = self.lon + np.rad2deg(
            u * dt_seconds / (const.RADIUS * coslat))
        self.lat = np.clip(self.lat + np.rad2deg(
            v * dt_seconds / const.RADIUS), -89.9, 89.9)
        self.lon = (self.lon + 180.0) % 360.0 - 180.0
        return self.lat.copy(), self.lon.copy()
