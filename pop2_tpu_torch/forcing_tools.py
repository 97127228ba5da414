"""Forcing time-interpolation machinery.

Reference: ``source/forcing_tools.F90`` — monthly-climatology / n-hour
forcing data interpolated to model time with 'nearest', 'linear', or
'4point' (iterated-linear / Neville cubic, interp_4pt :1144-1238 and
det :1209-1238) interpolation.

Instead of the reference's mutable module state (update windows,
interp_last bookkeeping), a ``MonthlyClimatology`` holds the 12 stacked
fields on the device and interpolates to any model hour, a host float or a
0-d tensor, without reading the device: the month is found on the device
(``searchsorted``) and the fields are gathered there. The mid-month times
stay float64 whatever the fields' dtype, and a float32 field is
interpolated in float64 (the JAX package's type promotion under x64).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from pop2_tpu_torch.grid import resolve_device

HOURS_PER_YEAR = 365.0 * 24.0

_DAYS_IN_MONTH = np.array([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31],
                          dtype=np.float64)


def midmonth_hours(data_type: str = "monthly-equal") -> np.ndarray:
    """Mid-month times in hours since year start
    (time_management thour00_midmonth_equal/calendar)."""
    if data_type == "monthly-equal":
        month = HOURS_PER_YEAR / 12.0
        return (np.arange(12) + 0.5) * month
    if data_type == "monthly-calendar":
        ends = np.cumsum(_DAYS_IN_MONTH) * 24.0
        starts = np.concatenate([[0.0], ends[:-1]])
        return 0.5 * (starts + ends)
    raise ValueError(f"unknown forcing data type {data_type}")


def _neville(tt, dd, t):
    """Cubic through 4 points by iterated linear interpolation
    (interp_4pt/det, forcing_tools.F90:1144-1238)."""
    def det(a, b, y, z):
        return (a * (z - t) - b * (y - t)) / (z - y)

    p12 = det(dd[0], dd[1], tt[0], tt[1])
    p23 = det(dd[1], dd[2], tt[1], tt[2])
    p34 = det(dd[2], dd[3], tt[2], tt[3])
    p123 = det(p12, p23, tt[0], tt[2])
    p234 = det(p23, p34, tt[1], tt[3])
    return det(p123, p234, tt[0], tt[3])


def _as_tensor(data, device):
    """``data`` as a tensor on ``device`` (a tensor's own device when None,
    the GPU for host data: no GPU raises)."""
    if isinstance(data, torch.Tensor):
        return data if device is None else data.to(resolve_device(device))
    return torch.as_tensor(np.asarray(data),
                           device=resolve_device(device or "cuda"))


def _time_at(value, like: torch.Tensor) -> torch.Tensor:
    """A host float or 0-d tensor as a 0-d tensor of ``like``'s dtype and
    device."""
    return torch.as_tensor(value, dtype=like.dtype, device=like.device)


@dataclass(frozen=True)
class MonthlyClimatology:
    """12 stacked monthly fields, shape (12, ...), with mid-month times."""
    data: torch.Tensor
    times: torch.Tensor                                   # (12,) hours
    interp: str = "linear"

    @classmethod
    def create(cls, data, interp: str = "linear",
               data_type: str = "monthly-equal",
               device=None) -> "MonthlyClimatology":
        data = _as_tensor(data, device)
        if data.shape[0] != 12:
            raise ValueError("monthly climatology needs leading axis 12")
        times = torch.as_tensor(midmonth_hours(data_type),
                                dtype=torch.float64, device=data.device)
        return cls(data=data, times=times, interp=interp)

    def at(self, thour) -> torch.Tensor:
        """Interpolate to model hour (any year; periodic)."""
        t = torch.remainder(_time_at(thour, self.times), HOURS_PER_YEAR)
        # month whose midpoint is the last one <= t (may be -1 -> wraps)
        idx = torch.searchsorted(self.times, t.reshape(1), right=True) - 1
        if self.interp == "nearest":
            lo = torch.remainder(idx, 12)
            hi = torch.remainder(idx + 1, 12)
            tlo = self.times[lo] - torch.where(idx < 0, HOURS_PER_YEAR, 0.0)
            thi = self.times[hi] + torch.where(idx + 1 >= 12,
                                               HOURS_PER_YEAR, 0.0)
            pick = torch.where(t - tlo <= thi - t, lo, hi)
            return torch.index_select(self.data, 0, pick)[0]
        if self.interp == "linear":
            offsets = torch.arange(2, device=idx.device)
        elif self.interp == "4point":
            offsets = torch.arange(-1, 3, device=idx.device)
        else:
            raise ValueError(f"unknown interp type {self.interp}")
        raw = idx + offsets
        ii = torch.remainder(raw, 12)
        tt = self.times[ii] + torch.div(
            raw, 12, rounding_mode="floor").to(self.times.dtype) \
            * HOURS_PER_YEAR
        dd = torch.index_select(self.data, 0, ii).to(
            torch.promote_types(self.data.dtype, self.times.dtype))
        if self.interp == "linear":
            w = (tt[1] - t) / (tt[1] - tt[0])
            shape = (2,) + (1,) * (self.data.ndim - 1)
            w = torch.stack([w, 1.0 - w]).reshape(shape)
            return torch.sum(w * dd, dim=0)
        return _neville(tt, dd, t)


@dataclass(frozen=True)
class TimeSeries:
    """Shared scalar/vector time-series forcing (CO2 records, CFC
    atmospheric histories), ``source/forcing_timeseries_mod.F90``
    (forcing_timeseries_dataset: linear interpolation in model year with
    endpoint handling).

    data: (ntime, ...) values; years: (ntime,) decimal model years, float64.
    """
    data: torch.Tensor
    years: torch.Tensor

    @classmethod
    def create(cls, years, data, device=None) -> "TimeSeries":
        data = _as_tensor(data, device)
        years = torch.as_tensor(np.asarray(years, np.float64)
                                if not isinstance(years, torch.Tensor)
                                else years, dtype=torch.float64,
                                device=data.device).contiguous()
        if years.ndim != 1 or data.shape[0] != years.shape[0]:
            raise ValueError("TimeSeries needs matching leading axes")
        return cls(data=data, years=years)

    @classmethod
    def from_file(cls, path: str, device=None) -> "TimeSeries":
        """Whitespace-separated text: first column decimal year, remaining
        columns values (the reference reads netCDF; a text table carries
        the same content)."""
        raw = np.loadtxt(path)
        return cls.create(raw[:, 0], raw[:, 1:].squeeze(), device)

    def at(self, year, taxmode: str = "extend"):
        """Linear interpolation at decimal model year
        (forcing_timeseries_mod.F90 taxmode semantics):
          'extend'      — clamp to the endpoint values outside the series;
          'extrapolate' — continue the slope of the first/last segment
                          beyond the endpoints (:taxmode_extrapolate).
        """
        t = _time_at(year, self.years)
        if taxmode == "extend":
            t_eff = torch.clamp(t, self.years[0], self.years[-1])
        elif taxmode == "extrapolate":
            t_eff = t  # segment weights run outside [0, 1] at the ends
        else:
            raise NotImplementedError(f"taxmode {taxmode}")
        idx = torch.clamp(torch.searchsorted(self.years, t_eff.reshape(1),
                                             right=True) - 1,
                          0, self.years.shape[0] - 2)
        t0, t1 = self.years[idx][0], self.years[idx + 1][0]
        w = torch.where(t1 > t0,
                        (t_eff - t0) / torch.where(t1 > t0, t1 - t0, 1.0),
                        0.0)
        wide = torch.promote_types(self.data.dtype, self.years.dtype)
        lo = torch.index_select(self.data, 0, idx)[0].to(wide)
        hi = torch.index_select(self.data, 0, idx + 1)[0].to(wide)
        return lo + w * (hi - lo)
