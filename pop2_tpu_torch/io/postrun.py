"""Post-run history processing.

The port's copy of the JAX package's ``io/postrun.py`` (the same files).

Reference: ``tools/postrun_proc/pop_hist_postprocess.csh`` — after a run
with high-frequency output (OCN_TAVG_HIFREQ), (1) recreate monthly means
for fields that were moved to the daily-mean stream, and (2) remove
fields from the daily stream that are only needed for that
reconstruction. The csh script shells out to NCO (ncra/ncks); here both
operations are native Python over the framework's own NetCDF3-classic
stream files (scipy), preserving coordinates and attributes.
"""

from __future__ import annotations

import os
from typing import Iterable, Sequence

import numpy as np

_COORDS = ("time", "z_t", "nlat", "nlon", "TLAT", "TLONG")


def _read_stream(path):
    from scipy.io import netcdf_file
    with netcdf_file(path, "r", mmap=False) as f:
        dims = dict(f.dimensions)
        out = {}
        for name, var in f.variables.items():
            attrs = {k: getattr(var, k) for k in ("units", "long_name")
                     if hasattr(var, k)}
            out[name] = (var.dimensions, np.array(var[:]), attrs)
    return dims, out


def _write_stream(path, dims, variables):
    from scipy.io import netcdf_file
    with netcdf_file(path, "w") as f:
        for d, n in dims.items():
            f.createDimension(d, n)
        for name, (vdims, data, attrs) in variables.items():
            typ = {"float64": "d", "float32": "f",
                   "int32": "i"}.get(str(data.dtype), "d")
            v = f.createVariable(name, typ, vdims)
            v[:] = data
            for k, a in attrs.items():
                setattr(v, k, a)
    return path


def monthly_mean_from_daily(daily_files: Sequence[str], out_path: str,
                            fields: Iterable[str] = None) -> str:
    """Recreate a monthly-mean file by time-averaging daily-mean stream
    files (the csh script's ncra invocation). ``fields`` restricts the
    averaged set (default: every non-coordinate field present in all
    files); coordinates are carried over from the first file."""
    if not daily_files:
        raise ValueError("no daily files given")
    dims0, vars0 = _read_stream(daily_files[0])
    names = [n for n in vars0 if n not in _COORDS]
    if fields is not None:
        fields = set(fields)
        names = [n for n in names if n in fields]
    sums = {n: np.array(vars0[n][1], np.float64) for n in names}
    for p in daily_files[1:]:
        _, v = _read_stream(p)
        for n in names:
            if n not in v:
                raise KeyError(f"{p} is missing field {n}")
            sums[n] += v[n][1]
    navg = float(len(daily_files))
    out = {n: vars0[n] for n in _COORDS if n in vars0}
    for n in names:
        vdims, data, attrs = vars0[n]
        attrs = dict(attrs)
        attrs["cell_methods"] = b"time: mean over daily means"
        out[n] = (vdims, (sums[n] / navg).astype(data.dtype), attrs)
    return _write_stream(out_path, dims0, out)


def strip_fields(path: str, fields: Iterable[str],
                 out_path: str = None) -> str:
    """Remove ``fields`` from a stream file (the csh script's ncks -x):
    writes ``out_path`` (default: replace in place via a temp file)."""
    drop = set(fields)
    bad = drop & set(_COORDS)
    if bad:
        raise ValueError(f"refusing to strip coordinates: {sorted(bad)}")
    dims, variables = _read_stream(path)
    kept = {n: v for n, v in variables.items() if n not in drop}
    dst = out_path or (path + ".tmp")
    _write_stream(dst, dims, kept)
    if out_path is None:
        os.replace(dst, path)
        return path
    return dst
