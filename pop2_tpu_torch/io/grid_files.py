"""POP-format grid file I/O.

The port's copy of the JAX package's ``io/grid_files.py`` (the same files).

Reference formats (source/grid.F90):
- horizontal grid (read_horiz_grid :1314-1542): Fortran direct-access
  binary, 7 records of ``nx*ny`` float64 in this order:
  ULAT, ULON (radians), HTN, HTE, HUS, HUW (cm), ANGLE (radians).
- topography (read_topography :2032-2109): 1 record of ``nx*ny`` int32 KMT.
- vertical grid (read_vert_grid :1716-1777): formatted text, one layer
  thickness (cm) as the first value on each of ``km`` lines.

A Fortran ``(nx, ny)`` column-major record is byte-identical to our
row-major ``(ny, nx)`` layout, so reads are a straight reshape. Production
POP grid files are big-endian; the byte order is a parameter.
"""

from __future__ import annotations

import numpy as np

HORIZ_RECORDS = ("ULAT", "ULON", "HTN", "HTE", "HUS", "HUW", "ANGLE")


def read_horiz_grid(path: str, ny: int, nx: int,
                    dtype: str = ">f8") -> dict:
    """Read the 7-record horizontal grid file -> dict of (ny, nx) float64."""
    raw = np.fromfile(path, dtype=dtype)
    n = ny * nx
    if raw.size < len(HORIZ_RECORDS) * n:
        raise ValueError(
            f"horiz_grid_file {path}: expected {len(HORIZ_RECORDS)} records "
            f"of {n} values, found {raw.size} values total")
    return {name: raw[r * n:(r + 1) * n].astype(np.float64).reshape(ny, nx)
            for r, name in enumerate(HORIZ_RECORDS)}


def write_horiz_grid(path: str, fields: dict, dtype: str = ">f8") -> None:
    """Write the 7-record horizontal grid file from a dict of (ny, nx)."""
    with open(path, "wb") as f:
        for name in HORIZ_RECORDS:
            np.ascontiguousarray(fields[name], dtype=dtype).tofile(f)


def read_topography(path: str, ny: int, nx: int,
                    dtype: str = ">i4") -> np.ndarray:
    """Read the KMT record -> (ny, nx) int32."""
    raw = np.fromfile(path, dtype=dtype)
    n = ny * nx
    if raw.size < n:
        raise ValueError(f"topography_file {path}: expected {n} values, "
                         f"found {raw.size}")
    return raw[:n].astype(np.int32).reshape(ny, nx)


def write_topography(path: str, kmt: np.ndarray,
                     dtype: str = ">i4") -> None:
    np.ascontiguousarray(kmt, dtype=dtype).tofile(path)


def read_vert_grid(path: str, km: int) -> np.ndarray:
    """Read layer thicknesses (cm) -> (km,) float64."""
    dz = []
    with open(path) as f:
        for line in f:
            s = line.split()
            if not s:
                continue
            dz.append(float(s[0]))
            if len(dz) == km:
                break
    if len(dz) < km:
        raise ValueError(f"vert_grid_file {path}: expected {km} levels, "
                         f"found {len(dz)}")
    return np.asarray(dz)


def write_vert_grid(path: str, dz_cm: np.ndarray) -> None:
    with open(path, "w") as f:
        for d in np.asarray(dz_cm):
            f.write(f"{d:.10e}\n")
