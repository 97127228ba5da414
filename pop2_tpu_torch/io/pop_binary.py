"""General POP-binary field-record I/O.

The port's copy of the JAX package's ``io/pop_binary.py`` (the same files).

Reference: ``source/io_binary.F90`` — history/movie/restart fields in
direct-access binary: fixed-length records of ``nx*ny`` values (one
record per horizontal slice; a 3-D field is ``km`` consecutive records),
big-endian, with an ASCII ``.hdr`` sidecar carrying the global
attributes and the per-field record map (&GLOBAL / &FIELD namelist-style
blocks, :330-520). The specialized grid/topography/forcing readers
(io/grid_files.py, forcing.py) handle the header-less fixed-layout
files; this module is the general writer/reader for arbitrary field
sets, completing the binary backend."""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional

import numpy as np


def write_pop_binary(path: str, ny: int, nx: int,
                     fields: Mapping[str, np.ndarray],
                     attrs: Optional[Mapping[str, str]] = None,
                     dtype: str = ">f8") -> str:
    """Write fields as consecutive ``nx*ny`` records plus a ``.hdr``
    sidecar. 2-D fields occupy one record, (km, ny, nx) fields km
    records, in dict order (record numbers are 1-based, as in the
    reference's current_record counter)."""
    rec = 1
    lines = ["&GLOBAL"]
    for k, v in (attrs or {}).items():
        lines.append(f"  {k} = '{v}'")
    lines.append("/")
    with open(path, "wb") as f:
        for name, arr in fields.items():
            arr = np.asarray(arr)
            if arr.shape[-2:] != (ny, nx):
                raise ValueError(f"{name}: trailing dims {arr.shape[-2:]} "
                                 f"!= ({ny}, {nx})")
            nrec = 1 if arr.ndim == 2 else int(np.prod(arr.shape[:-2]))
            np.ascontiguousarray(arr, dtype=dtype).tofile(f)
            lines += ["&FIELD",
                      f"  field_name = '{name}'",
                      f"  ndims = {arr.ndim}",
                      f"  start_record = {rec}",
                      f"  nrecords = {nrec}",
                      "/"]
            rec += nrec
    with open(path + ".hdr", "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def read_pop_binary(path: str, ny: int, nx: int,
                    dtype: str = ">f8") -> Dict[str, np.ndarray]:
    """Read a field file via its ``.hdr`` record map; 3-D fields come
    back as (nrecords, ny, nx)."""
    hdr = path + ".hdr"
    if not os.path.exists(hdr):
        raise FileNotFoundError(f"missing header file {hdr} "
                                "(header-less layouts: io/grid_files.py)")
    raw = np.fromfile(path, dtype=dtype).astype(np.float64)
    n = ny * nx
    out: Dict[str, np.ndarray] = {}
    name, start, nrec = None, None, 1
    for line in open(hdr):
        t = line.strip()
        if t.startswith("field_name"):
            name = t.split("=", 1)[1].strip().strip("'\"")
        elif t.startswith("start_record"):
            start = int(t.split("=", 1)[1])
        elif t.startswith("nrecords"):
            nrec = int(t.split("=", 1)[1])
        elif t == "/" and name is not None:
            a = raw[(start - 1) * n:(start - 1 + nrec) * n]
            if a.size != nrec * n:
                raise ValueError(f"{path}: field {name} truncated")
            out[name] = (a.reshape(ny, nx) if nrec == 1
                         else a.reshape(nrec, ny, nx))
            name, start, nrec = None, None, 1
    return out
