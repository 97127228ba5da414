"""Minimal NetCDF4 (HDF5) writer on h5py.

The port's copy of the JAX package's ``io/netcdf4.py`` (the same files).
The reference writes history/tavg/movie streams through PIO in either
netCDF3-classic or netCDF4 format (``source/io_netcdf.F90`` +
``io_pio.F90``). The classic path uses scipy
(``tavg.write_fields_netcdf``); this module adds the NetCDF4 flavor: an
HDF5 file following the netCDF-4 data-model conventions — dimensions as
HDF5 dimension scales attached to variable datasets, attributes as HDF5
attributes — readable by netCDF4-python/xarray/h5netcdf. Chunked +
gzip-compressed, which classic NetCDF3 cannot do (the reason the
reference offers netCDF4 output for high-frequency streams). h5py is
imported inside the functions: a machine without it can run everything but
a stream with ``tavg_fmt_out='nc4'``, whose write raises its ImportError.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

_DIM_ONLY = "This is a netCDF dimension but not a netCDF variable."


def write_netcdf4(fname: str,
                  dims: Mapping[str, int],
                  variables: Mapping[str, Tuple[Sequence[str], np.ndarray,
                                                Mapping[str, str]]],
                  global_attrs: Optional[Mapping[str, str]] = None,
                  compress: bool = True) -> str:
    """Write a netCDF-4 file: ``dims`` name->size; ``variables`` maps
    name -> (dim names, array, attrs). A variable named like a dimension
    becomes that dimension's coordinate variable."""
    import h5py

    with h5py.File(fname, "w") as f:
        f.attrs["_NCProperties"] = np.bytes_(
            "version=2,netcdf=4.9.2,hdf5=1.14.0")
        for k, v in (global_attrs or {}).items():
            f.attrs[k] = np.bytes_(str(v))

        scales: Dict[str, "h5py.Dataset"] = {}
        # coordinate variables double as their dimension's scale
        for dname, size in dims.items():
            if dname in variables:
                vdims, arr, attrs = variables[dname]
                if tuple(vdims) != (dname,):
                    raise ValueError(
                        f"coordinate variable {dname} must have dims "
                        f"({dname},), got {tuple(vdims)}")
                ds = f.create_dataset(dname, data=np.asarray(arr))
                ds.make_scale(dname)
                for k, v in attrs.items():
                    ds.attrs[k] = np.bytes_(str(v))
            else:
                ds = f.create_dataset(dname, shape=(size,),
                                      dtype=np.float32)
                ds.make_scale(f"{_DIM_ONLY}  {size}")
                ds.attrs["_Netcdf4Dummy"] = np.bytes_("yes")
            scales[dname] = ds

        for vname, (vdims, arr, attrs) in variables.items():
            if vname in dims:
                continue
            arr = np.asarray(arr)
            if arr.ndim != len(vdims):
                raise ValueError(f"{vname}: {arr.ndim}-d data with "
                                 f"{len(vdims)} dims {tuple(vdims)}")
            kw = {}
            if compress and arr.size > 1024:
                kw = dict(chunks=True, compression="gzip",
                          compression_opts=1, shuffle=True)
            ds = f.create_dataset(vname, data=arr, **kw)
            for i, dname in enumerate(vdims):
                ds.dims[i].attach_scale(scales[dname])
            for k, v in attrs.items():
                ds.attrs[k] = np.bytes_(str(v))
    return fname


def read_netcdf4(fname: str):
    """Read back a netCDF-4 file written by write_netcdf4 (or any
    h5py-readable netCDF-4 file): returns (dims, variables, attrs) with
    variables mapping name -> (dim names, array, attrs)."""
    import h5py

    dims: Dict[str, int] = {}
    variables = {}
    with h5py.File(fname, "r") as f:
        global_attrs = {k: _s(v) for k, v in f.attrs.items()}
        for name, ds in f.items():
            cls = _s(ds.attrs.get("CLASS", b""))
            nm = _s(ds.attrs.get("NAME", b""))
            if cls == "DIMENSION_SCALE":
                dims[name] = ds.shape[0]
                if nm.startswith(_DIM_ONLY):
                    continue            # pure dimension, not a variable
            vdims = []
            if "DIMENSION_LIST" in ds.attrs:
                for i in range(ds.ndim):
                    sc = ds.dims[i]   # indexing yields the scale dataset
                    vdims.append(sc[0].name.lstrip("/") if len(sc)
                                 else None)
            elif cls == "DIMENSION_SCALE":
                vdims = [name]
            attrs = {k: _s(v) for k, v in ds.attrs.items()
                     if k not in ("CLASS", "NAME", "DIMENSION_LIST",
                                  "REFERENCE_LIST", "_Netcdf4Dummy",
                                  "_Netcdf4Coordinates")}
            variables[name] = (tuple(vdims), ds[...], attrs)
    return dims, variables, global_attrs


def _s(v):
    if isinstance(v, bytes):
        return v.decode("utf-8", "replace")
    if isinstance(v, np.ndarray) and v.dtype.kind in "SO":
        return v.item().decode("utf-8", "replace") \
            if isinstance(v.item(), bytes) else str(v.item())
    return v
