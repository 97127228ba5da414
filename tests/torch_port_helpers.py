"""Shared helpers of the tests/test_torch_*.py files: hand the same config
and the same NumPy inputs to the JAX package and to its PyTorch port."""

import dataclasses

import numpy as np
import torch

from pop2_tpu_torch import config as tconfig

# The tests' fields are small (tens of thousands of values): a torch
# operation on them costs its dispatch, and more intra-op threads only add
# the wake-ups of a pool that every other test worker of the machine
# (pytest-xdist, one process a core) contends for, ten times the work
# itself in a loaded run. One thread a process; XLA's own pool, which the
# JAX package's side uses, is not touched.
torch.set_num_threads(1)


def torch_cfg(jcfg):
    """The port's ModelConfig with the field values of a JAX-package one
    (the overflow specs and their region boxes included)."""
    d = dataclasses.asdict(jcfg)
    d["time"] = tconfig.TimeConfig(**d["time"])
    d["solver"] = tconfig.SolverConfig(**d["solver"])
    boxes = ("inf", "src", "ent", "prd")
    d["overflows"] = tuple(
        tconfig.OverflowSpec(**{k: (tconfig.RegionBox(**v) if k in boxes
                                    else v) for k, v in o.items()})
        for o in d["overflows"])
    return tconfig.ModelConfig(**d)


def jax_leaves(obj, prefix=""):
    """{name: ndarray} of the array leaves of a JAX-package dataclass."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if v is None:
            continue
        if dataclasses.is_dataclass(v):
            out.update(jax_leaves(v, f"{prefix}{f.name}."))
        elif hasattr(v, "shape"):
            out[prefix + f.name] = np.asarray(v)
    return out


def scale_err(got, want):
    """max |got - want| over the reference's max magnitude."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max() or 1.0
    return float(np.abs(got - want).max() / scale)


def assert_leaves_close(tleaves, jleaves, rtol, skip=()):
    """Every tensor leaf of the port equals the JAX package's leaf."""
    for name, t in tleaves:
        if name in skip:
            continue
        want = jleaves[name]
        got = t.numpy()
        assert got.shape == want.shape, name
        if got.dtype == np.bool_ or np.issubdtype(got.dtype, np.integer):
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=rtol, atol=0,
                                       err_msg=name)


def stepped_bottom(jgrid, tgrid, ew, seed):
    """Both grids with a seeded stepped bathymetry inside the ocean mask.

    The internal topography generator gives full-depth ocean everywhere, so
    the kernels' bottom masking (levels below KMT/KMU, the bottom level
    itself) would only ever see 0 and km. This replaces KMT by smooth random
    depths of 2..km levels and recomputes the leaves derived from it that the
    kernel modules read (not the barotropic operator weights)."""
    kmt0 = np.asarray(jgrid.KMT)
    km = int(kmt0.max())
    ny, nx = kmt0.shape
    rng = np.random.RandomState(seed)
    jj, ii = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    depth = 0.55 + 0.45 * np.sin(2 * np.pi * (ii / nx + rng.rand())) \
        * np.cos(2 * np.pi * (jj / ny + rng.rand()))
    depth += 0.15 * rng.randn(ny, nx)
    kmt = np.where(kmt0 > 0, np.clip(np.rint(depth * km), 2, km), 0)
    kmt = kmt.astype(np.int32)

    def sh(f, di, dj):
        g = np.roll(f, (-dj, -di), axis=(0, 1))
        if dj > 0:
            g[-dj:] = 0
        elif dj < 0:
            g[:-dj] = 0
        if ew == "closed" and di > 0:
            g[:, -di:] = 0
        elif ew == "closed" and di < 0:
            g[:, :-di] = 0
        return g

    kmu = np.minimum(np.minimum(kmt, sh(kmt, 1, 0)),
                     np.minimum(sh(kmt, 0, 1), sh(kmt, 1, 1)))
    zw_pad = np.concatenate([[0.0], np.asarray(jgrid.vgrid.zw, np.float64)])
    hu = zw_pad[kmu]
    kidx = np.arange(1, km + 1)[:, None, None]
    new = dict(
        KMT=kmt, KMU=kmu.astype(np.int32), HT=zw_pad[kmt], HU=hu,
        HUR=np.where(hu > 0, 1.0 / np.where(hu > 0, hu, 1.0), 0.0),
        RCALCT=(kmt >= 1).astype(np.float64),
        RCALCU=(kmu >= 1).astype(np.float64),
        kmask_t=kidx <= kmt[None], kmask_u=kidx <= kmu[None],
        KMTN=sh(kmt, 0, 1), KMTS=sh(kmt, 0, -1), KMTE=sh(kmt, 1, 0),
        KMTW=sh(kmt, -1, 0))
    jnew, tnew = {}, {}
    for name, a in new.items():
        old_j, old_t = getattr(jgrid, name), getattr(tgrid, name)
        jnew[name] = np.asarray(a).astype(np.asarray(old_j).dtype)
        tnew[name] = torch.as_tensor(np.ascontiguousarray(a)).to(old_t.dtype)
    import jax.numpy as jnp
    return (jgrid.replace(**{k: jnp.asarray(v) for k, v in jnew.items()}),
            tgrid.replace(**tnew))


class GridPair:
    """One config in both packages with both grids (the port's on the CPU),
    on a seeded stepped bathymetry."""

    def __init__(self, preset, seed=1, **over):
        from pop2_tpu.config import get_config
        from pop2_tpu.grid import build_grid as j_build_grid
        from pop2_tpu_torch.grid import build_grid as t_build_grid

        self.jcfg = get_config(preset, **over)
        self.tcfg = torch_cfg(self.jcfg)
        self.jgrid, self.tgrid = stepped_bottom(
            j_build_grid(self.jcfg), t_build_grid(self.tcfg, "cpu"),
            self.jcfg.ew_boundary, seed=seed)
        self.np_dtype = (np.float64 if self.jcfg.dtype == "float64"
                         else np.float32)

    def with_(self, **over):
        """Same grids, other non-geometric config fields."""
        new = object.__new__(GridPair)
        new.__dict__.update(self.__dict__)
        new.jcfg = self.jcfg.with_(**over)
        new.tcfg = torch_cfg(new.jcfg)
        return new

    def ts_ranges(self):
        """(JAX, port) per-level T/S ranges of the equation of state."""
        from pop2_tpu import eos as jeos
        from pop2_tpu_torch import eos as teos
        zt = np.asarray(self.jgrid.vgrid.zt, np.float64)
        return (jeos.build_ts_range(zt, self.jcfg.jnp_dtype),
                teos.build_ts_range(zt, self.tcfg.torch_dtype))


def fold_bottom(jgrid, tgrid, jcfg, seed):
    """Both tripole grids on the port's seeded bottom with ocean across the
    fold (``sample.fold_bottom_kmt``), the leaves derived from the bottom
    recomputed through the fold (``sample.bottom_leaves``) and the
    anisotropic-viscosity statics rebuilt by each package from its grid
    (not the barotropic operator weights: the kernel modules do not read
    them). The internal grid's two top rows are land, which would hide the
    fold; the caller's test asserts that these hold ocean."""
    import jax.numpy as jnp
    from pop2_tpu import hmix_aniso as janiso
    from pop2_tpu.stencil import BC as JBC
    from pop2_tpu_torch import sample
    from pop2_tpu_torch.grid import build_aniso

    kmt = sample.fold_bottom_kmt(np.asarray(jgrid.KMT), jcfg.km, seed)
    new = sample.bottom_leaves(kmt, np.asarray(jgrid.vgrid.zw, np.float64),
                               jcfg.ew_boundary, jcfg.ns_boundary)
    jnew, tnew = {}, {}
    for name, a in new.items():
        old_j, old_t = getattr(jgrid, name), getattr(tgrid, name)
        jnew[name] = jnp.asarray(np.asarray(a).astype(np.asarray(old_j).dtype))
        tnew[name] = torch.as_tensor(np.ascontiguousarray(a)).to(old_t.dtype)
    if jcfg.hmix_momentum == "aniso":
        args = [np.asarray(getattr(jgrid, n)) for n in
                ("HTN", "HTE", "DXU", "DYU", "DXUR", "DYUR", "ULAT")]
        jnew["aniso"] = janiso.build_statics(
            jcfg, JBC(jcfg.ew_boundary, jcfg.ns_boundary), *args,
            new["KMU"])
        tnew["aniso"] = build_aniso(torch_cfg(jcfg), *args, new["KMU"],
                                    "cpu")
    return jgrid.replace(**jnew), tgrid.replace(**tnew)


def stretched_pair(jcfg, tmp, growth=1.5):
    """(JAX config, port config, JAX grid, port grid) of ``jcfg`` on a
    vertical grid read from a file, written to the directory ``tmp``: 10 m
    at the surface, each level ``growth`` times the one above (12 levels
    reach 2.6 km), so that a boundary layer spans several levels at few
    levels in all. The port's grid is the JAX package's handed over as
    NumPy leaves (``convert.grid_from_numpy``) and its config names the
    internal generators (``tests/test_torch_files.py`` builds both
    packages' grids from the files)."""
    import os

    from pop2_tpu.grid import build_grid as j_build_grid
    from pop2_tpu.io import grid_files
    from pop2_tpu_torch import convert

    path = os.path.join(str(tmp), f"vgrid_{jcfg.km}")
    grid_files.write_vert_grid(path, 1000.0 * growth ** np.arange(jcfg.km))
    jcfg = jcfg.with_(vert_grid="file", vert_grid_file=path)
    tcfg = torch_cfg(jcfg).with_(vert_grid="uniform")
    jgrid = j_build_grid(jcfg)
    return jcfg, tcfg, jgrid, convert.grid_from_numpy(jax_leaves(jgrid),
                                                      tcfg, "cpu")
