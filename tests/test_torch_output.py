"""The port's snapshot streams (``history.HistoryStream``,
``MovieStream``), runtime diagnostics (``diagnostics.py``) and tracer
budget (``budget.py``) against the JAX package's, on the CPU in float64.

The diagnostics and the budget are held on one state made from the same
seeded NumPy leaves in both packages (the 'mini' preset's initial state
with noise in T and S and seeded velocities, surface height and ice):
every function at 1e-12 of the value's scale (the budget's residual, a
difference of totals, at 1e-12 of the totals), the binned profiles (on
auxiliary latitude grids with no edge at a U row's latitude) and the
streamfunction field element by element. The snapshot streams run three
leapfrog steps of 'mini' through ``Model.advance`` in both packages from
the same perturbed state (the step counter past the Euler step), writing a
history stream of 3-D, 2-D and step-extras fields every step and two movie
streams (the surface and the third level): each file's variables equal to
1e-9 of scale, the band of ``test_torch_tavg.py``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

jax.config.update("jax_enable_x64", True)

from pop2_tpu import budget as jbudget, diagnostics as jdiag  # noqa: E402
from pop2_tpu.config import get_config  # noqa: E402
from pop2_tpu.grid import build_grid as j_build_grid  # noqa: E402
from pop2_tpu.io.input_templates import TransportSection as JSection  # noqa: E402
from pop2_tpu.model import Model as JModel  # noqa: E402
from pop2_tpu.state import State as JState  # noqa: E402

from pop2_tpu_torch import budget as tbudget, convert  # noqa: E402
from pop2_tpu_torch import diagnostics as tdiag  # noqa: E402
from pop2_tpu_torch.grid import build_grid as t_build_grid  # noqa: E402
from pop2_tpu_torch.model import Model as TModel  # noqa: E402
from pop2_tpu_torch.state import initial_state as t_initial_state  # noqa: E402

from tests.torch_port_helpers import jax_leaves, scale_err, torch_cfg  # noqa: E402

BAND = 1e-12


def _perturbed(leaves, mt, mu, seed):
    """State leaves with seeded noise in T/S, velocities, surface height
    and ice (NumPy, float64)."""
    rng = np.random.RandomState(seed)
    out = dict(leaves)
    tr = leaves["tracer_cur"].copy()
    tr[0] += 0.3 * rng.randn(*tr[0].shape) * mt
    tr[1] += 1.0e-4 * rng.randn(*tr[1].shape) * mt
    out["tracer_cur"] = tr
    out["tracer_old"] = tr - 0.01 * rng.randn(*tr.shape) * mt
    for name in ("u_cur", "v_cur"):
        out[name] = 5.0 * rng.randn(*mu.shape) * mu
    for name in ("ubtrop_cur", "vbtrop_cur"):
        out[name] = 5.0 * rng.randn(*mu.shape[1:]) * mu[0]
    out["psurf_cur"] = 500.0 * rng.randn(*mt.shape[1:]) * mt[0]
    out["qice"] = -1.0e-3 * np.abs(rng.randn(*mt.shape[1:])) * mt[0]
    return out


class Pair:
    """'mini' in both packages with one perturbed state and forcing."""

    def __init__(self):
        from pop2_tpu.forcing import analytic_forcing as j_forcing
        from pop2_tpu.state import initial_state as j_initial_state
        self.jcfg = get_config("mini")
        self.tcfg = torch_cfg(self.jcfg)
        self.jg = j_build_grid(self.jcfg)
        self.tg = t_build_grid(self.tcfg, "cpu")
        mt, mu = np.asarray(self.jg.kmask_t), np.asarray(self.jg.kmask_u)
        base = jax_leaves(j_initial_state(self.jcfg, self.jg))
        self.leaves = _perturbed(base, mt, mu, 3)
        prev = _perturbed(base, mt, mu, 4)
        self.js = JState(**{k: jnp.asarray(v) for k, v in
                            self.leaves.items()})
        self.ts = convert.state_from_numpy(self.leaves, self.tcfg, "cpu")
        self.jprev = JState(**{k: jnp.asarray(v) for k, v in prev.items()})
        self.tprev = convert.state_from_numpy(prev, self.tcfg, "cpu")
        rng = np.random.RandomState(5)
        shape = mt.shape[1:]
        f = dict(stf=1.0e-4 * rng.randn(2, *shape) * mt[0],
                 tfw=1.0e-5 * rng.randn(2, *shape) * mt[0],
                 shf_qsw=2.0e-4 * np.abs(rng.randn(*shape)) * mt[0])
        self.jf = j_forcing(self.jcfg, self.jg).replace(
            **{k: jnp.asarray(v) for k, v in f.items()})
        from pop2_tpu_torch.forcing import analytic_forcing as t_forcing
        self.tf = t_forcing(self.tcfg, self.tg).replace(
            **{k: torch.as_tensor(v) for k, v in f.items()})


@pytest.fixture(scope="module")
def p():
    return Pair()


def _close(got, want, name, band=BAND):
    if isinstance(want, dict):
        assert set(got) == set(want), name
        for k in want:
            _close(got[k], want[k], f"{name}.{k}", band)
        return
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want), name
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{name}[{i}]", band)
        return
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert scale_err(got, want) <= band, (name, scale_err(got, want))


@pytest.mark.parametrize("with_prev", [False, True])
def test_global_diagnostics_and_cfl(p, with_prev):
    jp, tp = (p.jprev, p.tprev) if with_prev else (None, None)
    got = tdiag.global_diagnostics(p.tcfg, p.tg, p.ts, tp)
    want = jdiag.global_diagnostics(p.jcfg, p.jg, p.js, jp)
    assert ("dTEMP_dt_per_day" in got) == with_prev
    _close(got, want, "global_diagnostics")
    _close(tdiag.cfl_numbers(p.tcfg, p.tg, p.ts),
           jdiag.cfl_numbers(p.jcfg, p.jg, p.js), "cfl_numbers")
    assert tdiag.check_ke(p.tcfg, p.tg, p.ts) == pytest.approx(
        jdiag.check_ke(p.jcfg, p.jg, p.js), rel=BAND)
    with pytest.raises(FloatingPointError, match="KE blow-up"):
        tdiag.check_ke(p.tcfg, p.tg, p.ts, ke_limit=1e-3)
    # the model's own table is another formula (SSH weighted by RCALCT
    # alone, SALT_mean): both stay
    model = TModel(p.tcfg, device="cpu")
    assert "SALT_mean" in model.diagnostics(p.ts)
    assert "SALT_mean_psu" in got


def test_transports(p):
    for i in (0, 7, p.jcfg.nx - 1):
        assert tdiag.zonal_transport(p.tcfg, p.tg, p.ts, i) == \
            pytest.approx(jdiag.zonal_transport(p.jcfg, p.jg, p.js, i),
                          rel=BAND, abs=1e-30)
    for sec in (JSection(5, 5, 3, 12, 0, 6, "merid", "a"),
                JSection(4, 20, 9, 9, 1, 9, "zonal", "b")):
        want = jdiag.section_transport(p.jcfg, p.jg, p.js, sec)
        got = tdiag.section_transport(p.tcfg, p.tg, p.ts,
                                      tdiag.TransportSection(*sec))
        _close(got, want, f"section {sec.name}")
        assert max(abs(x) for x in got) > 0.0
    _close(tdiag.barotropic_streamfunction(p.tcfg, p.tg, p.ts),
           jdiag.barotropic_streamfunction(p.jcfg, p.jg, p.js), "bsf")
    # bin counts with no interior edge at a U row's latitude: a column on an
    # edge falls in the bin that the last bit of each package's linspace
    # picks (jnp.linspace interpolates, torch.linspace does not)
    lat = np.asarray(p.jg.ULAT) * 180.0 / np.pi
    for nbins in (37, 23):
        edges = np.linspace(-90.0, 90.0, nbins + 1)[1:-1]
        assert np.abs(lat[..., None] - edges).min() > 1e-6
        _close(tdiag.moc_streamfunction(p.tcfg, p.tg, p.ts, nbins),
               jdiag.moc_streamfunction(p.jcfg, p.jg, p.js, nbins), "moc")
        _close(tdiag.meridional_transport(p.tcfg, p.tg, p.ts, nbins),
               jdiag.meridional_transport(p.jcfg, p.jg, p.js, nbins),
               "meridional_transport")


def test_diag_print(p):
    got = tdiag.diag_print(p.tcfg, p.tg, p.ts, 12, p.tprev, 37)
    want = jdiag.diag_print(p.jcfg, p.jg, p.js, 12, p.jprev, 37)
    gl, wl = got.splitlines(), want.splitlines()
    assert len(gl) == len(wl) and gl[0] == wl[0] and gl[-1] == wl[-1]
    for g, w in zip(gl[1:-1], wl[1:-1]):
        gk, gv = g.split()
        wk, wv = w.split()
        assert gk == wk
        assert float(gv) == pytest.approx(float(wv), rel=BAND, abs=1e-300)


def test_budget(p):
    _close(tbudget.tracer_totals(p.tcfg, p.tg, p.ts),
           jbudget.tracer_totals(p.jcfg, p.jg, p.js), "tracer_totals")
    _close(tbudget.ocean_volume(p.tcfg, p.tg, p.ts),
           jbudget.ocean_volume(p.jcfg, p.jg, p.js), "ocean_volume")
    _close(tbudget.surface_flux_integral(p.tcfg, p.tg, p.tf),
           jbudget.surface_flux_integral(p.jcfg, p.jg, p.jf), "flux")
    # the residual is a difference of totals: held at the band of the
    # totals it is the difference of (over the volume)
    got = tbudget.budget_residual(p.tcfg, p.tg, p.tprev, p.ts, p.tf, 3)
    want = np.asarray(jbudget.budget_residual(p.jcfg, p.jg, p.jprev, p.js,
                                              p.jf, 3))
    terms = np.abs(np.asarray(jbudget.tracer_totals(
        p.jcfg, p.jg, p.js))) / float(p.jg.volume_t)
    assert (np.abs(got.numpy() - want) <= BAND * terms).all(), (
        got.numpy() - want, terms)
    # the port's own initial state closes its budget with itself
    s0 = t_initial_state(p.tcfg, p.tg)
    assert float(tbudget.budget_residual(
        p.tcfg, p.tg, s0, s0, p.tf.replace(
            stf=torch.zeros_like(p.tf.stf), tfw=torch.zeros_like(p.tf.tfw),
            shf_qsw=torch.zeros_like(p.tf.shf_qsw)), 1).abs().max()) == 0.0


HISTORY = ["TEMP", "SALT", "UVEL", "PV", "WVEL", "SSH", "BSF", "SST",
           "VDC_T", "VVC", "TEND_SALT", "QSW_3D", "RHO_VINT"]
MOVIE = ["TEMP", "SSH", "UET", "VDC_S"]
NSTEPS = 3


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    """{package: [files]} of both packages' snapshot streams."""
    jcfg = get_config("mini")
    jm = JModel(jcfg)
    tm = TModel(torch_cfg(jcfg), device="cpu")
    mt, mu = np.asarray(jm.grid.kmask_t), np.asarray(jm.grid.kmask_u)
    leaves = _perturbed(jax_leaves(jm.initial_state()), mt, mu, 8)
    out = {}
    for name, m in (("jax", jm), ("port", tm)):
        tmp = str(tmp_path_factory.mktemp(name))
        m.enable_history(HISTORY, freq_steps=1, outdir=tmp)
        m.enable_movie(MOVIE, freq_steps=2, outdir=tmp)
        m.enable_movie(MOVIE, freq_steps=3, outdir=tmp, level=2,
                       prefix="level2")
        if name == "jax":
            state = jm.initial_state().replace(
                **{k: jnp.asarray(v) for k, v in leaves.items()})
        else:
            tm.initial_state()
            state = convert.state_from_numpy(leaves, tm.cfg, "cpu")
        m.nsteps_total = 1  # leapfrog steps from here
        for _ in range(NSTEPS):
            state, _ = m.advance(state)
        out[name] = list(m.tavg_files)
    return out


def test_snapshot_files_match_the_jax_packages(snapshots):
    from scipy.io import netcdf_file
    import os
    names = [os.path.basename(f) for f in snapshots["jax"]]
    assert names == [os.path.basename(f) for f in snapshots["port"]]
    assert names == ["pop2_tpu.h.00000002.nc", "pop2_tpu.m.00000002.nc",
                     "pop2_tpu.h.00000003.nc", "level2.00000003.nc",
                     "pop2_tpu.h.00000004.nc", "pop2_tpu.m.00000004.nc"]
    for jf, tf in zip(snapshots["jax"], snapshots["port"]):
        with netcdf_file(jf, mmap=False) as fj, \
                netcdf_file(tf, mmap=False) as ft:
            assert set(ft.variables) == set(fj.variables)
            for name, v in fj.variables.items():
                got, want = ft.variables[name][:], v[:]
                assert got.shape == want.shape, (jf, name)
                scale = np.abs(want).max() or 1.0
                err = np.abs(got.astype(np.float64) - want).max()
                assert err <= max(1e-9 * scale,
                                  np.spacing(np.float32(scale))), (jf, name)
                if hasattr(v, "long_name"):
                    assert ft.variables[name].long_name == v.long_name


def test_no_source_of_the_port_imports_jax():
    """No module of the port (its subpackages too) and no line of
    chip_smoke.py imports jax, jaxlib, flax or the JAX package, at any
    depth of the code (read from the sources: a lazy import counts)."""
    import ast
    import pathlib
    root = pathlib.Path(__file__).resolve().parents[1]
    files = sorted((root / "pop2_tpu_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    assert any(f.name == "netcdf4.py" for f in files)
    banned = ("jax", "jaxlib", "flax", "pop2_tpu")
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad += [f"{f.name}:{node.lineno} {n}" for n in names
                    if n.split(".")[0] in banned]
    assert not bad, bad
