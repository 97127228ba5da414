"""The port's coupler cap against the JAX package's on the CPU: the import
and export adapters (``coupled``), the ice heat flux to the coupler, the
``OcnComponent`` protocol over coupling intervals with its restarts, and the
post-run processing of the stream files (``io/postrun``).

Bands: the adapters and the ice flux 1e-14 of each field's scale (the same
arithmetic in float64); the component's exports 1e-7 of each field's scale
after one and two intervals (PARITY.md's band of five steps; an interval is
four steps of 'mini'); the port's resumed runs bitwise; post-run files
equal to the JAX functions' on the same inputs.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

jax.config.update("jax_enable_x64", True)

from pop2_tpu import coupled as jcoupled  # noqa: E402
from pop2_tpu import ice as jice  # noqa: E402
from pop2_tpu.config import get_config  # noqa: E402
from pop2_tpu.grid import build_grid as j_build_grid  # noqa: E402
from pop2_tpu.io import postrun as jpostrun  # noqa: E402
from pop2_tpu.ocn_component import OcnComponent as JComponent  # noqa: E402
from pop2_tpu.state import initial_state as j_initial_state  # noqa: E402

from pop2_tpu_torch import convert, coupled, ice  # noqa: E402
from pop2_tpu_torch.grid import build_grid  # noqa: E402
from pop2_tpu_torch.io import postrun  # noqa: E402
from pop2_tpu_torch.model import Model as TModel  # noqa: E402
from pop2_tpu_torch.ocn_component import OcnComponent  # noqa: E402

from tests.torch_port_helpers import jax_leaves, torch_cfg  # noqa: E402

EXPORTS = ("So_t", "So_s", "So_u", "So_v", "So_dhdx", "So_dhdy", "So_ssh",
           "Fioo_q")


def x2o_numpy(cfg, seed=0):
    """Seeded SI import fields at the magnitudes of the JAX package's own
    cap test (tests/test_ocn_component.py)."""
    rng = np.random.RandomState(seed)
    shape = (cfg.ny, cfg.nx)

    def f(s):
        return rng.uniform(-s, s, shape)
    return {
        "taux": f(0.1), "tauy": f(0.1),          # N/m^2
        "swnet": rng.uniform(0, 200, shape),
        "sen": f(20.0), "lwup": f(50.0), "lwdn": f(50.0), "melth": f(5.0),
        "snow": f(1e-5), "rain": f(1e-5), "evap": f(1e-5),
        "melt": f(1e-6), "rofl": f(1e-6), "rofi": f(1e-7),
        "salt": f(1e-7), "ifrac": rng.uniform(0, 0.5, shape),
        "pslv": np.full(shape, 101325.0), "duu10n": f(25.0),
    }


def scale_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / (np.abs(want).max() or 1.0))


@pytest.fixture(scope="module")
def grids():
    """The tripole 'mini' grid with frazil ice in both packages."""
    jcfg = get_config("mini", ns_boundary="tripole", liceform=True)
    tcfg = torch_cfg(jcfg)
    return jcfg, tcfg, j_build_grid(jcfg), build_grid(tcfg, "cpu")


@pytest.mark.parametrize("lfw_as_salt_flx", [True, False])
def test_ocn_import_matches(grids, lfw_as_salt_flx):
    jcfg, tcfg, jgrid, tgrid = grids
    x2o = x2o_numpy(jcfg, seed=1)
    want = jcoupled.ocn_import(jcfg, jgrid,
                               {k: jnp.asarray(v) for k, v in x2o.items()},
                               lfw_as_salt_flx=lfw_as_salt_flx)
    got = coupled.ocn_import(tcfg, tgrid,
                             {k: torch.as_tensor(v) for k, v in x2o.items()},
                             lfw_as_salt_flx=lfw_as_salt_flx)
    wl, gl = jax_leaves(want), dict(got.leaves())
    assert set(gl) == set(wl)
    for name, w in wl.items():
        assert scale_err(gl[name].numpy(), w) <= 1e-14, name
    assert got.u10_sqr is not None and got.ifrac is not None
    assert bool((got.fw == 0).all()) == lfw_as_salt_flx
    # without the gas-exchange fields, none is set; an absent field is zero
    part = {k: torch.as_tensor(v) for k, v in x2o.items()
            if k not in ("duu10n", "ifrac", "rain")}
    got = coupled.ocn_import(tcfg, tgrid, part, lfw_as_salt_flx)
    want = jcoupled.ocn_import(jcfg, jgrid,
                               {k: jnp.asarray(v.numpy())
                                for k, v in part.items()}, lfw_as_salt_flx)
    assert got.u10_sqr is None and got.ifrac is None
    assert want.u10_sqr is None and want.ifrac is None
    for name, w in jax_leaves(want).items():
        assert scale_err(dict(got.leaves())[name].numpy(), w) <= 1e-14, name
    assert coupled.IMPORT_FIELDS == jcoupled.IMPORT_FIELDS


def test_ocn_export_and_ice_flux_match(grids):
    jcfg, tcfg, jgrid, tgrid = grids
    rng = np.random.RandomState(4)
    leaves = jax_leaves(j_initial_state(jcfg, jgrid))
    mt, mu = np.asarray(jgrid.kmask_t), np.asarray(jgrid.kmask_u)
    leaves["u_cur"] = rng.randn(*mu.shape) * mu * 5.0
    leaves["v_cur"] = rng.randn(*mu.shape) * mu * 5.0
    leaves["gradpx_cur"] = rng.randn(*mu.shape[1:]) * mu[0] * 1e-2
    leaves["gradpy_cur"] = rng.randn(*mu.shape[1:]) * mu[0] * 1e-2
    leaves["psurf_cur"] = rng.randn(*mt.shape[1:]) * mt[0] * 1e3
    leaves["aqice"] = -np.abs(rng.randn(*mt.shape[1:])) * mt[0] * 10.0
    jstate = j_initial_state(jcfg, jgrid).replace(
        **{k: jnp.asarray(v) for k, v in leaves.items()})
    tstate = convert.state_from_numpy(leaves, tcfg, "cpu")

    tlast = 3600.0
    jq, ja = jice.ice_flx_to_coupler(jcfg, jgrid, jstate.tracer_cur,
                                     jstate.aqice, tlast)
    tq, ta = ice.ice_flx_to_coupler(tcfg, tgrid, tstate.tracer_cur,
                                    tstate.aqice, tlast)
    assert scale_err(tq.numpy(), jq) <= 1e-14 and float(tq.abs().max()) > 0
    assert not ta.any() and not np.asarray(ja).any()

    want = jcoupled.ocn_export(jcfg, jgrid, jstate, qflux=jq)
    got = coupled.ocn_export(tcfg, tgrid, tstate, qflux=tq)
    assert set(got) == set(want) == set(EXPORTS)
    for name in want:
        assert scale_err(got[name].numpy(), want[name]) <= 1e-14, name
    assert "Fioo_q" not in coupled.ocn_export(tcfg, tgrid, tstate)


# -- the component ----------------------------------------------------------

INTERVAL = dict(coupling_freq_opt="nhour", coupling_freq=1)  # 4 mini steps


@pytest.fixture(scope="module")
def mini():
    """'mini' with frazil ice (so the export carries the ice heat flux) and
    its seeded import fields."""
    jcfg = get_config("mini", liceform=True)
    return jcfg, torch_cfg(jcfg), x2o_numpy(jcfg)


def port_x2o(x2o):
    return {k: torch.as_tensor(v) for k, v in x2o.items()}


@pytest.fixture(scope="module")
def jax_intervals(mini, tmp_path_factory):
    """The JAX component's initial export and three intervals' exports,
    the second interval ending in a restart written on request."""
    jcfg, _, x2o = mini
    out = str(tmp_path_factory.mktemp("jax_cpl"))
    comp = JComponent(jcfg, outdir=out, **INTERVAL)
    jx = {k: jnp.asarray(v) for k, v in x2o.items()}
    exports = [comp.initialize(), comp.run(jx), comp.run(jx, rstwr=True),
               comp.run(jx)]
    return out, [{k: np.asarray(v) for k, v in e.items()} for e in exports]


def assert_exports_close(got, want, band):
    assert set(got) == set(want)
    for name in want:
        err = scale_err(got[name].numpy(), want[name])
        assert err <= band, (name, err)


def test_component_exports_match_jax(mini, jax_intervals, tmp_path):
    _, tcfg, x2o = mini
    _, want = jax_intervals
    comp = OcnComponent(tcfg, outdir=str(tmp_path), device="cpu", **INTERVAL)
    assert comp.EXPORT_FIELDS == JComponent.EXPORT_FIELDS
    assert comp.IMPORT_FIELDS == JComponent.IMPORT_FIELDS
    got = [comp.initialize()]
    n0 = comp.model.nsteps_total
    for _ in range(2):
        got.append(comp.run(port_x2o(x2o)))
    assert comp.model.nsteps_total - n0 == 8  # 4 steps an interval
    for g, w in zip(got, want[:3]):
        assert_exports_close(g, w, 1e-7)
    # physical ranges, and the model evolved between the intervals
    for name, (lo, hi) in {"So_t": (271.0, 310.0), "So_s": (0.0, 45.0),
                           "So_u": (-2.0, 2.0), "So_v": (-2.0, 2.0)}.items():
        v = got[-1][name].numpy()
        assert lo <= v.min() and v.max() <= hi, name
    assert not torch.equal(got[1]["So_u"], got[2]["So_u"])
    assert comp.finalize() is not None and len(comp.restart_files) == 1


def test_restart_on_request_resumes_bitwise(mini, tmp_path):
    _, tcfg, x2o = mini
    out = str(tmp_path)
    comp = OcnComponent(tcfg, outdir=out, device="cpu", **INTERVAL)
    comp.initialize()
    comp.run(port_x2o(x2o))
    comp.run(port_x2o(x2o), rstwr=True)
    assert len(comp.restart_files) == 1
    mid = comp.state
    ref = comp.run(port_x2o(x2o))

    comp2 = OcnComponent(tcfg, outdir=out, device="cpu", **INTERVAL)
    comp2.initialize(restart_dir=out)
    assert comp2.model.nsteps_total == 8
    for name, t in mid.leaves():  # the restart holds the reset aqice too
        assert torch.equal(getattr(comp2.state, name), t), name
    resumed = comp2.run(port_x2o(x2o))
    for name in EXPORTS:
        assert torch.equal(resumed[name], ref[name]), name
    for name, t in comp.state.leaves():
        assert torch.equal(getattr(comp2.state, name), t), name


def test_scheduled_restart_resumes_bitwise(mini, tmp_path):
    """A restart on the calendar (nhour 2: every second interval)."""
    _, tcfg, x2o = mini
    out = str(tmp_path)
    comp = OcnComponent(tcfg, outdir=out, device="cpu",
                        restart_freq_opt="nhour", restart_freq=2,
                        **INTERVAL)
    comp.initialize()
    comp.run(port_x2o(x2o))
    assert comp.restart_files == []
    comp.run(port_x2o(x2o))
    assert len(comp.restart_files) == 1
    ref = comp.run(port_x2o(x2o))
    comp2 = OcnComponent(tcfg, outdir=out, device="cpu",
                         restart_freq_opt="nhour", restart_freq=2,
                         **INTERVAL)
    comp2.initialize(restart_dir=out)
    resumed = comp2.run(port_x2o(x2o))
    for name in EXPORTS:
        assert torch.equal(resumed[name], ref[name]), name


def test_jax_restart_resumed_by_port(mini, jax_intervals):
    """The restart the JAX component wrote at the end of its second
    interval, resumed by the port's component: its third export within
    1e-7 of the JAX component's."""
    _, tcfg, x2o = mini
    out, want = jax_intervals
    comp = OcnComponent(tcfg, outdir=out, device="cpu", **INTERVAL)
    comp.initialize(restart_dir=out)
    assert comp.model.nsteps_total == 8
    assert_exports_close(comp.run(port_x2o(x2o)), want[3], 1e-7)


# -- post-run processing ----------------------------------------------------

def test_postrun_matches_jax(tmp_path):
    """Daily stream files written by the port's tavg, averaged into a
    monthly mean and stripped of fields by both packages' functions."""
    tcfg = torch_cfg(get_config("mini", nx=16, ny=12, km=4))
    m = TModel(tcfg, device="cpu")
    out = str(tmp_path / "daily")
    os.makedirs(out)
    m.enable_tavg(["TEMP", "SALT", "SSH", "UVEL"], freq_steps=2, outdir=out)
    state = m.initial_state()
    for _ in range(6):
        state, _ = m.advance(state)
    daily = sorted(m.tavg_files)
    assert len(daily) == 3
    got = postrun.monthly_mean_from_daily(daily, str(tmp_path / "tm.nc"),
                                          fields=["TEMP", "SSH", "UVEL"])
    want = jpostrun.monthly_mean_from_daily(daily, str(tmp_path / "jm.nc"),
                                            fields=["TEMP", "SSH", "UVEL"])
    g_dims, g_vars = postrun._read_stream(got)
    w_dims, w_vars = jpostrun._read_stream(want)
    assert g_dims == w_dims and list(g_vars) == list(w_vars)
    assert "SALT" not in g_vars and "TLAT" in g_vars
    for name, (dims, data, attrs) in w_vars.items():
        gd, ga, gat = g_vars[name]
        assert gd == dims and gat == attrs, name
        np.testing.assert_array_equal(ga, data, err_msg=name)
    # the mean is the mean of the days
    days = [postrun._read_stream(p)[1]["SSH"][1] for p in daily]
    np.testing.assert_allclose(g_vars["SSH"][1],
                               np.mean(days, axis=0, dtype=np.float64),
                               rtol=1e-6)

    for fn, dst in ((postrun.strip_fields, "ts.nc"),
                    (jpostrun.strip_fields, "js.nc")):
        fn(daily[0], ["SALT", "UVEL"], str(tmp_path / dst))
    _, gs = postrun._read_stream(str(tmp_path / "ts.nc"))
    _, js = jpostrun._read_stream(str(tmp_path / "js.nc"))
    assert list(gs) == list(js) and "SALT" not in gs and "TEMP" in gs
    for name in js:
        np.testing.assert_array_equal(gs[name][1], js[name][1])
    for fn in (postrun.strip_fields, jpostrun.strip_fields):
        with pytest.raises(ValueError, match="coordinates"):
            fn(daily[0], ["TLAT"])
    # in place
    postrun.strip_fields(daily[1], ["SSH"])
    assert "SSH" not in postrun._read_stream(daily[1])[1]
