"""The port's model services against the JAX package's, on the CPU: the
calendar and time flags (``time_management``), the step-type policy
(``Model.step_flags``, 'avgfit' included) and the calendar a run of it
advances, exact restart (``io/restart``: the same file format, read across
packages, the template fallbacks) and the timers."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

jax.config.update("jax_enable_x64", True)

from pop2_tpu import time_management as jtm  # noqa: E402
from pop2_tpu.config import TimeConfig, get_config  # noqa: E402
from pop2_tpu.io import restart as jrestart  # noqa: E402
from pop2_tpu.model import Model as JModel  # noqa: E402
from pop2_tpu.state import State as JState  # noqa: E402
from pop2_tpu import timers as jtimers  # noqa: E402

from pop2_tpu_torch import convert, supported, timers  # noqa: E402
from pop2_tpu_torch import time_management as ttm  # noqa: E402
from pop2_tpu_torch.io import restart  # noqa: E402
from pop2_tpu_torch.model import Model as TModel  # noqa: E402

from tests.torch_port_helpers import jax_leaves, torch_cfg  # noqa: E402

# -- calendar and time flags ---------------------------------------------------

# (Calendar keywords, steps, step lengths (None: the calendar's own)) of the
# cases of tests/test_time_management.py, and half steps as averaging
# steps take them
CALENDARS = {
    "quarter_days": (dict(dt_seconds=86400.0 / 4), 16, None),
    "days_one_year": (dict(dt_seconds=86400.0), 365, None),
    "leap_feb29": (dict(dt_seconds=86400.0, iyear=2000, imonth=2, iday=28,
                        allow_leapyear=True), 3, None),
    "off_midnight": (dict(dt_seconds=10000.0), 99, None),
    "half_hours": (dict(dt_seconds=1800.0), 96, None),
    "half_steps": (dict(dt_seconds=86400.0 / 45), 200,
                   [0.5 * 86400.0 / 45 if n % 7 == 0 else None
                    for n in range(1, 201)]),
}
FLAGS = [("dump", "nday", 2), ("six_hourly", "nhour", 6),
         ("monthly", "nmonth", 1), ("quarterly", "nmonth", 3),
         ("annual", "nyear", 1), ("every3", "nstep", 3),
         ("hourly_s", "nsecond", 3600), ("spinup", "once", 1),
         ("never", "never", 1)]
SWITCHES = ("iyear", "imonth", "iday", "seconds_this_day", "nsteps_total",
            "elapsed_days", "elapsed_months", "elapsed_years", "eod", "eom",
            "eoy", "midnight", "newhour", "newday")


def _trace(mod, kw, nsteps, dts):
    mgr = mod.TimeManager(kw["dt_seconds"], start_year=kw.get("iyear", 1),
                          start_month=kw.get("imonth", 1),
                          start_day=kw.get("iday", 1),
                          allow_leapyear=kw.get("allow_leapyear", False))
    for name, opt, freq in FLAGS:
        mgr.init_time_flag(name, opt, freq)
    out = []
    for n in range(nsteps):
        mgr.advance(None if dts is None else dts[n])
        cal = mgr.calendar
        out.append(tuple(getattr(cal, k) for k in SWITCHES)
                   + (cal.ihour, cal.elapsed_days_float, cal.year_fraction)
                   + tuple(mgr.check_time_flag(f[0]) for f in FLAGS))
    mgr.override_time_flag("never", True)
    out.append(mgr.check_time_flag("never"))
    mgr.reset()
    out.append(tuple(getattr(mgr.calendar, k) for k in SWITCHES))
    return out


@pytest.mark.parametrize("case", sorted(CALENDARS))
def test_time_manager_matches(case):
    kw, nsteps, dts = CALENDARS[case]
    assert _trace(ttm, kw, nsteps, dts) == _trace(jtm, kw, nsteps, dts)


def test_leapyear_and_flag_rules_match():
    for year in (1900, 1996, 2000, 2025):
        assert ttm.is_leapyear(year) == jtm.is_leapyear(year)
        for month in range(1, 13):
            for leap in (False, True):
                assert (ttm.days_in_month(year, month, leap)
                        == jtm.days_in_month(year, month, leap))
    with pytest.raises(ValueError):
        ttm.TimeFlag("bad", freq_opt="ndecade")
    with pytest.raises(ValueError):
        ttm.TimeFlag("bad", freq_opt="nday", freq=0)


# -- the step-type policy --------------------------------------------------------

POLICIES = {
    "avg": dict(time_mix_opt="avg", time_mix_freq=17),
    "avgfit": dict(time_mix_opt="avgfit", time_mix_freq=17),
    "avgfit_fit2": dict(time_mix_opt="avgfit", time_mix_freq=6, fit_freq=2,
                        dt_count=23.0),
    "robert": dict(time_mix_opt="robert"),
}


@pytest.fixture(scope="module", params=sorted(POLICIES))
def policy_pair(request):
    jcfg = get_config("mini", time=TimeConfig(**POLICIES[request.param]))
    return JModel(jcfg), TModel(torch_cfg(jcfg), device="cpu")


def test_step_flags_match(policy_pair):
    jm, tm = policy_pair
    assert [tm.step_flags(n) for n in range(1, 201)] == \
        [jm.step_flags(n) for n in range(1, 201)]
    assert tm.cfg.time.dtt == jm.cfg.time.dtt
    assert supported.unsupported(tm.cfg) == []


def test_calendar_of_a_run_matches(policy_pair):
    """The port's step counter and calendar over 200 steps (half steps on
    the averaging steps) against the JAX package's flags driving its time
    manager as its ``advance`` does."""
    jm, tm = policy_pair
    tm.initial_state()
    jm.time_manager.reset()
    for n in range(1, 201):
        tm._next_step()
        _, avg_ts = jm.step_flags(n)
        jm.time_manager.advance(0.5 * jm.cfg.time.dtt if avg_ts else None)
        assert dataclasses.astuple(tm.time_manager.calendar) == \
            dataclasses.astuple(jm.time_manager.calendar), n
    if jm.cfg.time.time_mix_opt == "avgfit":
        # the fitted timestep ends every coupling interval on midnight:
        # 200 steps of 45 or 46 a day pass four midnights
        assert tm.time_manager.calendar.elapsed_days >= 4


def test_avgfit_run_steps():
    """'avgfit' steps through Model.run_compiled on 'mini'."""
    cfg = torch_cfg(get_config(
        "mini", time=TimeConfig(time_mix_opt="avgfit", time_mix_freq=4,
                                dt_count=4.0)))
    model = TModel(cfg, device="cpu")
    state, _ = model.run_compiled(model.initial_state(), 6)
    assert [model.step_flags(n)[1] for n in range(1, 7)] == \
        [False, True, False, True, False, False]
    assert all(bool(torch.isfinite(t).all()) for _, t in state.leaves())
    # 4 full + 2 half steps fill one day exactly
    assert model.time_manager.calendar.date == (1, 1, 2)
    assert model.time_manager.calendar.midnight


def test_model_calendar_wiring():
    """9 quarter-day steps end at day 3, 06:00 (as the JAX package's
    test_model_calendar_wiring)."""
    cfg = torch_cfg(get_config("mini").with_(
        time=TimeConfig(dt_option="steps_per_day", dt_count=4.0)))
    model = TModel(cfg, device="cpu")
    state = model.initial_state()
    for _ in range(9):
        state, _ = model.advance(state)
    cal = model.time_manager.calendar
    assert cal.nsteps_total == 9 and cal.date == (1, 1, 3)
    assert cal.seconds_this_day == 21600.0
    model.initial_state()
    assert model.time_manager.calendar.nsteps_total == 0


# -- restart ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def mini_models():
    jcfg = get_config("mini")
    return jcfg, TModel(torch_cfg(jcfg), device="cpu")


def _seeded_state(model, seed=3):
    """The initial state with every leaf moved by seeded noise, so that no
    leaf is zero or equal to another."""
    rng = np.random.RandomState(seed)
    s = model.initial_state()
    return s.replace(**{name: t + torch.as_tensor(rng.standard_normal(
        tuple(t.shape)), dtype=t.dtype) for name, t in s.leaves()})


def test_restart_reads_across_packages(tmp_path, mini_models):
    jcfg, tm = mini_models
    tcfg = tm.cfg
    state = _seeded_state(tm)
    # the port writes, the JAX package reads
    path = restart.write_restart(str(tmp_path / "port"), state, 7, tcfg)
    assert path.endswith(".npz")
    js, n = jrestart.read_restart(str(tmp_path), jcfg)
    assert n == 7
    jl = jax_leaves(js)
    for name, t in state.leaves():
        np.testing.assert_array_equal(jl[name], t.numpy(), err_msg=name)
    # the JAX package writes, the port reads (through the pointer file)
    jstate = JState(**{k: jnp.asarray(v * 1.5) for k, v in jl.items()})
    jrestart.write_restart(str(tmp_path / "jax"), jstate, 11, jcfg)
    back, n = restart.read_restart(str(tmp_path), tcfg, device="cpu")
    assert n == 11
    for name, t in back.leaves():
        assert t.dtype == torch.float64
        np.testing.assert_array_equal(t.numpy(), jl[name] * 1.5,
                                      err_msg=name)
    # uncompressed: the same .npz for either reader
    restart.write_restart(str(tmp_path / "plain"), state, 2, tcfg,
                          compressed=False)
    js, _ = jrestart.read_restart(str(tmp_path / "plain.npz"), jcfg)
    np.testing.assert_array_equal(jax_leaves(js)["tracer_cur"],
                                  state.tracer_cur.numpy())


def test_restart_template_fallbacks_match(tmp_path):
    """A field missing from the checkpoint comes from the template; a
    checkpoint of fewer tracers is padded from the template and the Robert
    filter's memory re-primed; without a template both raise (the JAX
    package's read fallbacks)."""
    jcfg2 = get_config("mini")
    jcfg3 = get_config("mini", passive_tracers=("iage",), nt=3)
    t2 = TModel(torch_cfg(jcfg2), device="cpu")
    t3 = TModel(torch_cfg(jcfg3), device="cpu")
    state2 = _seeded_state(t2, 5).replace(
        rf_s_prev_valid=torch.ones((), dtype=torch.float64))
    path = restart.write_restart(str(tmp_path / "ck"), state2, 4, t2.cfg)
    # drop one field from the file
    data = dict(np.load(path))
    del data["qice"]
    np.savez(str(tmp_path / "short.npz"), **data)
    (tmp_path / "short.npz.json").write_text(
        (tmp_path / "ck.npz.json").read_text())

    tmpl3 = _seeded_state(t3, 6)
    got, _ = restart.read_restart(str(tmp_path / "short.npz"), t3.cfg,
                                  template=tmpl3, device="cpu")
    jtmpl3 = JState(**{k: jnp.asarray(v)
                       for k, v in jax_leaves(tmpl3).items()})
    want, _ = jrestart.read_restart(str(tmp_path / "short.npz"), jcfg3,
                                    template=jtmpl3)
    wl = jax_leaves(want)
    for name, t in got.leaves():
        np.testing.assert_array_equal(t.numpy(), wl[name], err_msg=name)
    assert float(got.rf_s_prev_valid) == 0.0
    assert got.tracer_cur.shape[0] == 3
    with pytest.raises(KeyError, match="template"):
        restart.read_restart(str(tmp_path / "short.npz"), t2.cfg,
                             device="cpu")
    with pytest.raises(ValueError, match="nt"):
        restart.read_restart(path, t3.cfg, device="cpu")


def test_restart_round_trip_is_bitwise(tmp_path, mini_models):
    """2 steps + write + read + 2 steps equal 4 steps, bitwise."""
    _, model = mini_models
    straight, _ = model.run_compiled(model.initial_state(), 4)
    half, _ = model.run_compiled(model.initial_state(), 2)
    restart.write_restart(str(tmp_path / "ck"), half, model.nsteps_total,
                          model.cfg)
    back, nsteps = restart.read_restart(str(tmp_path), model.cfg,
                                        device="cpu")
    model.initial_state()
    model.nsteps_total = nsteps
    resumed, _ = model.run_compiled(back, 2)
    for (name, x), (_, y) in zip(resumed.leaves(), straight.leaves()):
        assert torch.equal(x, y), name
    assert convert.state_to_numpy(resumed).keys() == \
        convert.state_to_numpy(straight).keys()


# -- timers ------------------------------------------------------------------------

def test_timers_match():
    got, want = timers.Timers(), jtimers.Timers()
    x = torch.ones(3)
    for _ in range(3):
        with got.section("STEP", sync_on=x):
            pass
        with want.section("STEP", sync_on=jnp.ones(3)):
            pass
    with got.section("BAROTROPIC", sync_on=[x, (x, x)]):
        pass
    t = got.get("STEP")
    assert t.count == want.get("STEP").count == 3
    assert 0.0 <= t.tmin <= t.tmax <= t.total
    assert got.get("never").count == 0
    table, jtable = got.print_all(), want.print_all()
    assert table.splitlines()[0] == jtable.splitlines()[0]
    assert [line.split()[:2] for line in table.splitlines()[1:2]] == \
        [line.split()[:2] for line in jtable.splitlines()[1:]]
    assert len(table.splitlines()) == 3  # header, STEP, BAROTROPIC
