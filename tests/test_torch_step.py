"""The slice as a whole: the port's ``Model`` against ``pop2_tpu.model.Model``
on the CPU in float64, stepping from the same state and forcing (carried
across as NumPy arrays through ``convert.py``).

Configuration: the matched physics of PARITY.md at 32 x 24 x 8
(``matched_config_at``: centered advection, del2 mixing, Richardson vertical
mixing, MWJF, variable-thickness surface, PCG, 'avg' time mixing; uniform
levels, since eight cannot carry the internal vertical grid).
Bands, relative to each field's maximum (PARITY.md): 1e-11 after the Euler
step, 1e-7 after five steps and past an averaging step.

The solver's convergence criterion is tightened from the matched 1e-12 to
1e-20 for these runs. A CG solve fixes the surface pressure only to its
stopping tolerance: fed bit-identical right-hand sides, the two packages'
PCG (whose global sums round in different orders) stop at the same iteration
and still differ by 1e-9 in PSURF at 1e-12, by 5e-7 at 1e-14, and by 2e-13
once the criterion is tight enough for both to converge to rounding. The
bands are meant for the arithmetic of the step, so the test removes the
stopping tolerance from the comparison.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pop2_tpu.model import Model as JModel  # noqa: E402

from pop2_tpu_torch import convert, supported  # noqa: E402
from pop2_tpu_torch.config import get_config as t_get_config  # noqa: E402
from pop2_tpu_torch.grid import build_grid  # noqa: E402
from pop2_tpu_torch.model import Model as TModel  # noqa: E402
from pop2_tpu_torch.state import State  # noqa: E402

from tests.reference_oracle.compare import matched_config_at  # noqa: E402
from tests.torch_port_helpers import jax_leaves, scale_err, torch_cfg  # noqa: E402

FIELDS = {  # PARITY.md's names -> how to read them from a State's leaves
    "UVEL": lambda s: s["u_cur"], "VVEL": lambda s: s["v_cur"],
    "TEMP": lambda s: s["tracer_cur"][0], "SALT": lambda s: s["tracer_cur"][1],
    "PSURF": lambda s: s["psurf_cur"], "UBTROP": lambda s: s["ubtrop_cur"],
    "VBTROP": lambda s: s["vbtrop_cur"],
}


def _worst(t_leaves, j_leaves):
    return {name: scale_err(get(t_leaves), get(j_leaves))
            for name, get in FIELDS.items()}


@pytest.fixture(scope="module")
def runs():
    """Both models stepped side by side: snapshots (as dicts of NumPy leaves)
    after steps 1 and 5, then — with both step counters moved to just before
    the averaging step of ``time_mix_freq`` — after that averaging step and
    one more leapfrog step."""
    # 8 levels cannot carry the internal (Gaussian) vertical grid
    jcfg = matched_config_at(32, 24, 8).with_(vert_grid="uniform")
    jcfg = jcfg.with_(solver=dataclasses.replace(
        jcfg.solver, convergence_criterion=1e-20))
    tcfg = torch_cfg(jcfg)
    jm, tm = JModel(jcfg), TModel(tcfg, device="cpu")
    js = jm.initial_state()
    ts = convert.state_from_numpy(jax_leaves(js), tcfg, "cpu")
    tm.initial_state()  # resets the step counter
    tforcing = convert.forcing_from_numpy(jax_leaves(jm.forcing), tcfg, "cpu")
    snaps, iters = {}, {}

    def advance(tag):
        nonlocal js, ts
        js, jd = jm.advance(js)
        ts, td = tm.advance(ts, tforcing)
        snaps[tag] = (convert.state_to_numpy(ts), jax_leaves(js))
        iters[tag] = (td.solver_iters, int(jd.solver_iters))

    for n in range(1, 6):
        advance(n)
    freq = jcfg.time.time_mix_freq
    assert freq == 17
    jm.nsteps_total = tm.nsteps_total = freq - 1
    assert tm.step_flags(freq) == jm.step_flags(freq) == (True, True)
    advance("avg")
    advance("after_avg")
    return dict(snaps=snaps, iters=iters, jm=jm, tm=tm, jcfg=jcfg, tcfg=tcfg,
                js=js, ts=ts)


def test_state_round_trip_through_convert(runs):
    tcfg = runs["tcfg"]
    j0 = jax_leaves(JModel(runs["jcfg"]).initial_state())
    ts = convert.state_from_numpy(j0, tcfg, "cpu")
    assert isinstance(ts, State) and ts.u_cur.dtype == torch.float64
    back = convert.state_to_numpy(ts)
    assert sorted(back) == sorted(j0)
    for name, want in j0.items():
        np.testing.assert_array_equal(back[name], want, err_msg=name)
    # and the port's own analytic initial state is the same state
    own = convert.state_to_numpy(
        TModel(tcfg, device="cpu").initial_state())
    for name, want in j0.items():
        np.testing.assert_allclose(own[name], want, rtol=1e-14, atol=0,
                                   err_msg=name)
    with pytest.raises(KeyError, match="psurf_cur"):
        convert.state_from_numpy(
            {k: v for k, v in j0.items() if k != "psurf_cur"}, tcfg, "cpu")


def test_step1_euler_machine_precision(runs):
    worst = _worst(*runs["snaps"][1])
    assert max(worst.values()) <= 1e-11, worst
    assert runs["iters"][1][0] == runs["iters"][1][1] > 0


def test_step5_leapfrog_parity(runs):
    worst = _worst(*runs["snaps"][5])
    assert max(worst.values()) <= 1e-7, worst
    t5 = runs["snaps"][5][0]
    assert np.abs(t5["u_cur"]).max() > 0 and np.isfinite(t5["u_cur"]).all()
    # the solves stop at the same check iteration in both packages
    for n in range(1, 6):
        assert runs["iters"][n][0] == runs["iters"][n][1], (n, runs["iters"])


@pytest.mark.parametrize("tag", ["avg", "after_avg"])
def test_parity_past_averaging_step(runs, tag):
    t_leaves, j_leaves = runs["snaps"][tag]
    worst = _worst(t_leaves, j_leaves)
    assert max(worst.values()) <= 1e-7, worst
    # the filter rewrites the old time level too
    for name in ("tracer_old", "u_old", "psurf_old", "rho_old", "rho_cur",
                 "pguess"):
        assert scale_err(t_leaves[name], j_leaves[name]) <= 1e-7, name


def test_diagnostics_match(runs):
    want = runs["jm"].diagnostics(runs["js"])
    got = runs["tm"].diagnostics(runs["ts"])
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == pytest.approx(want[name], rel=1e-7), name
    runs["tm"].check_ke(runs["ts"])
    with pytest.raises(FloatingPointError, match="KE blow-up"):
        runs["tm"].check_ke(runs["ts"], ke_limit=0.0)


def test_step_flags_follow_time_mix_freq(runs):
    tm, jm = runs["tm"], runs["jm"]
    for n in (1, 2, 16, 17, 18, 34):
        assert tm.step_flags(n) == jm.step_flags(n)
    assert tm.step_flags(1) == (False, False)


def test_model_defaults_to_cuda_and_raises_without_one():
    cfg = t_get_config("mini")
    if torch.cuda.is_available():
        assert TModel(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            TModel(cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            build_grid(cfg)


def test_convert_defaults_to_cuda_and_raises_without_one():
    cfg = t_get_config("mini")
    model = TModel(cfg, device="cpu")
    fields = convert.state_to_numpy(model.initial_state())
    forcing = convert.state_to_numpy(model.forcing)
    if torch.cuda.is_available():
        assert convert.state_from_numpy(fields, cfg).u_cur.is_cuda
        assert convert.forcing_from_numpy(forcing, cfg).stf.is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            convert.state_from_numpy(fields, cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            convert.forcing_from_numpy(forcing, cfg)


@pytest.mark.parametrize("over", [
    dict(tadvect="lw_lim"),
    dict(hmix_tracer="gm", gm_aniso="flow", gm_transition_layer=False),
    dict(partial_bottom_cells=True),
    dict(sw_absorption="chlorophyll", chl_option="file"),
    dict(lestuary_exch=True),
    dict(passive_tracers=("ecosys", "abio_dic"), nt=36,
         sw_absorption="chlorophyll", chl_option="model")],
    ids=["lw_lim", "gm_aniso_flow", "partial_bottom_cells", "chl_file",
         "lestuary_exch", "ecosys"])
def test_switches_ported_since_construct_and_step(over):
    """Once refused at construction (ROADMAP.md Queue 1 items 11b, 11c,
    11d, 11f): lw_lim advection, anisotropic GM, partial bottom cells, the
    chlorophyll of the forcing, the estuary exchange and the ecosystem with
    the abiotic DIC and the model's chlorophyll now construct and step
    (their values are held against the JAX package in
    test_torch_advect_eos.py, test_torch_gm_menu.py, test_torch_pbc.py,
    test_torch_forcing.py and test_torch_bgc.py; without the forcing's
    chlorophyll or runoff the constant chlorophyll is used and no exchange
    runs, as in the JAX package)."""
    model = TModel(t_get_config("mini", **over), device="cpu")
    state, _ = model.advance(model.initial_state())
    assert all(bool(torch.isfinite(t).all()) for _, t in state.leaves())


@pytest.mark.parametrize("over,error,names", [
    (dict(mesh_shape=(2, 2)), RuntimeError, "initialize_distributed"),
    (dict(mesh_shape=(1, 5)), ValueError, "nx=32"),
])
def test_unported_switches_raise_at_construction(over, error, names):
    """A 2-D mesh is carried (``supported`` names nothing). A model on one
    needs blocks of equal columns: without them it raises at construction,
    naming what is missing. Without a process group the blocks run in this
    process (``MeshModel``); what needs the ranks' process group
    (``multihost.local_device``) still raises, naming
    ``initialize_distributed``."""
    cfg = t_get_config("mini", **over)
    assert not supported.unsupported(cfg)
    if error is RuntimeError:
        from pop2_tpu_torch.model import MeshModel
        from pop2_tpu_torch.parallel import multihost
        assert isinstance(TModel(cfg, device="cpu"), MeshModel)
        with pytest.raises(error, match=names):
            multihost.local_device()
        return
    with pytest.raises(error, match=names):
        TModel(cfg, device="cpu")
