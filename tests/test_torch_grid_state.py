"""The PyTorch port's grid, initial state, forcing, equation of state and
stencil operators against the JAX package's, leaf for leaf, on the CPU in
float64 from the same config and the same NumPy inputs."""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

jax.config.update("jax_enable_x64", True)

from pop2_tpu import eos as jeos, stencil as jst  # noqa: E402
from pop2_tpu.config import get_config  # noqa: E402
from pop2_tpu.forcing import analytic_forcing as j_forcing  # noqa: E402
from pop2_tpu.grid import build_grid as j_build_grid  # noqa: E402
from pop2_tpu.state import initial_state as j_initial_state  # noqa: E402

from pop2_tpu_torch import eos as teos, stencil as tst  # noqa: E402
from pop2_tpu_torch.forcing import analytic_forcing as t_forcing  # noqa: E402
from pop2_tpu_torch.grid import build_grid as t_build_grid  # noqa: E402
from pop2_tpu_torch.state import initial_state as t_initial_state  # noqa: E402

from tests.torch_port_helpers import (assert_leaves_close, jax_leaves,  # noqa: E402
                                      torch_cfg)

CONFIGS = {
    "mini": dict(),
    # other dims, topography smoothing pass, closed east-west, constant f
    "closed": dict(nx=40, ny=24, km=10, flat_bottom=False, n_topo_smooth=2,
                  ew_boundary="closed", lconst_coriolis=True),
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    jcfg = get_config("mini", **CONFIGS[request.param])
    tcfg = torch_cfg(jcfg)
    return jcfg, j_build_grid(jcfg), tcfg, t_build_grid(tcfg, "cpu")


def test_grid_leaves_equal(pair):
    jcfg, jgrid, tcfg, tgrid = pair
    tl = tgrid.leaves()
    assert len(tl) >= 78
    assert_leaves_close(tl, jax_leaves(jgrid), rtol=1e-14)


_JAX_STATES = """
import json, sys
import jax
import numpy as np
jax.config.update("jax_enable_x64", True)
from pop2_tpu.config import get_config
from pop2_tpu.grid import build_grid
from pop2_tpu.state import initial_state
from tests.torch_port_helpers import jax_leaves
arrays = {}
for name, over in json.loads(sys.argv[1]).items():
    cfg = get_config("mini", **over)
    for key, a in jax_leaves(initial_state(cfg, build_grid(cfg))).items():
        arrays[name + "/" + key] = a
np.savez(sys.argv[2], **arrays)
"""


@pytest.fixture(scope="module")
def jax_states(tmp_path_factory):
    """The JAX package's initial state of every config, {name: {leaf:
    array}}, computed in a fresh interpreter with JAX's persistent
    compilation cache off. The state's density is compiled XLA code; in the
    test suite's multi-process runs that cache is shared by every worker,
    and an entry written elsewhere (or a worker lost while loading one)
    must not decide this comparison."""
    out = tmp_path_factory.mktemp("jax_states") / "states.npz"
    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, JAX_ENABLE_COMPILATION_CACHE="false",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(root)] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    res = subprocess.run(
        [sys.executable, "-c", _JAX_STATES, json.dumps(CONFIGS), str(out)],
        cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    data = np.load(out)
    states = {}
    for key in data.files:
        name, leaf = key.split("/", 1)
        states.setdefault(name, {})[leaf] = data[key]
    return states


def _density_sides(tgrid, ts, jleaves):
    """Which side's density lies off the NumPy oracle's (the reference's
    MWJF, ``tests/reference_oracle/ogrid.state_mwjf``) on the port's
    tracers: a line per density leaf with each side's largest difference
    from the oracle over its scale (the oracle clamps T and S to its own
    fixed range, the packages to theirs: equal away from the clamps)."""
    from tests.reference_oracle import ogrid
    trc = ts.tracer_cur.numpy()
    pz = tgrid.vgrid.pressz.numpy().reshape(-1, 1, 1)
    mask = tgrid.kmask_t.numpy()
    oracle = np.where(mask, ogrid.state_mwjf(trc[0], trc[1], pz), 0.0)
    scale = np.abs(oracle).max()
    lines = []
    for leaf in ("rho_old", "rho_cur"):
        port = getattr(ts, leaf).numpy()
        lines.append(
            f"{leaf}: port off the oracle by "
            f"{np.abs(port - oracle).max() / scale:.3e}, JAX by "
            f"{np.abs(jleaves[leaf] - oracle).max() / scale:.3e} of scale")
    return "\n".join(lines)


def test_initial_state_leaves_equal(pair, jax_states, request):
    _, _, tcfg, tgrid = pair
    name = request.node.callspec.params["pair"]
    ts = t_initial_state(tcfg, tgrid)
    try:
        assert_leaves_close(ts.leaves(), jax_states[name], rtol=1e-14)
    except AssertionError as err:
        # say which side moved (ROADMAP.md Queue 3, F1)
        raise AssertionError(
            f"{err}\n{_density_sides(tgrid, ts, jax_states[name])}") \
            from None


def test_analytic_forcing_leaves_equal(pair):
    jcfg, jgrid, tcfg, tgrid = pair
    assert_leaves_close(t_forcing(tcfg, tgrid).leaves(),
                        jax_leaves(j_forcing(jcfg, jgrid)), rtol=1e-14)


def test_float32_grid_is_rounded_float64(pair):
    jcfg, _, tcfg, tgrid = pair
    g32 = t_build_grid(tcfg.with_(dtype="float32"), "cpu")
    assert g32.DXU.dtype == torch.float32 and g32.KMT.dtype == torch.int32
    np.testing.assert_array_equal(g32.DXU.numpy(),
                                  tgrid.DXU.numpy().astype(np.float32))


def _ts(seed, shape=(10, 6, 8)):
    rng = np.random.RandomState(seed)
    T = rng.uniform(-2.0, 30.0, shape)
    S = rng.uniform(0.030, 0.038, shape)
    p = np.linspace(0.0, 550.0, shape[0])
    return T, S, p


@pytest.mark.parametrize("choice", ["mwjf", "jmcd", "linear"])
@pytest.mark.parametrize("enforce", [True, False])
def test_eos_state_matches(choice, enforce):
    T, S, p = _ts(3)
    jcfg = get_config("mini", km=10, state_choice=choice,
                      state_range_opt="enforce" if enforce else "ignore")
    tcfg = torch_cfg(jcfg)
    zt = np.linspace(250.0, 540000.0, 10)
    jr = jeos.build_ts_range(zt, jnp.float64) if enforce else None
    tr = teos.build_ts_range(zt, torch.float64) if enforce else None
    want = jeos.state(jcfg, jnp.asarray(p), jnp.asarray(T), jnp.asarray(S),
                      jr, want_drhodt=True, want_drhods=True)
    got = teos.state(tcfg, torch.as_tensor(p), torch.as_tensor(T),
                     torch.as_tensor(S), tr, want_drhodt=True,
                     want_drhods=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-13,
                                   atol=0)
    # single-level displaced form used by convective adjustment
    w1 = jeos.state_at_level(jcfg, p[3], jnp.asarray(T[2]), jnp.asarray(S[2]))
    g1 = teos.state_at_level(tcfg, float(p[3]), torch.as_tensor(T[2]),
                             torch.as_tensor(S[2]))
    np.testing.assert_allclose(g1.numpy(), np.asarray(w1), rtol=1e-13, atol=0)


def test_mwjf_reference_value():
    rho = teos.mwjf_rho(torch.tensor(20.0, dtype=torch.float64),
                        torch.tensor(0.035, dtype=torch.float64),
                        torch.tensor(200.0, dtype=torch.float64))
    # the reference quotes 1.033213242 (source/state_mod.F90:414) and
    # 1.033213387 (:786) for these inputs; same band as tests/test_eos.py
    assert abs(float(rho) - 1.033213242) < 5e-7


@pytest.mark.parametrize("ew", ["cyclic", "closed"])
def test_stencil_ops_exact(ew):
    rng = np.random.RandomState(5)
    f = rng.randn(3, 12, 16)
    g = rng.randn(3, 12, 16)
    m2 = [rng.rand(12, 16) + 0.5 for _ in range(4)]
    mask = rng.rand(12, 16) > 0.3
    jbc, tbc = jst.BC(ew, "closed"), tst.BC(ew, "closed")
    tf, tg = torch.as_tensor(f), torch.as_tensor(g)
    tm = [torch.as_tensor(a) for a in m2]
    for name in ("e", "w", "n", "s", "ne", "nw", "se", "sw"):
        np.testing.assert_array_equal(
            getattr(tbc, name)(tf).numpy(),
            np.asarray(getattr(jbc, name)(jnp.asarray(f))), err_msg=name)
    for name in ("div", "zcurl"):
        want = getattr(jst, name)(jnp.asarray(f), jnp.asarray(g), m2[0],
                                  m2[1], mask, jbc)
        got = getattr(tst, name)(tf, tg, tm[0], tm[1],
                                 torch.as_tensor(mask), tbc)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), name)
    want = jst.grad(jnp.asarray(f), m2[0], m2[1], mask, jbc)
    got = tst.grad(tf, tm[0], tm[1], torch.as_tensor(mask), tbc)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    want = jst.tgrid_to_ugrid(jnp.asarray(f), *m2, jbc)
    np.testing.assert_array_equal(
        tst.tgrid_to_ugrid(tf, *tm, tbc).numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tst.ugrid_to_tgrid(tf, tbc).numpy(),
        np.asarray(jst.ugrid_to_tgrid(jnp.asarray(f), jbc)))


def test_tripole_grid_and_state_leaves_equal():
    """The tripole fold in the grid and the initial state (the fold's own
    primitives and shifts: tests/test_torch_tripole.py)."""
    jcfg = get_config("mini", ns_boundary="tripole", flat_bottom=False)
    tcfg = torch_cfg(jcfg)
    jgrid, tgrid = j_build_grid(jcfg), t_build_grid(tcfg, "cpu")
    assert tst.BC("cyclic", "tripole").ns == "tripole"
    assert_leaves_close(tgrid.leaves(), jax_leaves(jgrid), rtol=1e-14)
    assert_leaves_close(t_initial_state(tcfg, tgrid).leaves(),
                        jax_leaves(j_initial_state(jcfg, jgrid)), rtol=1e-14)


def test_port_imports_nothing_of_jax():
    """Importing every module of the port leaves jax, flax and the JAX
    package out of sys.modules (checked in a fresh interpreter)."""
    code = (
        "import sys, pkgutil, importlib, pop2_tpu_torch\n"
        "for m in pkgutil.iter_modules(pop2_tpu_torch.__path__):\n"
        "    importlib.import_module('pop2_tpu_torch.' + m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'pop2_tpu')]\n"
        "assert not bad, bad\n"
        "assert len(list(pkgutil.iter_modules(pop2_tpu_torch.__path__))) "
        ">= 20\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
