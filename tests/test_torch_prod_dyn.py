"""The production dynamics menu (prod_dyn) as a whole: the port's ``Model``
against ``pop2_tpu.model.Model`` on the CPU in float64.

prod_dyn is the production gx1v7 preset without KPP, tidal mixing, the
submesoscale scheme and passive tracers (prod_mix adds the first three:
tests/test_torch_prod_mix.py): tripole north edge, upwind3 advection, anisotropic
'east' viscosity, GM with bfre diffusivities and the transition layer,
chlorophyll shortwave, frazil ice, the Robert filter, PCSI at 1e-13 with the
FSPAI preconditioner. It runs at small sizes on two grids:

  (a) the internal tripole grid at 32 x 16 x 6 (its two top rows are land);
  (b) a file grid of 32 x 12 x 6 with ocean across the fold (the grid of
      tests/test_tripole_model.py), built by the JAX package and handed to
      the port as NumPy leaves (``convert.grid_from_numpy``).

Both packages step from the same state: the JAX package's state of rest with
seeded noise in T and a surface layer below freezing on a third of the
points, under the analytic forcing with a seeded shortwave flux, so that GM,
the shortwave heating and frazil ice all act. Bands, relative to each
field's maximum (PARITY.md): 1e-11 after the first step, 1e-7 after five.
Turning the Robert filter or frazil ice off moves the five-step result
beyond the band. The FSPAI preconditioner changes a converged solve only at
the solver's tolerance, so it is shown at a fixed budget of iterations that
stops short of convergence: there the preconditioner decides the result, and
the port with FSPAI matches the JAX package with it.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

jax.config.update("jax_enable_x64", True)

from pop2_tpu import eos as jeos  # noqa: E402
from pop2_tpu.config import get_config  # noqa: E402
from pop2_tpu.grid import build_grid as j_build_grid  # noqa: E402
from pop2_tpu.io import grid_files  # noqa: E402
from pop2_tpu.model import Model as JModel  # noqa: E402

from pop2_tpu_torch import convert, supported  # noqa: E402
from pop2_tpu_torch.config import get_config as t_get_config  # noqa: E402
from pop2_tpu_torch.model import Model as TModel  # noqa: E402

from tests.test_tripole_model import _half_raw  # noqa: E402
from tests.torch_port_helpers import jax_leaves, torch_cfg  # noqa: E402

PROD_DYN = dict(vmix="rich", ltidal_mixing=False, lsubmeso=False,
                passive_tracers=(), nt=2)
FIELDS = ("u_cur", "v_cur", "tracer_cur", "psurf_cur", "ubtrop_cur",
          "vbtrop_cur")
NSTEPS = 5


def _file_grid_cfg(tmp):
    """prod_dyn on the file grid with ocean across the fold: (JAX config,
    the port's config naming the internal generators, which the port's
    supported check asks for; the grid itself is handed over)."""
    raw = _half_raw()
    ny, nx = raw["KMT"].shape
    km = int(raw["KMT"].max())
    hg, vg, tp = (str(tmp / n) for n in ("hg", "vg", "topo"))
    grid_files.write_horiz_grid(hg, raw)
    grid_files.write_topography(tp, raw["KMT"])
    grid_files.write_vert_grid(vg, np.full(km, 5.0e4))
    jcfg = get_config("prod_full", nx=nx, ny=ny, km=km, horiz_grid="file",
                      horiz_grid_file=hg, vert_grid="file",
                      vert_grid_file=vg, topography="file",
                      topography_file=tp, **PROD_DYN)
    tcfg = torch_cfg(jcfg).with_(horiz_grid="internal",
                                 vert_grid="uniform", topography="internal")
    return jcfg, tcfg


class Run:
    """One prod_dyn configuration in both packages from the same state."""

    def __init__(self, jcfg, tcfg, fold_grid):
        self.jcfg, self.tcfg = jcfg, tcfg
        self.jm = JModel(jcfg)
        self.tgrid = (convert.grid_from_numpy(jax_leaves(self.jm.grid), tcfg,
                                              "cpu") if fold_grid else None)
        g = self.jm.grid
        mt = np.asarray(g.kmask_t)
        if fold_grid:
            assert mt[0, -2:].mean() > 0.9  # ocean across the fold
        rng = np.random.RandomState(7)
        leaves = jax_leaves(self.jm.initial_state())
        tr = leaves["tracer_cur"].copy()
        tr[0] += 0.1 * rng.randn(*tr[0].shape) * mt
        cold = rng.rand(*tr[0, 0].shape) < 0.3
        tr[0, 0] = np.where(mt[0], np.where(cold, -2.5, tr[0, 0]), 0.0)
        rho = np.asarray(jnp.where(g.kmask_t, jeos.state(
            jcfg, g.vgrid.pressz, jnp.asarray(tr[0]), jnp.asarray(tr[1]),
            self.jm.ts_range), 0.0))
        leaves.update(tracer_cur=tr, tracer_old=tr, rho_cur=rho,
                      rho_old=rho)
        self.leaves = leaves
        self.qsw = 200.0 * np.abs(rng.randn(*mt.shape[1:])) * mt[0]
        self.jsteps = self.run_jax(self.jm)

    def run_jax(self, jm):
        state = jm.initial_state().replace(
            **{k: jnp.asarray(self.leaves[k]) for k in
               ("tracer_cur", "tracer_old", "rho_cur", "rho_old")})
        forcing = jm.forcing.replace(shf_qsw=jnp.asarray(self.qsw))
        out = []
        for _ in range(NSTEPS):
            state, _ = jm.advance(state, forcing)
            out.append(jax_leaves(state))
        return out

    def run_port(self, tcfg=None):
        tcfg = tcfg or self.tcfg
        tm = TModel(tcfg, grid=self.tgrid, device="cpu")
        state = convert.state_from_numpy(self.leaves, tcfg, "cpu")
        forcing = tm.forcing.replace(shf_qsw=torch.as_tensor(self.qsw))
        out, iters = [], []
        for _ in range(NSTEPS):
            state, diags = tm.advance(state, forcing)
            out.append(state)
            iters.append(diags.solver_iters)
        return out, iters


def _rel(state, want):
    return {k: float(np.abs(getattr(state, k).numpy() - want[k]).max()
                     / (np.abs(want[k]).max() or 1.0)) for k in FIELDS}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    internal = get_config("prod_full", nx=32, ny=16, km=6,
                          vert_grid="uniform", **PROD_DYN)
    fold_j, fold_t = _file_grid_cfg(tmp_path_factory.mktemp("prod_dyn"))
    out = {}
    for name, jcfg, tcfg, fold_grid in (
            ("internal", internal, torch_cfg(internal), False),
            ("fold", fold_j, fold_t, True)):
        r = Run(jcfg, tcfg, fold_grid)
        r.tsteps, r.titers = r.run_port()
        out[name] = r
    return out


@pytest.mark.parametrize("grid", ["internal", "fold"])
def test_prod_dyn_step1_machine_precision(runs, grid):
    r = runs[grid]
    diffs = _rel(r.tsteps[0], r.jsteps[0])
    assert max(diffs.values()) <= 1e-11, diffs


@pytest.mark.parametrize("grid", ["internal", "fold"])
def test_prod_dyn_step5_parity(runs, grid):
    r = runs[grid]
    diffs = _rel(r.tsteps[-1], r.jsteps[-1])
    assert max(diffs.values()) <= 1e-7, diffs
    for s in r.tsteps:  # the fold's degenerate top U row stays symmetric
        top = s.u_cur[:, -1].numpy()
        np.testing.assert_array_equal(
            np.abs(top), np.abs(np.roll(top[:, ::-1], -1, axis=-1)))


@pytest.mark.parametrize("grid", ["internal", "fold"])
@pytest.mark.parametrize("switch", ["robert", "ice"])
def test_switch_changes_the_result(runs, grid, switch):
    r = runs[grid]
    time = dataclasses.replace(r.tcfg.time, time_mix_opt="avg")
    off = {"robert": r.tcfg.with_(time=time),
           "ice": r.tcfg.with_(liceform=False)}[switch]
    steps, _ = r.run_port(off)
    assert max(_rel(steps[-1], r.jsteps[-1]).values()) > 1e-7


def test_fspai_decides_a_budgeted_solve(runs):
    """PCSI stopped at 20 iterations, before its first convergence check:
    the port with FSPAI matches the JAX package with FSPAI; the port with
    the diagonal preconditioner does not."""
    r = runs["fold"]
    budget = dict(max_iterations=20, convergence_check_start=60)
    jcfg = r.jcfg.with_(solver=dataclasses.replace(r.jcfg.solver, **budget))
    tcfg = r.tcfg.with_(solver=dataclasses.replace(r.tcfg.solver, **budget))
    want = r.run_jax(JModel(jcfg, grid=r.jm.grid))
    got, iters = r.run_port(tcfg)
    assert iters == [20] * NSTEPS
    assert max(_rel(got[-1], want[-1]).values()) <= 1e-7
    diag = tcfg.with_(solver=dataclasses.replace(tcfg.solver,
                                                 preconditioner="diagonal"))
    plain, _ = r.run_port(diag)
    assert max(_rel(plain[-1], want[-1]).values()) > 1e-7


def test_prod_dyn_builds_and_what_stays_refused():
    cfg = t_get_config("prod_full", nx=32, ny=16, km=6, vert_grid="uniform",
                       **PROD_DYN)
    assert supported.unsupported(cfg) == []
    assert TModel(cfg, device="cpu").precond is not None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TModel(cfg)
    # the full preset, and GM without the transition layer on the tripole
    # grid (the flux-assembly kernel's tripole row), are carried
    # (tests/test_torch_prod_full.py)
    assert supported.unsupported(t_get_config("prod_full")) == []
    assert supported.unsupported(cfg.with_(gm_transition_layer=False)) == []
