"""The production menu less passive tracers (prod_mix) as a whole: the
port's ``Model`` against ``pop2_tpu.model.Model`` on the CPU in float64.

prod_mix is ``get_config("prod_full", passive_tracers=(), nt=2)``: the
production gx1v7 menu of the JAX package with only its two passive tracers
left out. Over prod_dyn (``test_torch_prod_dyn.py``) it adds KPP (double
diffusion, the shortwave term of the boundary-layer depth, the horizontally
varying background), Jayne tidal mixing inside KPP's interior mixing, and
the submesoscale scheme folded into the GM chain, whose transition layer
now starts at KPP's boundary layer. It runs on two grids, both with 10
levels 10 m thick at the surface and growing by half a level each, so that
the boundary layer spans several levels:

  (a) the internal tripole grid at 32 x 16 (its two top rows are land);
  (b) a file grid of 32 x 12 with ocean across the fold (the grid of
      tests/test_tripole_model.py, its deep columns 10 levels deep).

Both grids are built by the JAX package and handed to the port as NumPy
leaves (``convert.grid_from_numpy``). Both packages step from the same
state (the JAX package's state of rest with seeded noise in T and a surface
layer below freezing on a third of the points) under the analytic wind
stress with a seeded shortwave flux and a surface heat flux that cools part
of the points (so that KPP's convective branches and non-local source act).
Bands, relative to each field's maximum (PARITY.md): 1e-11 after the first
step, 1e-7 after five. Turning KPP (back to Richardson mixing) or the
submesoscale scheme off moves the five-step result beyond the band;
turning tidal mixing off moves KPP's diffusivities beyond it.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

jax.config.update("jax_enable_x64", True)

from pop2_tpu import eos as jeos  # noqa: E402
from pop2_tpu.config import get_config  # noqa: E402
from pop2_tpu.io import grid_files  # noqa: E402
from pop2_tpu.model import Model as JModel  # noqa: E402

from pop2_tpu_torch import convert, supported, vmix  # noqa: E402
from pop2_tpu_torch.config import get_config as t_get_config  # noqa: E402
from pop2_tpu_torch.model import Model as TModel  # noqa: E402

from tests.test_tripole_model import _half_raw  # noqa: E402
from tests.torch_port_helpers import (jax_leaves, stretched_pair,  # noqa: E402
                                      torch_cfg)

PROD_MIX = dict(passive_tracers=(), nt=2)
KM = 10
FIELDS = ("u_cur", "v_cur", "tracer_cur", "psurf_cur", "ubtrop_cur",
          "vbtrop_cur")
NSTEPS = 5


def _file_grid_cfg(tmp):
    """prod_mix on the file grid with ocean across the fold: (JAX config,
    the port's config naming the internal generators)."""
    raw = _half_raw()
    raw["KMT"] = np.where(raw["KMT"] == raw["KMT"].max(), KM, raw["KMT"])
    ny, nx = raw["KMT"].shape
    hg, vg, tp = (str(tmp / n) for n in ("hg", "vg", "topo"))
    grid_files.write_horiz_grid(hg, raw)
    grid_files.write_topography(tp, raw["KMT"])
    grid_files.write_vert_grid(vg, 1000.0 * 1.5 ** np.arange(KM))
    jcfg = get_config("prod_full", nx=nx, ny=ny, km=KM, horiz_grid="file",
                      horiz_grid_file=hg, vert_grid="file",
                      vert_grid_file=vg, topography="file",
                      topography_file=tp, **PROD_MIX)
    tcfg = torch_cfg(jcfg).with_(horiz_grid="internal",
                                 vert_grid="uniform", topography="internal")
    return jcfg, tcfg


class Run:
    """One prod_mix configuration in both packages from the same state."""

    def __init__(self, jcfg, tcfg, fold_grid):
        self.jcfg, self.tcfg = jcfg, tcfg
        self.jm = JModel(jcfg)
        self.tgrid = convert.grid_from_numpy(jax_leaves(self.jm.grid), tcfg,
                                             "cpu")
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
        self.qsw = 2.0e-4 * np.abs(rng.randn(*mt.shape[1:])) * mt[0]
        # a heat flux (degC cm/s) that cools 40 % of the points
        heat = 5.0e-4 * np.abs(rng.randn(*mt.shape[1:]))
        cool = rng.rand(*mt.shape[1:]) < 0.4
        self.stf = np.stack([np.where(cool, -heat, 0.2 * heat),
                             np.zeros_like(heat)]) * mt[0]
        self.jsteps = self.run_jax(self.jm)

    def run_jax(self, jm):
        state = jm.initial_state().replace(
            **{k: jnp.asarray(self.leaves[k]) for k in
               ("tracer_cur", "tracer_old", "rho_cur", "rho_old")})
        forcing = jm.forcing.replace(shf_qsw=jnp.asarray(self.qsw),
                                     stf=jnp.asarray(self.stf))
        out = []
        for _ in range(NSTEPS):
            state, _ = jm.advance(state, forcing)
            out.append(jax_leaves(state))
        return out

    def port_model(self, tcfg=None):
        tm = TModel(tcfg or self.tcfg, grid=self.tgrid, device="cpu")
        forcing = tm.forcing.replace(shf_qsw=torch.as_tensor(self.qsw),
                                     stf=torch.as_tensor(self.stf))
        return tm, forcing

    def run_port(self, tcfg=None):
        tm, forcing = self.port_model(tcfg)
        state = convert.state_from_numpy(self.leaves, tm.cfg, "cpu")
        out, diags = [], []
        for _ in range(NSTEPS):
            state, d = tm.advance(state, forcing)
            out.append(state)
            diags.append(d)
        return out, diags


def _rel(state, want):
    return {k: float(np.abs(getattr(state, k).numpy() - want[k]).max()
                     / (np.abs(want[k]).max() or 1.0)) for k in FIELDS}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("prod_mix")
    internal, t_internal, _, _ = stretched_pair(
        get_config("prod_full", nx=32, ny=16, km=KM, **PROD_MIX), tmp)
    fold_j, fold_t = _file_grid_cfg(tmp)
    out = {}
    for name, jcfg, tcfg, fold_grid in (
            ("internal", internal, t_internal, False),
            ("fold", fold_j, fold_t, True)):
        r = Run(jcfg, tcfg, fold_grid)
        r.tsteps, r.tdiags = r.run_port()
        out[name] = r
    return out


@pytest.mark.parametrize("grid", ["internal", "fold"])
def test_prod_mix_step1_machine_precision(runs, grid):
    r = runs[grid]
    diffs = _rel(r.tsteps[0], r.jsteps[0])
    assert max(diffs.values()) <= 1e-11, diffs
    # KPP's depths reach the step diagnostics; the boundary layer spans
    # several levels
    d = r.tdiags[0]
    zt = r.tgrid.vgrid.zt
    ocean = r.tgrid.KMT > 0
    assert d.hblt is not None and d.hmxl is not None
    assert float(d.hblt[ocean].max()) > float(zt[2])


@pytest.mark.parametrize("grid", ["internal", "fold"])
def test_prod_mix_step5_parity(runs, grid):
    r = runs[grid]
    diffs = _rel(r.tsteps[-1], r.jsteps[-1])
    assert max(diffs.values()) <= 1e-7, diffs
    for s in r.tsteps:  # the fold's degenerate top U row stays symmetric
        top = s.u_cur[:, -1].numpy()
        np.testing.assert_array_equal(
            np.abs(top), np.abs(np.roll(top[:, ::-1], -1, axis=-1)))


@pytest.mark.parametrize("switch", ["kpp", "submeso"])
def test_switch_changes_the_result(runs, switch):
    r = runs["internal"]
    off = {"kpp": r.tcfg.with_(vmix="rich"),
           "submeso": r.tcfg.with_(lsubmeso=False)}[switch]
    steps, _ = r.run_port(off)
    assert max(_rel(steps[-1], r.jsteps[-1]).values()) > 1e-7


def test_tidal_mixing_changes_the_diffusivities(runs):
    """Jayne tidal mixing adds to KPP's interior diffusivity: without it the
    diffusivities of the first step's mixing differ beyond the band."""
    r = runs["internal"]
    state = convert.state_from_numpy(r.leaves, r.tcfg, "cpu")
    got = []
    for tcfg in (r.tcfg, r.tcfg.with_(ltidal_mixing=False)):
        tm, forcing = r.port_model(tcfg)
        got.append(vmix.vmix_coeffs(
            tcfg, tm.grid, tm.bc, state.tracer_cur, state.u_cur,
            state.v_cur, state.rho_cur, forcing=forcing,
            kpp_statics=tm.kpp_statics, chl=torch.full_like(
                forcing.shf_qsw, tcfg.chl_const)).vdc)
    rel = float((got[0] - got[1]).abs().max() / got[0].abs().max())
    assert rel > 1e-7


def test_prod_mix_builds_and_what_stays_refused():
    cfg = t_get_config("prod_full", nx=32, ny=16, km=KM, vert_grid="uniform",
                       **PROD_MIX)
    assert supported.unsupported(cfg) == []
    assert TModel(cfg, device="cpu").kpp_statics is not None
    # the full preset with its passive tracers is carried too
    # (tests/test_torch_prod_full.py)
    assert supported.unsupported(t_get_config("prod_full")) == []
    # the rest of vertical mixing and the GM variants are carried
    # (tests/test_torch_vmix_menu.py, tests/test_torch_gm_menu.py)
    for c in (cfg.with_(tidal_mixing_method="polzin"),
              cfg.with_(tidal_mixing_method="schmittner"),
              cfg.with_(ltidal_lunar_cycle=True),
              cfg.with_(lniw_mixing=True),
              cfg.with_(gm_aniso="flow", gm_transition_layer=False),
              cfg.with_(gm_kappa_isop_type="vmhs",
                        gm_kappa_thic_type="vmhs")):
        assert supported.unsupported(c) == []
