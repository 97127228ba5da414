"""The whole production configuration (prod_full) as a whole: the port's
``Model`` against ``pop2_tpu.model.Model`` on the CPU in float64.

prod_full is ``get_production_config()``, the JAX package's flagship where
the reference's input templates are absent: ``get_config("prod_full")``,
nt = 5 (T, S, the ideal age and CFC-11 and CFC-12). Over prod_mix
(``test_torch_prod_mix.py``) it adds the passive tracers: their surface gas
exchange under a 10-m wind (``Forcing.u10_sqr``; without it the CFC fluxes
are zero), the ideal age's interior source and surface reset, and the
implicit solves of more than two tracers on one factorisation (four on the
Euler step, three in the leapfrog corrector). It runs on the two grids of
prod_mix: the internal tripole grid at 32 x 16 and a file grid with ocean
across the fold, both with 10 levels 10 m thick at the surface growing by
half a level each. Both packages step from the same state (noise in T, a
third of the surface below freezing, a seeded ideal age) under a heat flux
that cools part of the points. Bands, relative to each field's largest
value and for the tracers to each tracer's own (PARITY.md): 1e-11 after the
first step, 1e-7 after five. The path without the transition layer, which
runs the flux-assembly kernel's tripole row, is
``test_torch_prod_flux.py``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

jax.config.update("jax_enable_x64", True)

from pop2_tpu import eos as jeos  # noqa: E402
from pop2_tpu import production as jproduction  # noqa: E402
from pop2_tpu.config import get_config  # noqa: E402
from pop2_tpu.io import grid_files  # noqa: E402
from pop2_tpu.model import Model as JModel  # noqa: E402

from pop2_tpu_torch import convert, production, supported  # noqa: E402
from pop2_tpu_torch.model import Model as TModel  # noqa: E402

from tests.test_tripole_model import _half_raw  # noqa: E402
from tests.torch_port_helpers import (jax_leaves, stretched_pair,  # noqa: E402
                                      torch_cfg)

KM = 10
FIELDS = ("u_cur", "v_cur", "psurf_cur", "ubtrop_cur", "vbtrop_cur")
NSTEPS = 5
U10_SQR = 4.9e5  # cm^2/s^2: a 7 m/s wind


def file_grid_cfg(tmp, **over):
    """The production preset on the file grid with ocean across the fold:
    (JAX config, the port's config naming the internal generators)."""
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
                      topography_file=tp, **over)
    tcfg = torch_cfg(jcfg).with_(horiz_grid="internal",
                                 vert_grid="uniform", topography="internal")
    return jcfg, tcfg


class ProdRun:
    """One production configuration in both packages from the same state
    and forcing, NSTEPS steps of the JAX package's at construction."""

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
        tr[2] = 10.0 * rng.rand(*tr[2].shape) * mt  # an ideal age, years
        rho = np.asarray(jnp.where(g.kmask_t, jeos.state(
            jcfg, g.vgrid.pressz, jnp.asarray(tr[0]), jnp.asarray(tr[1]),
            self.jm.ts_range), 0.0))
        leaves.update(tracer_cur=tr, tracer_old=tr, rho_cur=rho,
                      rho_old=rho)
        self.leaves = leaves
        shape = mt.shape[1:]
        self.qsw = 2.0e-4 * np.abs(rng.randn(*shape)) * mt[0]
        heat = 5.0e-4 * np.abs(rng.randn(*shape))
        cool = rng.rand(*shape) < 0.4
        self.stf = np.zeros((jcfg.nt,) + shape)
        self.stf[0] = np.where(cool, -heat, 0.2 * heat) * mt[0]
        self.gas = dict(u10_sqr=np.full(shape, U10_SQR),
                        ifrac=np.zeros(shape))
        self.jsteps = self.run_jax()

    def run_jax(self):
        jm = self.jm
        state = jm.initial_state().replace(
            **{k: jnp.asarray(self.leaves[k]) for k in
               ("tracer_cur", "tracer_old", "rho_cur", "rho_old")})
        forcing = jm.forcing.replace(
            shf_qsw=jnp.asarray(self.qsw), stf=jnp.asarray(self.stf),
            **{k: jnp.asarray(v) for k, v in self.gas.items()})
        out = []
        for _ in range(NSTEPS):
            state, _ = jm.advance(state, forcing)
            out.append(jax_leaves(state))
        return out

    def run_port(self):
        tm = TModel(self.tcfg, grid=self.tgrid, device="cpu")
        forcing = tm.forcing.replace(
            shf_qsw=torch.as_tensor(self.qsw), stf=torch.as_tensor(self.stf),
            **{k: torch.as_tensor(v) for k, v in self.gas.items()})
        state = convert.state_from_numpy(self.leaves, tm.cfg, "cpu")
        out = []
        for _ in range(NSTEPS):
            state, _ = tm.advance(state, forcing)
            out.append(state)
        return out


def rel_diffs(state, want):
    """Each field's largest difference over its largest value; each tracer
    on its own scale."""
    out = {k: float(np.abs(getattr(state, k).numpy() - want[k]).max()
                    / (np.abs(want[k]).max() or 1.0)) for k in FIELDS}
    got, w = state.tracer_cur.numpy(), want["tracer_cur"]
    for n in range(w.shape[0]):
        out[f"tracer{n}"] = float(np.abs(got[n] - w[n]).max()
                                  / (np.abs(w[n]).max() or 1.0))
    return out


def make_runs(tmp, **over):
    """{grid: ProdRun} on the internal tripole grid and the file grid, the
    port's steps taken."""
    internal, t_internal, _, _ = stretched_pair(
        get_config("prod_full", nx=32, ny=16, km=KM, **over), tmp)
    fold_j, fold_t = file_grid_cfg(tmp, **over)
    out = {}
    for name, jcfg, tcfg, fold_grid in (
            ("internal", internal, t_internal, False),
            ("fold", fold_j, fold_t, True)):
        r = ProdRun(jcfg, tcfg, fold_grid)
        r.tsteps = r.run_port()
        out[name] = r
    return out


def check_step1(r):
    assert r.jcfg.nt == 5 and r.tcfg.passive_tracers == ("iage", "cfc")
    diffs = rel_diffs(r.tsteps[0], r.jsteps[0])
    assert max(diffs.values()) <= 1e-11, diffs
    tr = r.tsteps[0].tracer_cur
    # the gas exchange filled the CFC surface; the ideal age's surface is
    # reset to zero and its interior aged
    assert float(tr[3, 0].abs().max()) > 0.0
    assert float(tr[4, 0].abs().max()) > 0.0
    assert float(tr[2, 0].abs().max()) == 0.0
    assert float(tr[2, 1:].max()) > 0.0


def check_step5(r):
    diffs = rel_diffs(r.tsteps[-1], r.jsteps[-1])
    assert max(diffs.values()) <= 1e-7, diffs
    for s in r.tsteps:  # the fold's degenerate top U row stays symmetric
        top = s.u_cur[:, -1].numpy()
        np.testing.assert_array_equal(
            np.abs(top), np.abs(np.roll(top[:, ::-1], -1, axis=-1)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return make_runs(tmp_path_factory.mktemp("prod_full"))


@pytest.mark.parametrize("grid", ["internal", "fold"])
def test_prod_full_step1_machine_precision(runs, grid):
    check_step1(runs[grid])


@pytest.mark.parametrize("grid", ["internal", "fold"])
def test_prod_full_step5_parity(runs, grid):
    check_step5(runs[grid])


def test_production_config_is_the_jax_packages(tmp_path):
    want = jproduction.get_production_config(
        templates=str(tmp_path / "absent"))
    got = production.get_production_config(
        templates=str(tmp_path / "absent"))
    assert got == torch_cfg(want)
    # without a templates directory named, the preset: nothing outside the
    # checkout is looked for
    assert production.get_production_config() == got
    assert supported.unsupported(got) == []
    assert got.nt == 5 and (got.nx, got.ny, got.km) == (320, 384, 60)
    assert production.get_production_config(
        gm_transition_layer=False).gm_transition_layer is False
    # a templates directory without the gx1v7 files: the preset, as the JAX
    # package returns it (tests/test_torch_files.py reads the files)
    assert production.get_production_config(templates=str(tmp_path)) == \
        torch_cfg(jproduction.get_production_config(templates=str(tmp_path)))
