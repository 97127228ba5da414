"""The port's overflows (``pop2_tpu_torch.overflows``) against the JAX
package's, on the CPU in float64.

The specs are those of the JAX package's own overflow tests
(tests/test_overflows.py) on the 'mini' preset (32 x 24 x 8): a box-only
overflow, a point-data overflow with two product sets (sidewall momentum,
ZX/ZY renormalization, the overflow-modified barotropic operator), and the
point-data overflow over kmt pop-ups that shelve the columns beside its
walls. Compared:

  (a) the wet regions and the pop-ups of the grid, HU extended down the
      sidewalls (``modified_hu``) and the rebuilt operator weights
      (``solvers_9pt``): exactly equal;
  (b) ``transports``, ``product_set_selection``, ``tendency``, ``qsurf``
      and ``momentum_adjust`` on a state with dense source water: 1e-12
      relative to each field's largest value;
  (c) ``validate_geometry``: the same warning and the same overflows left,
      and an error under ``overflow_geometry_strict``;
  (d) ``Model`` from the dense-source state: step 1 to 1e-11, step 5 to
      1e-7 relative (PARITY.md), with the overflow active.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)

from pop2_tpu import overflows as jovf  # noqa: E402
from pop2_tpu.config import get_config  # noqa: E402
from pop2_tpu.grid import build_grid as j_build_grid  # noqa: E402
from pop2_tpu.model import Model as JModel  # noqa: E402

from pop2_tpu_torch import convert, overflows as tovf  # noqa: E402
from pop2_tpu_torch.grid import build_grid as t_build_grid  # noqa: E402
from pop2_tpu_torch.model import Model as TModel  # noqa: E402

from tests.test_overflows import _pt_spec, _pt_spec_topo, _spec  # noqa: E402
from tests.torch_port_helpers import jax_leaves, scale_err, torch_cfg  # noqa: E402

SPECS = {"box": _spec, "point": _pt_spec, "point_topo": _pt_spec_topo}
FIELDS = ("u_cur", "v_cur", "tracer_cur", "psurf_cur", "ubtrop_cur",
          "vbtrop_cur")
NSTEPS = 5


def _cfg(kind):
    return get_config("mini").with_(overflows=(SPECS[kind](),))


def _dense_tracers(cfg, jm):
    """The JAX model's initial tracers, 4 K colder in the source region."""
    src = jovf.region_mask3(cfg, jm.ovf_statics, 0, jovf.REG_SRC) > 0
    tr = np.array(jm.initial_state().tracer_cur)
    tr[0][src] -= 4.0
    return tr


class Case:
    """One overflow config in both packages; the port's grid is the JAX
    package's, handed over as NumPy leaves."""

    def __init__(self, kind):
        self.jcfg = _cfg(kind)
        self.tcfg = torch_cfg(self.jcfg)
        self.jm = JModel(self.jcfg)
        self.tgrid = convert.grid_from_numpy(jax_leaves(self.jm.grid),
                                             self.tcfg, "cpu")
        self.tstatics = tovf.build_statics(self.tcfg, self.tgrid)
        self.tracer = _dense_tracers(self.jcfg, self.jm)


@pytest.fixture(scope="module")
def cases():
    return {kind: Case(kind) for kind in ("box", "point")}


def _close(got, want, name, band=1e-12):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, name
    assert scale_err(got, want) <= band, (name, scale_err(got, want))


# ---- (a) grid and operator statics ------------------------------------------

@pytest.mark.parametrize("kind", ["box", "point", "point_topo"])
def test_wet_regions_and_popups_equal(kind):
    jcfg = _cfg(kind)
    jk = np.asarray(j_build_grid(jcfg).KMT)
    tk = t_build_grid(torch_cfg(jcfg), "cpu").KMT.numpy()
    np.testing.assert_array_equal(tk, jk)
    # the box spec's source region reaches land, which it makes wet; the
    # pop-ups shelve columns
    base = np.asarray(j_build_grid(jcfg.with_(overflows=())).KMT)
    assert (jk != base).any() == (kind != "point")


@pytest.mark.parametrize("kind", ["point", "point_topo"])
def test_modified_hu_and_operator_weights_equal(kind):
    jcfg = _cfg(kind)
    tcfg = torch_cfg(jcfg)
    jgrid = j_build_grid(jcfg)
    tgrid = convert.grid_from_numpy(jax_leaves(jgrid), tcfg, "cpu")
    np.testing.assert_array_equal(tovf.modified_hu(tcfg, tgrid),
                                  jovf.modified_hu(jcfg, jgrid))
    j9, t9 = jovf.solvers_9pt(jcfg, jgrid), tovf.solvers_9pt(tcfg, tgrid)
    for name in ("btrop_ne", "btrop_n", "btrop_e", "btrop_c_indep"):
        np.testing.assert_array_equal(getattr(t9, name).numpy(),
                                      np.asarray(getattr(j9, name)), name)
    if kind == "point_topo":  # the sidewall columns deepened
        assert (tovf.modified_hu(tcfg, tgrid) > tgrid.HU.numpy()).any()


# ---- (b) the per-step functions ---------------------------------------------

@pytest.mark.parametrize("kind", ["box", "point"])
def test_step_functions_match(cases, kind):
    c = cases[kind]
    jst, tst = c.jm.ovf_statics, c.tstatics
    jtr, ttr = jnp.asarray(c.tracer), torch.as_tensor(c.tracer)
    jtrans = jovf.transports(c.jcfg, c.jm.grid, jst, jtr)
    ttrans = tovf.transports(c.tcfg, c.tgrid, tst, ttr)
    for g, w, name in zip(ttrans, jtrans, ("ms", "me", "mp", "phi",
                                           "tavg")):
        _close(g, w, name)
    assert float(ttrans[0][0]) > 0.0  # the dense source drives a transport
    jsel = jsets = tsel = tsets = None
    if kind == "point":
        jsel, jsets = jovf.product_set_selection(c.jcfg, c.jm.grid, jst,
                                                 jtr, jtrans)
        tsel, tsets = tovf.product_set_selection(c.tcfg, c.tgrid, tst, ttr,
                                                 ttrans)
        np.testing.assert_array_equal(tsel.numpy(), np.asarray(jsel))
        for g, w in zip(tsets[0], jsets[0]):
            _close(g, w, "sets_tavg")
    _close(tovf.tendency(c.tcfg, c.tgrid, tst, ttr, ttrans, tsel, tsets),
           jovf.tendency(c.jcfg, c.jm.grid, jst, jtr, jtrans, jsel, jsets),
           "tendency")
    q = tovf.qsurf(c.tcfg, c.tgrid, tst, ttrans, sel=tsel)
    _close(q, jovf.qsurf(c.jcfg, c.jm.grid, jst, jtrans, sel=jsel), "qsurf")
    # into the product columns, out of the source's
    prd = (tst.sets[0][int(tsel[0])] if kind == "point"
           else tst.regions[0][tovf.REG_PRD])
    assert q.numpy()[tovf.footprint2(c.tcfg, prd) > 0].mean() > 0.0
    src = tovf.footprint2(c.tcfg, tst.regions[0][tovf.REG_SRC])
    assert q.numpy()[src > 0].mean() < 0.0
    if kind == "point":
        rng = np.random.RandomState(5)
        mu = np.asarray(c.jm.grid.kmask_u)
        u, v = (rng.randn(*mu.shape) * mu for _ in range(2))
        ub, vb = (rng.randn(*mu.shape[1:]) * mu[0] for _ in range(2))
        want = jovf.momentum_adjust(c.jcfg, c.jm.grid, jst, jtrans, jsel,
                                    *(jnp.asarray(a) for a in (u, v, ub,
                                                               vb)))
        got = tovf.momentum_adjust(c.tcfg, c.tgrid, tst, ttrans, tsel,
                                   *(torch.as_tensor(a) for a in (u, v, ub,
                                                                  vb)))
        for g, w, a, name in zip(got, want, (u, v), ("u", "v")):
            _close(g, w, name)
        assert not np.array_equal(got[0].numpy(), u)  # the shift acted
        _close(tst.zren, jst.zren, "zren", 0.0)


# ---- (c) validate_geometry --------------------------------------------------

def _mismatched(spec):
    """``spec`` with kmt-change records whose old depths are not the
    topography's."""
    import dataclasses
    return dataclasses.replace(spec, kmt_changes=((6, 16, 3, 2),))


def test_validate_geometry_warns_and_deactivates_as_the_jax_package():
    jcfg = get_config("mini").with_(
        overflows=(_pt_spec_topo(), _mismatched(_pt_spec())))
    tcfg = torch_cfg(jcfg)
    with pytest.warns(UserWarning, match="deactivating overflows") as jw:
        jout = jovf.validate_geometry(jcfg)
    with pytest.warns(UserWarning, match="deactivating overflows") as tw:
        tout = tovf.validate_geometry(tcfg)
    assert str(tw[0].message) == str(jw[0].message)
    assert [s.name for s in tout.overflows] == [
        s.name for s in jout.overflows] == ["pt_ovf"]
    assert tout.overflows[0].kmt_changes == _pt_spec_topo().kmt_changes
    # a consistent set passes untouched, with no warning
    ok = torch_cfg(get_config("mini").with_(overflows=(_pt_spec_topo(),)))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tovf.validate_geometry(ok) is ok
    with pytest.raises(ValueError, match="init_overflows_kmt"):
        tovf.validate_geometry(tcfg.with_(overflow_geometry_strict=True))


# ---- (d) whole steps ---------------------------------------------------------

@pytest.fixture(scope="module")
def runs(cases):
    out = {}
    for kind, c in cases.items():
        tr = jnp.asarray(c.tracer)
        js = c.jm.initial_state().replace(tracer_cur=tr, tracer_old=tr)
        jsteps = []
        for _ in range(NSTEPS):
            js, _ = c.jm.advance(js)
            jsteps.append(jax_leaves(js))
        tm = TModel(c.tcfg, grid=c.tgrid, device="cpu")
        ts = tm.initial_state()
        ttr = torch.as_tensor(c.tracer)
        ts = ts.replace(tracer_cur=ttr, tracer_old=ttr)
        tsteps = []
        for _ in range(NSTEPS):
            ts, _ = tm.advance(ts)
            tsteps.append(ts)
        out[kind] = (tsteps, jsteps, tm)
    return out


def _rel(state, want):
    return {k: float(np.abs(getattr(state, k).numpy() - want[k]).max()
                     / (np.abs(want[k]).max() or 1.0)) for k in FIELDS}


@pytest.mark.parametrize("kind", ["box", "point"])
def test_overflow_model_step1_and_step5(runs, kind):
    tsteps, jsteps, tm = runs[kind]
    assert tm.ovf_statics is not None
    d1 = _rel(tsteps[0], jsteps[0])
    assert max(d1.values()) <= 1e-11, d1
    d5 = _rel(tsteps[-1], jsteps[-1])
    assert max(d5.values()) <= 1e-7, d5
    assert np.isfinite(tsteps[-1].tracer_cur.numpy()).all()
