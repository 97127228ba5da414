"""The biharmonic (del4) horizontal mixing and the topographic stress in the
port against the JAX package, on the CPU in float64.

Functions on identical inputs, band 1e-12 of each field's scale, on a
40 x 24 x 10 grid with a stepped bottom (the 'test' preset's cyclic,
closed-north grid) and on a tripole grid whose bottom has ocean across the
fold: ``hdifft_del4`` and ``hdiffu_del4``; the topographic-stress velocities
TSU/TSV of each package's grid (and carried by ``convert.grid_from_numpy``);
the Laplacian friction relaxing toward them; the momentum forcing
(``clinic_cuda.clinic_rhs``, the plain twin of the kernel's fused-friction
instance fed u - TSU, and of its instance without the friction beside del4)
against ``baroclinic.clinic_forcing_jnp``; the tavg fields HDIFT/HDIFS under
del4. Whole steps: ``prod_hmix`` (the production preset with del4 tracer and
momentum mixing, Schmittner tidal mixing with the Southern-Ocean floor and
velocity damping) at 32 x 16 x 10 and the 'mini' dynamical core with
topographic stress, from one perturbed state in both packages; bands
(PARITY.md): 1e-11 after the first step, 1e-7 after five.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

jax.config.update("jax_enable_x64", True)

from pop2_tpu import baroclinic as jbaro, eos as jeos  # noqa: E402
from pop2_tpu import hmix as jhmix, tavg as jtavg  # noqa: E402
from pop2_tpu.config import get_config  # noqa: E402
from pop2_tpu.grid import build_grid as j_build_grid  # noqa: E402
from pop2_tpu.grid import grid_bc as j_grid_bc  # noqa: E402
from pop2_tpu.model import Model as JModel  # noqa: E402
from pop2_tpu.state import initial_state as j_initial_state  # noqa: E402

from pop2_tpu_torch import clinic_cuda, convert, hmix as thmix  # noqa: E402
from pop2_tpu_torch import production, supported, tavg as ttavg  # noqa: E402
from pop2_tpu_torch import tracer_cuda  # noqa: E402
from pop2_tpu_torch.config import get_config as t_get_config  # noqa: E402
from pop2_tpu_torch.grid import build_grid as t_build_grid  # noqa: E402
from pop2_tpu_torch.grid import grid_bc as t_grid_bc  # noqa: E402
from pop2_tpu_torch.model import Model as TModel  # noqa: E402
from pop2_tpu_torch.state import initial_state as t_initial_state  # noqa: E402

from tests.torch_port_helpers import (GridPair, fold_bottom,  # noqa: E402
                                      jax_leaves, scale_err, torch_cfg)

NX, NY, KM = 40, 24, 10
BAND = 1e-12
NSTEPS = 5
# prod_hmix's menu over the production preset (chip_smoke.py's path)
HMIX = dict(hmix_tracer="del4", hmix_momentum="del4",
            tidal_mixing_method="schmittner", ltidal_schmittner_socn=True,
            ldamp_uv=True, passive_tracers=(), nt=2)


def _t(a):
    return torch.as_tensor(np.array(a))


class Grids:
    """Both packages' grids of one case with topographic stress: 'closed'
    is the 'test' preset on a stepped bottom; 'tripole' the production
    preset's tripole grid on a bottom with ocean across the fold (TSU/TSV
    rebuilt by each package for that bottom)."""

    def __init__(self, which):
        if which == "closed":
            p = GridPair("test", seed=2, nx=NX, ny=NY, km=KM,
                         vert_grid="uniform", ltopostress=True)
            self.jcfg, self.tcfg = p.jcfg, p.tcfg
            jg, tg = p.jgrid, p.tgrid
        else:
            self.jcfg = get_config("prod_full", nx=NX, ny=NY, km=KM,
                                   vert_grid="uniform", ltopostress=True,
                                   hmix_momentum="del2", passive_tracers=(),
                                   nt=2)
            self.tcfg = torch_cfg(self.jcfg)
            jg, tg = fold_bottom(j_build_grid(self.jcfg),
                                 t_build_grid(self.tcfg, "cpu"), self.jcfg,
                                 seed=4)
            assert (np.asarray(jg.KMT)[-2:] > 0).mean() > 0.5
        # the topographic stress of this bottom, each package its own
        self.jg = jg.replace(**dict(zip(("TSU", "TSV"), (
            jnp.asarray(a) for a in _jax_topostress(self.jcfg, jg)))))
        leaves = jax_leaves(jg)
        leaves.pop("TSU"), leaves.pop("TSV")
        self.tg = convert.grid_from_numpy(leaves, self.tcfg, "cpu")
        self.tg_carried = convert.grid_from_numpy(jax_leaves(self.jg),
                                                  self.tcfg, "cpu")
        self.jbc, self.tbc = j_grid_bc(self.jcfg), t_grid_bc(self.tcfg)
        rng = np.random.RandomState(23)
        mt, mu = np.asarray(jg.kmask_t), np.asarray(jg.kmask_u)
        shape = mt.shape
        self.tr = np.stack([(10.0 + 2.0 * rng.randn(*shape)) * mt,
                            (0.035 + 1e-3 * rng.randn(*shape)) * mt])
        self.f = {k: 20.0 * rng.randn(*shape) * mu
                  for k in ("ucur", "vcur", "uold", "vold")}
        for k in ("rho_old", "rho_cur", "rho_new"):
            self.f[k] = (1.026 + 1e-3 * rng.randn(*shape)) * mt
        self.f["vvc"] = 10.0 * rng.rand(*shape) * mu
        self.f["smf"] = rng.randn(2, *shape[1:]) * mu[0]
        self.f["dhu"] = 1e-3 * rng.randn(*shape[1:]) * mu[0]


def _jax_topostress(jcfg, jg):
    """The JAX package's TSU/TSV for the bottom of ``jg`` (its grid built
    again from the config cannot know the seeded bottom): its build's own
    code, run on the grid's fields."""
    from pop2_tpu_torch.grid import build_topostress
    return build_topostress(jcfg, *(np.asarray(getattr(jg, n), np.float64)
                                    for n in ("HT", "KMT", "KMU", "TLAT",
                                              "FCORT", "DXUR", "DYUR",
                                              "HUR")))


_GRIDS = {}


def _grids(which):
    if which not in _GRIDS:
        _GRIDS[which] = Grids(which)
    return which, _GRIDS[which]


@pytest.fixture(scope="module", params=["closed", "tripole"])
def grids(request):
    return _grids(request.param)


@pytest.fixture(scope="module")
def fold():
    """The tripole case alone: the fold's ghost rows read u - TSU."""
    return _grids("tripole")


def _close(got, want, name, band=BAND):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert scale_err(got, np.asarray(want)) <= band, (
        name, scale_err(got, np.asarray(want)))


@pytest.mark.parametrize("preset", ["mini", "prod"])
def test_topostress_velocities(preset):
    """TSU/TSV of each package's own grid build, the port's carried by
    ``convert.grid_from_numpy`` and rebuilt there from the grid's fields."""
    jcfg = (get_config("mini", ltopostress=True) if preset == "mini"
            else get_config("prod_full", nx=NX, ny=NY, km=KM,
                            vert_grid="uniform", ltopostress=True))
    tcfg = torch_cfg(jcfg)
    jg, tg = j_build_grid(jcfg), t_build_grid(tcfg, "cpu")
    leaves = jax_leaves(jg)
    rebuilt = {k: v for k, v in leaves.items() if k not in ("TSU", "TSV")}
    for grid in (tg, convert.grid_from_numpy(leaves, tcfg, "cpu"),
                 convert.grid_from_numpy(rebuilt, tcfg, "cpu")):
        for name in ("TSU", "TSV"):
            want = np.asarray(getattr(jg, name))
            assert np.abs(want).max() > 0.0
            _close(getattr(grid, name), want, name, 1e-14)
    assert t_build_grid(tcfg.with_(ltopostress=False), "cpu").TSU is None


def test_tracer_del4(grids):
    which, g = grids
    want = jax.jit(lambda t: jhmix.hdifft_del4(g.jcfg, g.jg, g.jbc, t))(
        jnp.asarray(g.tr))
    got = thmix.hdifft_del4(g.tcfg, g.tg, g.tbc, _t(g.tr))
    assert np.abs(np.asarray(want)).max() > 0.0
    _close(got, want, f"{which} hdifft_del4")
    # the dispatch of the tracer kernel's wrapper: without the Laplacian
    cfg = g.tcfg.with_(hmix_tracer="del4")
    assert not tracer_cuda.with_del2(cfg)
    tracer_cuda._check_mode(cfg, g.tg)
    _close(thmix.hdifft(cfg, g.tg, g.tbc, _t(g.tr)), want, "dispatch")


def test_momentum_del4(grids):
    which, g = grids
    u, v = g.f["uold"], g.f["vold"]
    want = jax.jit(lambda u, v: jhmix.hdiffu_del4(g.jcfg, g.jg, g.jbc, u,
                                                  v))(jnp.asarray(u),
                                                      jnp.asarray(v))
    got = thmix.hdiffu_del4(g.tcfg, g.tg, g.tbc, _t(u), _t(v))
    for gg, w, name in zip(got, want, ("hdu", "hdv")):
        assert np.abs(np.asarray(w)).max() > 0.0
        _close(gg, w, f"{which} {name}")


def test_del2_friction_relaxes_toward_topostress(grids):
    which, g = grids
    u, v = g.f["uold"], g.f["vold"]
    want = jax.jit(lambda u, v: jhmix.hdiffu_del2(g.jcfg, g.jg, g.jbc, u,
                                                  v))(jnp.asarray(u),
                                                      jnp.asarray(v))
    for grid in (g.tg, g.tg_carried):
        got = thmix.hdiffu_del2(g.tcfg, grid, g.tbc, _t(u), _t(v))
        for gg, w, name in zip(got, want, ("hdu", "hdv")):
            _close(gg, w, f"{which} {name}")
    plain = thmix.hdiffu_del2(g.tcfg.with_(ltopostress=False), g.tg, g.tbc,
                              _t(u), _t(v))
    assert not torch.equal(plain[0], got[0])


@pytest.mark.parametrize("mom,leapfrog", [("del2", True), ("del4", False)])
def test_momentum_forcing(fold, mom, leapfrog):
    """The port's momentum forcing (the plain twins of the kernel's
    instances: the fused friction fed u - TSU under del2, no friction and
    del4 added after under del4) against the JAX package's
    ``clinic_forcing_jnp`` with topographic stress on; ZX/ZY as the
    thickness-weighted means."""
    which, g = fold
    jcfg = g.jcfg.with_(hmix_momentum=mom)
    tcfg = torch_cfg(jcfg)
    assert clinic_cuda.with_hdiffu(tcfg) == (mom == "del2")
    clinic_cuda._check_mode(tcfg, g.tg)
    f = g.f
    umix, vmix = (("uold", "vold") if leapfrog else ("ucur", "vcur"))

    @jax.jit
    def jfn(a):
        fx, fy = jbaro.clinic_forcing_jnp(
            jcfg, g.jg, g.jbc, a["ucur"], a["vcur"], a["uold"], a["vold"],
            a[umix], a[vmix], a["rho_old"], a["rho_cur"], a["rho_new"],
            a["vvc"], a["smf"], a["dhu"], leapfrog)
        dz = g.jg.vgrid.dz[:, None, None]
        return (fx, fy, g.jg.HUR * jnp.sum(fx * dz, axis=0),
                g.jg.HUR * jnp.sum(fy * dz, axis=0))
    want = jfn({k: jnp.asarray(v) for k, v in f.items()})
    tf = {k: _t(v) for k, v in f.items()}
    state = t_initial_state(tcfg, g.tg, "cpu").replace(
        **{k + s: tf[k[:1] + ("cur" if s == "_cur" else "old")]
           for k in ("u", "v") for s in ("_cur", "_old")},
        rho_old=tf["rho_old"], rho_cur=tf["rho_cur"])
    got = clinic_cuda.clinic_rhs(tcfg, g.tg, state, tf[umix], tf[vmix],
                                 tf["rho_new"], tf["vvc"], tf["smf"],
                                 tf["dhu"], leapfrog)
    for gg, w, name in zip(got, want, ("fx", "fy", "zx", "zy")):
        _close(gg, w, f"{which} {mom} {name}")


def test_topostress_leaves_del4_alone(grids):
    """With del4 (or aniso) momentum the topographic stress does nothing,
    as in the JAX package."""
    which, g = grids
    tcfg = g.tcfg.with_(hmix_momentum="del4")
    u, v = _t(g.f["uold"]), _t(g.f["vold"])
    on = thmix.hdiffu(tcfg, g.tg, g.tbc, u, v)
    off = thmix.hdiffu(tcfg.with_(ltopostress=False), g.tg, g.tbc, u, v)
    assert all(torch.equal(a, b) for a, b in zip(on, off))


@pytest.mark.parametrize("field", ["HDIFT", "HDIFS"])
def test_tavg_horizontal_diffusion_under_del4(fold, field):
    which, g = fold
    jcfg = g.jcfg.with_(hmix_tracer="del4")
    tcfg = torch_cfg(jcfg)
    jstate = j_initial_state(jcfg, g.jg).replace(
        tracer_old=jnp.asarray(g.tr))
    tstate = t_initial_state(tcfg, g.tg, "cpu").replace(
        tracer_old=_t(g.tr))
    want = jax.jit(lambda s: jtavg.FIELDS[field].fn(
        jcfg, g.jg, s, jtavg.TavgAux(bc=g.jbc)))(jstate)
    got = ttavg.FIELDS[field].fn(tcfg, g.tg, tstate,
                                 ttavg.TavgAux(bc=g.tbc, memo={}))
    assert np.abs(np.asarray(want)).max() > 0.0
    _close(got, want, field)


# -- whole steps ---------------------------------------------------------------

class StepRun:
    """One configuration in both packages from one perturbed state (T noise,
    a seeded u) under a heat flux that cools part of the points: NSTEPS
    leapfrog steps of ``advance`` each (the step counter starts past the
    Euler step: one compiled JAX step)."""

    def __init__(self, jcfg, tcfg, tgrid):
        jm = JModel(jcfg)
        tm = TModel(tcfg, grid=tgrid, device="cpu")
        self.tm = tm
        g = jm.grid
        mt, mu = np.asarray(g.kmask_t), np.asarray(g.kmask_u)
        rng = np.random.RandomState(29)
        leaves = jax_leaves(jm.initial_state())
        tr = leaves["tracer_cur"].copy()
        tr[0] += 0.1 * rng.randn(*tr[0].shape) * mt
        rho = np.asarray(jnp.where(g.kmask_t, jeos.state(
            jcfg, g.vgrid.pressz, jnp.asarray(tr[0]), jnp.asarray(tr[1]),
            jm.ts_range), 0.0))
        leaves.update(tracer_cur=tr, tracer_old=tr, rho_cur=rho,
                      rho_old=rho, u_cur=5.0 * rng.randn(*mt.shape) * mu)
        shape = mt.shape[1:]
        heat = 5.0e-4 * np.abs(rng.randn(*shape))
        stf = np.zeros((jcfg.nt,) + shape)
        stf[0] = np.where(rng.rand(*shape) < 0.4, -heat, 0.2 * heat) * mt[0]
        jf = jm.forcing.replace(stf=jnp.asarray(stf))
        tf = tm.forcing.replace(stf=torch.as_tensor(stf))
        js = jm.initial_state().replace(
            **{k: jnp.asarray(leaves[k]) for k in (
                "tracer_cur", "tracer_old", "rho_cur", "rho_old", "u_cur")})
        ts = convert.state_from_numpy(leaves, tcfg, "cpu")
        jm.nsteps_total = tm.nsteps_total = 1
        self.jsteps, self.tsteps = [], []
        for _ in range(NSTEPS):
            js, _ = jm.advance(js, jf)
            ts, _ = tm.advance(ts, tf)
            self.jsteps.append(jax_leaves(js))
            self.tsteps.append(ts)


@pytest.fixture(scope="module", params=["prod_hmix", "core_topo"])
def stepped(request, tmp_path_factory):
    if request.param == "prod_hmix":
        from tests.torch_port_helpers import stretched_pair
        jcfg, tcfg, _, tgrid = stretched_pair(
            get_config("prod_full", nx=32, ny=16, km=KM, **HMIX),
            tmp_path_factory.mktemp("prod_hmix"))
        return request.param, StepRun(jcfg, tcfg, tgrid)
    jcfg = get_config("mini", ltopostress=True)
    tcfg = torch_cfg(jcfg)
    return request.param, StepRun(jcfg, tcfg, t_build_grid(tcfg, "cpu"))


@pytest.mark.parametrize("step,band", [(1, 1e-11), (NSTEPS, 1e-7)])
def test_whole_steps_match_the_jax_package(stepped, step, band):
    which, r = stepped
    assert supported.unsupported(r.tm.cfg) == []
    state, want = r.tsteps[step - 1], r.jsteps[step - 1]
    diffs = {k: scale_err(getattr(state, k).numpy(), want[k])
             for k in ("u_cur", "v_cur", "psurf_cur", "ubtrop_cur",
                       "vbtrop_cur")}
    for n in range(want["tracer_cur"].shape[0]):
        diffs[f"tracer{n}"] = scale_err(state.tracer_cur[n].numpy(),
                                        want["tracer_cur"][n])
    assert max(diffs.values()) <= band, (which, diffs)
    if which == "prod_hmix":  # the fold's degenerate top U row
        top = state.u_cur[:, -1].numpy()
        np.testing.assert_array_equal(
            np.abs(top), np.abs(np.roll(top[:, ::-1], -1, axis=-1)))


@pytest.mark.parametrize("over", [
    dict(hmix_tracer="del4"), dict(hmix_momentum="del4"),
    dict(ltopostress=True), dict(ltopostress=True, hmix_momentum="del2"),
    HMIX], ids=["tracer_del4", "momentum_del4", "topostress_aniso",
                "topostress_del2", "prod_hmix"])
def test_ported_switches_are_supported(over):
    cfg = production.get_production_config(**over)
    assert supported.unsupported(cfg) == []
    mini = {k: v for k, v in over.items()
            if k in ("hmix_tracer", "hmix_momentum", "ltopostress")}
    assert supported.unsupported(t_get_config("mini", **mini)) == []
