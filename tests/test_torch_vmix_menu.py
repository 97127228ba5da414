"""The rest of vertical mixing in the port against the JAX package, on the
CPU in float64: the Schmittner and Polzin tidal methods, the Southern-Ocean
floor, the lunar cycle, near-inertial wave (NIW) mixing, the geothermal
bottom heat flux and depth acceleration.

Functions are fed identical inputs (the JAX package's upstream results on a
40 x 24 x 10 tripole grid whose bottom has ocean across the fold, levels
10 m thick at the surface growing by half a level each), band 1e-12 of each
field's scale: the Schmittner coefficient and floor, Polzin's statics and
profile on one N^2, ``ri_iwmix`` under both methods, ``blke``,
``niw_energy`` of both types, ``niw_mix``, ``kpp_coeffs``, the per-level
tracer timestep and ``convad`` under depth acceleration; the readers of a
2-D and a 3-D ``tidal_energy_file`` and of a ``niw_energy_file`` written
here. The whole menu (``prod_vmix``: the production preset with Polzin, the
lunar cycle, NIW from the boundary-layer energy, geothermal heat and depth
acceleration) steps in both packages at 32 x 16 x 10 from one perturbed
state; bands (PARITY.md): 1e-11 after the first step, 1e-7 after five (the
steps are leapfrog steps: the step counter starts past the Euler step, one
compiled JAX step). ``run_compiled`` equals ``run`` bitwise across a jump of
the calendar, and a captured step that kept a stale lunar factor would not.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

jax.config.update("jax_enable_x64", True)

from pop2_tpu import baroclinic as jbaro, eos as jeos  # noqa: E402
from pop2_tpu import kpp as jkpp, tidal_mixing as jtidal  # noqa: E402
from pop2_tpu import vmix as jvmix  # noqa: E402
from pop2_tpu.config import get_config  # noqa: E402
from pop2_tpu.grid import grid_bc as j_grid_bc  # noqa: E402
from pop2_tpu.model import Model as JModel  # noqa: E402

from pop2_tpu_torch import baroclinic as tbaro, convert, graphs  # noqa: E402
from pop2_tpu_torch import kpp as tkpp, production, sample  # noqa: E402
from pop2_tpu_torch import supported, tidal_mixing as ttidal  # noqa: E402
from pop2_tpu_torch import vmix as tvmix  # noqa: E402
from pop2_tpu_torch.grid import grid_bc as t_grid_bc  # noqa: E402
from pop2_tpu_torch.model import Model as TModel  # noqa: E402

from tests.test_overflows import _spec as ovf_spec  # noqa: E402
from tests.torch_port_helpers import (fold_bottom, jax_leaves,  # noqa: E402
                                      scale_err, stretched_pair, torch_cfg)

KM = 10
BAND = 1e-12
NSTEPS = 5
# the production preset with two tracers, the base of every case here
PROD = dict(passive_tracers=(), nt=2)
ENERGY = 1.0e-3  # W/m^2, the preset's tidal_energy_const


def vmix_menu(cfg, zt):
    """``cfg`` with prod_vmix's vertical-mixing menu (as chip_smoke.py's
    path): Polzin tidal mixing under the lunar cycle, NIW mixing from the
    boundary-layer energy, geothermal heat and depth acceleration rising
    below 1000 m (``sample.depth_accel_profile`` over the level centres
    ``zt``)."""
    return cfg.with_(
        tidal_mixing_method="polzin", ltidal_lunar_cycle=True,
        lniw_mixing=True, niw_energy_type="blke", geoheatflux_const=0.1,
        time=dataclasses.replace(
            cfg.time, laccel=True,
            dttxcel=sample.depth_accel_profile(zt)))


def _t(a):
    return torch.as_tensor(np.array(a))


class Case:
    """The JAX package's and the port's results of every function here on
    one set of seeded inputs."""

    def __init__(self, tmp):
        jcfg, tcfg, jg, tg = stretched_pair(
            get_config("prod_full", nx=40, ny=24, km=KM, **PROD), tmp)
        self.jg, self.tg = fold_bottom(jg, tg, jcfg, seed=5)
        assert (np.asarray(self.jg.KMT)[-2:] > 0).mean() > 0.5
        self.jcfg, self.tcfg = jcfg, tcfg
        self.jbc, self.tbc = j_grid_bc(jcfg), t_grid_bc(tcfg)
        rng = np.random.RandomState(17)
        mt = np.asarray(self.jg.kmask_t)
        mu = np.asarray(self.jg.kmask_u)
        zt = np.asarray(self.jg.vgrid.zt)
        shape = mt.shape
        # stratified water with noise: convective and near-neutral points
        T = (2.0 + 16.0 * np.exp(-zt / 8.0e4))[:, None, None] \
            + 0.5 * rng.randn(*shape)
        S = (0.0347 - 0.0005 * np.exp(-zt / 5.0e4))[:, None, None] \
            + 2.0e-4 * rng.randn(*shape)
        self.trcr = np.stack([T * mt, S * mt])
        self.u, self.v, self.ucur, self.vcur = (
            5.0 * rng.randn(*shape) * mu for _ in range(4))
        heat = 2.0e-5 * np.abs(rng.randn(*shape[1:]))
        self.stf = np.stack([np.where(rng.rand(*shape[1:]) < 0.4, -heat,
                                      heat), 1.0e-6 * rng.randn(*shape[1:])
                             ]) * mt[0]
        self.qsw = np.abs(2.0e-5 * rng.randn(*shape[1:])) * mt[0]
        self.smft = 0.5 * rng.randn(2, *shape[1:]) * mt[0]
        self.lnc = 1.0375
        self.j, self.t = {}, {}
        self.tidal("polzin", tidal_mixing_method="polzin")
        self.tidal("schmittner", tidal_mixing_method="schmittner",
                   ltidal_schmittner_socn=True)
        self.niw()

    def cfgs(self, **over):
        jcfg = self.jcfg.with_(**over)
        return jcfg, torch_cfg(jcfg)

    def tidal(self, name, **over):
        """Statics and ri_iwmix under one tidal method, both packages fed
        the JAX package's DBLOC (its functions jitted together: one compile
        instead of one an operation)."""
        jcfg, tcfg = self.cfgs(**over)
        jst = jkpp.build_statics(jcfg, self.jg)
        tst = tkpp.build_statics(tcfg, self.tg)

        @jax.jit
        def run(trcr, u, v, lnc):
            dbloc = jkpp.buoydiff(jcfg, self.jg, jst, trcr)[0]
            return dbloc, jkpp.ri_iwmix(jcfg, self.jg, self.jbc, jst, dbloc,
                                        u, v, tidal_lnc=lnc,
                                        want_kvmix=True)
        dbloc, ri = run(*(jnp.asarray(a) for a in (self.trcr, self.u,
                                                   self.v, self.lnc)))
        self.j[name] = dict(statics=jst, dbloc=np.asarray(dbloc),
                            ri_iwmix=ri)
        self.t[name] = dict(statics=tst, ri_iwmix=tkpp.ri_iwmix(
            tcfg, self.tg, self.tbc, tst, _t(dbloc), _t(self.u), _t(self.v),
            tidal_lnc=torch.tensor(self.lnc, dtype=torch.float64)))

    def niw(self):
        """blke, both NIW energy types and niw_mix under Polzin with NIW
        from the boundary-layer energy."""
        jcfg, tcfg = self.cfgs(tidal_mixing_method="polzin",
                               lniw_mixing=True, niw_energy_type="blke")
        ext = jcfg.with_(niw_energy_type="external", niw_energy_const=2e-3)
        jst = jkpp.build_statics(jcfg, self.jg)
        tst = tkpp.build_statics(tcfg, self.tg)
        g, bc = self.jg, self.jbc

        @jax.jit
        def run(trcr, u, v, uc, vc, stf, qsw, smft):
            dbloc, dbsfc = jkpp.buoydiff(jcfg, g, jst, trcr)
            visc, vdc = jkpp.ri_iwmix(jcfg, g, bc, jst, dbloc, u, v)
            hblt, _, _, _, kbl = jkpp.bldepth(
                jcfg, g, bc, jst, dbloc, dbsfc, trcr, u, v, stf, qsw, smft)
            j = dict(kbl=kbl, dbloc=dbloc, hblt=hblt, visc=visc, vdc=vdc)
            j["blke"] = jkpp.blke(jcfg, g, uc, vc, kbl)
            en = jkpp.niw_energy(jcfg, g, jst, kbl, u, v, uc, vc)
            j["niw_energy_blke"] = en
            j["niw_energy_external"] = jkpp.niw_energy(ext, g, jst, kbl, u,
                                                       v, uc, vc)
            j["niw_mix"] = jkpp.niw_mix(jcfg, g, jst, dbloc, hblt, kbl, visc,
                                        vdc, 1.1 * vdc, en=en)
            return j
        j = run(*(jnp.asarray(a) for a in (
            self.trcr, self.u, self.v, self.ucur, self.vcur, self.stf,
            self.qsw, self.smft)))
        dbloc, hblt, visc, vdc, en = (j[k] for k in (
            "dbloc", "hblt", "visc", "vdc", "niw_energy_blke"))
        j["kbl"] = np.asarray(j["kbl"])
        self.j["niw"] = j

        tk = _t(j["kbl"]).to(torch.int32)
        tu, tv, tuc, tvc = (_t(a) for a in (self.u, self.v, self.ucur,
                                            self.vcur))
        tvisc, tvdc = _t(visc), _t(vdc)
        t = dict(blke=tkpp.blke(tcfg, self.tg, tuc, tvc, tk))
        t["niw_energy_blke"] = tkpp.niw_energy(tcfg, self.tg, tst, tk, tu,
                                               tv, tuc, tvc)
        t["niw_energy_external"] = tkpp.niw_energy(
            torch_cfg(ext), self.tg, tst, tk, tu, tv, tuc, tvc)
        t["niw_mix"] = tkpp.niw_mix(tcfg, self.tg, tst, _t(dbloc),
                                    _t(hblt), tk, tvisc, tvdc, 1.1 * tvdc,
                                    en=_t(en))
        self.t["niw"] = t


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    return Case(tmp_path_factory.mktemp("vmix_menu"))


def _close(got, want, band=BAND, name=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, name
    if np.issubdtype(want.dtype, np.integer) or want.dtype == np.bool_:
        np.testing.assert_array_equal(got, want, err_msg=name)
        return
    assert scale_err(got, want) <= band, (name, scale_err(got, want))


def test_schmittner_coefficient_and_floor(case):
    jcfg, tcfg = case.cfgs(tidal_mixing_method="schmittner")
    want = jtidal.build_tidal_coef_schmittner(jcfg, case.jg)
    got = ttidal.build_tidal_coef_schmittner(tcfg, case.tg)
    assert np.abs(want).max() > 0.0
    _close(got, want, name="schmittner coefficient")
    floor = jtidal.schmittner_socn_floor(jcfg, case.jg)
    assert np.abs(floor).max() > 0.0
    _close(ttidal.schmittner_socn_floor(tcfg, case.tg), floor,
           name="Southern-Ocean floor")
    st_j, st_t = case.j["schmittner"]["statics"], case.t["schmittner"][
        "statics"]
    _close(st_t.tidal_coef, st_j.tidal_coef, name="statics coefficient")
    _close(st_t.tidal_socn, st_j.tidal_socn, name="statics floor")


def test_polzin_statics_and_profile(case):
    jcfg, tcfg = case.cfgs(tidal_mixing_method="polzin")
    jst, tst = case.j["polzin"]["statics"], case.t["polzin"]["statics"]
    assert jst.tidal_coef is None and tst.tidal_coef is None
    for got, want, name in zip(tst.tidal_polzin, jst.tidal_polzin,
                               ttidal.PolzinStatics._fields):
        _close(got, want, name=name)
    # Polzin's profile on one N^2 (ri_iwmix's, from the JAX DBLOC)
    dbloc = case.j["polzin"]["dbloc"]
    dzt = np.asarray(case.jg.vgrid.dz)[:, None, None]
    n2 = dbloc / (0.5 * (dzt + np.concatenate([dzt[1:], dzt[-1:]])))
    want = jax.jit(lambda n2: jtidal.polzin_diff(
        jcfg, case.jg, jtidal.PolzinStatics(*jst.tidal_polzin), n2))(
            jnp.asarray(n2))
    got = ttidal.polzin_diff(tcfg, case.tg, tst.tidal_polzin, _t(n2))
    assert np.abs(np.asarray(want)).max() > 0.0
    _close(got, want, name="polzin_diff")


@pytest.mark.parametrize("method", ["polzin", "schmittner"])
def test_ri_iwmix_under_each_method(case, method):
    """visc, vdc, KVMIX, KVMIX_M on one DBLOC, the lunar factor applied."""
    want, got = case.j[method]["ri_iwmix"], case.t[method]["ri_iwmix"]
    for g, w, name in zip(got, want, ("visc", "vdc", "kvmix", "kvmix_m")):
        _close(g, w, name=f"{method} {name}")
    # the tidal term acts: KVMIX lies above the background somewhere
    bck = np.asarray(case.j[method]["statics"].bckgrnd_vdc)
    assert (np.asarray(want[2])[:-1] - bck > 1e-3).any()


def test_lunar_nodal_modulation():
    years = np.linspace(1.0, 40.0, 57)
    got = [ttidal.lunar_nodal_modulation(y) for y in years]
    want = [jtidal.lunar_nodal_modulation(y) for y in years]
    assert got == want
    assert max(got) - min(got) > 0.01  # the cycle moves the factor


@pytest.mark.parametrize("fn", ["blke", "niw_energy_blke",
                                "niw_energy_external", "niw_mix"])
def test_niw_functions(case, fn):
    """Each NIW function on the same inputs (the JAX package's KBL, DBLOC,
    HBLT, interior coefficients and energy); the whole KPP pipeline with
    NIW is held in ``test_prod_vmix_matches_the_jax_package``."""
    want, got = case.j["niw"][fn], case.t["niw"][fn]
    if isinstance(want, tuple):
        pairs = list(zip(got, want))
    else:
        pairs = [(got, want)]
    for g, w in pairs:
        _close(g, w, name=fn)
    if fn == "niw_mix":  # NIW raises the diffusivity below the layer
        kbl = case.j["niw"]["kbl"]
        assert (np.asarray(want[1]) != 0).any() and kbl.max() > 1


@pytest.mark.parametrize("leapfrog", [False, True])
def test_accelerated_timestep_profile(case, leapfrog):
    zt = np.asarray(case.jg.vgrid.zt)
    jcfg = vmix_menu(case.jcfg, zt)
    want = jbaro._timestep_arrays(jcfg, leapfrog)
    got = tbaro._timestep_arrays(torch_cfg(jcfg), case.tg, leapfrog)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[1:] == want[1:]
    c2dtt = got[0].numpy()
    assert c2dtt[0] == c2dtt[-1] / 2.0 == (2.0 if leapfrog else 1.0) \
        * jcfg.time.dtt


def test_convad_under_depth_acceleration(case):
    zt = np.asarray(case.jg.vgrid.zt)
    jcfg = vmix_menu(case.jcfg, zt).with_(convection_type="adjustment",
                                          nconvad=1)
    tcfg = torch_cfg(jcfg)
    want = jvmix.convad(jcfg, case.jg, jnp.asarray(case.trcr))
    got = tvmix.convad(tcfg, case.tg, _t(case.trcr))
    _close(got, want, name="convad")
    plain = tvmix.convad(tcfg.with_(time=dataclasses.replace(
        tcfg.time, laccel=False)), case.tg, _t(case.trcr))
    assert not torch.equal(plain, got)  # acceleration changes the mixing
    assert not np.array_equal(np.asarray(want), case.trcr)


def test_energy_file_readers(case, tmp_path):
    """A 2-D and a 3-D tidal_energy_file and a niw_energy_file (POP binary,
    big-endian float64) written here, read by both packages."""
    rng = np.random.RandomState(3)
    km, ny, nx = case.jcfg.km, case.jcfg.ny, case.jcfg.nx
    e2 = tmp_path / "tidal2d"
    e3 = tmp_path / "tidal3d"
    niw = tmp_path / "niw"
    (ENERGY * rng.rand(ny, nx)).astype(">f8").tofile(e2)
    (ENERGY * rng.rand(km, ny, nx)).astype(">f8").tofile(e3)
    (2e-3 * rng.rand(ny, nx)).astype(">f8").tofile(niw)
    for path, method in ((e2, "jayne"), (e2, "schmittner"),
                         (e3, "schmittner")):
        jcfg, tcfg = case.cfgs(tidal_mixing_method=method,
                               tidal_energy_file=str(path))
        build_j = (jtidal.build_tidal_coef if method == "jayne"
                   else jtidal.build_tidal_coef_schmittner)
        build_t = (ttidal.build_tidal_coef if method == "jayne"
                   else ttidal.build_tidal_coef_schmittner)
        want = build_j(jcfg, case.jg)
        _close(build_t(tcfg, case.tg), want, name=f"{path.name} {method}")
        assert np.abs(want).max() > 0.0
    j3 = jtidal.energy_flux_3d(case.cfgs(tidal_energy_file=str(e3))[0],
                               case.jg)
    assert j3.shape == (km, ny, nx) and (j3[0] > 0).all()
    jcfg, tcfg = case.cfgs(lniw_mixing=True, niw_energy_file=str(niw))
    want = jkpp.build_statics(jcfg, case.jg).niw_energy
    got = tkpp.build_statics(tcfg, case.tg).niw_energy
    _close(got, want, name="niw_energy_file")
    kbl = _t(case.j["niw"]["kbl"]).to(torch.int32)
    st = tkpp.build_statics(tcfg, case.tg)
    _close(tkpp.niw_energy(tcfg, case.tg, st, kbl, None, None),
           jkpp.niw_energy(jcfg, case.jg, jkpp.build_statics(jcfg, case.jg),
                           jnp.asarray(case.j["niw"]["kbl"]), None, None),
           name="niw_energy from the file")


# -- the whole menu ------------------------------------------------------------

class MenuRun:
    """prod_vmix at 32 x 16 x 10 in both packages from one perturbed state
    under a heat flux that cools part of the points, NSTEPS leapfrog steps
    of ``advance`` each."""

    def __init__(self, tmp):
        base = get_config("prod_full", nx=32, ny=16, km=KM, **PROD)
        dz = 1000.0 * 1.5 ** np.arange(KM)  # stretched_pair's levels
        jcfg, tcfg, jg, tgrid = stretched_pair(
            vmix_menu(base, np.cumsum(dz) - 0.5 * dz), tmp)
        jm = JModel(jcfg)
        tm = TModel(tcfg, grid=tgrid, device="cpu")
        self.jcfg, self.tm = jcfg, tm
        g = jm.grid
        mt = np.asarray(g.kmask_t)
        zw = np.asarray(g.vgrid.zw)
        kmt = np.asarray(g.KMT)
        # the geothermal flux reaches the bottom of some columns
        self.geo_columns = int(((kmt > 0) & (zw[np.maximum(kmt - 1, 0)]
                                             >= jcfg.geoheatflux_depth)
                                ).sum())
        rng = np.random.RandomState(7)
        leaves = jax_leaves(jm.initial_state())
        tr = leaves["tracer_cur"].copy()
        tr[0] += 0.1 * rng.randn(*tr[0].shape) * mt
        rho = np.asarray(jnp.where(g.kmask_t, jeos.state(
            jcfg, g.vgrid.pressz, jnp.asarray(tr[0]), jnp.asarray(tr[1]),
            jm.ts_range), 0.0))
        u = 2.0 * rng.randn(*mt.shape) * np.asarray(g.kmask_u)
        leaves.update(tracer_cur=tr, tracer_old=tr, rho_cur=rho,
                      rho_old=rho, u_cur=u)
        shape = mt.shape[1:]
        heat = 5.0e-4 * np.abs(rng.randn(*shape))
        stf = np.zeros((jcfg.nt,) + shape)
        stf[0] = np.where(rng.rand(*shape) < 0.4, -heat, 0.2 * heat) * mt[0]
        forcing = dict(stf=stf,
                       shf_qsw=2.0e-4 * np.abs(rng.randn(*shape)) * mt[0])
        jf = jm.forcing.replace(
            **{k: jnp.asarray(v) for k, v in forcing.items()})
        tf = tm.forcing.replace(
            **{k: torch.as_tensor(v) for k, v in forcing.items()})
        js = jm.initial_state().replace(
            **{k: jnp.asarray(leaves[k]) for k in (
                "tracer_cur", "tracer_old", "rho_cur", "rho_old", "u_cur")})
        ts = convert.state_from_numpy(leaves, tcfg, "cpu")
        jm.nsteps_total = tm.nsteps_total = 1  # leapfrog steps from here
        self.jsteps, self.tsteps, self.lnc = [], [], []
        for _ in range(NSTEPS):
            self.lnc.append(tm.lunar_factor())
            js, _ = jm.advance(js, jf)
            ts, _ = tm.advance(ts, tf)
            self.jsteps.append(jax_leaves(js))
            self.tsteps.append(ts)


@pytest.fixture(scope="module")
def menu(tmp_path_factory):
    return MenuRun(tmp_path_factory.mktemp("prod_vmix"))


def _state_diffs(state, want):
    out = {k: scale_err(getattr(state, k).numpy(), want[k])
           for k in ("u_cur", "v_cur", "psurf_cur", "ubtrop_cur",
                     "vbtrop_cur")}
    for n in range(want["tracer_cur"].shape[0]):
        out[f"tracer{n}"] = scale_err(state.tracer_cur[n].numpy(),
                                      want["tracer_cur"][n])
    return out


@pytest.mark.parametrize("step,band", [(1, 1e-11), (NSTEPS, 1e-7)])
def test_prod_vmix_matches_the_jax_package(menu, step, band):
    assert menu.geo_columns > 0
    assert supported.unsupported(menu.tm.cfg) == []
    diffs = _state_diffs(menu.tsteps[step - 1], menu.jsteps[step - 1])
    assert max(diffs.values()) <= band, diffs
    # the model's lunar factor is the calendar's, and its forcing holds it
    assert float(menu.tm.forcing.tidal_lnc) == menu.lnc[-1]
    assert menu.lnc[0] == jtidal.lunar_nodal_modulation(
        menu.jcfg.time.start_year)


# -- the lunar cycle under the captured run loop -------------------------------

def _prod_vmix_small():
    cfg = production.get_production_config(nx=24, ny=16, km=KM,
                                           vert_grid="uniform", **PROD)
    from pop2_tpu_torch.grid import build_grid
    return vmix_menu(cfg, build_grid(cfg, "cpu").vgrid.zt.numpy())


def _lunar_runs(compiled, n_before=2, n_after=2, years=7):
    """(state, [the captured step's lunar buffer after each captured
    step], [the calendar's factor before each step]) of n_before steps, a
    jump of the calendar by ``years``, n_after steps."""
    cfg = _prod_vmix_small()
    model = TModel(cfg, device="cpu")
    state = model.initial_state()
    factors, buffers = [], []
    for n in (n_before, n_after):
        for _ in range(n):
            factors.append(model.lunar_factor())
            if compiled:
                state, _ = model.run_compiled(state, 1)
                cap = model._captured  # from the third step on
                if cap is not None:
                    buffers.append(float(cap.forcing.tidal_lnc))
            else:
                state, _ = model.advance(state)
        model.time_manager.calendar.iyear += years
    return state, buffers, factors


def test_run_compiled_refreshes_the_lunar_factor(monkeypatch):
    eager, _, factors = _lunar_runs(False)
    comp, buffers, factors_c = _lunar_runs(True)
    assert factors == factors_c
    assert abs(factors[2] - factors[1]) > 1e-3  # the jump moved it
    # each captured step read the calendar's factor of its own step
    assert buffers == factors[2:], (buffers, factors)
    for (name, x), (_, y) in zip(comp.leaves(), eager.leaves()):
        assert torch.equal(x, y), name

    # a captured step that kept a stale factor is caught by the same check
    step = graphs.CapturedStep.step

    def stale_step(self, forcing):
        if self.forcing.tidal_lnc is not None:
            forcing = forcing.replace(tidal_lnc=self.forcing.tidal_lnc)
        return step(self, forcing)
    monkeypatch.setattr(graphs.CapturedStep, "step", stale_step)
    stale, buffers, _ = _lunar_runs(True)
    assert buffers != factors[2:]
    assert not all(torch.equal(x, y) for (_, x), (_, y) in zip(
        stale.leaves(), eager.leaves()))


# -- what supported.py carries now ---------------------------------------------

@pytest.mark.parametrize("over", [
    dict(tidal_mixing_method="polzin"),
    dict(tidal_mixing_method="schmittner", ltidal_schmittner_socn=True),
    dict(ltidal_lunar_cycle=True), dict(lniw_mixing=True),
    dict(lniw_mixing=True, niw_energy_type="blke"),
    dict(geoheatflux_const=0.1), dict(ldamp_uv=True)],
    ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()))
def test_ported_switches_are_supported(over):
    cfg = production.get_production_config(**over)
    assert supported.unsupported(cfg) == []


def test_depth_acceleration_is_supported_and_checked():
    cfg = production.get_production_config()
    acc = vmix_menu(cfg, np.linspace(5e2, 5e5, cfg.km))
    assert supported.unsupported(acc) == []
    short = acc.with_(time=dataclasses.replace(acc.time,
                                               dttxcel=(1.0, 2.0)))
    from pop2_tpu_torch.grid import build_grid
    grid = build_grid(short.with_(nx=8, ny=6), "cpu")
    with pytest.raises(ValueError, match="dttxcel has 2 levels"):
        tbaro._timestep_arrays(short.with_(nx=8, ny=6), grid, True)


def test_polynomial_equation_of_state_constructs_and_steps():
    """Once refused at construction (ROADMAP.md Queue 1 item 11b): the
    production preset's vertical mixing under the polynomial equation of
    state constructs and steps on a small grid (its densities are held
    against the JAX package in test_torch_advect_eos.py)."""
    cfg = production.get_production_config(state_choice="polynomial")
    assert supported.unsupported(cfg) == []
    model = TModel(cfg.with_(nx=16, ny=12, km=10, vert_grid="uniform",
                             passive_tracers=(), nt=2), device="cpu")
    state, _ = model.advance(model.initial_state())
    assert all(bool(torch.isfinite(t).all()) for _, t in state.leaves())


def test_production_menu_under_partial_bottom_cells_constructs_and_steps():
    """Once refused at construction (ROADMAP.md Queue 1 item 11c): the
    production preset under partial bottom cells (the degenerate bottom
    cell of the full thickness, no file) constructs and steps on a small
    grid (its values are held against the JAX package in
    test_torch_pbc.py)."""
    cfg = production.get_production_config(partial_bottom_cells=True)
    assert supported.unsupported(cfg) == []
    model = TModel(cfg.with_(nx=16, ny=12, km=10, vert_grid="uniform",
                             passive_tracers=(), nt=2), device="cpu")
    assert model.grid.DZBT is not None
    state, _ = model.advance(model.initial_state())
    assert all(bool(torch.isfinite(t).all()) for _, t in state.leaves())


@pytest.mark.parametrize("over,item", [
    (dict(gm_aniso="east"), "gm_aniso='east'"),
    (dict(state_choice="polynomial", overflows=torch_cfg(get_config(
        "mini").with_(overflows=(ovf_spec(),))).overflows),
     "overflows under state_choice='polynomial'"),
    (dict(mesh_shape=(2, 2), passive_tracers=("ecosys",)),
     "Queue 1 item 12")])
def test_remaining_refusals_still_raise(over, item, monkeypatch):
    cfg = production.get_production_config(**over)
    if tuple(cfg.mesh_shape) == (1, 1):
        with pytest.raises(NotImplementedError, match=item):
            supported.check_supported(cfg)
        return
    # every package runs on blocks (tests/test_torch_ranks_services.py);
    # what stays of item 12 is a decomposition over NCCL, a card a rank
    assert not supported.unsupported(cfg)
    import torch.distributed as dist
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 4)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    with pytest.raises(NotImplementedError, match=item):
        TModel(cfg, device="cpu")
