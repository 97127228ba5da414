"""The port's KPP vertical mixing and Jayne tidal mixing against the JAX
package, on the CPU in float64.

The same seeded NumPy inputs (stratified T/S with noise strong enough for
convective columns, velocities, a surface heat flux that cools part of the
points so that the convective branches, ghat and the non-local source act,
shortwave, wind stress) go through both packages on two 40 x 24 x 12
configurations, with levels 10 m thick at the surface growing by half a
level each (``torch_port_helpers.stretched_pair``):

  closed   the 'test' grid (cyclic east-west, closed north edge) on a
           stepped bottom: the atan background profile, double diffusion,
           Jerlov shortwave in the boundary-layer depth, the Ekman /
           Monin-Obukhov limits, Jayne tidal mixing;
  tripole  the production menu ('prod_full': the horizontally varying
           background, double diffusion, chlorophyll shortwave, Jayne tidal
           mixing) on a tripole grid whose bottom has ocean across the fold
           (``torch_port_helpers.fold_bottom``), where the smoothing of the
           boundary-layer depth reads the fold.

Each function is fed the JAX package's own upstream results, so that it is
held alone; the whole pipeline ``kpp_coeffs`` is held end to end. Bands:
1e-12 of each field's scale, the integer boundary-layer levels equal, the
Jayne coefficient to 1e-14. ``bldepth`` and ``wscale`` are also held
against the NumPy oracle of the reference (``tests/reference_oracle/
okpp.py``) as the JAX package's own test does.
"""

import itertools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

jax.config.update("jax_enable_x64", True)

from pop2_tpu import kpp as jkpp, tidal_mixing as jtidal  # noqa: E402
from pop2_tpu.config import get_config  # noqa: E402
from pop2_tpu.grid import grid_bc as j_grid_bc  # noqa: E402

from pop2_tpu_torch import kpp as tkpp, tidal_mixing as ttidal  # noqa: E402
from pop2_tpu_torch.grid import grid_bc as t_grid_bc  # noqa: E402

from tests.reference_oracle import okpp  # noqa: E402
from tests.torch_port_helpers import (fold_bottom, scale_err,  # noqa: E402
                                      stepped_bottom, stretched_pair)

NX, NY, KM = 40, 24, 12
MIX = dict(vmix="kpp", kpp_ldbl_diff=True, ltidal_mixing=True,
           tidal_mixing_method="jayne", tidal_energy_const=1.0e-3)
CLOSED = dict(MIX, nx=NX, ny=NY, km=KM, sw_absorption="jerlov",
              jerlov_water_type=3, kpp_lshort_wave=True, kpp_lcheckekmo=True,
              bckgrnd_vdc2=0.3)
PROD = dict(nx=NX, ny=NY, km=KM, passive_tracers=(), nt=2)


def _t(a):
    return torch.as_tensor(np.array(a))


class Case:
    """One configuration in both packages with seeded inputs, the JAX
    package's results of every KPP function (``j``) and the port's
    (``t``)."""

    def __init__(self, name, tmp):
        if name == "closed":
            self.jcfg, self.tcfg, jg, tg = stretched_pair(
                get_config("test", **CLOSED), tmp)
            self.jg, self.tg = stepped_bottom(jg, tg, "cyclic", seed=3)
        else:
            self.jcfg, self.tcfg, jg, tg = stretched_pair(
                get_config("prod_full", **PROD), tmp)
            self.jg, self.tg = fold_bottom(jg, tg, self.jcfg, seed=5)
            assert (np.asarray(self.jg.KMT)[-2:] > 0).mean() > 0.5
        self.jbc, self.tbc = j_grid_bc(self.jcfg), t_grid_bc(self.tcfg)
        self.inputs()
        self.run_jax()
        self.run_port()

    def inputs(self):
        rng = np.random.RandomState(7)
        mt = np.asarray(self.jg.kmask_t)
        mu = np.asarray(self.jg.kmask_u)
        zt = np.asarray(self.jg.vgrid.zt)
        tprof = 2.0 + 16.0 * np.exp(-zt / 8.0e4)
        sprof = 0.0347 - 0.0005 * np.exp(-zt / 5.0e4)
        shape = mt.shape
        T = (tprof[:, None, None] + 0.5 * rng.randn(*shape)) * mt
        S = (sprof[:, None, None] + 2.0e-4 * rng.randn(*shape)) * mt
        self.trcr = np.stack([T, S])
        self.u = 5.0 * rng.randn(*shape) * mu
        self.v = 5.0 * rng.randn(*shape) * mu
        # heating on most points, cooling on the rest: both signs of the
        # surface buoyancy forcing
        heat = 2.0e-5 * np.abs(rng.randn(*shape[1:]))
        cool = rng.rand(*shape[1:]) < 0.4
        self.stf = np.stack([np.where(cool, -heat, heat),
                             1.0e-6 * rng.randn(*shape[1:])]) * mt[0]
        self.qsw = np.abs(2.0e-5 * rng.randn(*shape[1:])) * mt[0]
        self.smft = 0.5 * rng.randn(2, *shape[1:]) * mt[0]
        self.rho = 1.025 + 1.0e-3 * rng.randn(*shape) * mt
        self.hblt_in = (zt[0] + (zt[min(6, KM - 1)] - zt[0])
                        * rng.rand(*shape[1:])) * mt[0]

    def run_jax(self):
        cfg, g, bc = self.jcfg, self.jg, self.jbc
        st = jkpp.build_statics(cfg, g)
        trcr, u, v = (jnp.asarray(a) for a in (self.trcr, self.u, self.v))
        j = {"statics": st}
        j["dbloc"], j["dbsfc"] = jkpp.buoydiff(cfg, g, st, trcr)
        j["ri_iwmix"] = jkpp.ri_iwmix(cfg, g, bc, st, j["dbloc"], u, v,
                                      want_kvmix=True)
        visc, vdc = j["ri_iwmix"][:2]
        j["ddmix"] = jkpp.ddmix(cfg, g, trcr, vdc, vdc)
        j["bldepth"] = jkpp.bldepth(
            cfg, g, bc, st, j["dbloc"], j["dbsfc"], trcr, u, v,
            jnp.asarray(self.stf), jnp.asarray(self.qsw),
            jnp.asarray(self.smft))
        j["smooth_hblt"] = jkpp.smooth_hblt(cfg, g, bc,
                                            jnp.asarray(self.hblt_in))
        hblt, ustar, bfsfc, stable, kbl = j["bldepth"]
        j["blmix"] = jkpp.blmix(cfg, g, st, visc, *j["ddmix"], hblt, ustar,
                                bfsfc, stable, kbl)
        j["hmxl_diag"] = jkpp.hmxl_diag(cfg, g, j["dbsfc"])
        j["hmxl_dr_diag"] = jkpp.hmxl_dr_diag(cfg, g, trcr)
        j["kpp_coeffs"] = jkpp.kpp_coeffs(
            cfg, g, bc, st, trcr, u, v, jnp.asarray(self.stf),
            jnp.asarray(self.qsw), jnp.asarray(self.smft), cfg.convect_diff,
            cfg.convect_visc, rhomix=jnp.asarray(self.rho))
        j["kpp_sources"] = jkpp.kpp_sources(
            cfg, g, j["kpp_coeffs"].ghat_src, jnp.asarray(self.stf))
        self.j = j

    def run_port(self):
        cfg, g, bc, j = self.tcfg, self.tg, self.tbc, self.j
        st = tkpp.build_statics(cfg, g)
        trcr, u, v = (_t(a) for a in (self.trcr, self.u, self.v))
        stf, qsw, smft = _t(self.stf), _t(self.qsw), _t(self.smft)
        jst = tkpp.KPPStatics(*(_t(a) if a is not None else None
                                for a in j["statics"][:7]))
        t = {"statics": st}
        t["dbloc"], t["dbsfc"] = tkpp.buoydiff(cfg, g, st, trcr)
        dbloc, dbsfc = _t(j["dbloc"]), _t(j["dbsfc"])
        t["ri_iwmix"] = tkpp.ri_iwmix(cfg, g, bc, jst, dbloc, u, v)
        visc, vdc = (_t(a) for a in j["ri_iwmix"][:2])
        t["ddmix"] = tkpp.ddmix(cfg, g, trcr, vdc, vdc)
        t["bldepth"] = tkpp.bldepth(cfg, g, bc, jst, dbloc, dbsfc, trcr, u,
                                    v, stf, qsw, smft)
        t["smooth_hblt"] = tkpp.smooth_hblt(cfg, g, bc, _t(self.hblt_in))
        bl = [_t(a) for a in j["bldepth"]]
        t["blmix"] = tkpp.blmix(cfg, g, jst, visc,
                                *(_t(a) for a in j["ddmix"]), *bl)
        t["hmxl_diag"] = tkpp.hmxl_diag(cfg, g, dbsfc)
        t["hmxl_dr_diag"] = tkpp.hmxl_dr_diag(cfg, g, trcr)
        t["kpp_coeffs"] = tkpp.kpp_coeffs(
            cfg, g, bc, st, trcr, u, v, stf, qsw, smft, cfg.convect_diff,
            cfg.convect_visc, rhomix=_t(self.rho))
        t["kpp_sources"] = tkpp.kpp_sources(
            cfg, g, _t(j["kpp_coeffs"].ghat_src), stf)
        self.t = t


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("kpp")
    return {name: Case(name, tmp) for name in ("closed", "tripole")}


def _pairs(got, want):
    if isinstance(want, tuple):
        return list(zip(got, want))
    return [(got, want)]


def _check(got, want, name, band=1e-12):
    got = got.numpy() if hasattr(got, "numpy") else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        assert scale_err(got, want) <= band, (name, scale_err(got, want))


FUNCTIONS = ("dbloc", "dbsfc", "ri_iwmix", "ddmix", "bldepth",
             "smooth_hblt", "blmix", "hmxl_diag", "hmxl_dr_diag",
             "kpp_sources")


def _oracle_buoydiff(c):
    """DBLOC and DBSFC (source/vmix_kpp.F90:3509-3626) from the NumPy
    oracle's MWJF density (``okpp.state_mwjf_derivs``, T clamped at -2 as
    the reference does) on the case's inputs, with the surface-layer pair
    weights of the JAX package's statics."""
    T, S = c.trcr
    pz = np.asarray(c.jg.vgrid.pressz)
    km = pz.shape[0]

    def rho(t, s, p):
        return okpp.state_mwjf_derivs(t, s, p.reshape(-1, 1, 1))[0]
    rho_k = rho(T, S, pz)
    st = c.j["statics"]
    pk, pm, pw = (np.asarray(a) for a in (st.pair_k, st.pair_m, st.pair_w))
    rhoavg = np.tensordot(pw, rho(T[pm], S[pm], pz[pk]), axes=1)
    safe = np.where(rho_k != 0.0, rho_k, 1.0)
    grav = okpp.grav
    dbsfc = np.where(rho_k != 0.0, grav * (1.0 - rhoavg / safe), 0.0)
    dbsfc[0] = 0.0
    dbloc = np.zeros_like(rho_k)
    dbloc[:-1] = np.where(rho_k[1:] != 0.0, grav * (
        1.0 - rho(T[:-1], S[:-1], pz[1:]) / safe[1:]), 0.0)
    kidx = np.arange(1, km)[:, None, None]
    dbloc[:-1] = np.where(kidx >= np.asarray(c.jg.KMT)[None], 0.0,
                          dbloc[:-1])
    return {"dbloc": dbloc, "dbsfc": dbsfc}


@pytest.mark.parametrize("case", ["closed", "tripole"])
@pytest.mark.parametrize("fn", FUNCTIONS)
def test_kpp_function_matches(cases, case, fn):
    c = cases[case]
    try:
        for i, (got, want) in enumerate(_pairs(c.t[fn], c.j[fn])):
            _check(got, want, f"{fn}[{i}]")
    except AssertionError as err:
        if fn not in ("dbloc", "dbsfc"):
            raise
        # say which side moved (ROADMAP.md Queue 3, F2)
        oracle = _oracle_buoydiff(c)[fn]
        raise AssertionError(
            f"{err}; off the NumPy oracle: port "
            f"{scale_err(c.t[fn].numpy(), oracle):.3e}, JAX "
            f"{scale_err(c.j[fn], oracle):.3e} of scale") from None
    if fn == "bldepth":  # the boundary-layer levels, and where they lie
        kbl = c.t[fn][4].numpy()
        ocean = np.asarray(c.jg.KMT) > 0
        assert len(np.unique(kbl[ocean])) >= 3


@pytest.mark.parametrize("case", ["closed", "tripole"])
def test_kpp_coeffs_matches(cases, case):
    """The whole pipeline, every output: 1e-12 of scale, kbl equal; the
    non-local source acts on the cooled points."""
    c = cases[case]
    got, want = c.t["kpp_coeffs"], c.j["kpp_coeffs"]
    for name in want._fields:
        w = getattr(want, name)
        if w is not None:
            _check(getattr(got, name), w, name)
    assert float(got.ghat_src.abs().max()) > 0.0
    assert float(c.t["kpp_sources"].abs().max()) > 0.0
    # the interior diagnostics see the tidal diffusivity beyond the
    # background
    assert float((got.kvmix - c.t["statics"].bckgrnd_vdc).max()) > 0.0


@pytest.mark.parametrize("case", ["closed", "tripole"])
def test_kpp_statics_match(cases, case):
    c = cases[case]
    got, want = c.t["statics"], c.j["statics"]
    for name in ("bckgrnd_vdc", "bckgrnd_vvc", "uref_w", "pair_w"):
        _check(getattr(got, name), getattr(want, name), name, 1e-14)
    for name in ("pair_k", "pair_m"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    # the Jayne coefficient
    assert np.abs(got.tidal_coef.numpy() - np.asarray(want.tidal_coef)).max() \
        <= 1e-14 * np.abs(np.asarray(want.tidal_coef)).max()
    np.testing.assert_allclose(
        ttidal.build_tidal_coef(c.tcfg, c.tg),
        jtidal.build_tidal_coef(c.jcfg, c.jg), rtol=1e-14, atol=0)


def test_bldepth_matches_the_oracle(cases):
    """``bldepth`` against the NumPy transliteration of the reference, on the
    closed grid (the oracle's topology), as tests/test_kpp_oracle.py holds
    the JAX package."""
    c = cases["closed"]
    g = c.jg
    hblt, ustar, bfsfc, stable, kbl = (a.numpy() for a in c.t["bldepth"])
    zt, zw, dz = (np.asarray(getattr(g.vgrid, n)) for n in ("zt", "zw",
                                                            "dz"))
    ho, uo, bo, so, ko = okpp.bldepth(
        zt, zw, dz, np.asarray(g.KMT), np.asarray(g.FCORT), c.trcr, c.u,
        c.v, c.stf, c.qsw, c.smft, float(g.vgrid.pressz[0]),
        lshort_wave=True, lcheckekmo=True,
        water_type=c.jcfg.jerlov_water_type,
        DBLOC=np.asarray(c.j["dbloc"]), DBSFC=np.asarray(c.j["dbsfc"]))
    ocean = np.asarray(g.KMT) > 0
    np.testing.assert_allclose(ustar[ocean], uo[ocean], rtol=1e-12)
    np.testing.assert_allclose(bfsfc[ocean], bo[ocean], rtol=0, atol=1e-13)
    assert (stable[ocean] == so[ocean]).all()
    assert int((kbl[ocean] != ko[ocean]).sum()) == 0
    np.testing.assert_allclose(hblt[ocean], ho[ocean], rtol=0,
                               atol=1e-9 * np.abs(ho[ocean]).max())


def test_wscale_matches_jax_and_the_oracle():
    """The six similarity-law branches at random stability parameters
    spanning stable, weakly and strongly convective."""
    rng = np.random.RandomState(3)
    n = 4096
    sigma = rng.uniform(0.0, 1.0, n)
    hbl = rng.uniform(1.0e2, 5.0e5, n)
    ustar = rng.uniform(0.0, 3.0, n)
    bfsfc = rng.standard_normal(n) * 2.0e-5
    got = tkpp.wscale(*(_t(a) for a in (sigma, hbl, ustar, bfsfc)))
    want = jkpp.wscale(*(jnp.asarray(a) for a in (sigma, hbl, ustar,
                                                  bfsfc)))
    oracle = okpp.wscale(sigma, hbl, ustar, bfsfc, 3)
    for g, w, o in zip(got, want, oracle):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12)
        np.testing.assert_allclose(g.numpy(), o, rtol=1e-12)


# ---- the boundary-layer depth's conditioning (ROADMAP.md Queue 3, F4) -------

HMIX = dict(nx=32, ny=16, km=12, hmix_tracer="del4", hmix_momentum="del4",
            tidal_mixing_method="schmittner", ltidal_schmittner_socn=True,
            ldamp_uv=True, passive_tracers=(), nt=2)


def test_boundary_layer_depth_is_ill_conditioned_on_a_noisy_state(tmp_path):
    """prod_hmix's menu at 32 x 16 x 12 on stretched levels, from its state
    of rest with 0.3 K of T noise and 0.01 of S noise, under the model's
    own wind stress (the first leapfrog step's mixing of the whole-step
    recipe that shows the gap): KPP's boundary-layer depth, which
    interpolates the bulk Richardson number between two levels where it
    changes little, turns last-bit differences of its inputs into
    differences of order 1e-10 of its scale. There the port's HBLT leaves
    the JAX package's compiled one by more than the whole-step band
    (1e-11, which a step carries into S and u: 7.8e-11 and 4.0e-11 after
    one step), and so does the port's own HBLT when T or S moves by one
    ulp, by half as much at least; the buoyancy differences that
    feed it agree to 1e-13 of scale, the level below the boundary layer
    exactly. A property of the state, not a fault of either package: run
    op by op, the JAX package's step lies within 7.2e-12 of the port's."""
    base = get_config("prod_full", **HMIX)
    jcfg, tcfg, jg, tg = stretched_pair(base, tmp_path)
    from pop2_tpu_torch.model import Model as TModel
    tm = TModel(tcfg, grid=tg, device="cpu")
    mt, mu = tg.kmask_t.numpy(), tg.kmask_u.numpy()
    rng = np.random.RandomState(29)
    tr = tm.initial_state().tracer_cur.numpy().copy()
    tr[0] += 0.3 * rng.randn(*tr[0].shape) * mt
    tr[1] += 0.01 * rng.randn(*tr[1].shape) * mt
    rng.randn(*mu.shape)  # the step's u_cur; KPP mixes the old level,
    u = v = np.zeros(mu.shape)  # at rest on the first leapfrog step
    shape = mt.shape[1:]
    heat = 5.0e-4 * np.abs(rng.randn(*shape))
    stf = np.zeros((2,) + shape)
    stf[0] = np.where(rng.rand(*shape) < 0.4, -heat, 0.2 * heat) * mt[0]
    qsw, smft = np.zeros(shape), tm.forcing.smft.numpy()
    jst, tst = jkpp.build_statics(jcfg, jg), tkpp.build_statics(tcfg, tg)
    want = jax.jit(lambda t: jkpp.kpp_coeffs(
        jcfg, jg, j_grid_bc(jcfg), jst, t, *(jnp.asarray(a) for a in (
            u, v, stf, qsw, smft)), jcfg.convect_diff, jcfg.convect_visc))(
        jnp.asarray(tr))

    def port(t):
        return tkpp.kpp_coeffs(tcfg, tg, t_grid_bc(tcfg), tst,
                               *(_t(a) for a in (t, u, v, stf, qsw, smft)),
                               tcfg.convect_diff, tcfg.convect_visc)
    got = port(tr)
    np.testing.assert_array_equal(got.kbl.numpy(), np.asarray(want.kbl))
    gap = scale_err(got.hblt.numpy(), want.hblt)
    own = 0.0  # the port's largest response to T or S moved by one ulp
    for n, to in itertools.product((0, 1), (np.inf, -np.inf)):
        bumped = tr.copy()
        bumped[n] = np.where(mt, np.nextafter(tr[n], to), 0.0)
        own = max(own, scale_err(port(bumped).hblt.numpy(),
                                 got.hblt.numpy()))
    # each package's HBLT lies about one ulp of input rounding from the
    # other's inputs' value: their distance is at most twice that response
    assert gap > 1e-11 and gap <= 2.0 * own, (gap, own)
    jdb = jkpp.buoydiff(jcfg, jg, jst, jnp.asarray(tr))
    tdb = tkpp.buoydiff(tcfg, tg, tst, _t(tr))
    for g, w in zip(tdb, jdb):
        assert scale_err(g.numpy(), w) <= 1e-13
