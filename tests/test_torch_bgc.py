"""Ocean biogeochemistry in the port against the JAX package, on the CPU in
float64: the carbonate solver (``co2calc``), the abiotic DIC/DIC14
(``abio_dic``), the 32-tracer ecosystem (``ecosys``), the model's own
chlorophyll under ``chl_option='model'``, and the GM chain and flux
assembly at 39 tracers.

prod_bgc is the production configuration with the ideal age, the CFC
tracers, the ecosystem and the abiotic DIC (nt = 39) and the ecosystem's
surface chlorophyll driving the shortwave absorption, here at 32 x 16 on
the internal tripole grid with 20 internal levels (uniform levels put the
whole photic zone in the first cell). One JAX model serves the whole file;
its functions are called eagerly on its grid and forcing, and its compiled
step runs once per step kind (the steps start past the Euler step: one
compile). Bands, relative to each field's scale: the functions 1e-12;
whole steps (PARITY.md) 1e-11 after the first step, 1e-7 after five, each
tracer on its own scale; the chain and flux twins those of ROADMAP.md's
North star (1e-12 in float64; in float32 5e-5 of scale or 5 % of the value
for the chain, 2e-5 of scale for the flux assembly).
"""

import itertools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

jax.config.update("jax_enable_x64", True)

from pop2_tpu import abio_dic as jabio, co2calc as jco2  # noqa: E402
from pop2_tpu import ecosys as jeco, eos as jeos, gm as jgm  # noqa: E402
from pop2_tpu.config import get_config  # noqa: E402
from pop2_tpu.grid import grid_bc as j_grid_bc  # noqa: E402
from pop2_tpu.model import Model as JModel  # noqa: E402

from pop2_tpu_torch import abio_dic as tabio, co2calc as tco2  # noqa: E402
from pop2_tpu_torch import convert, ecosys as teco  # noqa: E402
from pop2_tpu_torch import gm as tgm, gm_chain_cuda, gm_cuda  # noqa: E402
from pop2_tpu_torch import gm_slope_cuda, gm_tlt_cuda  # noqa: E402
from pop2_tpu_torch import sample, supported, sw_absorption  # noqa: E402
from pop2_tpu_torch.grid import grid_bc as t_grid_bc  # noqa: E402
from pop2_tpu_torch.model import Model as TModel  # noqa: E402
from pop2_tpu_torch.passive_tracers import PassiveTracers as TPassive  # noqa: E402

from tests.torch_port_helpers import (GridPair, jax_leaves,  # noqa: E402
                                      scale_err, torch_cfg)

BAND = 1e-12
NSTEPS = 5
PACKAGES = ("iage", "cfc", "ecosys", "abio_dic")
NT = 39
BGC = dict(nx=32, ny=16, km=20, vert_grid="internal",
           passive_tracers=PACKAGES, nt=NT, chl_option="model")
U10_SQR = 4.9e5  # cm^2/s^2: a 7 m/s wind
S0_ECO = 2 + 3   # the ecosystem's first slot: after T, S, IAGE, CFC11/12
FIELDS = ("u_cur", "v_cur", "psurf_cur", "ubtrop_cur", "vbtrop_cur")


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, name, band=BAND):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert np.abs(want).max() > 0.0, name
    assert scale_err(got, want) <= band, (name, scale_err(got, want))


class Bgc:
    """prod_bgc in both packages: the models (the port's on the JAX grid's
    leaves), a seeded state of both time levels and a forcing with
    shortwave, wind and sea ice; the JAX package's steps run on first use
    (``steps``)."""

    def __init__(self):
        self.jcfg = get_config("prod_full", **BGC)
        self.tcfg = torch_cfg(self.jcfg)
        self.jm = JModel(self.jcfg)
        self.tm = TModel(self.tcfg, grid=convert.grid_from_numpy(
            jax_leaves(self.jm.grid), self.tcfg, "cpu"), device="cpu")
        g = self.jm.grid
        mt = np.asarray(g.kmask_t)
        rng = np.random.RandomState(41)
        leaves = jax_leaves(self.jm.initial_state())
        tr = leaves["tracer_cur"].copy()
        tr[0] += 0.1 * rng.randn(*tr[0].shape) * mt
        # the ecosystem's fields varied point by point, a few below zero
        # (the interior sources clip them), O2 low at a fifth of the points
        eco = tr[S0_ECO:S0_ECO + 32]
        eco *= 1.0 + 0.3 * rng.randn(*eco.shape)
        eco[jeco.IDX["O2"]] *= np.where(rng.rand(*mt.shape) < 0.2, 0.01, 1.0)
        told = tr.copy()
        told[2:] *= 1.0 + 0.01 * rng.randn(*told[2:].shape)
        rho = np.asarray(jnp.where(g.kmask_t, jeos.state(
            self.jcfg, g.vgrid.pressz, jnp.asarray(tr[0]),
            jnp.asarray(tr[1]), self.jm.ts_range), 0.0))
        leaves.update(tracer_cur=tr * mt, tracer_old=told * mt, rho_cur=rho,
                      rho_old=rho)
        self.leaves = leaves
        shape = mt.shape[1:]
        self.forcing = dict(
            shf_qsw=4.0e-3 * np.abs(rng.randn(*shape)) * mt[0],
            u10_sqr=U10_SQR * (0.5 + rng.rand(*shape)),
            ifrac=np.clip(1.5 * rng.rand(*shape) - 0.5, 0.0, 1.0))
        stf = np.zeros((NT,) + shape)
        stf[0] = -2.0e-4 * np.abs(rng.randn(*shape)) * mt[0]
        self.forcing["stf"] = stf
        self._steps = None

    def jforcing(self, **drop):
        f = {k: v for k, v in self.forcing.items() if k not in drop}
        return self.jm.forcing.replace(
            **{k: jnp.asarray(v) for k, v in f.items()})

    def tforcing(self, **drop):
        f = {k: v for k, v in self.forcing.items() if k not in drop}
        return self.tm.forcing.replace(**{k: _t(v) for k, v in f.items()})

    def tracers(self):
        """(old, cur) of both packages: JAX arrays, port tensors."""
        lv = self.leaves
        return ((jnp.asarray(lv["tracer_old"]), jnp.asarray(lv["tracer_cur"])),
                (_t(lv["tracer_old"]), _t(lv["tracer_cur"])))

    def steps(self):
        """NSTEPS leapfrog steps of each package from the seeded state
        (the step counter past the Euler step), with the chlorophyll the
        port's first step handed to the shortwave absorption."""
        if self._steps is None:
            jm, tm = self.jm, self.tm
            js = jm.initial_state().replace(**{
                k: jnp.asarray(self.leaves[k]) for k in (
                    "tracer_cur", "tracer_old", "rho_cur", "rho_old")})
            ts = convert.state_from_numpy(self.leaves, self.tcfg, "cpu")
            jf, tf = self.jforcing(), self.tforcing()
            jm.nsteps_total = tm.nsteps_total = 1
            seen = []
            trans = sw_absorption.chl_transmission

            def spy(cfg, grid, chl):
                seen.append(chl.clone())
                return trans(cfg, grid, chl)
            jout, tout = [], []
            for n in range(NSTEPS):
                js, _ = jm.advance(js, jf)
                if n == 0:
                    sw_absorption.chl_transmission = spy
                try:
                    ts, _ = tm.advance(ts, tf)
                finally:
                    sw_absorption.chl_transmission = trans
                jout.append(jax_leaves(js))
                tout.append(ts)
            self._steps = jout, tout, seen
        return self._steps


@pytest.fixture(scope="module")
def bgc():
    return Bgc()


# ---- the carbonate system and the gas-exchange coefficients ----------------

@pytest.mark.parametrize("case", ["ocean", "bracket_ends"])
def test_co2calc_surface_matches(case):
    """Seeded SST/SSS/DIC/ALK; 'bracket_ends' puts the root of half of the
    points near pH 6 and of the other half near 10 (and some beyond, where
    the bisection ends at the bracket)."""
    rng = np.random.RandomState(5)
    n = 400
    temp, salt = rng.uniform(-2.0, 35.0, n), rng.uniform(4.0, 40.0, n)
    if case == "ocean":
        dic = rng.uniform(1.8e-3, 2.4e-3, n)
        ta = rng.uniform(2.1e-3, 2.6e-3, n)
    else:
        dic = np.where(np.arange(n) % 2, rng.uniform(3.0e-3, 4.0e-3, n),
                       rng.uniform(1.0e-5, 2.0e-4, n))
        ta = np.where(np.arange(n) % 2, rng.uniform(1.0e-4, 3.0e-3, n),
                      rng.uniform(2.0e-3, 4.0e-3, n))
    want = jco2.co2calc_surface(*(jnp.asarray(a) for a in (temp, salt, dic,
                                                          ta)))
    got = tco2.co2calc_surface(*(_t(a) for a in (temp, salt, dic, ta)))
    for name in tco2.CO2Result._fields:
        _close(getattr(got, name), getattr(want, name), name)
    ph = got.ph.numpy()
    if case == "bracket_ends":
        assert ph.min() < 6.5 and ph.max() > 9.5, (ph.min(), ph.max())
    coeffs_j = jco2.surface_coeffs(jnp.asarray(temp), jnp.asarray(salt))
    coeffs_t = tco2.surface_coeffs(_t(temp), _t(salt))
    for name in tco2.CO3Coeffs._fields:
        _close(getattr(coeffs_t, name), getattr(coeffs_j, name), name)


@pytest.mark.parametrize("fn", ["o2_saturation", "schmidt_o2",
                                "schmidt_co2"])
def test_gas_exchange_coefficients_match(fn):
    rng = np.random.RandomState(9)
    sst, sss = rng.uniform(-5.0, 45.0, 300), rng.uniform(0.0, 42.0, 300)
    mods = (jabio, tabio) if fn == "schmidt_co2" else (jeco, teco)
    args = (sst, sss) if fn == "o2_saturation" else (sst,)
    want = getattr(mods[0], fn)(*(jnp.asarray(a) for a in args))
    _close(getattr(mods[1], fn)(*(_t(a) for a in args)), want, fn)


@pytest.mark.parametrize("bury", [None, "dunne", "field"])
def test_sink_remin_matches(bgc, bury):
    g = bgc.jm.grid
    km = bgc.jcfg.km
    rng = np.random.RandomState(13)
    prod = rng.rand(km, *g.KMT.shape) * 1e-6
    dz3 = np.asarray(g.vgrid.dz).reshape(km, 1, 1)
    mask = np.asarray(g.kmask_t)
    bottom = (np.arange(1, km + 1)[:, None, None] == np.asarray(g.KMT)[None])
    b = {"field": rng.rand(*g.KMT.shape)}.get(bury, bury)
    want = jeco._sink_remin(jnp.asarray(prod), jnp.asarray(dz3),
                            jnp.asarray(mask), jnp.asarray(bottom),
                            jeco.POC_LENGTH,
                            bury=jnp.asarray(b) if bury == "field" else b)
    got = teco._sink_remin(_t(prod), _t(dz3), _t(mask), _t(bottom),
                           teco.POC_LENGTH,
                           bury=_t(b) if bury == "field" else b)
    _close(got[0], want[0], "remin")
    if bury is None:
        assert float(got[1].abs().max()) == 0.0
    else:
        _close(got[1], want[1], "burial")


# ---- the ecosystem package --------------------------------------------------

def test_ecosystem_init_values_match(bgc):
    jpkg, tpkg = bgc.jm.passive.packages[2], bgc.tm.passive.packages[2]
    assert isinstance(tpkg, teco.Ecosystem) and tpkg.slot0 == S0_ECO
    want = jpkg.init_values(bgc.jcfg, bgc.jm.grid)
    got = tpkg.init_values(bgc.tcfg, bgc.tm.grid)
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=0)


def _packages(bgc, name, **params):
    """(JAX, port) instances of package ``name`` with ``params`` (the
    defaults where empty), the port's carried by ``convert``, at the slot
    the model gives it."""
    jpkg = next(p for p in bgc.jm.passive.packages
                if p.names == (jeco.TRACER_NAMES if name == "ecosys"
                               else jabio.AbioDIC.names))
    if params:
        slot = jpkg.slot0
        jpkg = type(jpkg)(**params)
        jpkg.slot0 = slot
    tpkg = convert.package_from_numpy(name,
                                      convert.package_to_numpy(name, jpkg))
    tpkg.slot0 = jpkg.slot0
    return jpkg, tpkg


ECO_PARAMS = {"default": {},
              "params": dict(fe_dust_flux=3.0e-8, pco2_atm=400.0,
                             pco2_atm_alt=280.0, lburial=False)}


@pytest.mark.parametrize("params", ["default", "params"])
def test_ecosystem_set_interior_matches(bgc, params):
    jpkg, tpkg = _packages(bgc, "ecosys", **ECO_PARAMS[params])
    (jo, jc), (to, tc) = bgc.tracers()
    want = jpkg.set_interior(bgc.jcfg, bgc.jm.grid, jo, jc, bgc.jforcing())
    got = tpkg.set_interior(bgc.tcfg, bgc.tm.grid, to, tc, bgc.tforcing())
    assert got.shape == (32,) + tuple(bgc.jm.grid.kmask_t.shape)
    for n, name in enumerate(teco.TRACER_NAMES):
        _close(got[n], want[n], name)
    # without shortwave there is no light and no growth
    dark = tpkg.set_interior(bgc.tcfg, bgc.tm.grid, to, tc,
                             bgc.tforcing(shf_qsw=True))
    _close(dark, jpkg.set_interior(bgc.jcfg, bgc.jm.grid, jo, jc,
                                   bgc.jforcing(shf_qsw=True)), "dark")


@pytest.mark.parametrize("forcing", ["no_wind", "wind", "wind_no_ice"])
def test_ecosystem_set_sflux_matches(bgc, forcing):
    jpkg, tpkg = _packages(bgc, "ecosys", **ECO_PARAMS["params"])
    drop = {"no_wind": dict(u10_sqr=True), "wind": {},
            "wind_no_ice": dict(ifrac=True)}[forcing]
    (jo, jc), (to, tc) = bgc.tracers()
    want = jpkg.set_sflux(bgc.jcfg, bgc.jm.grid, jo, jc,
                          bgc.jforcing(**drop))
    got = tpkg.set_sflux(bgc.tcfg, bgc.tm.grid, to, tc, bgc.tforcing(**drop))
    live = [teco.IDX[n] for n in ("Fe", "O2", "DIC", "DIC_ALT_CO2")]
    for n in live[:1] if forcing == "no_wind" else live:
        _close(got[n], want[n], teco.TRACER_NAMES[n])
    rest = [n for n in range(32) if n not in live]
    assert float(got[rest].abs().max()) == 0.0
    assert np.abs(np.asarray(want)[rest]).max() == 0.0


def test_ecosystem_reset_matches(bgc):
    jpkg, tpkg = _packages(bgc, "ecosys")
    block = np.random.RandomState(17).randn(32, *bgc.jm.grid.kmask_t.shape)
    want = jpkg.reset(bgc.jcfg, bgc.jm.grid, jnp.asarray(block))
    got = tpkg.reset(bgc.tcfg, bgc.tm.grid, _t(block))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---- the abiotic DIC --------------------------------------------------------

@pytest.mark.parametrize("part", ["set_sflux", "set_interior"])
def test_abio_dic_matches(bgc, part):
    jpkg, tpkg = _packages(bgc, "abio_dic", pco2_atm=350.0, d14c_atm=-50.0,
                           dic_init=2.1)
    assert tpkg.slot0 == NT - 2
    (jo, jc), (to, tc) = bgc.tracers()
    want = getattr(jpkg, part)(bgc.jcfg, bgc.jm.grid, jo, jc,
                               bgc.jforcing())
    got = getattr(tpkg, part)(bgc.tcfg, bgc.tm.grid, to, tc, bgc.tforcing())
    for n, name in enumerate(tabio.AbioDIC.names):
        if part == "set_interior" and n == 0:  # no source for DIC
            assert float(got[0].abs().max()) == 0.0
            continue
        _close(got[n], want[n], name)
    if part == "set_sflux":  # no wind, no flux
        calm = tpkg.set_sflux(bgc.tcfg, bgc.tm.grid, to, tc,
                              bgc.tforcing(u10_sqr=True))
        assert float(calm.abs().max()) == 0.0
    np.testing.assert_array_equal(
        tpkg.init_values(bgc.tcfg, bgc.tm.grid),
        jpkg.init_values(bgc.jcfg, bgc.jm.grid))


def test_package_parameters_carried_and_checked(bgc):
    jpkg, tpkg = _packages(bgc, "ecosys", **ECO_PARAMS["params"])
    assert vars(tpkg) == {k: v for k, v in vars(jpkg).items()}
    tp = TPassive(bgc.tcfg, ("iage", "cfc", tpkg, "abio_dic"))
    assert tp.packages[2] is tpkg and tpkg.slot0 == S0_ECO
    with pytest.raises(KeyError, match="missing"):
        convert.package_from_numpy("abio_dic", {"pco2_atm": 1.0})
    with pytest.raises(KeyError, match="unknown"):
        convert.package_from_numpy("abio_dic", dict(
            convert.package_to_numpy("abio_dic", jabio.AbioDIC()), x=1.0))


def test_model_chl_matches(bgc):
    (_, jc), (_, tc) = bgc.tracers()
    want = bgc.jm.passive.model_chl(jc)
    got = bgc.tm.passive.model_chl(tc)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert TPassive(torch_cfg(get_config("mini", nt=3, passive_tracers=(
        "iage",))), ("iage",)).model_chl(tc) is None


# ---- what the port refuses --------------------------------------------------

def test_production_bgc_is_supported():
    from pop2_tpu_torch import production
    cfg = production.get_production_config(passive_tracers=PACKAGES, nt=NT,
                                           chl_option="model")
    assert supported.unsupported(cfg) == []


def test_wrong_tracer_count_raises():
    cfg = torch_cfg(get_config("prod_full", **BGC))
    with pytest.raises(ValueError, match="nt=38"):
        TPassive(cfg.with_(nt=38), PACKAGES)
    with pytest.raises(ValueError, match="need nt = 2"):
        TModel(cfg.with_(nt=40), device="cpu")


# ---- whole steps ------------------------------------------------------------

@pytest.mark.parametrize("step,band", [(1, 1e-11), (NSTEPS, 1e-7)])
def test_whole_steps_match_the_jax_package(bgc, step, band):
    jout, tout, _ = bgc.steps()
    state, want = tout[step - 1], jout[step - 1]
    diffs = {k: scale_err(getattr(state, k).numpy(), want[k])
             for k in FIELDS}
    for n in range(NT):
        diffs[f"tracer{n}"] = scale_err(state.tracer_cur[n].numpy(),
                                        want["tracer_cur"][n])
    assert max(diffs.values()) <= band, diffs
    moved = np.abs(want["tracer_cur"][S0_ECO:] - bgc.leaves["tracer_cur"][
        S0_ECO:]).max(axis=(1, 2, 3))
    assert (moved > 0.0).all()


def test_first_step_shortwave_takes_the_ecosystem_chlorophyll(bgc):
    _, _, seen = bgc.steps()
    assert len(seen) == 1
    (_, jc), (_, tc) = bgc.tracers()
    assert torch.equal(seen[0], bgc.tm.passive.packages[2].surface_chl(tc))
    np.testing.assert_array_equal(seen[0].numpy(),
                                  np.asarray(bgc.jm.passive.model_chl(jc)))
    assert float(seen[0].max()) > 0.0


# ---- the GM chain and the flux assembly at 39 tracers -----------------------

GM_FULL = dict(hmix_tracer="gm", gm_transition_layer=True,
               gm_kappa_isop_type="bfre", gm_kappa_thic_type="bfre",
               gm_kappa_isop_deep=0.2, gm_kappa_thic_deep=0.1,
               gm_ah=3.0e7, gm_ah_bolus=3.0e7, gm_ah_bkg_srfbl=3.0e7)


@pytest.fixture(scope="module")
def gm_pairs():
    """The 'mini' preset at nt = 39 on a stepped bottom, float64 and
    float32."""
    return {dt: GridPair("mini", nx=32, ny=16, km=12, dtype=dt, nt=NT,
                         **GM_FULL) for dt in ("float64", "float32")}


def _tmix(p, seed):
    """T and S stratified (``sample.stratified_tracers``) and 37 more
    tracers, each a seeded multiple of T plus noise."""
    g = p.jgrid
    ts = sample.stratified_tracers(g.kmask_t, g.vgrid.zt, g.TLAT, 2, seed)
    rng = np.random.RandomState(seed)
    mt = np.asarray(g.kmask_t)
    more = (rng.uniform(0.1, 10.0, (NT - 2, 1, 1, 1)) * ts[:1]
            + rng.randn(NT - 2, *mt.shape)) * mt
    return np.concatenate([ts, more]).astype(p.np_dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_chain_plain_at_39_tracers_matches_jnp(gm_pairs, dtype):
    p = gm_pairs[dtype]
    jr, tr = p.ts_ranges()
    tmix = _tmix(p, 3)
    want = jax.jit(lambda t: jgm.hdifft_gm(
        p.jcfg, p.jgrid, j_grid_bc(p.jcfg), jr, t, use_kernels=False))(
        jnp.asarray(tmix))
    got = gm_chain_cuda.hdifft_chain(p.tcfg, p.tgrid, t_grid_bc(p.tcfg), tr,
                                     _t(tmix))
    assert got.gtk.shape[0] == NT
    for name in ("gtk", "vdc_gm"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        if dtype == "float64":
            assert scale_err(g, w) <= BAND, name
        else:
            err, aw = np.abs(g - w), np.abs(w)
            ok = (err <= 5e-5 * aw.max()) | (err <= 5e-2 * aw)
            assert ok.all(), (name, int((~ok).sum()))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_flux_assembly_plain_at_39_tracers_matches_jnp(gm_pairs, dtype):
    p = gm_pairs[dtype]
    _, tr = p.ts_ranges()
    f = [a.numpy() for a in sample.flux_operands(
        p.tcfg, p.tgrid, t_grid_bc(p.tcfg), tr, _t(_tmix(p, 6)),
        levels=(1, 4))]
    assert f[0].shape[0] == NT
    jf = [jnp.asarray(a) for a in f]
    want = jgm.flux_assembly_jnp(p.jcfg, p.jgrid, j_grid_bc(p.jcfg), *jf[:8],
                                 jf[7], jf[8], False)
    got = tgm.flux_assembly_plain(p.tcfg, p.tgrid, t_grid_bc(p.tcfg),
                                  *(_t(a) for a in f), False)
    band = BAND if dtype == "float64" else 2e-5
    for g, w, name in zip(got, want, ("gtk", "vdc_gm")):
        assert scale_err(g.numpy(), w) <= band, name


def _chain_operands(p, tr, tmix):
    """The chain's operands after the slopes of ``tmix``'s T and S: (slp,
    sla, kv, tlt), as ``hdifft_chain`` forms them."""
    cfg, grid, bc = p.tcfg, p.tgrid, t_grid_bc(p.tcfg)
    slp, sla, n2 = gm_slope_cuda.slopes(cfg, grid, bc, tr, tmix)
    tlt = gm_tlt_cuda.transition_layer(
        cfg, grid, tgm.diabatic_depth(cfg, grid, bc, None), sla,
        tgm._rossby_radius(grid))
    kv = tgm.kappa_vertical_bfre(cfg, grid, tr, tmix, tlt.interior_depth,
                                 n2=n2)
    return slp, sla, kv, tlt


@pytest.mark.parametrize("kernel", ["chain", "flux_assembly"])
def test_tracer_groups_do_not_change_a_tracer(gm_pairs, kernel):
    """The launches of 39 tracers and the plain twins taken a group at a
    time: every tracer's tendency as in one call on all of them, VDC_GM as
    the first group's. The chain's groups fill two blocks an SM where that
    leaves groups of 8 or more (float32: 8 + 8 + 8 + 8 + 7), else take 16
    at most (float64: 13 + 13 + 13, as the flux assembly's)."""
    thirteen = [(0, 13), (13, 13), (26, 13)]
    assert gm_cuda.tracer_groups(NT) == thirteen
    assert gm_chain_cuda.tracer_groups(NT, 8, True) == thirteen
    assert gm_chain_cuda.tracer_groups(NT, 4, True) == [
        (0, 8), (8, 8), (16, 8), (24, 8), (32, 7)]
    assert gm_cuda.tracer_groups(16) == [(0, 16)]
    for vb, sm in itertools.product((4, 8), (False, True)):
        assert gm_chain_cuda.tracer_groups(5, vb, sm) == [(0, 5)]
    with pytest.raises(ValueError):
        gm_cuda.tracer_groups(0)
    with pytest.raises(ValueError):
        gm_chain_cuda.tracer_groups(0, 8)
    p = gm_pairs["float64"]
    _, tr = p.ts_ranges()
    bc = t_grid_bc(p.tcfg)
    tmix = _t(_tmix(p, 8))
    if kernel == "chain":
        ops = _chain_operands(p, tr, tmix)

        def run(t):
            return gm_chain_cuda.chain_plain(p.tcfg, p.tgrid, bc, t, *ops,
                                             want_diags=False)[:2]
    else:
        f = sample.flux_operands(p.tcfg, p.tgrid, bc, tr, tmix,
                                 levels=(1, 4))

        def run(t):
            tx, ty, tz = tgm.tracer_diffs(p.tcfg, p.tgrid, bc, t)
            return tgm.flux_assembly_plain(p.tcfg, p.tgrid, bc, tx, ty, tz,
                                           *f[3:], False)
    gtk, vdc = run(tmix)
    groups = (gm_chain_cuda.tracer_groups(NT, 4, True) if kernel == "chain"
              else gm_cuda.tracer_groups(NT))
    for g, (n0, n) in enumerate(groups):
        part, pvdc = run(tmix[n0:n0 + n])
        assert torch.equal(part, gtk[n0:n0 + n]), (kernel, n0)
        if g == 0:
            assert torch.equal(pvdc, vdc)
