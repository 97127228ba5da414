"""The flux-limited Lax-Wendroff advection (lw_lim) and the polynomial
equation of state in the port against the JAX package, on the CPU in
float64.

``advt_lw_lim`` on identical inputs, 1e-12 of scale, on a 40 x 24 x 10
grid with a stepped bottom (the 'test' preset's) and on a tripole grid whose
bottom has ocean across the fold, with the Euler, the leapfrog and a depth
accelerated leapfrog step. The polynomial fit: the port's NumPy fit bitwise
equal to the JAX package's, and the densities (with derivatives) at every
pressure profile the package takes them at (the grid's fit and rows of
it), 1e-14 relative; a density without a fit raises; a ``Model`` on a grid
handed to it (moved with ``Grid.to``, the fit with it) steps under
Richardson mixing with Eden-Greatbatch GM and under convective adjustment
with bfre GM. GM under the jmcd, linear and polynomial
equations of state (the plain slopes, as in the JAX package), the tavg
field ADV_3D_TEMP under lw_lim, and whole steps of ``core_lw`` ('mini'
with lw_lim, the polynomial equation of state and GM with the depth
profile and differing diffusivity types), 1e-11 after the first step and
1e-7 after five (``PARITY.md``).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

jax.config.update("jax_enable_x64", True)

from pop2_tpu import advect as jadvect, eos as jeos, gm as jgm  # noqa: E402
from pop2_tpu import baroclinic as jbaro, tavg as jtavg  # noqa: E402
from pop2_tpu.config import get_config  # noqa: E402
from pop2_tpu.grid import build_grid as j_build_grid  # noqa: E402
from pop2_tpu.grid import grid_bc as j_grid_bc  # noqa: E402
from pop2_tpu.state import initial_state as j_initial_state  # noqa: E402

from pop2_tpu_torch import advect as tadvect, baroclinic as tbaro  # noqa: E402
from pop2_tpu_torch import eos as teos, gm as tgm, gm_chain_cuda  # noqa: E402
from pop2_tpu_torch import sample, supported, tavg as ttavg  # noqa: E402
from pop2_tpu_torch import tracer_cuda  # noqa: E402
from pop2_tpu_torch.grid import build_grid as t_build_grid  # noqa: E402
from pop2_tpu_torch.grid import grid_bc as t_grid_bc  # noqa: E402
from pop2_tpu_torch.model import Model as TModel  # noqa: E402
from pop2_tpu_torch.state import initial_state as t_initial_state  # noqa: E402

from tests.test_torch_gm_menu import NSTEPS, StepRun  # noqa: E402
from tests.torch_port_helpers import (GridPair, fold_bottom,  # noqa: E402
                                      scale_err, torch_cfg)

NX, NY, KM = 40, 24, 10
BAND = 1e-12
# chip_smoke.py's core_lw path over the 'mini' preset
CORE_LW = dict(tadvect="lw_lim", state_choice="polynomial",
               hmix_tracer="gm", gm_transition_layer=False,
               gm_kappa_isop_type="depth", gm_kappa_thic_type="const",
               lsubmeso=False)


def _t(a):
    return torch.as_tensor(np.array(a))


class Case:
    """Both packages' grids of one case under lw_lim and the polynomial
    equation of state, and seeded stratified tracers, velocities of 20
    cm/s and a surface-height tendency."""

    def __init__(self, which):
        over = dict(tadvect="lw_lim", state_choice="polynomial")
        if which == "closed":
            p = GridPair("test", seed=3, nx=NX, ny=NY, km=KM,
                         vert_grid="uniform", **over)
            self.jcfg, jg, tg = p.jcfg, p.jgrid, p.tgrid
        else:
            self.jcfg = get_config("prod_full", nx=NX, ny=NY, km=KM,
                                   vert_grid="uniform", passive_tracers=(),
                                   nt=2, **over)
            jg, tg = fold_bottom(j_build_grid(self.jcfg),
                                 t_build_grid(torch_cfg(self.jcfg), "cpu"),
                                 self.jcfg, seed=6)
            assert (np.asarray(jg.KMT)[-2:] > 0).mean() > 0.5
        self.tcfg = torch_cfg(self.jcfg)
        self.jg, self.tg = jg, tg
        self.jbc, self.tbc = j_grid_bc(self.jcfg), t_grid_bc(self.tcfg)
        zt = np.asarray(jg.vgrid.zt, np.float64)
        self.jr = jeos.build_ts_range(zt, self.jcfg.jnp_dtype)
        self.tr = teos.build_ts_range(zt, self.tcfg.torch_dtype)
        self.tmix = sample.stratified_tracers(jg.kmask_t, zt, jg.TLAT, 2, 7)
        self.trcr = sample.stratified_tracers(jg.kmask_t, zt, jg.TLAT, 2, 8)
        rng = np.random.RandomState(37)
        mu = np.asarray(jg.kmask_u)
        self.u = 20.0 * rng.randn(*mu.shape) * mu
        self.v = 20.0 * rng.randn(*mu.shape) * mu
        self.dh = 1.0e-4 * rng.randn(*mu.shape[1:]) * mu[0]

        @jax.jit
        def lw_lim(u, v, dh, trcr, tmix, c2dtt):
            fv = jadvect.comp_flux_vel(self.jcfg, jg, self.jbc, u, v, dh)
            return jadvect.advt(self.jcfg, jg, self.jbc, fv, trcr,
                                tmix=tmix, c2dtt=c2dtt)
        self.jax_lw_lim = lw_lim  # compiled once, for every step kind


_CASES = {}


def _case(which):
    if which not in _CASES:
        _CASES[which] = Case(which)
    return which, _CASES[which]


@pytest.fixture(scope="module", params=["closed", "tripole"])
def case(request):
    return _case(request.param)


@pytest.fixture(scope="module")
def closed():
    return _case("closed")


def _close(got, want, name, band=BAND):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert scale_err(got, np.asarray(want)) <= band, (
        name, scale_err(got, np.asarray(want)))


def _c2dtt(c, kind):
    """The advective step: Euler, leapfrog, or leapfrog under depth
    acceleration (1 down to the third level, then up to 3)."""
    if kind == "laccel":
        xcel = np.concatenate([np.ones(3), np.linspace(1.5, 3.0, KM - 3)])
        jcfg = c.jcfg.with_(time=c.jcfg.time.__class__(**{
            **vars(c.jcfg.time), "laccel": True,
            "dttxcel": tuple(float(x) for x in xcel)}))
    else:
        jcfg = c.jcfg
    leapfrog = kind != "euler"
    want = np.asarray(jbaro._timestep_arrays(jcfg, leapfrog)[0])
    tcfg = torch_cfg(jcfg)
    got = tbaro._timestep_arrays(tcfg, c.tg, leapfrog)[0]
    np.testing.assert_array_equal(got.numpy(), want)
    return want


@pytest.mark.parametrize("kind", ["euler", "leapfrog", "laccel"])
def test_advt_lw_lim(case, kind):
    which, c = case
    c2dtt = _c2dtt(c, kind)
    want = c.jax_lw_lim(*(jnp.asarray(a) for a in (
        c.u, c.v, c.dh, c.trcr, c.tmix, c2dtt)))
    fv = tadvect.comp_flux_vel(c.tcfg, c.tg, c.tbc, _t(c.u), _t(c.v),
                               _t(c.dh))
    got = tadvect.advt(c.tcfg, c.tg, c.tbc, fv, _t(c.trcr),
                       tmix=_t(c.tmix), c2dtt=_t(c2dtt))
    assert np.abs(np.asarray(want)).max() > 0.0
    _close(got, want, f"{which} {kind} lw_lim")
    # the tracer kernel refuses lw_lim; the driver never hands it the scheme
    with pytest.raises(NotImplementedError, match="lw_lim"):
        tracer_cuda._check_mode(c.tcfg, c.tg)


def _profiles(c):
    """Each pressure profile the package takes densities at: the JAX
    package's pressures, and the port's with the rows of the grid's fit."""
    pz, tpz, fit = c.jg.vgrid.pressz, c.tg.vgrid.pressz, c.tg.vgrid.poly
    return {"pressz": (pz, tpz, fit),
            "kp1": (jnp.concatenate([pz[1:], pz[-1:]]),
                    torch.cat([tpz[1:], tpz[-1:]]),
                    teos.fit_rows(fit, "down")),
            "p1": (jnp.full_like(pz, pz[0]), tpz[:1].expand_as(tpz),
                   teos.fit_rows(fit, 0))}


def test_polynomial_fit_bitwise(closed):
    """The port's fit, and each profile's rows of it, bitwise the JAX
    package's own fit of that profile."""
    which, c = closed
    for name, (jp, _, fit) in _profiles(c).items():
        pz = tuple(np.asarray(jp, np.float64).ravel())
        zt = tuple(jeos._depth_from_pressz(pz))
        np.testing.assert_array_equal(teos._depth_from_pressz(pz), zt)
        want = jeos._poly_coeffs_np(zt, pz)
        for g, w in zip(teos._poly_coeffs_np(zt, pz), want):
            np.testing.assert_array_equal(g, w, err_msg=name)
        for g, w in zip((fit.coeffs, fit.tref, fit.sref, fit.sigref), want):
            # p1's one row broadcast over the levels, as the reference's
            g = g.numpy().reshape(np.shape(w)[:-1] + (-1,))
            np.testing.assert_array_equal(np.broadcast_to(g, np.shape(w)),
                                          w, err_msg=name)


def _rel_close(got, want, name, rtol=1e-14):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0, err_msg=name)


@pytest.mark.parametrize("profile", ["pressz", "kp1", "p1"])
def test_polynomial_state(closed, profile):
    which, c = closed
    jp, tp, fit = _profiles(c)[profile]
    want = jeos.state(c.jcfg, jp, jnp.asarray(c.tmix[0]),
                      jnp.asarray(c.tmix[1]), c.jr, want_drhodt=True,
                      want_drhods=True)
    got = teos.state(c.tcfg, tp, _t(c.tmix[0]), _t(c.tmix[1]), c.tr,
                     want_drhodt=True, want_drhods=True, fit=fit)
    for g, w, name in zip(got, want, ("rho", "drhodt", "drhods")):
        _rel_close(g.numpy(), w, f"{profile} {name}")


def test_polynomial_state_at_level(closed):
    """Convective adjustment's densities, each level's pressure alone."""
    which, c = closed
    vg = c.tg.vgrid
    for k in (1, 4, KM - 1):
        t, s = c.tmix[0, k - 1], c.tmix[1, k - 1]
        want = jeos.state_at_level(c.jcfg, c.jg.vgrid.pressz[k],
                                   jnp.asarray(t), jnp.asarray(s))
        got = teos.state_at_level(c.tcfg, vg.pressz[k], _t(t), _t(s),
                                  fit=teos.fit_rows(vg.poly, k))
        _rel_close(got.numpy(), want, f"level {k}")


def test_polynomial_needs_a_prebuilt_fit(closed):
    which, c = closed
    t, s = _t(c.tmix[0]), _t(c.tmix[1])
    pz = c.tg.vgrid.pressz
    with pytest.raises(ValueError, match="no prebuilt fit"):
        teos.state(c.tcfg, pz, t, s)
    with pytest.raises(ValueError, match="no prebuilt fit"):
        teos.state_at_level(c.tcfg, pz[2], t[1], s[1])
    # another equation of state needs none, and its grid carries none
    teos.state(c.tcfg.with_(state_choice="mwjf"), pz, t, s)
    assert t_build_grid(c.tcfg.with_(state_choice="mwjf"),
                        "cpu").vgrid.poly is None


@pytest.mark.parametrize("over", [
    dict(vmix="rich", gm_kappa_isop_type="eg", gm_kappa_thic_type="eg"),
    dict(vmix="const", convection_type="adjustment",
         gm_kappa_isop_type="bfre", gm_kappa_thic_type="bfre")],
    ids=["rich-eg", "convad-bfre"])
def test_polynomial_model_on_a_given_grid(over):
    """A grid handed to ``Model`` is moved with ``Grid.to``; the fit is a
    field of its vertical grid and moves with it, so every density of a
    step finds it: the step's own, the displaced parcel's of Richardson
    mixing and of GM's N^2, each level's of convective adjustment."""
    cfg = torch_cfg(get_config("mini").with_(**{**CORE_LW, **over}))
    grid = t_build_grid(cfg, "cpu")
    moved = grid.to("cpu")
    assert moved is not grid and moved.vgrid.poly is not None
    assert torch.equal(moved.vgrid.poly.coeffs, grid.vgrid.poly.coeffs)
    model = TModel(cfg, grid=grid, device="cpu")
    state, _ = model.advance(model.initial_state())
    assert all(bool(torch.isfinite(t).all()) for _, t in state.leaves())


CHOICES = ["jmcd", "linear", "polynomial"]
_EOS_GM = {}


def _eos_over(choice, tl):
    return dict(state_choice=choice, hmix_tracer="gm",
                gm_transition_layer=tl, gm_kappa_isop_type="const",
                gm_kappa_thic_type="const")


def _jax_gm_under(c, choice):
    """The JAX package's hdifft_gm (gtk, vdc_gm) under each of CHOICES,
    without the transition layer, from one compiled function."""
    if not _EOS_GM:
        _EOS_GM.update(jax.jit(lambda t: {
            ch: jgm.hdifft_gm(c.jcfg.with_(**_eos_over(ch, False)), c.jg,
                              c.jbc, c.jr, t)[:2] for ch in CHOICES})(
                                  jnp.asarray(c.tmix)))
    return _EOS_GM[choice]


@pytest.mark.parametrize("choice", CHOICES)
def test_gm_under_the_equation_of_state(closed, choice):
    """GM under an equation of state other than MWJF: the chain does not
    apply (with the transition layer on, its configuration under MWJF),
    ``gm.hdifft_gm`` runs its plain slopes; held without the transition
    layer, whose search the whole steps of test_torch_gm_menu.py hold.
    (The displaced profile of the N^2-dependent diffusivities is held by
    ``test_polynomial_state``: the JAX package fits the polynomial on the
    host from the profile's values, which a traced JAX function does not
    have there.)"""
    which, c = closed
    tl = torch_cfg(c.jcfg.with_(**_eos_over(choice, True)))
    assert not gm_chain_cuda.available(tl, c.tg)
    assert gm_chain_cuda.available(tl.with_(state_choice="mwjf"), c.tg)
    tcfg = torch_cfg(c.jcfg.with_(**_eos_over(choice, False)))
    want = _jax_gm_under(c, choice)
    out = tgm.hdifft_gm(tcfg, c.tg, c.tbc, c.tr, _t(c.tmix))
    for g, w, name in zip((out.gtk, out.vdc_gm), want, ("gtk", "vdc_gm")):
        assert np.abs(np.asarray(w)).max() > 0.0
        _close(g, w, f"{choice} {name}")


def test_tavg_adv_3d_under_lw_lim(closed):
    """ADV_3D_TEMP: lw_lim's tendency of the mixing-time tracers with the
    leapfrog step."""
    which, c = closed
    jstate = j_initial_state(c.jcfg, c.jg).replace(
        u_cur=jnp.asarray(c.u), v_cur=jnp.asarray(c.v),
        tracer_cur=jnp.asarray(c.trcr), tracer_old=jnp.asarray(c.tmix))
    tstate = t_initial_state(c.tcfg, c.tg, "cpu").replace(
        u_cur=_t(c.u), v_cur=_t(c.v), tracer_cur=_t(c.trcr),
        tracer_old=_t(c.tmix))
    want = jax.jit(lambda s: jtavg.FIELDS["ADV_3D_TEMP"].fn(
        c.jcfg, c.jg, s, jtavg.TavgAux(bc=c.jbc)))(jstate)
    got = ttavg.FIELDS["ADV_3D_TEMP"].fn(c.tcfg, c.tg, tstate,
                                         ttavg.TavgAux(bc=c.tbc, memo={}))
    assert np.abs(np.asarray(want)).max() > 0.0
    _close(got, want, f"{which} ADV_3D_TEMP")


@pytest.fixture(scope="module")
def core_lw():
    jcfg = get_config("mini", **CORE_LW)
    tcfg = torch_cfg(jcfg)
    return StepRun(jcfg, tcfg, t_build_grid(tcfg, "cpu"))


@pytest.mark.parametrize("step,band", [(1, 1e-11), (NSTEPS, 1e-7)])
def test_core_lw_whole_steps_match_the_jax_package(core_lw, step, band):
    assert supported.unsupported(core_lw.tm.cfg) == []
    diffs = core_lw.diffs(step)
    assert max(diffs.values()) <= band, diffs
