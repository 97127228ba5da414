"""The rest of the GM menu in the port against the JAX package, on the CPU
in float64: the diffusivity types 'depth', 'vmhs' and 'eg', isopycnal and
thickness diffusivities of differing types, and anisotropic GM.

Functions on identical inputs, band 1e-12 of each field's scale, on a
40 x 24 x 10 grid with a stepped bottom (the 'test' preset's cyclic,
closed-north grid) and on a tripole grid whose bottom has ocean across the
fold (the top row's north faces opened, ``sample.open_top_face``):
``kappa_vmhs``, ``kappa_eg`` (with and without a boundary layer),
``kappa_fields`` for type pairs, ``_aniso_factors``, the plain flux
assembly with x and y diffusivities apart in both branches against
``flux_assembly_jnp``, ``hdifft_gm`` of each variant, the tavg field HDIFT
under 'vmhs' and anisotropic 'flow' GM. Whole steps (``PARITY.md``: 1e-11
after the first step, 1e-7 after five): ``prod_eg`` (the production preset
with Eden-Greatbatch diffusivities) and ``prod_aniso`` (without the
transition layer, Visbeck diffusivities, flow-aligned anisotropy) at
32 x 16 x 10, with T and S alone. Anisotropic GM with the transition layer
raises in both packages.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

jax.config.update("jax_enable_x64", True)

from pop2_tpu import eos as jeos, gm as jgm, tavg as jtavg  # noqa: E402
from pop2_tpu.config import get_config  # noqa: E402
from pop2_tpu.grid import build_grid as j_build_grid  # noqa: E402
from pop2_tpu.grid import grid_bc as j_grid_bc  # noqa: E402
from pop2_tpu.model import Model as JModel  # noqa: E402
from pop2_tpu.state import initial_state as j_initial_state  # noqa: E402

from pop2_tpu_torch import convert, gm as tgm, gm_chain_cuda  # noqa: E402
from pop2_tpu_torch import sample, supported, tavg as ttavg  # noqa: E402
from pop2_tpu_torch.grid import build_grid as t_build_grid  # noqa: E402
from pop2_tpu_torch.grid import grid_bc as t_grid_bc  # noqa: E402
from pop2_tpu_torch.model import Model as TModel  # noqa: E402
from pop2_tpu_torch.state import initial_state as t_initial_state  # noqa: E402

from tests.torch_port_helpers import (GridPair, fold_bottom,  # noqa: E402
                                      jax_leaves, scale_err, stretched_pair,
                                      torch_cfg)

NX, NY, KM = 40, 24, 10
BAND = 1e-12
NSTEPS = 5
# chip_smoke.py's paths over the production preset
PROD_EG = dict(gm_kappa_isop_type="eg", gm_kappa_thic_type="eg")
PROD_ANISO = dict(gm_transition_layer=False, gm_aniso="flow",
                  gm_kappa_isop_type="vmhs", gm_kappa_thic_type="vmhs")
# GM without the transition layer over the grids' configurations
FLUX = dict(hmix_tracer="gm", gm_transition_layer=False, lsubmeso=False)


def _t(a):
    return torch.as_tensor(np.array(a))


class Case:
    """Both packages' grids of one case and one set of seeded inputs:
    stratified tracers, mixing-time velocities of 20 cm/s, a boundary
    layer of levels 2 to 6."""

    def __init__(self, which):
        if which == "closed":
            p = GridPair("test", seed=2, nx=NX, ny=NY, km=KM,
                         vert_grid="uniform", **FLUX)
            self.jcfg, jg, tg = p.jcfg, p.jgrid, p.tgrid
        else:
            self.jcfg = get_config("prod_full", nx=NX, ny=NY, km=KM,
                                   vert_grid="uniform", passive_tracers=(),
                                   nt=2, gm_transition_layer=False)
            jg, tg = fold_bottom(j_build_grid(self.jcfg),
                                 t_build_grid(torch_cfg(self.jcfg), "cpu"),
                                 self.jcfg, seed=4)
            assert (np.asarray(jg.KMT)[-2:] > 0).mean() > 0.5
            htn = sample.open_top_face(tg).HTN
            jg, tg = jg.replace(HTN=jnp.asarray(htn.numpy())), tg.replace(
                HTN=htn)
        self.tcfg = torch_cfg(self.jcfg)
        self.jg, self.tg = jg, tg
        self.jbc, self.tbc = j_grid_bc(self.jcfg), t_grid_bc(self.tcfg)
        zt = np.asarray(jg.vgrid.zt, np.float64)
        self.jr = jeos.build_ts_range(zt, self.jcfg.jnp_dtype)
        from pop2_tpu_torch import eos as teos
        self.tr = teos.build_ts_range(zt, self.tcfg.torch_dtype)
        self.tmix = sample.stratified_tracers(jg.kmask_t, zt, jg.TLAT, 2, 5)
        rng = np.random.RandomState(31)
        mu = np.asarray(jg.kmask_u)
        self.u = 20.0 * rng.randn(*mu.shape) * mu
        self.v = 20.0 * rng.randn(*mu.shape) * mu
        self.hblt = ((zt[1] + (zt[5] - zt[1]) * rng.rand(*mu.shape[1:]))
                     * (np.asarray(jg.KMT) > 0))

    def with_(self, **over):
        """(JAX config, port config) of this case with ``over``."""
        jcfg = self.jcfg.with_(**over)
        return jcfg, torch_cfg(jcfg)

    def j(self):
        return (jnp.asarray(self.tmix), jnp.asarray(self.u),
                jnp.asarray(self.v), jnp.asarray(self.hblt))

    def t(self):
        return _t(self.tmix), _t(self.u), _t(self.v), _t(self.hblt)


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


_KAPPAS = {}


def _jax_kappas(which, c):
    """The JAX package's kappa_vmhs, kappa_eg without and with the boundary
    layer, the sigma mask and the 'flow' factors of a case, from one
    compiled function (one compile a case)."""
    if which not in _KAPPAS:
        jflow = c.jcfg.with_(gm_aniso="flow")

        @jax.jit
        def jfn(t, u, v, h):
            return (jgm.kappa_vmhs(c.jcfg, c.jg, c.jbc, c.jr, t, u, v),
                    jgm.kappa_eg(c.jcfg, c.jg, c.jbc, c.jr, t, u, v, None),
                    jgm.kappa_eg(c.jcfg, c.jg, c.jbc, c.jr, t, u, v, h),
                    jgm._sigma_topo_mask(c.jg, c.jbc, KM),
                    jgm._aniso_factors(jflow, c.jg, c.jbc, u, v))
        _KAPPAS[which] = jfn(*c.j())
    return _KAPPAS[which]


def _close(got, want, name, band=BAND):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.broadcast_to(np.asarray(want), got.shape)
    assert scale_err(got, want) <= band, (name, scale_err(got, want))


def test_kappa_vmhs(case):
    which, c = case
    want = _jax_kappas(which, c)[0]
    got = tgm.kappa_vmhs(c.tcfg, c.tg, c.tbc, c.tr, *c.t()[:3])
    # the Visbeck diffusivity varies inside its bounds
    assert np.ptp(np.asarray(want)) > 1e5
    _close(got, want, f"{which} kappa_vmhs")


@pytest.mark.parametrize("with_hblt", [False, True])
def test_kappa_eg(case, with_hblt):
    which, c = case
    want = _jax_kappas(which, c)[1 + int(with_hblt)]
    t, u, v, h = c.t()
    got = tgm.kappa_eg(c.tcfg, c.tg, c.tbc, c.tr, t, u, v,
                       h if with_hblt else None)
    assert np.ptp(np.asarray(want)) > 0.0
    _close(got, want, f"{which} kappa_eg")


def test_sigma_topo_mask(case):
    which, c = case
    want = _jax_kappas(which, c)[3]
    got = tgm._sigma_topo_mask(c.tg, c.tbc, KM)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


KINDS = [("depth", "depth"), ("vmhs", "vmhs"), ("eg", "eg"),
         ("depth", "const"), ("bfre", "vmhs")]
_KF = {}


def _kinds_cfg(c, kinds):
    return c.with_(gm_kappa_isop_type=kinds[0], gm_kappa_thic_type=kinds[1],
                   gm_ah_bolus=6.0e6)


def _jax_kappa_fields(c):
    """The JAX package's kappa_fields of every pair of KINDS (isop, thic,
    vertical profile) and its cancellation flag, a Python bool kept while
    the function traces, from one compiled function."""
    if not _KF:
        cancellation = {}

        @jax.jit
        def jfn(t, u, v, h):
            res = {}
            for kinds in KINDS:
                out = jgm.kappa_fields(_kinds_cfg(c, kinds)[0], c.jg, c.jbc,
                                       c.jr, t, u, v, h)
                cancellation[kinds] = out[2]
                res[kinds] = (out[0], out[1], out[3])
            return res
        for kinds, want in jfn(*c.j()).items():
            _KF[kinds] = want, cancellation[kinds]
    return _KF


@pytest.mark.parametrize("kinds", KINDS, ids=lambda k: "-".join(k))
def test_kappa_fields(closed, kinds):
    which, c = closed
    jcfg, tcfg = _kinds_cfg(c, kinds)
    want, cancellation = _jax_kappa_fields(c)[kinds]
    t, u, v, h = c.t()
    got = tgm.kappa_fields(tcfg, c.tg, c.tbc, c.tr, t, u, v, h)
    assert got[2] == cancellation
    for g, w, name in zip((got[0], got[1], got[3]), want,
                          ("kappa_isop", "kappa_thic", "kappa_vert")):
        g = torch.as_tensor(g, dtype=torch.float64)
        _close(g.expand(np.broadcast_shapes(g.shape, np.shape(w))), w,
               f"{kinds} {name}")


@pytest.mark.parametrize("kind", ["grid", "flow"])
def test_aniso_factors(case, kind):
    which, c = case
    jcfg, tcfg = c.with_(gm_aniso=kind)
    want = (jgm._aniso_factors(jcfg, c.jg, c.jbc, None, None)
            if kind == "grid" else _jax_kappas(which, c)[4])
    got = tgm._aniso_factors(tcfg, c.tg, c.tbc, *c.t()[1:3])
    for g, w in zip(got, want):
        if kind == "grid":
            assert g == w
        else:
            _close(g, w, f"{which} {kind}")


def _flux_fields(c, cancellation):
    """The flux assembly's operands (``sample.flux_operands``) with the y
    faces' diffusivity 0.3 of the x faces' in the upper half of the column
    and 1.7 of it below, NumPy; zero streamfunction where it is not read."""
    f = [a.numpy() for a in sample.flux_operands(
        c.tcfg, c.tg, c.tbc, c.tr, _t(c.tmix), levels=(1, 4))]
    if cancellation:
        f[5], f[6] = np.zeros_like(f[5]), np.zeros_like(f[6])
    ky = f[7] * np.where(np.arange(KM)[None, :, None, None] < KM // 2, 0.3,
                         1.7)
    return f, ky


_FLUX = {}


def _jax_flux(which, c):
    """The JAX package's flux_assembly_jnp of a case's operands in both
    branches (cancellation, skew), from one compiled function."""
    if which not in _FLUX:
        ops = {canc: _flux_fields(c, canc) for canc in (True, False)}

        @jax.jit
        def jfn(ops):
            return {canc: jgm.flux_assembly_jnp(
                c.jcfg, c.jg, c.jbc, *f[:8], ky, f[8], canc)
                for canc, (f, ky) in ops.items()}
        _FLUX[which] = ops, jfn(ops)
    return _FLUX[which]


@pytest.mark.parametrize("cancellation", [True, False])
def test_flux_assembly_aniso_plain_matches_jnp(case, cancellation):
    which, c = case
    ops, want = _jax_flux(which, c)
    f, ky = ops[cancellation]
    want = want[cancellation]
    got = tgm.flux_assembly(c.tcfg, c.tg, c.tbc,
                            *(_t(a) for a in f), cancellation,
                            kisop_y=_t(ky))
    iso = tgm.flux_assembly_plain(c.tcfg, c.tg, c.tbc, *(_t(a) for a in f),
                                  cancellation)
    for g, w, name in zip(got, want, ("gtk", "vdc_gm")):
        _close(g, w, f"{which} {name}")
        _close(g[..., -2:, :], np.asarray(w)[..., -2:, :], f"{name} top")
    # the y faces' diffusivity moves the result
    assert scale_err(iso[0].numpy(), np.asarray(want[0])) > 1e-3


VARIANTS = {
    "depth": dict(gm_kappa_isop_type="depth", gm_kappa_thic_type="depth"),
    "vmhs": dict(gm_kappa_isop_type="vmhs", gm_kappa_thic_type="vmhs"),
    "eg": dict(gm_kappa_isop_type="eg", gm_kappa_thic_type="eg"),
    "bfre_vmhs": dict(gm_kappa_isop_type="bfre",
                      gm_kappa_thic_type="vmhs"),
    "aniso_flow_vmhs": dict(gm_aniso="flow", gm_kappa_isop_type="vmhs",
                            gm_kappa_thic_type="vmhs"),
}
TAVG_VARIANTS = ("vmhs", "aniso_flow_vmhs")
_GM = {}


def _jax_gm(c, variant):
    """The JAX package's hdifft_gm of a variant (gtk, vdc_gm and the three
    diffusivity columns) and, for TAVG_VARIANTS, its tavg field HDIFT, of
    the mixing-time tracers and velocities; every variant from one compiled
    function (the tavg field's GM is the same call: no T/S range, no
    boundary layer)."""
    if not _GM:
        def one(variant, t, u, v):
            jcfg = c.jcfg.with_(**VARIANTS[variant])
            o = jgm.hdifft_gm(jcfg, c.jg, c.jbc, None, t, umix=u, vmix_m=v)
            out = (o.gtk, o.vdc_gm, o.kappa_isop, o.kappa_thic, o.hor_diff)
            if variant not in TAVG_VARIANTS:
                return out
            s = j_initial_state(jcfg, c.jg).replace(tracer_old=t, u_old=u,
                                                    v_old=v)
            return out + (jtavg.FIELDS["HDIFT"].fn(
                jcfg, c.jg, s, jtavg.TavgAux(bc=c.jbc)),)
        _GM.update(jax.jit(lambda t, u, v: {
            variant: one(variant, t, u, v) for variant in VARIANTS})(
                *c.j()[:3]))
    return _GM[variant]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_hdifft_gm_variant(closed, variant):
    which, c = closed
    jcfg, tcfg = c.with_(**VARIANTS[variant])
    assert not gm_chain_cuda.available(tcfg, c.tg)
    want = _jax_gm(c, variant)
    t, u, v, _ = c.t()
    out = tgm.hdifft_gm(tcfg, c.tg, c.tbc, None, t, umix=u, vmix_m=v)
    got = (out.gtk, out.vdc_gm, out.kappa_isop, out.kappa_thic,
           out.hor_diff)
    assert np.abs(np.asarray(want[0])).max() > 0.0
    for g, w, name in zip(got, want, ("gtk", "vdc_gm", "kappa_isop",
                                      "kappa_thic", "hor_diff")):
        _close(g, w, f"{variant} {name}")


@pytest.mark.parametrize("variant", TAVG_VARIANTS)
def test_tavg_hdift(closed, variant):
    """HDIFT: GM's tendency of the mixing-time tracers and velocities."""
    which, c = closed
    jcfg, tcfg = c.with_(**VARIANTS[variant])
    t, u, v, _ = c.t()
    tstate = t_initial_state(tcfg, c.tg, "cpu").replace(
        tracer_old=t, u_old=u, v_old=v)
    want = _jax_gm(c, variant)[5]
    got = ttavg.FIELDS["HDIFT"].fn(tcfg, c.tg, tstate,
                                   ttavg.TavgAux(bc=c.tbc, memo={}))
    assert np.abs(np.asarray(want)).max() > 0.0
    _close(got, want, f"HDIFT {variant}")


def test_aniso_with_transition_layer_raises(closed):
    which, c = closed
    jcfg, tcfg = c.with_(gm_aniso="flow", gm_transition_layer=True)
    with pytest.raises(NotImplementedError, match="transition layer"):
        jax.jit(lambda t, u, v: jgm.hdifft_gm(
            jcfg, c.jg, c.jbc, c.jr, t, umix=u, vmix_m=v))(*c.j()[:3])
    with pytest.raises(NotImplementedError, match="transition layer"):
        tgm.hdifft_gm(tcfg, c.tg, c.tbc, c.tr, c.t()[0], umix=c.t()[1],
                      vmix_m=c.t()[2])
    assert supported.unsupported(tcfg) == []


# -- whole steps ---------------------------------------------------------------

class StepRun:
    """One configuration in both packages from one perturbed state (T noise,
    a seeded u) under a heat flux that cools part of the points: NSTEPS
    leapfrog steps of ``advance`` each (the step counter starts past the
    Euler step: one compiled JAX step)."""

    def __init__(self, jcfg, tcfg, tgrid, jgrid=None):
        jm = JModel(jcfg, grid=jgrid)
        tm = TModel(tcfg, grid=tgrid, device="cpu")
        self.tm = tm
        g = jm.grid
        mt, mu = np.asarray(g.kmask_t), np.asarray(g.kmask_u)
        rng = np.random.RandomState(29)
        start = jm.initial_state()
        leaves = jax_leaves(start)
        tr = leaves["tracer_cur"].copy()
        tr[0] += 0.1 * rng.randn(*tr[0].shape) * mt
        rho = np.asarray(jnp.where(g.kmask_t, jeos.state(
            jcfg, g.vgrid.pressz, jnp.asarray(tr[0]), jnp.asarray(tr[1]),
            jm.ts_range), 0.0))
        u = 5.0 * rng.randn(*mt.shape) * mu
        leaves.update(tracer_cur=tr, tracer_old=tr, rho_cur=rho,
                      rho_old=rho, u_cur=u, u_old=u)
        shape = mt.shape[1:]
        heat = 5.0e-4 * np.abs(rng.randn(*shape))
        stf = np.zeros((jcfg.nt,) + shape)
        stf[0] = np.where(rng.rand(*shape) < 0.4, -heat, 0.2 * heat) * mt[0]
        jf = jm.forcing.replace(stf=jnp.asarray(stf))
        tf = tm.forcing.replace(stf=torch.as_tensor(stf))
        js = start.replace(
            **{k: jnp.asarray(leaves[k]) for k in (
                "tracer_cur", "tracer_old", "rho_cur", "rho_old", "u_cur",
                "u_old")})
        ts = convert.state_from_numpy(leaves, tcfg, "cpu")
        jm.nsteps_total = tm.nsteps_total = 1
        self.jsteps, self.tsteps = [], []
        for _ in range(NSTEPS):
            js, _ = jm.advance(js, jf)
            ts, _ = tm.advance(ts, tf)
            self.jsteps.append(jax_leaves(js))
            self.tsteps.append(ts)

    def diffs(self, step):
        state, want = self.tsteps[step - 1], self.jsteps[step - 1]
        out = {k: scale_err(getattr(state, k).numpy(), want[k])
               for k in ("u_cur", "v_cur", "psurf_cur", "ubtrop_cur",
                         "vbtrop_cur")}
        for n in range(want["tracer_cur"].shape[0]):
            out[f"tracer{n}"] = scale_err(state.tracer_cur[n].numpy(),
                                          want["tracer_cur"][n])
        return out


@pytest.fixture(scope="module", params=["prod_eg", "prod_aniso"])
def stepped(request, tmp_path_factory):
    over = PROD_EG if request.param == "prod_eg" else PROD_ANISO
    jcfg, tcfg, jgrid, tgrid = stretched_pair(
        get_config("prod_full", nx=32, ny=16, km=KM, passive_tracers=(),
                   nt=2, **over), tmp_path_factory.mktemp(request.param))
    return request.param, StepRun(jcfg, tcfg, tgrid, jgrid)


@pytest.mark.parametrize("step,band", [(1, 1e-11), (NSTEPS, 1e-7)])
def test_whole_steps_match_the_jax_package(stepped, step, band):
    which, r = stepped
    assert supported.unsupported(r.tm.cfg) == []
    assert not gm_chain_cuda.available(r.tm.cfg, r.tm.grid)
    diffs = r.diffs(step)
    assert max(diffs.values()) <= band, (which, diffs)
