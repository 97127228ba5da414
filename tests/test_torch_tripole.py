"""The port's tripole north edge and the modules of the production dynamics
menu (prod_dyn) against the JAX package, on the CPU:

  - the fold primitives and every northward BC shift, bitwise;
  - the tripole grid's leaves, the anisotropic-viscosity statics included,
    to 1e-14;
  - in float64 at 1e-12 of scale, on a bottom with ocean across the fold
    (``torch_port_helpers.fold_bottom``; the internal grid's top rows are
    land and would hide a fault of the fold): upwind3 advection, the
    anisotropic friction, the GM chain, frazil ice, the chlorophyll
    shortwave heating, the Robert filter, the FSPAI preconditioner, and the
    preconditioned eigenvalue bounds to 1e-10.

The kernel modes' plain versions are held in ``test_torch_fold_kernels.py``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

jax.config.update("jax_enable_x64", True)

from pop2_tpu import advect as jadvect, gm as jgm, hmix as jhmix  # noqa: E402
from pop2_tpu import ice as jice, solvers as jsol, step as jstep  # noqa: E402
from pop2_tpu import stencil as jst, sw_absorption as jsw  # noqa: E402
from pop2_tpu import tripole as jtri  # noqa: E402
from pop2_tpu.barotropic import diagonal_correction as j_diag  # noqa: E402
from pop2_tpu.config import get_config  # noqa: E402
from pop2_tpu.forcing import analytic_forcing as jaf  # noqa: E402
from pop2_tpu.grid import build_grid as j_build_grid  # noqa: E402
from pop2_tpu.grid import grid_bc as j_grid_bc  # noqa: E402
from pop2_tpu.state import State as JState  # noqa: E402

from pop2_tpu_torch import advect as tadvect, convert  # noqa: E402
from pop2_tpu_torch import gm_chain_cuda, hmix as thmix  # noqa: E402
from pop2_tpu_torch import ice as tice, sample, solvers as tsol  # noqa: E402
from pop2_tpu_torch import step as tstep, stencil as tst  # noqa: E402
from pop2_tpu_torch import sw_absorption as tsw, tripole as ttri  # noqa: E402
from pop2_tpu_torch.barotropic import diagonal_correction as t_diag  # noqa: E402
from pop2_tpu_torch.forcing import analytic_forcing as taf  # noqa: E402
from pop2_tpu_torch.grid import build_grid as t_build_grid  # noqa: E402
from pop2_tpu_torch.grid import grid_bc as t_grid_bc  # noqa: E402

from tests.torch_port_helpers import (assert_leaves_close, fold_bottom,  # noqa: E402
                                      jax_leaves, scale_err, torch_cfg)

LOCS = ("center", "necorner", "eface", "nface")
KINDS = ("scalar", "vector")
# the prod_dyn menu: the production preset without KPP, tidal mixing,
# submesoscale and passive tracers
PROD_DYN = dict(vmix="rich", ltidal_mixing=False, lsubmeso=False,
                passive_tracers=(), nt=2)
NX, NY, KM = 32, 16, 6   # ny % 8 == 0: the Pallas interpret mode needs it


def _field(seed, shape=(2, 3, 10, 12)):
    return np.random.RandomState(seed).randn(*shape)


# ---- the fold primitives and the BC shifts, bitwise -----------------------

@pytest.mark.parametrize("loc", LOCS)
@pytest.mark.parametrize("kind", KINDS)
def test_fold_primitives_bitwise(loc, kind):
    f = _field(1)
    jf, tf = jnp.asarray(f), torch.as_tensor(f)
    for n in (1, 2):
        np.testing.assert_array_equal(
            ttri.fold_rows(tf, n, loc, kind).numpy(),
            np.asarray(jtri.fold_rows(jf, n, loc, kind)))
        np.testing.assert_array_equal(
            ttri.shift_n_tripole(tf, n, loc, kind).numpy(),
            np.asarray(jtri.shift_n_tripole(jf, n, loc, kind)))
    np.testing.assert_array_equal(
        ttri.enforce_top_symmetry(tf, loc, kind).numpy(),
        np.asarray(jtri.enforce_top_symmetry(jf, loc, kind)))
    np.testing.assert_array_equal(
        ttri.reduction_weights(10, 12, loc).numpy(),
        np.asarray(jtri.reduction_weights(10, 12, loc)))


@pytest.mark.parametrize("ew", ["cyclic", "closed"])
@pytest.mark.parametrize("loc", LOCS)
def test_bc_tripole_shifts_bitwise(ew, loc):
    f, g = _field(2), _field(3)
    jbc, tbc = jst.BC(ew, "tripole"), tst.BC(ew, "tripole")
    jf, tf = jnp.asarray(f), torch.as_tensor(f)
    for kind in KINDS:
        for name in ("n", "nn", "ne", "nw"):
            np.testing.assert_array_equal(
                getattr(tbc, name)(tf, loc, kind).numpy(),
                np.asarray(getattr(jbc, name)(jf, loc, kind)), name)
        np.testing.assert_array_equal(
            tbc.n_partner(tf, torch.as_tensor(g), loc, kind).numpy(),
            np.asarray(jbc.n_partner(jf, jnp.asarray(g), loc, kind)))
    for name in ("e", "w", "s", "se", "sw"):
        np.testing.assert_array_equal(
            getattr(tbc, name)(tf).numpy(),
            np.asarray(getattr(jbc, name)(jf)), name)
    with pytest.raises(NotImplementedError, match="location and kind"):
        tst.shift_n(tf, "tripole")


# ---- the tripole grid, leaf for leaf ---------------------------------------

@pytest.mark.parametrize("over", [
    dict(),
    dict(nx=40, ny=24, km=10, flat_bottom=False, n_topo_smooth=1,
         hmix_momentum="aniso"),
    dict(nx=40, ny=24, km=10, ew_boundary="closed", hmix_momentum="aniso",
         lvariable_hmix_aniso=False, lsmag_aniso=True, smag_lat_fact=0.3),
])
def test_tripole_grid_leaves_equal(over):
    jcfg = get_config("mini", ns_boundary="tripole", **over)
    tgrid = t_build_grid(torch_cfg(jcfg), "cpu")
    jgrid = j_build_grid(jcfg)
    assert (tgrid.aniso is not None) == (jcfg.hmix_momentum == "aniso")
    assert_leaves_close(tgrid.leaves(), jax_leaves(jgrid), rtol=1e-14)


# ---- the fold-active pair and the modules in float64 -----------------------

class FoldPair:
    """The prod_dyn menu at NX x NY x KM in both packages, on the bottom
    with ocean across the fold."""

    def __init__(self, dtype, seed=4, **over):
        base = dict(PROD_DYN, nx=NX, ny=NY, km=KM, vert_grid="uniform",
                    dtype=dtype)
        base.update(over)
        self.jcfg = get_config("prod_full", **base)
        self.tcfg = torch_cfg(self.jcfg)
        self.jgrid, self.tgrid = fold_bottom(
            j_build_grid(self.jcfg), t_build_grid(self.tcfg, "cpu"),
            self.jcfg, seed)
        self.jbc, self.tbc = j_grid_bc(self.jcfg), t_grid_bc(self.tcfg)
        self.np_dtype = np.float64 if dtype == "float64" else np.float32

    def tracers(self, seed, noise=0.1):
        return sample.stratified_tracers(
            np.asarray(self.jgrid.kmask_t), np.asarray(self.jgrid.vgrid.zt),
            np.asarray(self.jgrid.TLAT), 2, seed, self.np_dtype, noise)

    def rand(self, seed, *shape, scale=1.0, mask=None):
        a = scale * np.random.RandomState(seed).randn(*shape)
        if mask is not None:
            a = a * np.asarray(mask)
        return a.astype(self.np_dtype)

    def ts_ranges(self):
        from pop2_tpu import eos as jeos
        from pop2_tpu_torch import eos as teos
        zt = np.asarray(self.jgrid.vgrid.zt, np.float64)
        return (jeos.build_ts_range(zt, self.jcfg.jnp_dtype),
                teos.build_ts_range(zt, self.tcfg.torch_dtype))


@pytest.fixture(scope="module")
def fold():
    p = {dt: FoldPair(dt) for dt in ("float64", "float32")}
    for q in p.values():  # the fold bottom keeps ocean in the top rows
        assert (np.asarray(q.jgrid.KMT)[-2:] > 0).mean() > 0.5
        assert (q.tgrid.KMU[-1] > 0).any() and (q.tgrid.KMU[-2] > 0).any()
        np.testing.assert_array_equal(q.tgrid.KMTN.numpy(),
                                      np.asarray(q.jgrid.KMTN))
    return p


def test_fold_pair_leaves_equal(fold):
    p = fold["float64"]
    assert_leaves_close(p.tgrid.leaves(), jax_leaves(p.jgrid), rtol=1e-14)
    # the grid handed across as NumPy leaves builds the same port grid
    back = convert.grid_from_numpy(jax_leaves(p.jgrid), p.tcfg, "cpu")
    assert_leaves_close(back.leaves(), jax_leaves(p.jgrid), rtol=1e-14)


def _uv(p, seed):
    m = p.jgrid.kmask_u
    return (p.rand(seed, KM, NY, NX, scale=10.0, mask=m),
            p.rand(seed + 1, KM, NY, NX, scale=10.0, mask=m))


def test_advt_upwind3_matches(fold):
    p = fold["float64"]
    u, v = _uv(p, 11)
    dh = p.rand(13, NY, NX, scale=1e-4)
    tr = p.tracers(14)
    jfv = jadvect.comp_flux_vel(p.jcfg, p.jgrid, p.jbc, jnp.asarray(u),
                                jnp.asarray(v), jnp.asarray(dh))
    want = jadvect.advt_upwind3(p.jcfg, p.jgrid, p.jbc, jfv, jnp.asarray(tr))
    tfv = tadvect.comp_flux_vel(p.tcfg, p.tgrid, p.tbc, torch.as_tensor(u),
                                torch.as_tensor(v), torch.as_tensor(dh))
    got = tadvect.advt_upwind3(p.tcfg, p.tgrid, p.tbc, tfv,
                               torch.as_tensor(tr))
    assert scale_err(got.numpy(), np.asarray(want)) <= 1e-12
    assert scale_err(got[..., -2:, :].numpy(),
                     np.asarray(want)[..., -2:, :]) <= 1e-12


def test_hdiffu_aniso_matches(fold):
    p = fold["float64"]
    u, v = _uv(p, 21)
    want = jhmix.hdiffu(p.jcfg, p.jgrid, p.jbc, jnp.asarray(u),
                        jnp.asarray(v))
    got = thmix.hdiffu(p.tcfg, p.tgrid, p.tbc, torch.as_tensor(u),
                       torch.as_tensor(v))
    for g, w in zip(got, want):
        assert scale_err(g.numpy(), np.asarray(w)) <= 1e-12
        assert np.abs(np.asarray(w)[:, -1]).max() > 0  # the fold row moves


def test_gm_chain_on_tripole_matches(fold):
    p = fold["float64"]
    jr, tr = p.ts_ranges()
    tmix = p.tracers(31)
    want = jgm.hdifft_gm(p.jcfg, p.jgrid, p.jbc, jr, jnp.asarray(tmix))
    got = gm_chain_cuda.hdifft_chain(p.tcfg, p.tgrid, p.tbc, tr,
                                     torch.as_tensor(tmix))
    for name in ("gtk", "vdc_gm", "kappa_isop", "kappa_thic", "hor_diff"):
        assert scale_err(getattr(got, name).numpy(),
                         np.asarray(getattr(want, name))) <= 1e-12, name
    assert np.abs(np.asarray(want.gtk)[:, :, -1]).max() > 0


def test_ice_formation_matches(fold):
    p = fold["float64"]
    tr = p.tracers(41)
    # a surface layer from -3 to +1 C: freezing where below -1.9 C
    tr[0, 0] = (1.0 - 4.0 * np.random.RandomState(42).rand(NY, NX)) \
        * np.asarray(p.jgrid.kmask_t)[0]
    psurf = p.rand(43, NY, NX, scale=100.0)
    q0, aq0 = p.rand(44, NY, NX), p.rand(45, NY, NX)
    for weight in (1.0, 0.5):
        want = jice.ice_formation(p.jcfg, p.jgrid, jnp.asarray(tr),
                                  jnp.asarray(psurf), jnp.asarray(q0),
                                  jnp.asarray(aq0), weight)
        got = tice.ice_formation(p.tcfg, p.tgrid, torch.as_tensor(tr),
                                 torch.as_tensor(psurf), torch.as_tensor(q0),
                                 torch.as_tensor(aq0), weight)
        for g, w in zip(got, want):
            assert scale_err(g.numpy(), np.asarray(w)) <= 1e-12
    assert np.abs(np.asarray(want[0]) - tr).max() > 0.1  # ice formed


def test_chlorophyll_shortwave_matches(fold):
    p = fold["float64"]
    chl = 10.0 ** p.rand(51, NY, NX)       # 0.1 .. 10 mg/m^3 and beyond
    qsw = 100.0 * np.abs(p.rand(52, NY, NX))
    ft = p.rand(53, 2, KM, NY, NX)
    jtr = jsw.chl_transmission(p.jcfg, p.jgrid, jnp.asarray(chl))
    ttr = tsw.chl_transmission(p.tcfg, p.tgrid, torch.as_tensor(chl))
    assert scale_err(ttr.numpy(), np.asarray(jtr)) <= 1e-12
    want = jsw.add_sw_absorb(p.jcfg, p.jgrid, jnp.asarray(ft),
                             jnp.asarray(qsw), jtr)
    got = tsw.add_sw_absorb(p.tcfg, p.tgrid, torch.as_tensor(ft),
                            torch.as_tensor(qsw), ttr)
    assert scale_err(got.numpy(), np.asarray(want)) <= 1e-12
    jprof = jsw.absorb_profile(p.jcfg, p.jgrid)
    tprof = tsw.absorb_profile(p.tcfg, p.tgrid)
    assert scale_err(tprof.numpy(), np.asarray(jprof)) <= 1e-14


def test_robert_filter_matches(fold):
    p = fold["float64"]
    jr, tr = p.ts_ranges()
    rng = np.random.RandomState(61)
    mt, mu = np.asarray(p.jgrid.kmask_t), np.asarray(p.jgrid.kmask_u)
    fields = {}
    for lvl, seed in (("old", 1), ("cur", 2), ("new", 3)):
        fields[lvl] = dict(
            tracer=p.tracers(60 + seed), u=10 * rng.randn(KM, NY, NX) * mu,
            v=10 * rng.randn(KM, NY, NX) * mu,
            psurf=100 * rng.randn(NY, NX) * mt[0],
            btrop=rng.randn(4, NY, NX))
    names = [f.name for f in JState.__dataclass_fields__.values()]

    def state(a, b, rf_valid):
        d = dict(tracer_old=a["tracer"], tracer_cur=b["tracer"],
                 u_old=a["u"], u_cur=b["u"], v_old=a["v"], v_cur=b["v"],
                 rho_old=np.zeros((KM, NY, NX)),
                 rho_cur=np.zeros((KM, NY, NX)),
                 ubtrop_old=a["btrop"][0], ubtrop_cur=b["btrop"][0],
                 vbtrop_old=a["btrop"][1], vbtrop_cur=b["btrop"][1],
                 psurf_old=a["psurf"], psurf_cur=b["psurf"],
                 gradpx_old=a["btrop"][2], gradpx_cur=b["btrop"][2],
                 gradpy_old=a["btrop"][3], gradpy_cur=b["btrop"][3],
                 pguess=b["psurf"], fw_old=np.zeros((NY, NX)),
                 qice=rng.randn(NY, NX), aqice=rng.randn(NY, NX),
                 rf_s_prev=np.array([1e-3, -2e-6]),
                 rf_s_prev_valid=np.array(rf_valid))
        assert sorted(d) == sorted(names)
        return d

    for valid in (0.0, 1.0):
        before = state(fields["old"], fields["cur"], valid)
        after = state(fields["cur"], fields["new"], valid)
        jf, tf = jaf(p.jcfg, p.jgrid), taf(p.tcfg, p.tgrid)
        want = jstep._robert_filter(
            p.jcfg, p.jgrid, p.jbc, jr,
            JState(**{k: jnp.asarray(v) for k, v in before.items()}),
            JState(**{k: jnp.asarray(v) for k, v in after.items()}), jf)
        got = tstep._robert_filter(
            p.tcfg, p.tgrid, tr, convert.state_from_numpy(before, p.tcfg,
                                                          "cpu"),
            convert.state_from_numpy(after, p.tcfg, "cpu"), tf)
        wl = jax_leaves(want)
        for name, t in got.leaves():
            assert scale_err(t.numpy(), wl[name]) <= 1e-12, name


@pytest.fixture(scope="module")
def fspai(fold):
    p = fold["float64"]
    jop = jsol.make_operator(p.jgrid, j_diag(p.jcfg, p.jgrid, True))
    top = tsol.make_operator(p.tgrid, t_diag(p.tcfg, p.tgrid, True))
    return p, jop, top, jsol.build_fspai9(p.jcfg, jop), \
        tsol.build_fspai9(p.tcfg, top)


def test_build_fspai9_matches(fspai):
    p, _, _, jpre, tpre = fspai
    for name in tsol.FSPAI9._fields:
        assert scale_err(getattr(tpre, name).numpy(),
                         np.asarray(getattr(jpre, name))) <= 1e-12, name
    r = p.rand(71, NY, NX)
    want = jsol.fspai_apply(jpre, p.jbc)(jnp.asarray(r))
    got = tsol.fspai_apply(tpre, p.tbc)(torch.as_tensor(r))
    assert scale_err(got.numpy(), np.asarray(want)) <= 1e-12


def test_pcg_lanczos_eigs_match(fspai):
    p, jop, top, jpre, tpre = fspai
    want = jsol.pcg_lanczos_eigs(p.jcfg, jop, p.jbc, jpre)
    got = tsol.pcg_lanczos_eigs(p.tcfg, top, p.tbc, tpre)
    np.testing.assert_allclose(got, want, rtol=1e-10)
    assert 0 < got[0] < got[1]
