"""The port's GM/Redi path against the JAX package, on the CPU.

The same seeded NumPy inputs (the stratified T/S profile of the JAX
package's GM kernel tests, on a 32 x 16 x 12 grid with a stepped bathymetry)
go through both packages:

  (a) float64, the port's plain chain (``gm.py`` and the plain versions of
      the three GM kernels) against the jnp chain: 1e-12 of each field's
      scale. Slopes are compared point by point (rtol 1e-12) since their
      scale is set by the clamped points: where the vertical density
      difference is not negative the slope divides by -1e-20, rides a
      cancellation, and two evaluation orders differ; the JAX package's test
      allows 5 % there and so does this one;
  (b) float32, the port's ``slopes``, ``hdifft_chain`` and ``flux_assembly``
      entries (plain versions on the CPU) against the JAX package's Pallas
      kernels in interpret mode, at the bands the JAX package holds those
      kernels to;
  (c) the tracer kernel's plain version in its ``with_del2=False`` mode
      against ``-advt + vdifft``;
  (d) the whole step: ``Model`` with both GM configurations against
      ``pop2_tpu.model.Model`` in float64, at the ``PARITY.md`` bands;
  (e) what the port does not carry raises and names its ROADMAP item.

On CPU tensors the wrappers take the plain versions; the CUDA kernels are
held against these plain versions on the GPU by ``chip_smoke.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pop2_tpu import advect as jadvect, gm as jgm, vmix as jvmix  # noqa: E402
from pop2_tpu import constants as jconst  # noqa: E402
from pop2_tpu import gm_chain_pallas, gm_pallas, gm_slope_pallas  # noqa: E402
from pop2_tpu.grid import grid_bc as j_grid_bc  # noqa: E402
from pop2_tpu.model import Model as JModel  # noqa: E402

from pop2_tpu_torch import baroclinic as tbaroclinic, convert  # noqa: E402
from pop2_tpu_torch import gm as tgm, gm_chain_cuda, gm_cuda  # noqa: E402
from pop2_tpu_torch import gm_slope_cuda, sample, supported, tracer_cuda  # noqa: E402
from pop2_tpu_torch.config import get_config as t_get_config  # noqa: E402
from pop2_tpu_torch.grid import grid_bc as t_grid_bc  # noqa: E402
from pop2_tpu_torch.model import Model as TModel  # noqa: E402

from tests.reference_oracle.compare import matched_config_at  # noqa: E402
from tests.torch_port_helpers import (GridPair, jax_leaves, scale_err,  # noqa: E402
                                      torch_cfg)

NX, NY, KM = 32, 16, 12   # ny % 8 == 0: the Pallas interpret mode needs it

# the two GM configurations of the port's main path
GM_FULL = dict(hmix_tracer="gm", gm_transition_layer=True,
               gm_kappa_isop_type="bfre", gm_kappa_thic_type="bfre",
               gm_kappa_isop_deep=0.2, gm_kappa_thic_deep=0.1,
               gm_ah=3.0e7, gm_ah_bolus=3.0e7, gm_ah_bkg_srfbl=3.0e7)
GM_FLUX = dict(hmix_tracer="gm")   # transition layer off, const kappa
CONFIGS = {"gm_full": GM_FULL, "gm_flux": GM_FLUX}


@pytest.fixture(scope="module")
def pairs():
    """Grids by (dtype, east-west boundary), built once per module."""
    return {(dt, ew): GridPair("mini", nx=NX, ny=NY, km=KM, dtype=dt,
                               ew_boundary=ew, hmix_tracer="gm")
            for dt in ("float64", "float32") for ew in ("cyclic", "closed")}


def _tmix(p, seed=3):
    return sample.stratified_tracers(p.jgrid.kmask_t, p.jgrid.vgrid.zt,
                                     p.jgrid.TLAT, p.jcfg.nt, seed,
                                     p.np_dtype)


def _slopes_close(got, want, rtol, name):
    """Point by point, with the JAX package's allowance at clamped points."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    aw = np.abs(want)
    regular = aw[aw <= 1e8]
    scale = regular.max() if regular.size else 1.0
    err = np.abs(got - want)
    ok = (err <= rtol * aw + 1e-3 * rtol * scale) | ((aw > 1e8)
                                                     & (err <= 5e-2 * aw))
    assert ok.all(), (name, int(np.count_nonzero(~ok)),
                      float(np.max(err / (aw + 1e-30))))


def _flux_close(got, want, name, abs_band=5e-5, rel_band=5e-2):
    """Within ``abs_band`` of the field's scale, or ``rel_band`` of the
    value: the band of the JAX package's chain test, whose points on the
    clamped-slope cancellation carry a local relative spread."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    aw = np.abs(want)
    err = np.abs(got - want)
    ok = (err <= abs_band * (aw.max() or 1.0)) | (err <= rel_band * aw)
    assert ok.all(), (name, int(np.count_nonzero(~ok)), float(err.max()))


class _Pallas:
    """Force the JAX package's Pallas kernels on, in interpret mode, as its
    own tests do; restored on exit."""

    def __init__(self, *mods):
        self.mods = mods

    def __enter__(self):
        self.saved = [(m.USE_PALLAS, m.force_interpret) for m in self.mods]
        for m in self.mods:
            m.USE_PALLAS, m.force_interpret = True, True

    def __exit__(self, *exc):
        for m, (use, interp) in zip(self.mods, self.saved):
            m.USE_PALLAS, m.force_interpret = use, interp


# ---- (a) float64: plain chain against the jnp chain -------------------------

def _jnp_slopes(p, ts_range, tmix):
    bc = j_grid_bc(p.jcfg)
    tx, ty, tz, slx, sly = jgm._slopes(p.jcfg, p.jgrid, bc, ts_range, tmix)
    sla = jgm._sla(p.jcfg, p.jgrid, slx, sly)
    km = p.jcfg.km
    work3 = jgm._displaced_density_diff(p.jcfg, p.jgrid, ts_range, tmix[:2],
                                        clamp=False)
    dzwr = jnp.reshape(p.jgrid.vgrid.dzwr[1:km + 1], (km, 1, 1))
    below = jnp.arange(1, km + 1)[:, None, None] < p.jgrid.KMT[None]
    n2 = jnp.where(below, jnp.maximum(0.0, -jconst.GRAV * work3 * dzwr), 0.0)
    return tx, ty, tz, slx, sly, sla, n2


@pytest.mark.parametrize("ew", ["cyclic", "closed"])
def test_slopes_sla_n2_plain_match_jnp_f64(pairs, ew):
    p = pairs[("float64", ew)]
    jr, tr = p.ts_ranges()
    tmix = _tmix(p)
    tx, ty, tz, slx, sly, sla, n2 = _jnp_slopes(p, jr, jnp.asarray(tmix))
    bc = t_grid_bc(p.tcfg)
    t = torch.as_tensor(tmix)
    got = tgm._slopes(p.tcfg, p.tgrid, bc, tr, t)
    for g, w, name in zip(got[:3], (tx, ty, tz), ("tx", "ty", "tz")):
        assert scale_err(g.numpy(), w) <= 1e-12, name
    _slopes_close(got[3].numpy(), slx, 1e-12, "slx")
    _slopes_close(got[4].numpy(), sly, 1e-12, "sly")
    assert np.abs(np.asarray(slx)).max() > 1e8   # clamped points are present

    # the slope kernel's plain version: packed slopes, SLA, N^2
    before = gm_slope_cuda.launches
    slp, sla_t, n2_t = gm_slope_cuda.slopes(p.tcfg, p.tgrid, bc, tr, t)
    assert gm_slope_cuda.launches == before   # CPU tensors: no launch
    ux, uy = gm_slope_cuda.unpack_slopes(slp)
    _slopes_close(ux.numpy(), slx, 1e-12, "slp x")
    _slopes_close(uy.numpy(), sly, 1e-12, "slp y")
    _slopes_close(sla_t.numpy(), sla, 1e-12, "sla")
    assert scale_err(n2_t.numpy(), n2) <= 1e-12
    assert float(n2_t.max()) > 0.0


def _jnp_tlt(p, jr, tmix):
    *_, sla, _ = _jnp_slopes(p, jr, tmix)
    dd = jnp.full_like(p.jgrid.FCORT, float(np.asarray(p.jgrid.vgrid.zw)[0]))
    return sla, jgm.transition_layer(p.jcfg, p.jgrid, dd, sla,
                                     jgm._rossby_radius(p.jgrid))


def _searched_tlt_inputs(p, sla):
    """A diabatic depth that varies over the first five levels and slope
    measures scaled up a hundredfold, so that the second and third sweeps of
    the search extend the layer in many columns (with the first layer as
    diabatic depth on this coarse grid the first sweep settles every
    column)."""
    rng = np.random.RandomState(2)
    zw = np.asarray(p.jgrid.vgrid.zw)
    zt = np.asarray(p.jgrid.vgrid.zt)
    dd = rng.uniform(0.3 * zw[0], zt[5], (NY, NX)).astype(p.np_dtype)
    return dd, np.asarray(sla) * 100.0


@pytest.mark.parametrize("case", ["first_layer", "searched"])
def test_transition_layer_matches_jnp_f64(pairs, case):
    p = pairs[("float64", "cyclic")].with_(**GM_FULL)
    jr, _ = p.ts_ranges()
    sla, want = _jnp_tlt(p, jr, jnp.asarray(_tmix(p)))
    dd = tgm.first_layer_depth(p.tgrid)
    sla = np.array(sla)
    if case == "searched":
        dd_np, sla = _searched_tlt_inputs(p, sla)
        want = jgm.transition_layer(p.jcfg, p.jgrid, jnp.asarray(dd_np),
                                    jnp.asarray(sla),
                                    jgm._rossby_radius(p.jgrid))
        dd = torch.as_tensor(dd_np)
    got = tgm.transition_layer(p.tcfg, p.tgrid, dd, torch.as_tensor(sla),
                               tgm._rossby_radius(p.tgrid))
    for name in ("k_level", "ztw"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
        assert getattr(got, name).dtype == torch.int32
    for name in ("diabatic_depth", "thickness", "interior_depth"):
        assert scale_err(getattr(got, name).numpy(),
                         getattr(want, name)) <= 1e-12, name
    if case == "searched":
        # the layer grew past the first sweep's level in many columns, and
        # ends at cell centres and at interfaces
        zw = p.tgrid.vgrid.zw.reshape(KM, 1, 1)
        first = torch.argmax((dd[None] < zw).to(torch.uint8), dim=0) + 1
        grown = (got.k_level != first) & (p.tgrid.KMT > 0)
        assert int(grown.sum()) > 50
        assert set(np.unique(got.ztw.numpy())) == {0, 1, 2}


def test_kappa_vertical_bfre_matches_jnp_f64(pairs):
    p = pairs[("float64", "cyclic")].with_(**GM_FULL)
    jr, tr = p.ts_ranges()
    tmix = _tmix(p)
    _, tlt = _jnp_tlt(p, jr, jnp.asarray(tmix))
    for sdl in (tlt.interior_depth,
                jnp.full_like(tlt.interior_depth,
                              float(np.asarray(p.jgrid.vgrid.zw)[0]))):
        want = jgm.kappa_vertical_bfre(p.jcfg, p.jgrid, jr, jnp.asarray(tmix),
                                       sdl)
        got = tgm.kappa_vertical_bfre(
            p.tcfg, p.tgrid, tr, torch.as_tensor(tmix),
            torch.as_tensor(np.asarray(sdl)))
        assert scale_err(got.numpy(), want) <= 1e-12
        assert 0.1 <= float(got.min()) < float(got.max()) == 1.0


@pytest.mark.parametrize("case", ["first_layer", "searched"])
def test_merged_streamfunction_matches_jnp_f64(pairs, case):
    p = pairs[("float64", "closed")].with_(**GM_FULL)
    jr, _ = p.ts_ranges()
    tmix = jnp.asarray(_tmix(p))
    _, _, _, slx, sly, sla, _ = _jnp_slopes(p, jr, tmix)
    _, tlt = _jnp_tlt(p, jr, tmix)
    if case == "searched":   # bases at cell centres and at interfaces
        dd, sla100 = _searched_tlt_inputs(p, sla)
        tlt = jgm.transition_layer(p.jcfg, p.jgrid, jnp.asarray(dd),
                                   jnp.asarray(sla100),
                                   jgm._rossby_radius(p.jgrid))
        assert {1, 2} <= set(np.unique(np.asarray(tlt.ztw)))
    rng = np.random.RandomState(5)
    kthic = 3.0e7 * rng.uniform(0.0, 1.0, (2, KM, NY, NX))
    want = jgm.merged_streamfunction(p.jcfg, p.jgrid, tlt, jnp.asarray(kthic),
                                     slx, sly)
    ttlt = tgm.TLT(*(torch.as_tensor(np.array(a)) for a in tlt))
    got = tgm.merged_streamfunction(
        p.tcfg, p.tgrid, ttlt, torch.as_tensor(kthic),
        torch.as_tensor(np.array(slx)), torch.as_tensor(np.array(sly)))
    for g, w, name in zip(got, want, ("sf_slx", "sf_sly")):
        _slopes_close(g.numpy(), w, 1e-12, name)


@pytest.mark.parametrize("ew", ["cyclic", "closed"])
@pytest.mark.parametrize("name", ["gm_full", "gm_flux", "gm_flux_slm"])
def test_hdifft_gm_matches_jnp_f64(pairs, name, ew):
    over = dict(CONFIGS.get(name, GM_FLUX))
    if name == "gm_flux_slm":   # unequal slope limits: the skew branch
        over.update(gm_slm_b=0.25, gm_ah_bkg_bottom=1.0e6,
                    gm_use_const_ah_bkg_srfbl=False)
    p = pairs[("float64", ew)].with_(**over)
    jr, tr = p.ts_ranges()
    tmix = _tmix(p, seed=4)
    want = jgm.hdifft_gm(p.jcfg, p.jgrid, j_grid_bc(p.jcfg), jr,
                         jnp.asarray(tmix), use_kernels=False)
    before = gm_cuda.launches
    got = tgm.hdifft_gm(p.tcfg, p.tgrid, t_grid_bc(p.tcfg), tr,
                        torch.as_tensor(tmix))
    assert gm_cuda.launches == before
    for field in tgm.GMOut._fields:
        g, w = getattr(got, field), getattr(want, field)
        assert (g is None) == (w is None), field
        if g is not None:
            assert scale_err(g.numpy(), w) <= 1e-12, field
    assert float(got.gtk.abs().max()) > 0 and float(got.vdc_gm.max()) > 0


def _flux_fields(p, tr, seed, cancellation):
    """Production-shaped operands of the flux assembly as NumPy arrays
    (``sample.flux_operands`` on the stratified state); in the
    ``cancellation`` branch the streamfunction is not read: zeros."""
    f = [a.numpy() for a in sample.flux_operands(
        p.tcfg, p.tgrid, t_grid_bc(p.tcfg), tr,
        torch.as_tensor(_tmix(p, seed)), levels=(1, 4))]
    if cancellation:
        f[5], f[6] = np.zeros_like(f[5]), np.zeros_like(f[6])
    return f


@pytest.mark.parametrize("ew", ["cyclic", "closed"])
@pytest.mark.parametrize("cancellation", [False, True])
def test_flux_assembly_plain_matches_jnp_f64(pairs, cancellation, ew):
    p = pairs[("float64", ew)]
    _, tr = p.ts_ranges()
    f = _flux_fields(p, tr, 6, cancellation)
    jf = [jnp.asarray(a) for a in f]
    want = jgm.flux_assembly_jnp(p.jcfg, p.jgrid, j_grid_bc(p.jcfg), *jf[:8],
                                 jf[7], jf[8], cancellation)
    got = tgm.flux_assembly_plain(
        p.tcfg, p.tgrid, t_grid_bc(p.tcfg),
        *(torch.as_tensor(a) for a in f), cancellation)
    for g, w, name in zip(got, want, ("gtk", "vdc_gm")):
        assert scale_err(g.numpy(), w) <= 1e-12, name


# ---- (b) float32: the port's entries against Pallas in interpret mode -------

def test_slopes_entry_matches_pallas_interpret_f32(pairs):
    p = pairs[("float32", "cyclic")]
    jr, tr = p.ts_ranges()
    tmix = _tmix(p)
    with _Pallas(gm_slope_pallas):
        assert gm_slope_pallas.available(p.jcfg, p.jgrid)
        want = gm_slope_pallas.slopes_raw(p.jcfg, p.jgrid, j_grid_bc(p.jcfg),
                                          jr, jnp.asarray(tmix))
    got = gm_slope_cuda.slopes(p.tcfg, p.tgrid, t_grid_bc(p.tcfg), tr,
                               torch.as_tensor(tmix))
    # the JAX package's band for this kernel: rtol 3e-4 + 1e-6 of scale,
    # 5 % at the clamped points
    for g, w, name in zip(got, want, ("slp", "sla", "n2")):
        assert g.dtype == torch.float32
        g, w = g.numpy(), np.asarray(w)
        aw = np.abs(w)
        err = np.abs(g - w)
        ok = (err <= 3e-4 * aw + 1e-6 * (aw.max() or 1.0)) | (
            (aw > 1e8) & (err <= 5e-2 * aw))
        assert ok.all(), (name, int(np.count_nonzero(~ok)))


def test_hdifft_chain_matches_pallas_interpret_f32(pairs):
    p = pairs[("float32", "cyclic")].with_(**GM_FULL)
    jr, tr = p.ts_ranges()
    tmix = _tmix(p)
    assert p.jcfg.nt == 2
    with _Pallas(gm_chain_pallas, gm_slope_pallas):
        assert gm_chain_pallas.available(p.jcfg, p.jgrid)
        want, with_sm = gm_chain_pallas.hdifft_chain(
            p.jcfg, p.jgrid, j_grid_bc(p.jcfg), jr, jnp.asarray(tmix))
    assert not with_sm
    assert gm_chain_cuda.available(p.tcfg, p.tgrid)
    before = gm_chain_cuda.launches
    got = gm_chain_cuda.hdifft_chain(p.tcfg, p.tgrid, t_grid_bc(p.tcfg), tr,
                                     torch.as_tensor(tmix))
    assert gm_chain_cuda.launches == before
    # the JAX package's bands for the chain: 5e-5 of scale or 5 % of the
    # value for GTK and VDC_GM, 3e-5 of scale or 1 % for the diagnostics
    _flux_close(got.gtk.numpy(), want.gtk, "gtk")
    _flux_close(got.vdc_gm.numpy(), want.vdc_gm, "vdc_gm")
    for name in ("kappa_isop", "kappa_thic", "hor_diff"):
        _flux_close(getattr(got, name).numpy(), getattr(want, name), name,
                    3e-5, 1e-2)
    for name in ("dia_depth", "tlt_thick", "int_depth"):
        assert scale_err(getattr(got, name).numpy(),
                         getattr(want, name)) <= 1e-6, name
    no_diags = gm_chain_cuda.hdifft_chain(
        p.tcfg, p.tgrid, t_grid_bc(p.tcfg), tr, torch.as_tensor(tmix),
        want_diags=False)
    assert no_diags.kappa_isop is None
    assert torch.equal(no_diags.gtk, got.gtk)


@pytest.mark.parametrize("cancellation", [False, True])
def test_flux_assembly_entry_matches_pallas_interpret_f32(pairs,
                                                          cancellation):
    p = pairs[("float32", "cyclic")]
    _, tr = p.ts_ranges()
    f = _flux_fields(p, tr, 7, cancellation)
    with _Pallas(gm_pallas):
        assert gm_pallas.available(p.jcfg, p.jgrid)
        want_gtk, want_vdc = gm_pallas.flux_assembly_tiles_wrapper(
            p.jcfg, p.jgrid, j_grid_bc(p.jcfg),
            *(jnp.asarray(a) for a in f), cancellation)
    got_gtk, got_vdc = gm_cuda.flux_assembly(
        p.tcfg, p.tgrid, t_grid_bc(p.tcfg),
        *(torch.as_tensor(a) for a in f), cancellation)
    assert got_gtk.dtype == torch.float32
    # the JAX package's bands: GTK 2e-5 of scale, VDC_GM rtol 1e-6 (here
    # with the float32 rounding of two summation orders: 4e-6)
    assert scale_err(got_gtk.numpy(), want_gtk) <= 2e-5
    np.testing.assert_allclose(got_vdc.numpy(), np.asarray(want_vdc),
                               rtol=4e-6, atol=0)


# ---- (c) tracer tendency without the Laplacian ------------------------------

@pytest.mark.parametrize("ew", ["cyclic", "closed"])
def test_tracer_plain_without_del2_matches_jnp_f64(pairs, ew):
    p = pairs[("float64", ew)]
    rng = np.random.RandomState(8)
    mt = np.asarray(p.jgrid.kmask_t)
    mu = np.asarray(p.jgrid.kmask_u)
    nt = p.jcfg.nt
    u, v = (rng.randn(KM, NY, NX) * 10.0 * mu for _ in range(2))
    trcr, tmix, told = (rng.randn(nt, KM, NY, NX) * mt for _ in range(3))
    vdc = rng.uniform(0.0, 10.0, (2, KM, NY, NX)) * mt
    stf = rng.randn(nt, NY, NX) * mt[0]
    dh = rng.randn(NY, NX) * 1e-4 * mt[0]
    bc = j_grid_bc(p.jcfg)
    fv = jadvect.comp_flux_vel(p.jcfg, p.jgrid, bc, jnp.asarray(u),
                               jnp.asarray(v), jnp.asarray(dh))
    want = (-jadvect.advt(p.jcfg, p.jgrid, bc, fv, jnp.asarray(trcr))
            + jvmix.vdifft(p.jcfg, p.jgrid, jnp.asarray(vdc),
                           jnp.asarray(told), jnp.asarray(stf)))
    assert not tracer_cuda.with_del2(p.tcfg)
    before = tracer_cuda.launches
    args = [torch.as_tensor(a) for a in (u, v, trcr, tmix, told, vdc, stf,
                                         dh)]
    got = tracer_cuda.tracer_tendency(p.tcfg, p.tgrid, *args)
    assert tracer_cuda.launches == before
    assert scale_err(got.numpy(), want) <= 1e-12
    # the mixing-time tracer is not read in this mode
    args[3] = torch.full_like(args[3], float("nan"))
    again = tracer_cuda.tracer_tendency(p.tcfg, p.tgrid, *args)
    assert torch.equal(again, got)


# ---- (d) the whole step -----------------------------------------------------

@pytest.fixture(scope="module", params=["gm_full", "gm_flux"])
def runs(request):
    """Both models stepped side by side for five steps from one perturbed
    stratified state (GM does nothing on the horizontally uniform initial
    state), with the solver's criterion tightened as in test_torch_step."""
    jcfg = matched_config_at(32, 24, KM).with_(vert_grid="uniform",
                                               **CONFIGS[request.param])
    jcfg = jcfg.with_(solver=dataclasses.replace(
        jcfg.solver, convergence_criterion=1e-20))
    tcfg = torch_cfg(jcfg)
    jm, tm = JModel(jcfg), TModel(tcfg, device="cpu")
    assert gm_chain_cuda.available(tcfg, tm.grid) == (
        request.param == "gm_full")
    leaves = jax_leaves(jm.initial_state())
    tracers = sample.stratified_tracers(jm.grid.kmask_t, jm.grid.vgrid.zt,
                                        jm.grid.TLAT, jcfg.nt, 11)
    rho = tbaroclinic._masked_density(tcfg, tm.grid, tm.ts_range,
                                      torch.as_tensor(tracers)).numpy()
    leaves.update(tracer_cur=tracers, tracer_old=tracers, rho_cur=rho,
                  rho_old=rho)
    js = jm.initial_state().replace(
        **{k: jnp.asarray(leaves[k]) for k in ("tracer_cur", "tracer_old",
                                               "rho_cur", "rho_old")})
    ts = convert.state_from_numpy(leaves, tcfg, "cpu")
    tm.initial_state()
    tforcing = convert.forcing_from_numpy(jax_leaves(jm.forcing), tcfg,
                                          "cpu")
    snaps = {}
    for n in range(1, 6):
        js, _ = jm.advance(js)
        ts, _ = tm.advance(ts, tforcing)
        snaps[n] = (convert.state_to_numpy(ts), jax_leaves(js))
    return dict(snaps=snaps, jm=jm, tm=tm, js=js, ts=ts, tforcing=tforcing,
                name=request.param)


_STATE_FIELDS = ("u_cur", "v_cur", "tracer_cur", "psurf_cur", "ubtrop_cur",
                 "vbtrop_cur")


def _worst(snap):
    t_leaves, j_leaves = snap
    return {n: scale_err(t_leaves[n], j_leaves[n]) for n in _STATE_FIELDS}


def test_gm_step1_euler_machine_precision(runs):
    worst = _worst(runs["snaps"][1])
    assert max(worst.values()) <= 1e-11, worst


def test_gm_step5_leapfrog_parity(runs):
    worst = _worst(runs["snaps"][5])
    assert max(worst.values()) <= 1e-7, worst
    t5 = runs["snaps"][5][0]
    assert np.isfinite(t5["tracer_cur"]).all()
    assert np.abs(t5["u_cur"]).max() > 0


def test_gm_driver_carries_vdc_and_gm_output(runs):
    """One more baroclinic driver call in both packages from the step-5
    states: the GM tendency, and the diffusivity handed to the corrector,
    which includes VDC_GM."""
    from pop2_tpu import baroclinic as jbaroclinic, step as jstep
    from pop2_tpu_torch import step as tstep
    jm, tm, js, ts = runs["jm"], runs["tm"], runs["js"], runs["ts"]
    jdh, jdhu = jstep.dhdt(jm.cfg, jm.grid, jm.bc, js)
    jout = jbaroclinic.driver(jm.cfg, jm.grid, jm.bc, jm.ts_range, js,
                              jm.forcing, jdh, jdhu, True)
    tdh, tdhu = tstep.dhdt(tm.cfg, tm.grid, tm.bc, ts)
    tout = tbaroclinic.driver(tm.cfg, tm.grid, tm.bc, tm.ts_range, ts,
                              runs["tforcing"], tdh, tdhu, True)
    assert tout.gm is not None
    for name in ("vdc", "tracer_new", "u_new"):
        assert scale_err(getattr(tout, name).numpy(),
                         getattr(jout, name)) <= 1e-7, name
    assert float(tout.gm.vdc_gm.max()) > 0.0
    assert float(tout.gm.gtk.abs().max()) > 0.0
    has_tlt = runs["name"] == "gm_full"
    assert (tout.gm.dia_depth is not None) == has_tlt
    assert tout.gm.kappa_isop is not None   # want_gm_diags defaults to True


# ---- (e) what the port does not carry ---------------------------------------

@pytest.mark.parametrize("over,names", [
    (dict(mesh_shape=(4, 32)), "columns: a block needs at least 2"),
])
def test_unported_gm_switches_raise_at_construction(over, names):
    """GM on a 2-D mesh is carried (``supported`` names nothing), but a
    block must be as wide as the widest kernel halo: 'mini''s 32 columns
    on 32 ranks in x, blocks of one column, are refused at construction."""
    cfg = t_get_config("mini", hmix_tracer="gm", **over)
    assert not supported.unsupported(cfg)
    with pytest.raises(ValueError, match=names):
        TModel(cfg, device="cpu")


@pytest.mark.parametrize("over", [
    dict(gm_aniso="flow", gm_transition_layer=False),
    dict(gm_kappa_isop_type="vmhs", gm_kappa_thic_type="vmhs"),
    dict(gm_kappa_isop_type="eg", gm_kappa_thic_type="eg"),
    dict(gm_kappa_isop_type="depth", gm_kappa_thic_type="depth"),
    dict(gm_kappa_isop_type="bfre"),
    dict(state_choice="jmcd")],
    ids=["aniso", "vmhs", "eg", "depth", "differing", "jmcd"])
def test_gm_switches_ported_since_construct_and_step(over):
    """Once refused at construction (ROADMAP.md Queue 1 item 11b), now
    carried: each constructs and takes a step from the stratified state
    (its values are held against the JAX package in
    test_torch_gm_menu.py and test_torch_advect_eos.py)."""
    cfg = t_get_config("mini", hmix_tracer="gm", **over)
    assert supported.unsupported(cfg) == []
    model = TModel(cfg, device="cpu")
    tracers = sample.grid_tracers(cfg, model.grid, 7, noise=0.02)
    rho = tbaroclinic._masked_density(cfg, model.grid, model.ts_range,
                                      tracers)
    state = model.initial_state().replace(
        tracer_cur=tracers, tracer_old=tracers, rho_cur=rho, rho_old=rho)
    state, _ = model.advance(state)
    assert all(bool(torch.isfinite(t).all()) for _, t in state.leaves())
    assert not gm_chain_cuda.available(cfg, model.grid)


def test_supported_gm_switches_construct():
    for over in CONFIGS.values():
        cfg = t_get_config("mini", **over)
        assert supported.unsupported(cfg) == []
    # the GM switches are not looked at when GM is off
    assert supported.unsupported(t_get_config("mini", gm_aniso="flow")) == []


def test_kernel_wrappers_raise_for_modes_not_ported(pairs):
    p = pairs[("float64", "cyclic")].with_(**GM_FULL)
    _, tr = p.ts_ranges()
    bc = t_grid_bc(p.tcfg)
    tmix = torch.as_tensor(_tmix(p))
    slp, sla, n2 = gm_slope_cuda.slopes(p.tcfg, p.tgrid, bc, tr, tmix)
    tlt = tgm.transition_layer(p.tcfg, p.tgrid,
                               tgm.first_layer_depth(p.tgrid), sla,
                               tgm._rossby_radius(p.tgrid))
    # partial bottom cells: GM runs on the 1-D dz, as the JAX package's
    # (ROADMAP.md Queue 3), so on a grid whose bottom cells are full (DZT
    # equal to dz) the chain and the hdifft_chain entry give the full-cell
    # output
    dz3 = p.tgrid.vgrid.dz.reshape(-1, 1, 1).expand(
        p.tgrid.kmask_t.shape).contiguous()
    plane = torch.full(p.tgrid.KMT.shape, float(p.tgrid.vgrid.dz[0]),
                       dtype=tmix.dtype)
    dzt_grid = p.tgrid.replace(DZT=dz3, DZU=dz3, DZBT=plane, DZBU=plane)
    for got, want in zip(
            gm_chain_cuda.chain(p.tcfg, dzt_grid, bc, tmix, slp, sla, n2,
                                tlt),
            gm_chain_cuda.chain(p.tcfg, p.tgrid, bc, tmix, slp, sla, n2,
                                tlt)):
        assert torch.equal(got, want)
    for got, want in zip(
            gm_chain_cuda.hdifft_chain(p.tcfg, dzt_grid, bc, tr, tmix,
                                       hmxl=tlt.thickness),
            gm_chain_cuda.hdifft_chain(p.tcfg, p.tgrid, bc, tr, tmix,
                                       hmxl=tlt.thickness)):
        if isinstance(got, torch.Tensor):
            assert torch.equal(got, want)
    # anisotropic GM is not the chain's: gm.hdifft_gm runs it, with the
    # flux assembly's y-face diffusivity (its kernel's ANISO instances)
    aniso = p.with_(gm_aniso="flow", gm_transition_layer=False).tcfg
    with pytest.raises(NotImplementedError, match="outside the chain"):
        gm_chain_cuda.hdifft_chain(aniso, p.tgrid, bc, tr, tmix,
                                   hblt=tlt.thickness)
    u = torch.full(p.tgrid.kmask_u.shape, 10.0, dtype=tmix.dtype) \
        * p.tgrid.kmask_u
    out = tgm.hdifft_gm(aniso, p.tgrid, bc, tr, tmix, umix=u, vmix_m=-u)
    assert bool(torch.isfinite(out.gtk).all())
    f = sample.flux_operands(p.tcfg, p.tgrid, bc, tr, tmix)
    gtk_x, _ = gm_cuda.flux_assembly(aniso, p.tgrid, bc, *f, False,
                                     kisop_y=0.5 * f[7])
    assert not torch.equal(gtk_x, gm_cuda.flux_assembly(
        aniso, p.tgrid, bc, *f, False)[0])
    # the flux assembly on the partial-cell grid: the full-cell output
    # (the tripole row is held in test_torch_fold_kernels.py)
    for got, want in zip(
            gm_cuda.flux_assembly(p.tcfg, dzt_grid, bc, *f, False),
            gm_cuda.flux_assembly(p.tcfg, p.tgrid, bc, *f, False)):
        assert torch.equal(got, want)
    flux_only = p.with_(gm_transition_layer=False).tcfg
    with pytest.raises(NotImplementedError, match="outside the chain"):
        gm_chain_cuda.chain(flux_only, p.tgrid, bc, tmix, slp, sla, n2, tlt)
    # the Eden-Greatbatch diffusivity, from the mixing-time velocities
    eg = p.with_(gm_kappa_isop_type="eg", gm_kappa_thic_type="eg").tcfg
    kisop, kthic, cancellation, _ = tgm.kappa_fields(
        eg, p.tgrid, bc, tr, tmix, umix=u, vmix_m=-u)
    assert kthic is kisop and not cancellation  # the transition layer
    assert bool((kisop >= eg.gm_kappa_min_eg).all())
