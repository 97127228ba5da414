"""The plain versions of the kernel modes that the production dynamics menu
(prod_dyn) adds, on a tripole grid with ocean across the fold, against the
JAX package on the CPU:

  - the tracer kernel's upwind3 mode, the momentum kernel without
    the Laplacian (with the anisotropic friction added by the model's
    entry), the slopes and the chain; and the flux assembly's tripole row
    (GM without the transition layer on the production grid, prod_flux),
    in both ``cancellation`` branches;
  - in float64 against the JAX package's jnp chain, at 1e-12 of scale;
  - in float32 against its Pallas kernels in interpret mode, inside the
    bands the JAX package holds those kernels to (2e-5 of scale for the
    tracer tendency, 4e-5 for the momentum forcing, rtol 3e-4 + 1e-6 of
    scale for the slopes, 5e-5 of scale or 5 % of the value for the chain,
    2e-5 of scale for the flux assembly's GTK with its top row re-patched
    by the JAX package's wrapper).

On CPU tensors the wrappers take these plain versions; the CUDA kernels are
held against them on the GPU by ``chip_smoke.py`` (on the same kind of
bottom, at the path's size).
"""

from types import SimpleNamespace

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pop2_tpu import advect as jadvect, baroclinic as jbaro  # noqa: E402
from pop2_tpu import clinic_pallas, gm as jgm, gm_chain_pallas  # noqa: E402
from pop2_tpu import gm_pallas, gm_slope_pallas, tracer_pallas  # noqa: E402
from pop2_tpu import vmix as jvmix  # noqa: E402

from pop2_tpu_torch import clinic_cuda, gm_chain_cuda, gm_cuda  # noqa: E402
from pop2_tpu_torch import gm_slope_cuda, sample, tracer_cuda  # noqa: E402

from tests.test_torch_gm import _Pallas, _flux_close  # noqa: E402
from tests.test_torch_tripole import KM, NX, NY, FoldPair, _uv  # noqa: E402
from tests.test_torch_tripole import fold  # noqa: E402,F401
from tests.torch_port_helpers import scale_err  # noqa: E402


# ---- the kernel modes' plain versions against the jnp chain (float64) and
# the Pallas kernels in interpret mode (float32) ------------------------------

def _tracer_inputs(p, seed):
    u, v = _uv(p, seed)
    mt = p.jgrid.kmask_t
    tr, to = p.tracers(seed + 2), p.tracers(seed + 3)
    vdc = np.abs(p.rand(seed + 4, 2, KM, NY, NX, scale=10.0, mask=mt))
    stf = p.rand(seed + 5, 2, NY, NX, mask=np.asarray(mt)[0])
    dh = p.rand(seed + 6, NY, NX, scale=1e-4, mask=np.asarray(mt)[0])
    return u, v, tr, to, to, vdc, stf, dh


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_tracer_upwind3_fold_plain(fold, dtype):
    p = fold[dtype]
    f = _tracer_inputs(p, 81)
    got = tracer_cuda.tracer_tendency(
        p.tcfg, p.tgrid, *(torch.as_tensor(a) for a in f))
    if dtype == "float64":  # the jnp chain of the JAX package's driver
        u, v, tr, tm, to, vdc, stf, dh = (jnp.asarray(a) for a in f)
        fv = jadvect.comp_flux_vel(p.jcfg, p.jgrid, p.jbc, u, v, dh)
        want = -jadvect.advt(p.jcfg, p.jgrid, p.jbc, fv, tr)
        want = want + jvmix.vdifft(p.jcfg, p.jgrid, vdc, to, stf)
        band = 1e-12
    else:
        with _Pallas(tracer_pallas):
            want = tracer_pallas.tracer_tendency(
                p.jcfg, p.jgrid, *(jnp.asarray(a) for a in f))
        band = 2e-5
    assert got.dtype == p.tcfg.torch_dtype
    assert scale_err(got.numpy(), np.asarray(want)) <= band
    assert scale_err(got[..., -2:, :].numpy(),
                     np.asarray(want)[..., -2:, :]) <= band


# the bands chip_smoke.py holds the tracer kernel to against this plain
# version (BAND["tracer", ...]): of scale, float64 and float32
TRACER_BAND = {"float64": 1e-12, "float32": 2e-5}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_tracer_fold_moves_the_top_row(fold, dtype):
    """With the top U row's DXU opened (``sample.open_top_dxu``: the
    internal grid's top U row lies on the pole, where DXU is all but zero),
    the fold moves the plain tendency's top row by far more than the band
    the kernel is held to under it, so a check of the top row sees the
    fold's rows."""
    p = fold[dtype]
    f = [torch.as_tensor(a) for a in _tracer_inputs(p, 91)]
    grid = sample.open_top_dxu(p.tgrid)
    assert float(grid.DXU[-1].min()) == float(p.tgrid.DXU.max())
    tripole = tracer_cuda.tracer_tendency_plain(p.tcfg, grid, *f)
    closed = tracer_cuda.tracer_tendency_plain(
        p.tcfg.with_(ns_boundary="closed"), grid, *f)
    top = tripole[..., -1, :]
    share = float((closed[..., -1, :] - top).abs().max() / top.abs().max())
    assert share > 100.0 * TRACER_BAND[dtype]
    # the wrapper on CPU tensors is the plain version, fold and all
    got = tracer_cuda.tracer_tendency(p.tcfg, grid, *f)
    assert torch.equal(got, tripole)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_clinic_aniso_fold_plain(fold, dtype):
    p = fold[dtype]
    u, v = _uv(p, 91)
    uo, vo = _uv(p, 93)
    rho = [1.02 + p.rand(95 + i, KM, NY, NX, scale=1e-3,
                         mask=p.jgrid.kmask_t) for i in range(3)]
    vvc = np.abs(p.rand(98, KM, NY, NX, scale=10.0, mask=p.jgrid.kmask_u))
    smf = p.rand(99, 2, NY, NX, mask=np.asarray(p.jgrid.kmask_u)[0])
    dhu = p.rand(100, NY, NX, scale=1e-4)
    # the model's clinic entry: the kernel without the Laplacian, then the
    # anisotropic friction added (forcing and vertical means)
    st = dict(u_cur=u, v_cur=v, u_old=uo, v_old=vo, rho_old=rho[0],
              rho_cur=rho[1])
    ts = SimpleNamespace(**{k: torch.as_tensor(a) for k, a in st.items()})
    got = clinic_cuda.clinic_rhs(p.tcfg, p.tgrid, ts, torch.as_tensor(uo),
                                 torch.as_tensor(vo), torch.as_tensor(rho[2]),
                                 torch.as_tensor(vvc), torch.as_tensor(smf),
                                 torch.as_tensor(dhu), True)
    jst_ = SimpleNamespace(**{k: jnp.asarray(a) for k, a in st.items()})
    if dtype == "float64":
        fx, fy = jbaro.clinic_forcing_jnp(
            p.jcfg, p.jgrid, p.jbc, *(jnp.asarray(a) for a in (
                u, v, uo, vo, uo, vo, rho[0], rho[1], rho[2], vvc, smf,
                dhu)), True)
        dz = np.asarray(p.jgrid.vgrid.dz).reshape(KM, 1, 1)
        hur = np.asarray(p.jgrid.HUR)
        want = (fx, fy, hur * np.sum(np.asarray(fx) * dz, axis=0),
                hur * np.sum(np.asarray(fy) * dz, axis=0))
        band = 1e-12
    else:
        with _Pallas(clinic_pallas):
            want = clinic_pallas.clinic_rhs(
                p.jcfg, p.jgrid, jst_, jnp.asarray(uo), jnp.asarray(vo),
                jnp.asarray(rho[2]), jnp.asarray(vvc), jnp.asarray(smf),
                jnp.asarray(dhu), True)
        band = 4e-5
    for g, w, name in zip(got, want, ("fx", "fy", "zx", "zy")):
        assert scale_err(g.numpy(), np.asarray(w)) <= band, name


def test_slopes_fold_plain_matches_pallas_interpret_f32(fold):
    p = fold["float32"]
    jr, tr = p.ts_ranges()
    tmix = p.tracers(111)
    with _Pallas(gm_slope_pallas):
        want = gm_slope_pallas.slopes_raw(p.jcfg, p.jgrid, p.jbc, jr,
                                          jnp.asarray(tmix))
    got = gm_slope_cuda.slopes(p.tcfg, p.tgrid, p.tbc, tr,
                               torch.as_tensor(tmix))
    # the JAX package's band for this kernel: rtol 3e-4 + 1e-6 of scale,
    # 5 % at the clamped points
    for g, w, name in zip(got, want, ("slp", "sla", "n2")):
        g, w = g.numpy(), np.asarray(w)
        aw, err = np.abs(w), np.abs(g - w)
        ok = (err <= 3e-4 * aw + 1e-6 * (aw.max() or 1.0)) | (
            (aw > 1e8) & (err <= 5e-2 * aw))
        assert ok.all(), (name, int(np.count_nonzero(~ok)))


def test_slopes_fold_plain_matches_jnp_f64(fold):
    p = fold["float64"]
    jr, tr = p.ts_ranges()
    tmix = p.tracers(112)
    tx, ty, tz, slx, sly = jgm._slopes(p.jcfg, p.jgrid, p.jbc, jr,
                                       jnp.asarray(tmix))
    sla = jgm._sla(p.jcfg, p.jgrid, slx, sly)
    slp, tsla, _ = gm_slope_cuda.slopes(p.tcfg, p.tgrid, p.tbc, tr,
                                        torch.as_tensor(tmix))
    tslx, tsly = gm_slope_cuda.unpack_slopes(slp)
    for g, w, name in ((tslx, slx, "slx"), (tsly, sly, "sly"),
                       (tsla, sla, "sla")):
        g, w = g.numpy(), np.asarray(w)
        ok = np.abs(g - w) <= 1e-12 * np.abs(w) + 1e-14
        assert ok.all(), name


def test_chain_fold_plain_matches_pallas_interpret_f32(fold):
    p = fold["float32"]
    jr, tr = p.ts_ranges()
    tmix = p.tracers(121)
    with _Pallas(gm_chain_pallas, gm_slope_pallas):
        want, with_sm = gm_chain_pallas.hdifft_chain(
            p.jcfg, p.jgrid, p.jbc, jr, jnp.asarray(tmix))
    assert not with_sm
    got = gm_chain_cuda.hdifft_chain(p.tcfg, p.tgrid, p.tbc, tr,
                                     torch.as_tensor(tmix))
    # the JAX package's bands for the chain (rtol 3e-4 at the value, with
    # 5e-5 of scale where the value is small)
    _flux_close(got.gtk.numpy(), want.gtk, "gtk")
    _flux_close(got.vdc_gm.numpy(), want.vdc_gm, "vdc_gm")


# ---- the flux assembly's tripole row ----------------------------------------

def _open_top_face(p):
    """``p``'s grids with the top row's north-face length HTN the grid's
    largest (``sample.open_top_face``): the internal grid's top row lies on
    the pole, where HTN is all but zero and no flux would cross the fold."""
    import jax.numpy as jnp_
    htn = sample.open_top_face(p.tgrid).HTN.numpy()
    q = SimpleNamespace(**vars(p))
    q.jgrid = p.jgrid.replace(HTN=jnp_.asarray(htn))
    q.tgrid = p.tgrid.replace(HTN=torch.as_tensor(htn).to(p.tgrid.HTN.dtype))
    return q


def _fold_flux_fields(p, seed, cancellation):
    """The flux assembly's operands on the fold bottom
    (``sample.flux_operands`` of stratified tracers), NumPy; the
    streamfunction is not read in the ``cancellation`` branch: zeros."""
    _, tr = FoldPair.ts_ranges(p)
    f = [a.numpy() for a in sample.flux_operands(
        p.tcfg, p.tgrid, p.tbc, tr,
        torch.as_tensor(FoldPair.tracers(p, seed)),
        levels=(1, 4))]
    if cancellation:
        f[5], f[6] = np.zeros_like(f[5]), np.zeros_like(f[6])
    return f


@pytest.mark.parametrize("cancellation", [False, True])
def test_flux_assembly_fold_plain_matches_jnp_f64(fold, cancellation):
    p = _open_top_face(fold["float64"])
    f = _fold_flux_fields(p, 131, cancellation)
    jf = [jnp.asarray(a) for a in f]
    want = jgm.flux_assembly_jnp(p.jcfg, p.jgrid, p.jbc, *jf[:8], jf[7],
                                 jf[8], cancellation)
    got = gm_cuda.flux_assembly(p.tcfg, p.tgrid, p.tbc,
                                *(torch.as_tensor(a) for a in f),
                                cancellation)
    for g, w, name in zip(got, want, ("gtk", "vdc_gm")):
        assert scale_err(g.numpy(), np.asarray(w)) <= 1e-12, name
        assert scale_err(g[..., -2:, :].numpy(),
                         np.asarray(w)[..., -2:, :]) <= 1e-12, name
    # the fold reaches the top row: it differs from a closed north edge
    closed = gm_cuda.flux_assembly_plain(
        p.tcfg.with_(ns_boundary="closed"), p.tgrid,
        type(p.tbc)(p.tcfg.ew_boundary, "closed"),
        *(torch.as_tensor(a) for a in f), cancellation)[0]
    assert scale_err(closed[..., -1, :].numpy(),
                     np.asarray(want[0])[..., -1, :]) > 1e-6


@pytest.mark.parametrize("cancellation", [False, True])
def test_flux_assembly_fold_matches_pallas_interpret_f32(fold, cancellation):
    p = _open_top_face(fold["float32"])
    f = _fold_flux_fields(p, 133, cancellation)
    with _Pallas(gm_pallas):
        assert gm_pallas.available(p.jcfg, p.jgrid)
        want_gtk, want_vdc = gm_pallas.flux_assembly_tiles_wrapper(
            p.jcfg, p.jgrid, p.jbc, *(jnp.asarray(a) for a in f),
            cancellation)
    got_gtk, got_vdc = gm_cuda.flux_assembly(
        p.tcfg, p.tgrid, p.tbc, *(torch.as_tensor(a) for a in f),
        cancellation)
    assert got_gtk.dtype == torch.float32
    # the JAX package's bands (tests/test_gm_pallas.py:91): GTK 2e-5 of
    # scale, the re-patched top row included; VDC_GM rtol 4e-6 (two
    # summation orders in float32)
    assert scale_err(got_gtk.numpy(), np.asarray(want_gtk)) <= 2e-5
    assert scale_err(got_gtk[..., -1, :].numpy(),
                     np.asarray(want_gtk)[..., -1, :]) <= 2e-5
    np.testing.assert_allclose(got_vdc.numpy(), np.asarray(want_vdc),
                               rtol=4e-6, atol=0)
