"""The port's three kernel modules against the JAX package, on the CPU.

For each of tridiag_cuda, tracer_cuda and clinic_cuda the same NumPy inputs
(seeded, on a 32 x 16 x 6 grid with a stepped bathymetry) go through

  (a) the port's plain PyTorch version and the JAX package's jnp chain in
      float64: equal to 1e-12 of the field's scale (the arithmetic is the
      same, only the order of a few sums differs);
  (b) the port's plain version in float32 and the JAX package's Pallas
      kernel in interpret mode: inside the bands the JAX package holds its
      kernels to (2e-5 of scale for the tracer tendency, 4e-5 for the
      momentum forcing, rtol 1e-6 / atol 1e-7 for the Thomas sweep).

On CPU tensors the wrappers take the plain versions, so the CUDA kernels
themselves are held against these plain versions on the GPU by
``chip_smoke.py``.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pop2_tpu import advect as jadvect, hmix as jhmix, pgrad as jpgrad  # noqa: E402
from pop2_tpu import clinic_pallas, tracer_pallas, tridiag_pallas  # noqa: E402
from pop2_tpu import constants as jconst, tridiag as jtridiag  # noqa: E402
from pop2_tpu import vmix as jvmix  # noqa: E402
from pop2_tpu.config import get_config  # noqa: E402
from pop2_tpu.grid import build_grid as j_build_grid  # noqa: E402
from pop2_tpu.grid import grid_bc as j_grid_bc, thickness_u as j_thickness_u  # noqa: E402

from pop2_tpu_torch import clinic_cuda, pgrad as tpgrad, tracer_cuda  # noqa: E402
from pop2_tpu_torch import tridiag as ttridiag, tridiag_cuda  # noqa: E402
from pop2_tpu_torch.grid import build_grid as t_build_grid  # noqa: E402

from tests.torch_port_helpers import (scale_err, stepped_bottom,  # noqa: E402
                                      torch_cfg)

NX, NY, KM = 32, 16, 6   # ny % 8 == 0: the Pallas interpret mode needs it


class Pair:
    """One config in both packages with both grids, in one dtype."""

    def __init__(self, dtype, **over):
        base = dict(nx=NX, ny=NY, km=KM, dtype=dtype)
        base.update(over)
        impcor = base.pop("impcor", None)
        jcfg = get_config("mini", **base)
        if impcor is not None:
            jcfg = dataclasses.replace(
                jcfg, time=dataclasses.replace(jcfg.time, impcor=impcor))
        self.jcfg, self.tcfg = jcfg, torch_cfg(jcfg)
        self.jgrid, self.tgrid = stepped_bottom(
            j_build_grid(self.jcfg), t_build_grid(self.tcfg, "cpu"),
            jcfg.ew_boundary, seed=1)
        self.np_dtype = np.float64 if dtype == "float64" else np.float32

    def with_(self, **over):
        """Same grids, other non-geometric config fields."""
        new = object.__new__(Pair)
        new.__dict__.update(self.__dict__)
        impcor = over.pop("impcor", None)
        jcfg = self.jcfg.with_(**over)
        if impcor is not None:
            jcfg = dataclasses.replace(
                jcfg, time=dataclasses.replace(jcfg.time, impcor=impcor))
        new.jcfg, new.tcfg = jcfg, torch_cfg(jcfg)
        return new


@pytest.fixture(scope="module")
def pairs():
    """Grids by (dtype, east-west boundary), built once per module."""
    return {(dt, ew): Pair(dt, ew_boundary=ew)
            for dt in ("float64", "float32")
            for ew in ("cyclic", "closed")}


def test_grid_has_topography(pairs):
    for p in pairs.values():
        kmt, kmu = p.tgrid.KMT.numpy(), p.tgrid.KMU.numpy()
        assert 0 in kmt and kmt.max() == KM and len(np.unique(kmt)) > 5
        assert len(np.unique(kmu)) > 5
        np.testing.assert_array_equal(kmt, np.asarray(p.jgrid.KMT))
        np.testing.assert_array_equal(kmu, np.asarray(p.jgrid.KMU))


def _fields(pair, seed):
    """Random operands with the magnitudes of the JAX package's kernel
    tests, masked to ocean, in the pair's dtype."""
    rng = np.random.RandomState(seed)
    nt = pair.jcfg.nt
    dt = pair.np_dtype
    mu = np.asarray(pair.jgrid.kmask_u)
    mt = np.asarray(pair.jgrid.kmask_t)
    f = {}
    for name in ("ucur", "vcur", "uold", "vold"):
        f[name] = (rng.randn(KM, NY, NX) * 10.0 * mu).astype(dt)
    for name in ("trcr", "tmix", "told"):
        f[name] = (rng.randn(nt, KM, NY, NX) * mt).astype(dt)
    f["vdc"] = (rng.uniform(0.0, 10.0, (2, KM, NY, NX)) * mt).astype(dt)
    f["vvc"] = (rng.uniform(0.0, 10.0, (KM, NY, NX)) * mu).astype(dt)
    f["stf"] = (rng.randn(nt, NY, NX) * mt[0]).astype(dt)
    f["smf"] = (rng.randn(2, NY, NX) * mu[0]).astype(dt)
    f["dh"] = (rng.randn(NY, NX) * 1e-4 * mt[0]).astype(dt)
    f["dhu"] = (rng.randn(NY, NX) * 1e-4 * mu[0]).astype(dt)
    for name in ("rho_old", "rho_cur", "rho_new"):
        f[name] = (rng.randn(KM, NY, NX) * 1e-3 * mt).astype(dt)
    f["psurf"] = (rng.randn(NY, NX) * 100.0 * mt[0]).astype(dt)
    f["rhs"] = (rng.randn(3, KM, NY, NX) * mt).astype(dt)
    return f


def _t(f, *names):
    return [torch.as_tensor(f[n]) for n in names]


def _j(f, *names):
    return [jnp.asarray(f[n]) for n in names]


def _vert(grid, dtype):
    dz = np.asarray(grid.vgrid.dz, dtype)
    dz_kp1 = np.concatenate([dz[1:], dz[-1:]])
    return (jnp.asarray(dz), jnp.asarray((1.0 / dz).astype(dtype)),
            jnp.asarray((0.5 / dz).astype(dtype)),
            jnp.asarray((1.0 / (0.5 * (dz + dz_kp1))).astype(dtype)))


# ---- Thomas sweep -----------------------------------------------------------

@pytest.mark.parametrize("varthick", [True, False])
@pytest.mark.parametrize("nr", [1, 2, 3])
def test_thomas_plain_matches_jnp_f64(pairs, nr, varthick):
    p = pairs[("float64", "cyclic")]
    f = _fields(p, 10 + nr)
    c2dt = 2.0 * p.jcfg.time.dtt
    jvg, tvg = p.jgrid.vgrid, p.tgrid.vgrid
    want = np.stack([np.asarray(jtridiag.impvmixt(
        jnp.asarray(f["rhs"][n]), jnp.asarray(f["vdc"][1]),
        jnp.asarray(f["psurf"]), p.jgrid.KMT, jvg.dz, jvg.dzwr,
        jnp.full((KM,), c2dt), 1.0, varthick)) for n in range(nr)])
    before = tridiag_cuda.launches
    got = ttridiag.impvmixt_batch(
        torch.as_tensor(f["rhs"][:nr]), torch.as_tensor(f["vdc"][1]),
        torch.as_tensor(f["psurf"]), p.tgrid.KMT, tvg.dz, tvg.dzwr,
        torch.full((KM,), c2dt, dtype=torch.float64), 1.0, varthick)
    assert tridiag_cuda.launches == before  # CPU tensors: no kernel launch
    assert got.shape == (nr, KM, NY, NX)
    assert scale_err(got.numpy(), want) <= 1e-12
    # land and the levels below the bottom stay zero
    assert not got.numpy()[:, ~np.asarray(p.jgrid.kmask_t)].any()


def test_impvmixu_and_correct_match_jnp_f64(pairs):
    p = pairs[("float64", "closed")]
    f = _fields(p, 20)
    jvg, tvg = p.jgrid.vgrid, p.tgrid.vgrid
    c2dtu = 2.0 * p.jcfg.time.dtu
    mu = np.asarray(p.jgrid.kmask_u)
    ru, rv = f["rhs"][0] * mu, f["rhs"][1] * mu
    want = jtridiag.impvmixu(jnp.asarray(ru), jnp.asarray(rv),
                             jnp.asarray(f["vvc"]), p.jgrid.KMU, jvg.dz,
                             jvg.dzwr, c2dtu, 1.0)
    got = ttridiag.impvmixu(torch.as_tensor(ru), torch.as_tensor(rv),
                            torch.as_tensor(f["vvc"]), p.tgrid.KMU, tvg.dz,
                            tvg.dzwr, c2dtu, 1.0)
    for g, w in zip(got, want):
        assert scale_err(g.numpy(), np.asarray(w)) <= 1e-12

    c2dt = 2.0 * p.jcfg.time.dtt
    rhs1 = f["rhs"][2, 0]
    want = jtridiag.impvmixt_correct(
        jnp.asarray(rhs1), jnp.asarray(f["vdc"][0]), jnp.asarray(f["psurf"]),
        p.jgrid.KMT, jvg.dz, jvg.dzwr, jnp.full((KM,), c2dt), 1.0, True)
    got = ttridiag.impvmixt_correct(
        torch.as_tensor(rhs1), torch.as_tensor(f["vdc"][0]),
        torch.as_tensor(f["psurf"]), p.tgrid.KMT, tvg.dz, tvg.dzwr,
        torch.full((KM,), c2dt, dtype=torch.float64), 1.0, True)
    assert scale_err(got.numpy(), np.asarray(want)) <= 1e-12


@pytest.mark.parametrize("nr", [1, 2, 3])
def test_thomas_plain_matches_pallas_interpret_f32(pairs, nr):
    p = pairs[("float32", "cyclic")]
    f = _fields(p, 30 + nr)
    c2dt = np.float32(2.0 * p.jcfg.time.dtt)
    dz = np.asarray(p.jgrid.vgrid.dz, np.float32)
    dzwr = np.asarray(p.jgrid.vgrid.dzwr, np.float32)
    hfac = dz / c2dt
    h1 = (hfac[0] + f["psurf"] / np.float32(jconst.GRAV * c2dt)).astype(
        np.float32)
    a = (dzwr[1:KM + 1].reshape(KM, 1, 1) * f["vdc"][1]).astype(np.float32)
    a[-1] = 0.0
    rhs = f["rhs"][:nr]
    want = tridiag_pallas.thomas_tiles(
        jnp.asarray(hfac), jnp.asarray(h1), p.jgrid.KMT, jnp.asarray(a),
        jnp.asarray(rhs), interpret=True)
    got = tridiag_cuda.thomas_plain(
        torch.as_tensor(hfac), torch.as_tensor(h1), p.tgrid.KMT,
        torch.as_tensor(a), torch.as_tensor(rhs))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


# ---- tracer tendency --------------------------------------------------------

def _tracer_args(f):
    return ("ucur", "vcur", "trcr", "tmix", "told", "vdc", "stf", "dh")


@pytest.mark.parametrize("ew", ["cyclic", "closed"])
@pytest.mark.parametrize("varthick", [True, False])
def test_tracer_plain_matches_jnp_f64(pairs, ew, varthick):
    p = pairs[("float64", ew)].with_(
        sfc_layer="varthick" if varthick else "rigid")
    f = _fields(p, 40)
    u, v, trcr, tmix, told, vdc, stf, dh = _j(f, *_tracer_args(f))
    bc = j_grid_bc(p.jcfg)
    want = jhmix.hdifft(p.jcfg, p.jgrid, bc, tmix)
    fv = jadvect.comp_flux_vel(p.jcfg, p.jgrid, bc, u, v, dh)
    want = want - jadvect.advt(p.jcfg, p.jgrid, bc, fv, trcr)
    want = want + jvmix.vdifft(p.jcfg, p.jgrid, vdc, told, stf)

    before = tracer_cuda.launches
    got = tracer_cuda.tracer_tendency(p.tcfg, p.tgrid,
                                      *_t(f, *_tracer_args(f)))
    assert tracer_cuda.launches == before
    assert scale_err(got.numpy(), np.asarray(want)) <= 1e-12


def test_tracer_plain_matches_pallas_interpret_f32(pairs):
    # one Pallas trace (each costs ~10 s on the CPU): the mode the slice runs
    ew, varthick = "cyclic", True
    p = pairs[("float32", ew)].with_(
        sfc_layer="varthick" if varthick else "rigid")
    f = _fields(p, 41)
    g, f32 = p.jgrid, jnp.float32
    want = tracer_pallas.tracer_tendency_tiles(
        *_j(f, *_tracer_args(f)), g.KMT,
        g.DYU.astype(f32), g.DXU.astype(f32), g.TAREA_R.astype(f32),
        g.DTN.astype(f32), g.DTS.astype(f32), g.DTE.astype(f32),
        g.DTW.astype(f32), *_vert(g, np.float32), float(p.jcfg.auto_ah),
        ew=ew, varthick=varthick, interpret=True)
    got = tracer_cuda.tracer_tendency_plain(p.tcfg, p.tgrid,
                                            *_t(f, *_tracer_args(f)))
    assert got.dtype == torch.float32
    assert scale_err(got.numpy(), np.asarray(want)) <= 2e-5


@pytest.mark.parametrize("over,match", [
    (dict(tadvect="lw_lim"), "lw_lim"),
    (dict(hmix_tracer="del6"), "with_del2=False"),  # no such scheme
    (dict(ns_boundary="cyclic"), "cyclic"),
])
def test_tracer_modes_not_ported_raise(pairs, over, match):
    p = pairs[("float64", "cyclic")].with_(**over)
    f = _fields(p, 42)
    with pytest.raises(NotImplementedError, match=match):
        tracer_cuda.tracer_tendency(p.tcfg, p.tgrid,
                                    *_t(f, *_tracer_args(f)))


# ---- momentum forcing -------------------------------------------------------

_CLINIC_CASES = [  # (east-west boundary, leapfrog, impcor)
    ("cyclic", True, True), ("cyclic", False, True),
    ("cyclic", True, False), ("closed", True, True),
    ("closed", False, False),
]


def _jnp_clinic_chain(cfg, grid, f, leapfrog):
    (ucur, vcur, uold, vold, rho_old, rho_cur, rho_new, vvc, smf,
     dhu) = _j(f, "ucur", "vcur", "uold", "vold", "rho_old", "rho_cur",
               "rho_new", "vvc", "smf", "dhu")
    umix, vmixm = (uold, vold) if leapfrog else (ucur, vcur)
    bc = j_grid_bc(cfg)
    gamma = cfg.time.gamma
    luk, lvk = jadvect.advu(cfg, grid, bc, ucur, vcur, dhu)
    fx, fy = -luk, -lvk
    if cfg.time.impcor and leapfrog:
        fx = fx + grid.FCOR * (gamma * vcur + (1.0 - gamma) * vold)
        fy = fy - grid.FCOR * (gamma * ucur + (1.0 - gamma) * uold)
    elif leapfrog:
        fx = fx + grid.FCOR * vcur
        fy = fy - grid.FCOR * ucur
    else:
        fx = fx + grid.FCOR * vold
        fy = fy - grid.FCOR * uold
    bouss = jpgrad.bouss_factor(cfg, grid.vgrid.pressz)
    pkx, pky = jpgrad.gradp(cfg, grid, bc, bouss, rho_old, rho_cur, rho_new,
                            leapfrog)
    fx, fy = fx - pkx, fy - pky
    hduk, hdvk = jhmix.hdiffu(cfg, grid, bc, umix, vmixm)
    fx, fy = fx + hduk, fy + hdvk
    du, dv = jvmix.vdiffu(cfg, grid, vvc, uold, vold, smf)
    fx = jnp.where(grid.kmask_u, fx + du, 0.0)
    fy = jnp.where(grid.kmask_u, fy + dv, 0.0)
    dzc = j_thickness_u(cfg, grid)
    return (fx, fy, grid.HUR * jnp.sum(fx * dzc, axis=0),
            grid.HUR * jnp.sum(fy * dzc, axis=0))


def _torch_clinic_args(p, f, leapfrog):
    (ucur, vcur, uold, vold, rho_old, rho_cur, rho_new, vvc, smf,
     dhu) = _t(f, "ucur", "vcur", "uold", "vold", "rho_old", "rho_cur",
               "rho_new", "vvc", "smf", "dhu")
    umix, vmixm = (uold, vold) if leapfrog else (ucur, vcur)
    rhoavg = tpgrad.rho_average(p.tcfg, p.tgrid, rho_old, rho_cur, rho_new,
                                leapfrog)
    wc, wo = clinic_cuda.coriolis_weights(p.tcfg, leapfrog)
    return (p.tcfg, p.tgrid, ucur, vcur, uold, vold, umix, vmixm, rhoavg,
            vvc, smf, dhu, wc, wo)


@pytest.mark.parametrize("ew,leapfrog,impcor", _CLINIC_CASES)
def test_clinic_plain_matches_jnp_f64(pairs, ew, leapfrog, impcor):
    p = pairs[("float64", ew)].with_(impcor=impcor, lbouss_correct=True)
    f = _fields(p, 50)
    want = _jnp_clinic_chain(p.jcfg, p.jgrid, f, leapfrog)
    before = clinic_cuda.launches
    got = clinic_cuda.clinic_rhs_fields(*_torch_clinic_args(p, f, leapfrog))
    assert clinic_cuda.launches == before
    for g, w, name in zip(got, want, ("fx", "fy", "zx", "zy")):
        assert scale_err(g.numpy(), np.asarray(w)) <= 1e-12, name


# the Coriolis weights are traced operands of the Pallas kernel, so the three
# cyclic cases share one trace (each trace costs ~10 s on the CPU)
@pytest.mark.parametrize("ew,leapfrog,impcor", _CLINIC_CASES[:3])
def test_clinic_plain_matches_pallas_interpret_f32(pairs, ew, leapfrog,
                                                   impcor):
    p = pairs[("float32", ew)].with_(impcor=impcor)
    f = _fields(p, 51)
    cfg, g, f32 = p.jcfg, p.jgrid, jnp.float32
    (ucur, vcur, uold, vold, rho_old, rho_cur, rho_new, vvc, smf,
     dhu) = _j(f, "ucur", "vcur", "uold", "vold", "rho_old", "rho_cur",
               "rho_new", "vvc", "smf", "dhu")
    umix, vmixm = (uold, vold) if leapfrog else (ucur, vcur)
    if cfg.lpressure_avg and leapfrog:
        rhoavg = 0.25 * (rho_new + 2.0 * rho_cur + rho_old)
    else:
        rhoavg = rho_cur
    bouss = jpgrad.bouss_factor(cfg, g.vgrid.pressz)
    rhoavg = (rhoavg * jnp.reshape(bouss, (KM, 1, 1))).astype(f32)
    if cfg.time.impcor and leapfrog:
        wc, wo = cfg.time.gamma, 1.0 - cfg.time.gamma
    elif leapfrog:
        wc, wo = 1.0, 0.0
    else:
        wc, wo = 0.0, 1.0
    facs = (g.vgrid.dzw[0:KM] * (jconst.GRAV * 0.5)).astype(f32)
    params = jnp.array([cfg.auto_am, cfg.bottom_drag, wc, wo], f32)
    want = clinic_pallas.clinic_rhs_tiles(
        ucur, vcur, uold, vold, umix, vmixm, rhoavg, vvc,
        clinic_pallas.pack_g2d(cfg, g), g.KMU, dhu, smf,
        *_vert(g, np.float32), facs, params, ew=ew, interpret=True)

    args = _torch_clinic_args(p, f, leapfrog)
    assert (args[-2], args[-1]) == (wc, wo)
    got = clinic_cuda.clinic_rhs_plain(*args)
    for a, w, name in zip(got, want, ("fx", "fy", "zx", "zy")):
        assert a.dtype == torch.float32
        assert scale_err(a.numpy(), np.asarray(w)) <= 4e-5, name


def test_pack_g2d_matches_jax_layout(pairs):
    p = pairs[("float64", "cyclic")]
    assert clinic_cuda.G2D == tuple(clinic_pallas._G2D)
    np.testing.assert_allclose(
        clinic_cuda.pack_g2d(p.tcfg, p.tgrid).numpy(),
        np.asarray(clinic_pallas.pack_g2d(p.jcfg, p.jgrid)), rtol=1e-6)


@pytest.mark.parametrize("over,match", [
    (dict(hmix_momentum="del6"), "with_hdiffu=False"),  # no such scheme
    (dict(ns_boundary="cyclic"), "cyclic"),
])
def test_clinic_modes_not_ported_raise(pairs, over, match):
    p = pairs[("float64", "cyclic")].with_(**over)
    f = _fields(p, 52)
    with pytest.raises(NotImplementedError, match=match):
        clinic_cuda.clinic_rhs_fields(*_torch_clinic_args(p, f, True))


# ---- the wrappers' checks (what a kernel does not take) --------------------

def test_check_operand_rejects_what_kernels_do_not_take():
    from pop2_tpu_torch import _cuda_build as cb
    x = torch.zeros(4, 6, dtype=torch.float32)
    cb.check_operand("x", x, (4, 6), torch.float32, x.device)
    with pytest.raises(ValueError, match="shape"):
        cb.check_operand("x", x, (6, 4), torch.float32, x.device)
    with pytest.raises(TypeError, match="dtype"):
        cb.check_operand("x", x, (4, 6), torch.float64, x.device)
    with pytest.raises(ValueError, match="contiguous"):
        cb.check_operand("x", x.t(), (6, 4), torch.float32, x.device)
    with pytest.raises(ValueError, match="expected"):
        cb.check_operand("x", x, (4, 6), torch.float32,
                         torch.device("meta"))
    with pytest.raises(TypeError, match="float32 or float64"):
        cb.dtype_code(x.half())
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        cb.check_launch(9, "thomas")
