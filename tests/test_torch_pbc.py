"""Partial bottom cells in the port against the JAX package, on the CPU in
float64.

Every bottom-cell file is written from a seed (``sample.write_bottom_cells``:
each ocean column's bottom level a fraction in [0.25, 1] of its thickness,
dz[0] on land, one big-endian float64 record, as ``tests/test_pbc.py``
writes it).

The grid: the port's ``build_grid`` and ``convert.grid_from_numpy`` give the
JAX package's DZT, DZU, HT, HU and HUR bitwise, on a closed grid and on the
tripole grid; on a bottom with ocean across the fold the port's DZT/DZU
equal the JAX package's recipe through its own shift; the bottom planes
DZBT/DZBU are the bottom level of DZT/DZU, which equal dz above it; without
a file the bottom cells are full; a short file raises.

The kernels' plain versions under 3-D thickness, at 1e-12 of scale, on a
stepped bottom whose every ocean column ends in a partial cell
(``sample.with_bottom_cells``): thomas through ``tridiag.impvmixt``,
``impvmixt_batch`` and ``impvmixu`` against the JAX package's solves; the
tracer tendency (centered with the Laplacian and without it, upwind3 on the
fold) against ``advect.advt`` + ``hmix.hdifft`` + ``vmix.vdifft``; the
momentum forcing and ZX/ZY against ``baroclinic.clinic_forcing_jnp``.

Whole steps, from one perturbed state in both packages (PARITY.md's bands:
1e-11 after the first step, 1e-7 after five): ``prod_pbc`` (the production
preset with the eddy-resolving preset's del4 menu, Schmittner tidal mixing
and velocity damping) at 32 x 16 x 12 on stretched levels
(``torch_port_helpers.stretched_pair``), 'mini' and 'mini' with GM's
transition layer, each under partial bottom cells; on 'mini' a tavg stream
of every field it evaluates against the JAX package's (1e-9 of scale, the
band of ``test_torch_tavg.py``), and the port's heat and salt budgets
closed over eight steps, as ``test_pbc.py`` holds the JAX package's.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

jax.config.update("jax_enable_x64", True)

from pop2_tpu import advect as jadvect, baroclinic as jbaro  # noqa: E402
from pop2_tpu import eos as jeos, hmix as jhmix, tavg as jtavg  # noqa: E402
from pop2_tpu import tridiag as jtridiag, vmix as jvmix  # noqa: E402
from pop2_tpu.config import get_config  # noqa: E402
from pop2_tpu.grid import _np_shift3 as j_np_shift3  # noqa: E402
from pop2_tpu.grid import build_grid as j_build_grid  # noqa: E402
from pop2_tpu.grid import grid_bc as j_grid_bc  # noqa: E402
from pop2_tpu.model import Model as JModel  # noqa: E402

from pop2_tpu_torch import budget, clinic_cuda, convert, sample  # noqa: E402
from pop2_tpu_torch import supported, tracer_cuda  # noqa: E402
from pop2_tpu_torch import tridiag as ttridiag, tridiag_cuda  # noqa: E402
from pop2_tpu_torch.grid import bottom_planes, partial_bottom_cells  # noqa: E402
from pop2_tpu_torch.grid import build_grid as t_build_grid  # noqa: E402
from pop2_tpu_torch.model import Model as TModel  # noqa: E402

from tests.test_torch_tavg import F3, evaluable_fields  # noqa: E402
from tests.torch_port_helpers import (GridPair, fold_bottom,  # noqa: E402
                                      jax_leaves, scale_err, stretched_pair,
                                      torch_cfg)

SEED = 5
BAND = 1e-12
NSTEPS = 5
SMALL = dict(nx=40, ny=24, km=10, vert_grid="uniform")
# the JAX package's tripole production grid, without passive tracers
FOLD = dict(SMALL, passive_tracers=(), nt=2)
# prod_pbc's menu (chip_smoke.py's path): the eddy-resolving preset's
# biharmonic mixing, Schmittner tidal mixing, velocity damping
HMIX = dict(hmix_tracer="del4", hmix_momentum="del4",
            tidal_mixing_method="schmittner", ltidal_schmittner_socn=True,
            ldamp_uv=True, passive_tracers=(), nt=2)
GM_FULL = dict(hmix_tracer="gm", gm_transition_layer=True,
               gm_kappa_isop_type="bfre", gm_kappa_thic_type="bfre",
               gm_kappa_isop_deep=0.2, gm_kappa_thic_deep=0.1,
               gm_ah=3.0e7, gm_ah_bolus=3.0e7, gm_ah_bkg_srfbl=3.0e7,
               lsubmeso=False)
THICK = ("DZT", "DZU", "HT", "HU", "HUR")


def with_file(jcfg, jgrid, path, seed=SEED):
    """``jcfg`` under partial bottom cells of a file written from ``jgrid``'s
    full-cell bottom."""
    sample.write_bottom_cells(str(path), np.asarray(jgrid.KMT),
                              np.asarray(jgrid.vgrid.dz, np.float64), seed)
    return jcfg.with_(partial_bottom_cells=True, bottom_cell_file=str(path))


# ---- the grid ---------------------------------------------------------------

@pytest.fixture(scope="module", params=["closed", "tripole"])
def grids(request, tmp_path_factory):
    jcfg = (get_config("mini") if request.param == "closed"
            else get_config("prod_full", **FOLD))
    path = tmp_path_factory.mktemp("dzbc") / "dzbc.ieeer8"
    jcfg = with_file(jcfg, j_build_grid(jcfg), path)
    jgrid = j_build_grid(jcfg)
    tcfg = torch_cfg(jcfg)
    return (request.param, jcfg, jgrid, t_build_grid(tcfg, "cpu"),
            convert.grid_from_numpy(jax_leaves(jgrid), tcfg, "cpu"))


def test_grid_fields_match_the_jax_package(grids):
    which, jcfg, jgrid, built, handed = grids
    for name in THICK:
        want = np.asarray(getattr(jgrid, name))
        for how, g in (("build_grid", built), ("grid_from_numpy", handed)):
            np.testing.assert_array_equal(getattr(g, name).numpy(), want,
                                          err_msg=f"{which} {how} {name}")
    for name in ("DZBT", "DZBU"):
        assert torch.equal(getattr(built, name), getattr(handed, name))
    # the cells are partial: every ocean column's bottom is thinner than dz
    kmt = np.asarray(jgrid.KMT)
    dz = np.asarray(jgrid.vgrid.dz)
    ocean = kmt > 0
    assert (built.DZBT.numpy()[ocean] < dz[kmt[ocean] - 1]).all()
    assert supported.unsupported(torch_cfg(jcfg)) == []


def test_bottom_planes_are_the_bottom_level(grids):
    _, _, _, g, _ = grids
    dz = g.vgrid.dz.numpy()
    for D, kmax, plane in ((g.DZT, g.KMT, g.DZBT), (g.DZU, g.KMU, g.DZBU)):
        D, kmax, plane = D.numpy(), kmax.numpy(), plane.numpy()
        wet = kmax > 0
        bottom = np.take_along_axis(D, np.maximum(kmax - 1, 0)[None], 0)[0]
        np.testing.assert_array_equal(plane[wet], bottom[wet])
        np.testing.assert_array_equal(plane[~wet], dz[0])
        above = np.arange(D.shape[0])[:, None, None] != kmax[None] - 1
        np.testing.assert_array_equal(
            D[above], np.broadcast_to(dz[:, None, None], D.shape)[above])
    # a thickness off dz above the bottom level is not a bottom plane
    bad = g.DZT.numpy().copy()
    bad[0, g.KMT.numpy() > 1] *= 0.5
    with pytest.raises(AssertionError, match="off the column's bottom"):
        bottom_planes(dz, bad, g.DZU.numpy(), g.KMT.numpy(), g.KMU.numpy())


def test_fold_bottom_matches_the_jax_shift():
    """On a bottom with ocean across the tripole fold (the internal grid's
    top rows are land), DZT/DZU by the JAX package's recipe through its own
    shift (pop2_tpu/grid.py:516-533)."""
    cfg = get_config("prod_full", **FOLD)
    g = j_build_grid(cfg)
    dz = np.asarray(g.vgrid.dz, np.float64)
    zw = np.asarray(g.vgrid.zw, np.float64)
    kmt = sample.fold_bottom_kmt(np.asarray(g.KMT), cfg.km, SEED)
    kmu = sample.bottom_leaves(kmt, zw, cfg.ew_boundary,
                               cfg.ns_boundary)["KMU"]
    dzbc = sample.bottom_cell_thickness(kmt, dz, SEED)
    dzt, dzu, _, _ = partial_bottom_cells(
        torch_cfg(cfg), dz, np.concatenate([[0.0], zw]), kmt, kmu, dzbc)
    kidx1 = np.arange(1, cfg.km + 1)[:, None, None]
    want_t = np.where(kidx1 == kmt[None], dzbc[None],
                      dz[:, None, None] * np.ones(dzt.shape))
    ew, ns = cfg.ew_boundary, cfg.ns_boundary
    want_u = np.minimum(np.minimum(want_t, j_np_shift3(want_t, 1, 0, ew, ns)),
                        np.minimum(j_np_shift3(want_t, 0, 1, ew, ns),
                                   j_np_shift3(want_t, 1, 1, ew, ns)))
    want_u = np.where(kidx1 > kmu[None], dz[:, None, None], want_u)
    np.testing.assert_array_equal(dzt, want_t)
    np.testing.assert_array_equal(dzu, want_u)
    # the fold reaches the top U row: its DZU differs from a closed edge's
    closed = partial_bottom_cells(
        torch_cfg(cfg.with_(ns_boundary="closed")), dz,
        np.concatenate([[0.0], zw]), kmt, kmu, dzbc)[1]
    assert (dzu[:, -1] != closed[:, -1]).any()


def test_degenerate_bottom_cells_without_a_file():
    jcfg = get_config("mini", partial_bottom_cells=True)
    jgrid, full = j_build_grid(jcfg), j_build_grid(get_config("mini"))
    g = t_build_grid(torch_cfg(jcfg), "cpu")
    dz = g.vgrid.dz.numpy()
    np.testing.assert_array_equal(
        g.DZT.numpy(), np.broadcast_to(dz[:, None, None], g.DZT.shape))
    for name in THICK:
        np.testing.assert_array_equal(getattr(g, name).numpy(),
                                      np.asarray(getattr(jgrid, name)))
    for name in ("HT", "HU", "HUR"):
        np.testing.assert_array_equal(getattr(g, name).numpy(),
                                      np.asarray(getattr(full, name)))


def test_short_bottom_cell_file_raises(tmp_path):
    path = tmp_path / "short.ieeer8"
    np.zeros(10, ">f8").tofile(str(path))
    cfg = torch_cfg(get_config("mini", partial_bottom_cells=True,
                               bottom_cell_file=str(path)))
    with pytest.raises(ValueError, match="too small"):
        t_build_grid(cfg, "cpu")


# ---- the kernels' plain versions under 3-D thickness -----------------------

class CellPair:
    """Both packages' grids on a stepped bottom whose every ocean column
    ends in a partial cell: the port's thicknesses (``sample.
    with_bottom_cells``) handed to the JAX grid."""

    def __init__(self, which):
        if which == "closed":
            p = GridPair("test", seed=3, **SMALL)
            self.jcfg, jg, tg = p.jcfg, p.jgrid, p.tgrid
        else:
            self.jcfg = get_config("prod_full", **FOLD)
            jg, tg = fold_bottom(j_build_grid(self.jcfg),
                                 t_build_grid(torch_cfg(self.jcfg), "cpu"),
                                 self.jcfg, SEED + 1)
        self.tcfg = torch_cfg(self.jcfg)
        self.tgrid = sample.with_bottom_cells(self.tcfg, tg, SEED + 2)
        self.jgrid = jg.replace(**{n: jnp.asarray(getattr(
            self.tgrid, n).numpy()) for n in ("DZT", "DZU")})
        rng = np.random.RandomState(SEED + 3)
        mt, mu = np.asarray(jg.kmask_t), np.asarray(jg.kmask_u)
        km, ny, nx = mt.shape
        f = {}
        for name in ("ucur", "vcur", "uold", "vold"):
            f[name] = rng.randn(km, ny, nx) * 10.0 * mu
        for name in ("trcr", "tmix", "told"):
            f[name] = rng.randn(2, km, ny, nx) * mt
        f["vdc"] = rng.uniform(0.0, 10.0, (2, km, ny, nx)) * mt
        f["vvc"] = rng.uniform(0.0, 10.0, (km, ny, nx)) * mu
        f["stf"] = rng.randn(2, ny, nx) * mt[0]
        f["smf"] = rng.randn(2, ny, nx) * mu[0]
        f["dh"] = rng.randn(ny, nx) * 1e-4 * mt[0]
        f["dhu"] = rng.randn(ny, nx) * 1e-4 * mu[0]
        for name in ("rho_old", "rho_cur", "rho_new"):
            f[name] = rng.randn(km, ny, nx) * 1e-3 * mt
        f["psurf"] = rng.randn(ny, nx) * 100.0 * mt[0]
        f["rhs"] = rng.randn(3, km, ny, nx) * mt
        self.f = f

    def t(self, *names):
        return [torch.as_tensor(self.f[n]) for n in names]

    def j(self, *names):
        return [jnp.asarray(self.f[n]) for n in names]


@pytest.fixture(scope="module", params=["closed", "fold"])
def cells(request):
    return request.param, CellPair(request.param)


def test_thomas_matches_the_jax_solves(cells):
    _, p = cells
    jvg, tvg, km = p.jgrid.vgrid, p.tgrid.vgrid, p.jcfg.km
    c2dt = 2.0 * p.jcfg.time.dtt
    rhs, vdc, psurf = p.j("rhs", "vdc", "psurf")
    trhs, tvdc, tpsurf = p.t("rhs", "vdc", "psurf")
    tc2dt = torch.full((km,), c2dt, dtype=torch.float64)
    # one tracer with the psurf term (impvmixt), three on one factorisation
    want = jtridiag.impvmixt(rhs[0], vdc[0], psurf, p.jgrid.KMT,
                             p.jgrid.DZT, jvg.dzwr, jnp.full((km,), c2dt),
                             1.0, True)
    got = ttridiag.impvmixt(trhs[0], tvdc[0], tpsurf, p.tgrid.KMT, tvg.dz,
                            tvg.dzwr, tc2dt, 1.0, True, bottom=p.tgrid.DZBT)
    assert scale_err(got.numpy(), np.asarray(want)) <= BAND
    want = np.stack([np.asarray(jtridiag.impvmixt(
        rhs[n], vdc[1], psurf, p.jgrid.KMT, p.jgrid.DZT, jvg.dzwr,
        jnp.full((km,), c2dt), 1.0, False)) for n in range(3)])
    got = ttridiag.impvmixt_batch(trhs, tvdc[1], tpsurf, p.tgrid.KMT, tvg.dz,
                                  tvg.dzwr, tc2dt, 1.0, False,
                                  bottom=p.tgrid.DZBT)
    assert scale_err(got.numpy(), want) <= BAND
    full = ttridiag.impvmixt_batch(trhs, tvdc[1], tpsurf, p.tgrid.KMT,
                                   tvg.dz, tvg.dzwr, tc2dt, 1.0, False)
    assert scale_err(full.numpy(), want) > 1e3 * BAND  # the cells matter
    mu = np.asarray(p.jgrid.kmask_u)
    ru, rv = p.f["rhs"][0] * mu, p.f["rhs"][1] * mu
    c2dtu = 2.0 * p.jcfg.time.dtu
    want = jtridiag.impvmixu(jnp.asarray(ru), jnp.asarray(rv),
                             jnp.asarray(p.f["vvc"]), p.jgrid.KMU,
                             p.jgrid.DZU, jvg.dzwr, c2dtu, 1.0)
    got = ttridiag.impvmixu(torch.as_tensor(ru), torch.as_tensor(rv),
                            *p.t("vvc"), p.tgrid.KMU, tvg.dz, tvg.dzwr,
                            c2dtu, 1.0, bottom=p.tgrid.DZBU)
    for g, w in zip(got, want):
        assert scale_err(g.numpy(), np.asarray(w)) <= BAND
    # the plain twin takes the 3-D hfac the wrapper forms
    hfac, h1, hbot = ttridiag._diagonal(tvg.dz, tc2dt, p.tgrid.KMT,
                                        p.tgrid.DZBT)
    a = ttridiag._coupling(tvg.dz, tvg.dzwr, tvdc[1], 1.0, p.tgrid.KMT,
                           p.tgrid.DZBT)
    three = tridiag_cuda.bottom_hfac(hfac, hbot, p.tgrid.KMT)
    np.testing.assert_array_equal(
        three.numpy(), (p.tgrid.DZT / tc2dt.reshape(km, 1, 1)).numpy())
    assert torch.equal(
        tridiag_cuda.thomas_plain(three, h1, p.tgrid.KMT, a, trhs),
        tridiag_cuda.thomas(hfac, h1, p.tgrid.KMT, a, trhs, hbot))


@pytest.mark.parametrize("mode", ["centered_del2", "centered", "upwind3"])
def test_tracer_twin_matches_the_jax_chain(cells, mode):
    which, p = cells
    over = {"centered_del2": dict(tadvect="centered", hmix_tracer="del2"),
            "centered": dict(tadvect="centered", hmix_tracer="del4"),
            "upwind3": dict(tadvect="upwind3", hmix_tracer="del4")}[mode]
    jcfg = p.jcfg.with_(**over)
    tcfg = torch_cfg(jcfg)
    u, v, trcr, tmix, told, vdc, stf, dh = p.j(
        "ucur", "vcur", "trcr", "tmix", "told", "vdc", "stf", "dh")

    @jax.jit
    def chain(u, v, trcr, tmix, told, vdc, stf, dh):
        bc = j_grid_bc(jcfg)
        fv = jadvect.comp_flux_vel(jcfg, p.jgrid, bc, u, v, dh)
        out = (jvmix.vdifft(jcfg, p.jgrid, vdc, told, stf)
               - jadvect.advt(jcfg, p.jgrid, bc, fv, trcr))
        if jcfg.hmix_tracer == "del2":
            out = out + jhmix.hdifft(jcfg, p.jgrid, bc, tmix)
        return out

    want = np.asarray(chain(u, v, trcr, tmix, told, vdc, stf, dh))
    args = p.t("ucur", "vcur", "trcr", "tmix", "told", "vdc", "stf", "dh")
    got = tracer_cuda.tracer_tendency(tcfg, p.tgrid, *args)
    assert scale_err(got.numpy(), want) <= BAND, (which, mode)
    full = tracer_cuda.tracer_tendency(
        tcfg, p.tgrid.replace(DZT=None, DZU=None, DZBT=None, DZBU=None),
        *args)
    assert scale_err(full.numpy(), want) > 1e3 * BAND


@pytest.mark.parametrize("leapfrog", [True, False])
def test_clinic_twin_matches_clinic_forcing_jnp(cells, leapfrog):
    which, p = cells
    jcfg = p.jcfg if which == "closed" else p.jcfg.with_(
        hmix_momentum="del4")
    tcfg = torch_cfg(jcfg)
    names = ("ucur", "vcur", "uold", "vold", "rho_old", "rho_cur",
             "rho_new", "vvc", "smf", "dhu")

    @jax.jit
    def chain(ucur, vcur, uold, vold, rho_old, rho_cur, rho_new, vvc, smf,
              dhu):
        umix, vmixm = (uold, vold) if leapfrog else (ucur, vcur)
        fx, fy = jbaro.clinic_forcing_jnp(
            jcfg, p.jgrid, j_grid_bc(jcfg), ucur, vcur, uold, vold, umix,
            vmixm, rho_old, rho_cur, rho_new, vvc, smf, dhu, leapfrog)
        dzc = p.jgrid.DZU
        return (fx, fy, p.jgrid.HUR * jnp.sum(fx * dzc, axis=0),
                p.jgrid.HUR * jnp.sum(fy * dzc, axis=0))

    want = chain(*p.j(*names))
    ucur, vcur, uold, vold, rho_old, rho_cur, rho_new, vvc, smf, dhu = \
        p.t(*names)
    umix, vmixm = (uold, vold) if leapfrog else (ucur, vcur)

    class State:  # the fields clinic_rhs reads of a state
        u_cur, v_cur, u_old, v_old = ucur, vcur, uold, vold

    State.rho_old, State.rho_cur = rho_old, rho_cur
    got = clinic_cuda.clinic_rhs(tcfg, p.tgrid, State, umix, vmixm, rho_new,
                                 vvc, smf, dhu, leapfrog)
    for g, w, name in zip(got, want, ("fx", "fy", "zx", "zy")):
        assert scale_err(g.numpy(), np.asarray(w)) <= BAND, (which, name)


# ---- whole steps ------------------------------------------------------------

class StepRun:
    """One configuration in both packages from one perturbed state (T
    noise, a seeded u) under a heat flux that cools part of the points:
    NSTEPS leapfrog steps of ``advance`` each (the step counter starts past
    the Euler step: one compiled JAX step), with a tavg stream of every
    field the configuration evaluates where ``tavg`` (its directory) is
    given."""

    def __init__(self, jcfg, tcfg, tgrid, tavg=None):
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
        if tavg:
            self.fields = evaluable_fields(tm, tf)
            self.jstream = jm.enable_tavg(self.fields, freq_steps=10 ** 6,
                                          outdir=str(tavg))
            self.tstream = tm.enable_tavg(self.fields, freq_steps=10 ** 6,
                                          outdir=str(tavg))
        js = jm.initial_state().replace(
            **{k: jnp.asarray(leaves[k]) for k in (
                "tracer_cur", "tracer_old", "rho_cur", "rho_old", "u_cur")})
        ts = convert.state_from_numpy(leaves, tcfg, "cpu")
        jm.nsteps_total = tm.nsteps_total = 1
        self.jsteps, self.tsteps, self.first = [], [], None
        for _ in range(NSTEPS):
            js, _ = jm.advance(js, jf)
            ts, _ = tm.advance(ts, tf)
            self.jsteps.append(jax_leaves(js))
            self.tsteps.append(ts)
            if tavg and self.first is None:  # F3: the first step's sample
                self.first = {n: (self.tstream.sums[n].numpy().copy(),
                                  np.array(self.jstream.sums[n]))
                              for n in F3 if n in self.fields}


def _step_run(which, tmp):
    if which == "prod_pbc":
        base = get_config("prod_full", nx=32, ny=16, km=12, **HMIX)
        jcfg = with_file(base, stretched_pair(base, tmp)[2],
                         tmp / "dzbc.ieeer8")
        jcfg, tcfg, _, tgrid = stretched_pair(jcfg, tmp)
        return StepRun(jcfg, tcfg, tgrid)
    base = get_config("mini", **(GM_FULL if which == "gm_full" else {}))
    jcfg = with_file(base, j_build_grid(base), tmp / "dzbc.ieeer8")
    tcfg = torch_cfg(jcfg)
    return StepRun(jcfg, tcfg, t_build_grid(tcfg, "cpu"),
                   tavg=tmp if which == "mini" else None)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The StepRun of a configuration, built once per module."""
    cache = {}

    def get(which):
        if which not in cache:
            cache[which] = _step_run(which, tmp_path_factory.mktemp(which))
        return cache[which]
    return get


@pytest.fixture(params=["prod_pbc", "mini", "gm_full"])
def stepped(request, runs):
    return request.param, runs(request.param)


@pytest.mark.parametrize("step,band", [(1, 1e-11), (NSTEPS, 1e-7)])
def test_whole_steps_match_the_jax_package(stepped, step, band):
    which, r = stepped
    assert supported.unsupported(r.tm.cfg) == []
    assert r.tm.grid.DZBT is not None
    state, want = r.tsteps[step - 1], r.jsteps[step - 1]
    diffs = {k: scale_err(getattr(state, k).numpy(), want[k])
             for k in ("u_cur", "v_cur", "psurf_cur", "ubtrop_cur",
                       "vbtrop_cur")}
    for n in range(want["tracer_cur"].shape[0]):
        diffs[f"tracer{n}"] = scale_err(state.tracer_cur[n].numpy(),
                                        want["tracer_cur"][n])
    assert max(diffs.values()) <= band, (which, diffs)


def test_tavg_stream_matches_the_jax_package(runs):
    r = runs("mini")
    got, want = r.tstream.averages(), r.jstream.sums
    norm = 1.0 / r.jstream.nsamples
    worst = {}
    for name in r.fields:
        g = got[name]
        w = np.asarray(want[name])
        if jtavg.FIELDS[name].method == "avg":
            w = w * norm
        if name in r.first:
            g, w = r.first[name]
        scale = np.abs(w).max()
        if scale == 0.0:
            np.testing.assert_array_equal(g, w, err_msg=name)
            continue
        worst[name] = float(np.abs(g - w).max() / scale)
    assert len(worst) > 40 and max(worst.values()) <= 1e-9, worst


def test_budgets_closed_over_eight_steps(tmp_path):
    """The port's heat and salt budgets under partial bottom cells, with
    DZT-weighted volumes, as test_pbc.py holds the JAX package's."""
    base = get_config("mini")
    cfg = torch_cfg(with_file(base, j_build_grid(base),
                              tmp_path / "dzbc.ieeer8", seed=SEED + 4))
    m = TModel(cfg, device="cpu")
    st0 = m.initial_state()
    st = st0
    for _ in range(8):
        st, _ = m.advance(st)
    d = m.diagnostics(st)
    assert np.isfinite(d["KE"]) and d["KE"] > 0
    res = budget.budget_residual(cfg, m.grid, st0, st, m.forcing, 8)
    assert abs(float(res[0])) < 1e-9     # heat closed (zero flux)
    assert abs(float(res[1])) < 1e-11    # salt closed
