"""Surface and interior forcing in the port against the JAX package, on the
CPU in float64.

Every input is seeded with NumPy (``sample.forcing_climatology``: monthly
climatologies of the bulk-NCEP heat and freshwater fluxes, a monthly wind
stress, chlorophyll, river runoff at coast points, a marginal sea, the
interior restoring targets' noise); files are written into ``tmp_path``.

Functions, band 1e-12 of each output's scale: ``MonthlyClimatology.at``
('nearest', 'linear', '4point', float32 and float64 data, hours across the
year's wrap and negative hours, the hour a float and a 0-d tensor);
``TimeSeries`` extend / extrapolate / from a file; ``sen_lat_flux`` (a
point with a zero temperature difference among them), ``bulk_ncep`` and
``barnier_restoring``; ``set_sfwf`` in both formulations and both branches
of ``lfw_as_salt_flx``; ``PrecipBalance`` over two synthetic years;
``ms_balancing``; ``river_vsf``; ``ebm_solve`` on inputs that reach both
branches of the cubic; ``exchange_circulation`` with its interface flux;
every ``mcog`` function, its aggregation guard raising; ``RunningMeans``
save / restore and ``NamedFieldRegistry``; the three samplers, twice on one
state; ``file_wind_stress`` from a file, on the closed and the tripole
grid.

Whole steps (PARITY.md's bands, 1e-11 after the first step, 1e-7 after
five): the production configuration less its passive tracers at 32 x 16
x 10 on stretched levels under ``chip_smoke.py``'s ``prod_forced`` menu (chlorophyll from the
forcing, the estuary exchange, interior restoring to the bottom,
bulk-NCEP freshwater as a real freshwater flux), each step's forcing
composed from the model's own surface state as ``chip_smoke.py`` composes
it. One step of
'mini' (chlorophyll shortwave) with each of interior restoring,
``lestuary_exch`` and ``chl_option='file'`` acting alone: one JAX model
with all three switched on, fed the other two's fields in their neutral
values (targets equal to the state, no runoff, the constant chlorophyll),
and the port's run of each switch alone equal to the port's run of that
model; then four steps of that model under all three fields with one tavg
stream of SHF, SFWF, ROFF_F, TAUX and the three estuary fields (1e-9 of
scale, the band of ``test_torch_tavg.py``). The steps are leapfrog steps
(the step counter starts past the Euler step): one compiled JAX step a
model.

The repairs: ``convert.forcing_from_numpy`` carries every leaf of a JAX
``Forcing`` that holds every field and raises on a key that is not a
field; ``graphs.assign`` raises on a structure that differs; and
``run_compiled`` builds its captured step again for a forcing of another
structure, equal bitwise to ``advance``.
"""

import dataclasses
import functools
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

jax.config.update("jax_enable_x64", True)

from pop2_tpu import estuary as jest  # noqa: E402
from pop2_tpu import forcing as jforcing, forcing_sfwf as jsfwf  # noqa: E402
from pop2_tpu import forcing_shf as jshf  # noqa: E402
from pop2_tpu import forcing_tools as jtools, mcog as jmcog  # noqa: E402
from pop2_tpu import ms_balance as jms, named_fields as jnf  # noqa: E402
from pop2_tpu import running_mean as jrm, samplers as jsamp  # noqa: E402
from pop2_tpu.config import get_config  # noqa: E402
from pop2_tpu.grid import build_grid as j_build_grid  # noqa: E402
from pop2_tpu.model import Model as JModel  # noqa: E402

from pop2_tpu_torch import baroclinic as tbaro, convert  # noqa: E402
from pop2_tpu_torch import estuary as test_, graphs  # noqa: E402
from pop2_tpu_torch import forcing as tforcing  # noqa: E402
from pop2_tpu_torch import forcing_sfwf as tsfwf  # noqa: E402
from pop2_tpu_torch import forcing_shf as tshf  # noqa: E402
from pop2_tpu_torch import forcing_tools as ttools, mcog as tmcog  # noqa: E402
from pop2_tpu_torch import ms_balance as tms, named_fields as tnf  # noqa: E402
from pop2_tpu_torch import running_mean as trm, sample  # noqa: E402
from pop2_tpu_torch import samplers as tsamp, supported  # noqa: E402
from pop2_tpu_torch.grid import build_grid as t_build_grid  # noqa: E402
from pop2_tpu_torch.model import Model as TModel  # noqa: E402

from tests.torch_port_helpers import (jax_leaves, scale_err,  # noqa: E402
                                      stretched_pair, torch_cfg)

SEED = 15
BAND = 1e-12
NSTEPS = 5
TAVG_STEPS = 4
SMALL = dict(nx=32, ny=16, km=10, passive_tracers=(), nt=2)
# chip_smoke.py's prod_forced menu on the production configuration
FORCED = dict(sw_absorption="chlorophyll", chl_option="file",
              lestuary_exch=True, sfwf_formulation="bulk-NCEP",
              lfw_as_salt_flx=False,
              pt_interior_restore_tau_days=365.0,
              s_interior_restore_tau_days=365.0)
U10_SQR = 4.9e5  # cm^2/s^2: chip_smoke.py's 7 m/s wind
TAVG_FIELDS = ("SHF", "SFWF", "ROFF_F", "TAUX", "T_FLUX_EXCH_INTRF",
               "S_FLUX_EXCH_INTRF", "S_FLUX_ROFF_VSF_SRF")
# the climatologies at the model's hour, and their interpolation
CLIMS = {"windspd": "4point", "tair": "linear", "qair": "linear",
         "qsw": "linear", "cldfrac": "linear", "sst": "linear",
         "sss": "linear", "precip": "linear", "chl": "linear"}


def _t(a):
    return torch.as_tensor(np.array(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, band=BAND, name=""):
    err = scale_err(_np(got), _np(want))
    assert err <= band, (name, err)


@pytest.fixture(scope="module")
def grids():
    """The production (tripole) grid at 32 x 16 x 10 and 'mini' (closed) in
    both packages."""
    out = {}
    for which, jcfg in (
            ("tripole", get_config("prod_full", vert_grid="uniform",
                                   **SMALL)),
            ("closed", get_config("mini"))):
        tcfg = torch_cfg(jcfg)
        out[which] = (jcfg, tcfg, j_build_grid(jcfg),
                      t_build_grid(tcfg, "cpu"))
    return out


# -- forcing_tools ---------------------------------------------------------------

HOURS = (0.0, 200.0, 365.0, 4000.0, 8500.0, 8759.5, 8760.0, 9000.0,
         -100.0, -8000.0, 20000.0)


@pytest.mark.parametrize("dtype,data_type", [
    ("float32", "monthly-equal"), ("float64", "monthly-calendar")])
@pytest.mark.parametrize("interp", ["nearest", "linear", "4point"])
def test_monthly_climatology_at(interp, dtype, data_type):
    rng = np.random.RandomState(SEED)
    data = (1.0 + rng.rand(12, 3, 4)).astype(dtype)
    jc = jtools.MonthlyClimatology.create(data, interp, data_type)
    jat = jax.jit(jc.at)
    tc = ttools.MonthlyClimatology.create(data, interp, data_type,
                                          device="cpu")
    assert tc.times.dtype == torch.float64
    for hour in HOURS:
        want = np.array(jat(hour))
        for thour in (hour, torch.tensor(hour, dtype=torch.float64)):
            got = tc.at(thour)
            assert got.dtype == torch.from_numpy(want).dtype
            _close(got, want, name=(data_type, hour))
    # the first month's midpoint lies after hour 0: both wrap to December
    assert np.isclose(float(jat(1.0)[0, 0]), float(tc.at(1.0)[0, 0]))


@pytest.mark.parametrize("taxmode", ["extend", "extrapolate"])
def test_time_series(taxmode, tmp_path):
    years = np.array([1850.0, 1900.0, 1950.0, 1975.0, 2000.0])
    rng = np.random.RandomState(SEED)
    values = rng.rand(5, 2)
    path = str(tmp_path / "series.txt")
    np.savetxt(path, np.column_stack([years, values]))
    pairs = [(jtools.TimeSeries.create(years, values),
              ttools.TimeSeries.create(years, values, device="cpu")),
             (jtools.TimeSeries.from_file(path),
              ttools.TimeSeries.from_file(path, device="cpu"))]
    for jts, tts in pairs:
        jat = jax.jit(lambda y: jts.at(y, taxmode))
        for year in (1800.0, 1850.0, 1923.4, 1975.0, 1999.9, 2050.0):
            want = np.asarray(jat(year))
            _close(tts.at(year, taxmode), want, name=year)
            _close(tts.at(torch.tensor(year, dtype=torch.float64), taxmode),
                   want, name=year)
    with pytest.raises(NotImplementedError):
        pairs[0][1].at(1900.0, "cycle")


# -- forcing_shf -----------------------------------------------------------------

def _surface(grids, which="tripole"):
    """(JAX cfg, port cfg, JAX grid, port grid, climatology at one hour as
    {name: (ny, nx)}, SST, SSS) on ``which``'s grid."""
    jcfg, tcfg, jgrid, tgrid = grids[which]
    rng = np.random.RandomState(SEED + 1)
    mask = np.asarray(jgrid.kmask_t)
    lat = np.asarray(jgrid.TLAT)
    sst = (15.0 + 12.0 * np.cos(lat) + rng.randn(*lat.shape)) * mask[0]
    sss = (0.035 + 1e-3 * rng.randn(*lat.shape)) * mask[0]
    clim = sample.forcing_climatology(mask, lat, sst, sss, SEED)
    month = {k: clim[k][4] for k in CLIMS}
    return jcfg, tcfg, jgrid, tgrid, clim, month, sst, sss


def test_sen_lat_flux_bulk_ncep_barnier(grids):
    jcfg, tcfg, jgrid, tgrid, _, data, sst, _ = _surface(grids)
    # a point whose air-sea temperature difference is exactly zero: the
    # reference's sign(0) makes it half stable
    tair = data["tair"].copy()
    tair[3, 5] = sst[3, 5] + 273.15 - 0.02
    delp = tair + 0.01 * 2.0 - sst - 273.15
    zero = delp == 0.0
    ins = (data["windspd"], sst, tair, data["qair"])
    want = jax.jit(jshf.sen_lat_flux)(*ins)
    got = tshf.sen_lat_flux(*map(_t, ins))
    for g, w, name in zip(got, want, ("hs", "hl")):
        _close(g, w, name=name)
    data = dict(data, tair=tair)
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    tdata = {k: _t(v) for k, v in data.items()}
    want = jax.jit(lambda s, d: jshf.bulk_ncep(jcfg, jgrid, s, d))(
        jnp.asarray(sst), jdata)
    got = tshf.bulk_ncep(tcfg, tgrid, _t(sst), tdata)
    for g, w, name in zip(got, want, ("stf_t", "shf_qsw")):
        _close(g, w, name=name)
    assert tgrid.__dict__["_ccint"] is tshf.ccint(tgrid)  # made once
    tau = np.where(np.arange(sst.size).reshape(sst.shape) % 3 == 0, 0.0,
                   30.0 * 86400.0)
    for qsw in (None, data["qsw"]):
        want = jshf.barnier_restoring(
            jcfg, jgrid, jnp.asarray(sst), jnp.asarray(data["sst"]),
            jnp.asarray(tau), None if qsw is None else jnp.asarray(qsw))
        got = tshf.barnier_restoring(
            tcfg, tgrid, _t(sst), _t(data["sst"]), _t(tau),
            None if qsw is None else _t(qsw))
        for g, w in zip(got, want):
            _close(g, w, name="barnier")
    # the zero-difference point was reached (if the sum rounds to zero)
    assert zero.any() or not np.isclose(delp[3, 5], 0.0, atol=1e-12)


# -- forcing_sfwf ----------------------------------------------------------------

@pytest.mark.parametrize("formulation,lfw", [
    ("restoring", True), ("bulk-NCEP", True), ("bulk-NCEP", False)],
    ids=["restoring", "bulk_salt_flux", "bulk_freshwater"])
def test_set_sfwf(grids, formulation, lfw):
    jcfg, tcfg, jgrid, tgrid, clim, data, sst, sss = _surface(grids)
    over = dict(sfwf_formulation=formulation, lfw_as_salt_flx=lfw,
                sfwf_restore_tau=30.0)
    jcfg, tcfg = jcfg.with_(**over), tcfg.with_(**over)
    rng = np.random.RandomState(SEED + 2)
    ifrac = np.where(rng.rand(*sst.shape) < 0.2, rng.rand(*sst.shape), 0.0)
    qlat = -80.0 - 40.0 * rng.rand(*sst.shape)
    ins = dict(sss_data=data["sss"], salt_surf=sss, sst_surf=sst,
               qlat=qlat, precip_data=data["precip"],
               ocn_wgt=(1.0 - ifrac) * np.asarray(jgrid.RCALCT),
               mask_sr=1.0 - clim["ms_mask"])
    want = jsfwf.set_sfwf(jcfg, jgrid, **{k: jnp.asarray(v)
                                          for k, v in ins.items()},
                          precip_fact=1.1)
    got = tsfwf.set_sfwf(tcfg, tgrid, **{k: _t(v) for k, v in ins.items()},
                         precip_fact=1.1)
    for name in tsfwf.SfwfOut._fields:
        _close(getattr(got, name), getattr(want, name), name=name)
    if formulation == "bulk-NCEP":
        assert float(np.abs(want.stf_salt).max()) > 0.0
        assert (float(np.abs(want.fw).max()) > 0.0) == (not lfw)


def test_precip_balance_over_two_years(grids):
    jcfg, tcfg, jgrid, tgrid = grids["tripole"]
    jcfg, tcfg = (c.with_(ladjust_precip=True) for c in (jcfg, tcfg))
    assert jsfwf.make_precip_fact(jcfg) == tsfwf.make_precip_fact(tcfg)
    jb = jsfwf.PrecipBalance(jcfg, jgrid, precip_fact=1.05)
    tb = tsfwf.PrecipBalance(tcfg, tgrid, precip_fact=1.05)
    np.testing.assert_allclose(tb.volume_t_k, jb.volume_t_k, rtol=1e-14)
    rng = np.random.RandomState(SEED + 3)
    salt = np.asarray(jgrid.kmask_t) * 0.035
    for year in range(2):
        # 2-3 mm/day of precipitation over the ocean's area (the
        # precip_total of SfwfOut: kg/m^2/s * cm^2)
        for _ in range(6):
            total = 3.0e-5 * (1.0 + 0.1 * rng.rand()) * jb.area_t
            jb.accumulate(jnp.asarray(total), 86400.0 * 365 / 6)
            tb.accumulate(torch.tensor(total, dtype=torch.float64),
                          86400.0 * 365 / 6)
        assert abs(tb.sum_precip - jb.sum_precip) <= BAND * jb.sum_precip
        salt = salt * (1.0 + 1e-6 * rng.randn())
        jsal = jb.salinity_means(jgrid, jnp.asarray(salt))
        tsal = tb.salinity_means(tgrid, _t(salt))
        np.testing.assert_allclose(tsal, jsal, rtol=1e-12)
        # the update from one salinity profile (the means' last bits would
        # be amplified by the year's difference of salinities)
        ssh = 1e-9 * year
        want = jb.end_of_year(jsal, ssh)
        got = tb.end_of_year(jsal, ssh)
        assert abs(got - want) <= BAND * abs(want), (year, got, want)
    assert abs(got - 1.05) > 1e-3  # the second year moved the factor


# -- ms_balance, estuary -------------------------------------------------------

def test_ms_balancing(grids):
    jcfg, tcfg, jgrid, tgrid, clim, data, _, _ = _surface(grids)
    jreg = jms.build_region(jgrid, clim["ms_mask"], clim["ms_points"])
    treg = tms.build_region(tgrid, clim["ms_mask"], clim["ms_points"])
    for name in tms.MSRegion._fields:
        _close(getattr(treg, name), getattr(jreg, name), name=name)
    flux = data["precip"] - 3e-5
    want = jms.ms_balancing(jcfg, jgrid, jnp.asarray(flux), [jreg, jreg])
    got = tms.ms_balancing(tcfg, tgrid, _t(flux), [treg, treg])
    _close(got, want)
    # the global integral is kept, the sea's is moved out
    area = tgrid.TAREA.numpy()
    assert np.isclose((got.numpy() * area).sum(), (flux * area).sum(),
                      rtol=1e-12)


def test_river_vsf(grids):
    jcfg, tcfg, jgrid, tgrid, clim, _, _, sss = _surface(grids)
    assert (clim["roff"] > 0).sum() > 0
    want = jest.river_vsf(jcfg, jgrid, jnp.asarray(clim["roff"]),
                          jnp.asarray(sss))
    _close(test_.river_vsf(tcfg, tgrid, _t(clim["roff"]), _t(sss)), want)


def _ebm_inputs(seed):
    """River discharges 1 to 1e5 m^3/s, tides 0.2-3 m, lower-layer
    salinities 5-35 ppt (a few zero: inactive), tidal pumping -1 to 1 (a
    negative coefficient opens Cardano's branch: with the pumping at 0-1
    every cubic has three real roots)."""
    rng = np.random.RandomState(seed)
    shape = (24, 24)
    q = 10.0 ** rng.uniform(0.0, 5.0, shape)
    q[0, :4] = 0.0
    s = rng.uniform(5.0, 35.0, shape)
    s[1, :4] = 0.0
    return dict(q_river=q, tide_amp=rng.uniform(0.2, 3.0, shape),
                s_lower=s, w_h=rng.uniform(500.0, 5000.0, shape),
                h=rng.uniform(5.0, 20.0, shape), a1=0.876,
                a2=rng.uniform(-1.0, 1.0, shape), h0=0.5)


def test_ebm_solve_reaches_both_cubic_branches():
    ins = _ebm_inputs(SEED)
    want = jax.jit(jest.ebm_solve)(*ins.values())
    tins = {k: (_t(v) if isinstance(v, np.ndarray) else v)
            for k, v in ins.items()}
    got = test_.ebm_solve(**tins)
    for g, w, name in zip(got, want, ("q_upper", "q_lower", "s_upper")):
        _close(g, w, name=name)
    _, _, _, b, c, d = test_.ebm_coefficients(**tins)
    disc = test_.cubic_discriminant(b, c, d)[2]
    active = (tins["s_lower"] > 0) & (tins["q_river"] > 0)
    assert bool(((disc <= 0) & active).any()), "three real roots not reached"
    assert bool(((disc > 0) & active).any()), "Cardano's branch not reached"
    # the cube root with its sign
    x = _t(np.array([-27.0, -1e-9, 0.0, 1e-300, 8.0, 3.3e5]))
    _close(test_.cbrt(x), np.cbrt(x.numpy()), name="cbrt")
    # the roots on coefficients that reach each branch directly
    rng = np.random.RandomState(SEED + 4)
    coef = [_t(rng.uniform(-3.0, 3.0, 400)) for _ in range(3)]
    disc = test_.cubic_discriminant(*coef)[2]
    assert bool((disc <= 0).any()) and bool((disc > 0).any())
    _close(test_._cubic_neg_real_root(*coef),
           jax.jit(jest._cubic_neg_real_root)(*(c.numpy() for c in coef)),
           name="roots")


def test_exchange_circulation(grids):
    jcfg, tcfg, jgrid, tgrid, clim, _, _, _ = _surface(grids)
    rng = np.random.RandomState(SEED + 5)
    mask = np.asarray(jgrid.kmask_t)
    tr = np.stack([(10.0 + rng.randn(*mask.shape)) * mask,
                   (0.034 + 1e-3 * rng.randn(*mask.shape)) * mask])
    w = jest.exchange_layer_weights(jcfg, jgrid, jcfg.est_h_upper,
                                    jcfg.est_h_lower)
    tw = test_.exchange_layer_weights(tcfg, tgrid, tcfg.est_h_upper,
                                      tcfg.est_h_lower)
    for g, want in zip(tw, w):
        np.testing.assert_allclose(g, want, rtol=1e-14)
    want = jax.jit(lambda t, r: jest.exchange_circulation(
        jcfg, jgrid, t, r, *w, want_flux=True))(tr, clim["roff"])
    dw = test_.device_layer_weights(tcfg, tgrid, torch.float64)
    assert test_.device_layer_weights(tcfg, tgrid, torch.float64) is dw
    for weights in (tw, dw):
        got = test_.exchange_circulation(tcfg, tgrid, _t(tr),
                                         _t(clim["roff"]), *weights,
                                         want_flux=True)
        for g, w_, name in zip(got, want, ("src", "flux")):
            _close(g, w_, name=name)
    assert float(np.abs(want[1]).max()) > 0.0


# -- mcog, running means, named fields, samplers --------------------------------

def test_mcog_functions():
    rng = np.random.RandomState(SEED + 6)
    ncols, ny, nx = 5, 6, 7
    kmt = np.where(rng.rand(ny, nx) < 0.8, 3, 0)
    frac = rng.rand(ncols, ny, nx)
    frac /= frac.sum(axis=0) * rng.uniform(0.85, 1.15, (ny, nx))
    fracr = frac * rng.uniform(0.5, 1.0, frac.shape)
    qf = 200.0 * fracr * rng.rand(*frac.shape)
    swnet = qf.sum(axis=0)
    ins = (frac, fracr, qf, swnet, kmt)
    for kw in (dict(), dict(col_to_bin=(0, 0, 1, 2, 2), debug=True)):
        want = jax.jit(functools.partial(jmcog.import_mcog, **kw))(*ins)
        got = tmcog.import_mcog(*map(_t, ins), **kw)
        for name in tmcog.McogBins._fields:
            g, w = getattr(got, name), getattr(want, name)
            assert (g is None) == (w is None), name
            if g is not None:
                _close(g, w, name=name)
        tmcog.check_aggregation(got, thresh=1e-9)
        _close(tmcog.qsw_bin_weighted(got, 0.7),
               jmcog.qsw_bin_weighted(want, 0.7))
    bad = tmcog.import_mcog(_t(frac), _t(fracr), _t(qf), _t(swnet + 1.0),
                            _t(kmt))
    with pytest.raises(FloatingPointError, match="aggregation"):
        tmcog.check_aggregation(bad)
    one_t = tmcog.single_column_bins(_t(swnet), _t(kmt))
    one_j = jmcog.single_column_bins(jnp.asarray(swnet), jnp.asarray(kmt))
    for g, w in zip(one_t, one_j):
        assert (g is None) == (w is None)
        if g is not None:
            _close(g, w)
    assert tmcog.tavg_field_names(3, True, 5) == jmcog.tavg_field_names(
        3, True, 5)
    for fn in ("normalize_fractions", "aggregate", "per_category_anomaly"):
        args = (frac,) if fn == "normalize_fractions" else (frac, qf)
        _close(getattr(tmcog, fn)(*map(_t, args)),
               getattr(jmcog, fn)(*map(jnp.asarray, args)), name=fn)
    with pytest.raises(ValueError, match="outside"):
        tmcog._bin_matrix((0, 3), 2)


def test_running_means_and_named_fields():
    rng = np.random.RandomState(SEED + 7)
    jr, tr = jrm.RunningMeans(3600.0), trm.RunningMeans(3600.0)
    init = rng.rand(4, 5)
    for r, conv in ((jr, jnp.asarray), (tr, _t)):
        r.define("sst", 86400.0 * 5, conv(init))
        r.define("fast", 1800.0, conv(init))
    samples = [rng.rand(4, 5) for _ in range(4)]
    for x in samples[:2]:
        for name in ("sst", "fast"):
            _close(tr.update(name, _t(x)), jr.update(name, jnp.asarray(x)))
    saved_t, saved_j = tr.save(), jr.save()
    for name in ("sst", "fast"):
        _close(saved_t[name], saved_j[name], name=name)
    for x in samples[2:]:
        tr.update("sst", _t(x))
    tr.restore({**saved_t, "unknown": np.zeros(3)})
    assert "unknown" not in tr.values
    for x in samples[2:]:
        jr.update("sst", jnp.asarray(x))
        tr.update("sst", _t(x))
    _close(tr.get("sst"), jr.get("sst"))

    for reg in (jnf.NamedFieldRegistry(), tnf.NamedFieldRegistry()):
        reg.register("SST", (4, 5))
        reg.register("SST", (4, 5))
        assert reg.registered("SST") and not reg.registered("SSS")
        assert reg.get_index("SST") == "SST"
        with pytest.raises(KeyError, match="no value"):
            reg.get("SST")
        reg.set("SST", init)
        np.testing.assert_array_equal(np.asarray(reg.get("SST")), init)
        with pytest.raises(ValueError, match="expected shape"):
            reg.set("SST", init[:2])
        with pytest.raises(ValueError, match="already registered"):
            reg.register("SST", (2,))
        with pytest.raises(KeyError, match="not registered"):
            reg.get_index("SSS")


def test_samplers_twice_on_one_state(forced):
    jcfg, tcfg = forced.jcfg, forced.tm.cfg
    jgrid, tgrid = forced.jm.grid, forced.tm.grid
    rng = np.random.RandomState(SEED + 8)
    leaves = dict(forced.leaves)
    mu = np.asarray(jgrid.kmask_u)
    leaves["u_cur"] = 20.0 * rng.randn(*mu.shape) * mu
    leaves["v_cur"] = 20.0 * rng.randn(*mu.shape) * mu
    js = forced.jm.initial_state().replace(
        **{k: jnp.asarray(leaves[k]) for k in ("u_cur", "v_cur",
                                               "tracer_cur")})
    ts = convert.state_from_numpy(leaves, tcfg, "cpu")
    points = [(-30.0, 20.0), (0.0, 100.0), (40.0, -60.0)]
    meters = [(-20.0, 50.0, 0), (10.0, 200.0, 3)]
    jsec = jsamp.HydroSection(jgrid, points)
    tsec = tsamp.HydroSection(tgrid, points)
    jm_, tm_ = (jsamp.CurrentMeters(jgrid, meters),
                tsamp.CurrentMeters(tgrid, meters))
    jd, td = (jsamp.Drifters(jcfg, jgrid, points),
              tsamp.Drifters(tcfg, tgrid, points))
    for _ in range(2):
        want, got = jsec.sample(js), tsec.sample(ts)
        for name in ("TEMP", "SALT"):
            _close(got[name], want[name], name=name)
        _close(tm_.sample(ts), jm_.sample(js))
        for g, w in zip(td.advance(ts, 3600.0), jd.advance(js, 3600.0)):
            _close(g, w, name="drifters")
    _close(tm_.series(), jm_.series())
    assert tm_.series().shape == (2, 2, 2)
    assert float(np.abs(jd.lat - np.array([p[0] for p in points])).max()) \
        > 0.0


# -- the wind stress file ------------------------------------------------------------

@pytest.mark.parametrize("which", ["closed", "tripole"])
def test_file_wind_stress(grids, which, tmp_path):
    jcfg, tcfg, jgrid, tgrid, clim, _, _, _ = _surface(grids, which)
    path = str(tmp_path / "ws.ieeer8")
    np.stack([clim["taux"], clim["tauy"]], axis=1).astype(">f8").tofile(
        path)
    ny, nx = jcfg.ny, jcfg.nx
    jx, jy = jforcing.read_ws_file(path, ny, nx)
    tx, ty = tforcing.read_ws_file(path, ny, nx)
    np.testing.assert_array_equal(tx, jx)
    jbase = jforcing.analytic_forcing(jcfg, jgrid)
    tbase = tforcing.analytic_forcing(tcfg, tgrid)
    clims = [ttools.MonthlyClimatology.create(a, device="cpu")
             for a in (tx, ty)]
    jws = jax.jit(lambda h: jforcing.file_wind_stress(jcfg, jgrid, jbase,
                                                      jx, jy, h))
    for hour in (10.0, 2000.0, 8700.0):
        want = jws(hour)
        for args in ((tx, ty), clims):
            got = tforcing.file_wind_stress(tcfg, tgrid, tbase, *args,
                                            torch.tensor(hour))
            for name in ("smf", "smft"):
                _close(getattr(got, name), getattr(want, name), name=name)
    with pytest.raises(ValueError, match="need"):
        tforcing.read_ws_file(path, ny + 1, nx)
    # restoring_forcing: both packages, the SST and the SSS
    sst, sss = (np.asarray(jgrid.RCALCT) * v for v in (10.0, 0.035))
    want = jforcing.restoring_forcing(jcfg, jgrid, jbase, sst + 1, sss, sst,
                                      sss * 1.01)
    got = tforcing.restoring_forcing(tcfg, tgrid, tbase, _t(sst + 1),
                                     _t(sss), _t(sst), _t(sss * 1.01))
    _close(got.stf, want.stf)


# -- the forced production run ------------------------------------------------------

def model_hour(model) -> float:
    """The model's hour of its year, from its calendar (either package)."""
    cal = model.time_manager.calendar
    return (cal.year_fraction - cal.iyear) * jtools.HOURS_PER_YEAR


class Composer:
    """chip_smoke.py's ``prod_forced`` forcing of a step, in one of the two
    packages: monthly wind stress from a file, bulk-NCEP heat flux and
    freshwater flux (the latter with the latent flux of ``sen_lat_flux``,
    P - E as a real freshwater flux) from the climatologies at the model's
    hour and the model's own SST and SSS, the marginal sea's salt and
    freshwater fluxes balanced, the runoff's virtual salt flux, the
    chlorophyll at the model's hour, the runoff, the interior targets (the
    start's T/S plus noise), a 7 m/s wind and no ice."""

    def __init__(self, pkg, cfg, grid, base, clim, ws_path, tracers0):
        self.pkg, self.cfg, self.grid, self.base = pkg, cfg, grid, base
        jaxp = pkg == "jax"
        tools, forcing, shf, sfwf, ms, est = (
            (jtools, jforcing, jshf, jsfwf, jms, jest) if jaxp
            else (ttools, tforcing, tshf, tsfwf, tms, test_))
        conv = jnp.asarray if jaxp else _t
        ny, nx = cfg.ny, cfg.nx
        self.ws = forcing.read_ws_file(ws_path, ny, nx)
        kw = {} if jaxp else dict(device="cpu")
        self.clims = {k: tools.MonthlyClimatology.create(clim[k], interp,
                                                         **kw)
                      for k, interp in CLIMS.items()}
        if not jaxp:  # the port's wind stress climatologies, made once
            self.ws = [tools.MonthlyClimatology.create(a, **kw)
                       for a in self.ws]
        self.region = ms.build_region(grid, clim["ms_mask"],
                                      clim["ms_points"])
        self.roff = conv(clim["roff"])
        self.targets = (conv(tracers0[0] + clim["t_noise"]),
                        conv(tracers0[1] + clim["s_noise"]))
        self.mods = (forcing, shf, sfwf, ms, est)
        self.compose = (jax.jit(self._compose) if jaxp else self._compose)

    def _compose(self, sst, sss, thour):
        forcing, shf, sfwf, ms, est = self.mods
        cfg, grid = self.cfg, self.grid
        f = forcing.file_wind_stress(cfg, grid, self.base, *self.ws, thour)
        data = {k: c.at(thour) for k, c in self.clims.items()}
        stf_t, qsw = shf.bulk_ncep(cfg, grid, sst, data)
        _, qlat = shf.sen_lat_flux(data["windspd"], sst, data["tair"],
                                   data["qair"])
        out = sfwf.set_sfwf(cfg, grid, data["sss"], sss, sst_surf=sst,
                            qlat=qlat, precip_data=data["precip"],
                            ocn_wgt=grid.RCALCT)
        salt, fw = (ms.ms_balancing(cfg, grid, x, [self.region])
                    for x in (out.stf_salt, out.fw))
        salt = salt + est.river_vsf(cfg, grid, self.roff, sss)
        return dict(smf=f.smf, smft=f.smft, stf_t=stf_t, salt=salt,
                    shf_qsw=qsw, fw=fw, tfw_t=out.tfw_temp,
                    chl=data["chl"])

    def __call__(self, model, state):
        thour = model_hour(model)
        if self.pkg == "jax":
            thour = jnp.asarray(thour)
        d = self.compose(state.tracer_cur[0, 0], state.tracer_cur[1, 0],
                         thour)
        base = self.base
        if self.pkg == "jax":
            stf = base.stf.at[0].set(d["stf_t"]).at[1].set(d["salt"])
            tfw = base.tfw.at[0].set(d["tfw_t"])
            full = jnp.full_like
        else:
            stf, tfw = base.stf.clone(), base.tfw.clone()
            stf[0], stf[1], tfw[0] = d["stf_t"], d["salt"], d["tfw_t"]
            full = torch.full_like
        return base.replace(
            smf=d["smf"], smft=d["smft"], stf=stf, tfw=tfw,
            shf_qsw=d["shf_qsw"], fw=d["fw"], chl=d["chl"],
            roff_f=self.roff, pt_interior_data=self.targets[0],
            s_interior_data=self.targets[1],
            u10_sqr=full(base.fw, U10_SQR), ifrac=full(base.fw, 0.0))


class ForcedRun:
    """prod_forced at 32 x 16 x 10 in both packages from one perturbed
    state, NSTEPS leapfrog steps of ``advance``, each under a forcing
    composed from the model's own state."""

    def __init__(self, tmp):
        base = get_config("prod_full", **SMALL)
        jcfg, tcfg, _, tgrid = stretched_pair(
            base.with_(pt_interior_restore_max_level=base.km,
                       s_interior_restore_max_level=base.km, **FORCED),
            tmp)
        jm = JModel(jcfg)
        tm = TModel(tcfg, grid=tgrid, device="cpu")
        self.jcfg, self.jm, self.tm = jcfg, jm, tm
        g = jm.grid
        mt = np.asarray(g.kmask_t)
        rng = np.random.RandomState(SEED + 9)
        leaves = jax_leaves(jm.initial_state())
        tr = leaves["tracer_cur"].copy()
        tr[0] += 0.1 * rng.randn(*tr[0].shape) * mt
        rho = tbaro._masked_density(tm.cfg, tm.grid, tm.ts_range,
                                    _t(tr)).numpy()
        leaves.update(tracer_cur=tr, tracer_old=tr, rho_cur=rho,
                      rho_old=rho)
        self.leaves = leaves
        self.clim = sample.forcing_climatology(
            mt, np.asarray(g.TLAT), tr[0, 0], tr[1, 0], SEED)
        ws = os.path.join(str(tmp), "ws.ieeer8")
        np.stack([self.clim["taux"], self.clim["tauy"]], axis=1).astype(
            ">f8").tofile(ws)
        self.jcomp = Composer("jax", jcfg, g, jm.forcing, self.clim, ws,
                              tr)
        self.tcomp = Composer("torch", tcfg, tm.grid, tm.forcing,
                              self.clim, ws, tr)
        js = jm.initial_state().replace(
            **{k: jnp.asarray(leaves[k]) for k in (
                "tracer_cur", "tracer_old", "rho_cur", "rho_old")})
        ts = convert.state_from_numpy(leaves, tcfg, "cpu")
        jm.nsteps_total = tm.nsteps_total = 1  # leapfrog steps from here
        self.jsteps, self.tsteps, self.forcings = [], [], []
        for _ in range(NSTEPS):
            jf, tf = self.jcomp(jm, js), self.tcomp(tm, ts)
            self.forcings.append((jf, tf))
            js, _ = jm.advance(js, jf)
            ts, _ = tm.advance(ts, tf)
            self.jsteps.append(jax_leaves(js))
            self.tsteps.append(ts)


@pytest.fixture(scope="module")
def forced(tmp_path_factory):
    return ForcedRun(tmp_path_factory.mktemp("prod_forced"))


def _state_diffs(state, want):
    out = {k: scale_err(getattr(state, k).numpy(), want[k])
           for k in ("u_cur", "v_cur", "psurf_cur", "ubtrop_cur",
                     "vbtrop_cur")}
    for n in range(want["tracer_cur"].shape[0]):
        out[f"tracer{n}"] = scale_err(state.tracer_cur[n].numpy(),
                                      want["tracer_cur"][n])
    return out


@pytest.mark.parametrize("step,band", [(1, 1e-11), (NSTEPS, 1e-7)])
def test_prod_forced_matches_the_jax_package(forced, step, band):
    assert supported.unsupported(forced.tm.cfg) == []
    jf, tf = forced.forcings[step - 1]
    # the composed forcing holds every field the menu reads
    for name in ("chl", "roff_f", "pt_interior_data", "s_interior_data",
                 "u10_sqr", "ifrac"):
        assert getattr(tf, name) is not None, name
    for name, leaf in tf.leaves():
        _close(leaf, np.asarray(getattr(jf, name)), band, name)
    diffs = _state_diffs(forced.tsteps[step - 1], forced.jsteps[step - 1])
    assert max(diffs.values()) <= band, diffs


# -- 'mini' with each switch alone ---------------------------------------------------

ALONE = ("interior", "estuary", "chl_file")
MINI = dict(sw_absorption="chlorophyll")


def _alone_config(which, km):
    return {"interior": dict(pt_interior_restore_max_level=km,
                             s_interior_restore_max_level=km - 2,
                             pt_interior_surface_restore=True,
                             pt_interior_restore_tau_days=30.0,
                             s_interior_restore_tau_days=20.0),
            "estuary": dict(lestuary_exch=True),
            "chl_file": dict(chl_option="file")}[which]


class MiniAlone:
    """'mini' with all three switches in both packages, one leapfrog step
    from a perturbed state under each switch's forcing (the other two's
    fields neutral), on stretched levels (``stretched_pair``: 'mini''s own
    levels, 625 m thick, would hold both of the estuary's layers and all
    of the shortwave in the top level, where neither switch acts). Then
    TAVG_STEPS leapfrog steps from the same state under all three fields,
    a heat and a freshwater flux, with one tavg stream of TAVG_FIELDS (the
    JAX model carries the stream from its first step: one compiled
    step)."""

    def __init__(self, tmp):
        base = get_config("mini", **MINI)
        over = {}
        for which in ALONE:
            over.update(_alone_config(which, base.km))
        jcfg, self.tcfg, _, self.tgrid = stretched_pair(base.with_(**over),
                                                        tmp)
        jm = JModel(jcfg)
        self.jcfg = jcfg
        g = jm.grid
        mt = np.asarray(g.kmask_t)
        rng = np.random.RandomState(SEED + 10)
        leaves = jax_leaves(jm.initial_state())
        tr = leaves["tracer_cur"].copy()
        tr[0] += 0.2 * rng.randn(*tr[0].shape) * mt
        tm = TModel(self.tcfg, grid=self.tgrid, device="cpu")
        rho = tbaro._masked_density(tm.cfg, tm.grid, tm.ts_range,
                                    _t(tr)).numpy()
        leaves.update(tracer_cur=tr, tracer_old=tr, rho_cur=rho,
                      rho_old=rho)
        self.leaves = leaves
        clim = sample.forcing_climatology(mt, np.asarray(g.TLAT), tr[0, 0],
                                          tr[1, 0], SEED + 1)
        self.river_points = int((clim["roff"] > 0).sum())
        # roff 100x the climatology's: the exchange moves the state above
        # the rounding of a step
        # a penetrating shortwave for the chlorophyll to act on
        self.common = dict(shf_qsw=2.0e-4 * np.abs(rng.randn(
            *mt.shape[1:])) * mt[0])
        neutral = dict(self.common, pt_interior_data=tr[0],
                       s_interior_data=tr[1],
                       roff_f=np.zeros(mt.shape[1:]),
                       chl=np.full(mt.shape[1:], jcfg.chl_const))
        self.forcings = {
            "interior": dict(neutral, pt_interior_data=tr[0]
                             + 5.0 * clim["t_noise"],
                             s_interior_data=tr[1] + 5.0 * clim["s_noise"]),
            "estuary": dict(neutral, roff_f=100.0 * clim["roff"]),
            "chl_file": dict(neutral, chl=clim["chl"][0])}
        self.jstates = {}
        jstream = jm.enable_tavg(list(TAVG_FIELDS), freq_steps=10 ** 6,
                                 outdir=str(tmp))
        js0 = jm.initial_state().replace(
            **{k: jnp.asarray(leaves[k]) for k in (
                "tracer_cur", "tracer_old", "rho_cur", "rho_old")})
        for which, f in self.forcings.items():
            jm.nsteps_total = 1
            js, _ = jm.advance(js0, jm.forcing.replace(
                **{k: jnp.asarray(v) for k, v in f.items()}))
            self.jstates[which] = jax_leaves(js)

        # the stream's run
        shape = mt.shape[1:]
        heat = 5.0e-4 * np.abs(rng.randn(*shape))
        stf = np.zeros((jcfg.nt,) + shape)
        stf[0] = np.where(rng.rand(*shape) < 0.4, -heat, 0.2 * heat) * mt[0]
        self.tavg_forcing = dict(
            self.common, stf=stf, fw=1.0e-6 * rng.randn(*shape) * mt[0],
            pt_interior_data=self.forcings["interior"]["pt_interior_data"],
            s_interior_data=self.forcings["interior"]["s_interior_data"],
            roff_f=self.forcings["estuary"]["roff_f"],
            chl=self.forcings["chl_file"]["chl"])
        jstream.reset()
        jm.nsteps_total = 1
        jf = jm.forcing.replace(**{k: jnp.asarray(v)
                                   for k, v in self.tavg_forcing.items()})
        js = js0
        for _ in range(TAVG_STEPS):
            js, _ = jm.advance(js, jf)
        self.javg = {k: np.asarray(v) / jstream.nsamples
                     for k, v in jstream.sums.items()}
        self.tstream = tm.enable_tavg(list(TAVG_FIELDS),
                                      freq_steps=10 ** 6, outdir=str(tmp))
        tm.nsteps_total = 1
        ts = convert.state_from_numpy(leaves, self.tcfg, "cpu")
        tf = tm.forcing.replace(**{k: _t(v)
                                   for k, v in self.tavg_forcing.items()})
        for _ in range(TAVG_STEPS):
            ts, _ = tm.advance(ts, tf)

    def alone_cfg(self, *which):
        """The port's 'mini' with the switches ``which`` alone, on the
        stretched levels."""
        over = {}
        for w in which:
            over.update(_alone_config(w, self.jcfg.km))
        return torch_cfg(get_config("mini", **MINI, **over)).with_(
            vert_grid="uniform")

    def port_step(self, cfg, fields):
        tm = TModel(cfg, grid=self.tgrid, device="cpu")
        tm.nsteps_total = 1
        ts = convert.state_from_numpy(self.leaves, cfg, "cpu")
        ts, _ = tm.advance(ts, tm.forcing.replace(
            **{k: _t(v) for k, v in fields.items()}))
        return ts


@pytest.fixture(scope="module")
def mini_alone(tmp_path_factory):
    return MiniAlone(tmp_path_factory.mktemp("mini_alone"))


@pytest.mark.parametrize("which", ALONE)
def test_mini_with_each_switch_alone(mini_alone, which):
    r = mini_alone
    assert r.river_points > 0
    fields = r.forcings[which]
    got = r.port_step(r.tcfg, fields)
    diffs = _state_diffs(got, r.jstates[which])
    assert max(diffs.values()) <= 1e-11, diffs
    # the switch alone, with its field alone, steps as the model of all
    # three does under the others' neutral fields
    key = {"interior": ("pt_interior_data", "s_interior_data"),
           "estuary": ("roff_f",), "chl_file": ("chl",)}[which]
    alone = r.port_step(r.alone_cfg(which),
                        dict(r.common, **{k: fields[k] for k in key}))
    for name, t in alone.leaves():
        assert torch.equal(t, getattr(got, name)), name
    # the switch moved the state
    base = r.port_step(r.alone_cfg(), r.common)
    assert not torch.equal(base.tracer_cur, got.tracer_cur)


# -- the repairs ----------------------------------------------------------------------

def test_forcing_from_numpy_carries_every_field(grids):
    jcfg, tcfg, jgrid, _ = grids["closed"]
    base = jforcing.analytic_forcing(jcfg, jgrid)
    rng = np.random.RandomState(SEED + 11)
    names = [f.name for f in dataclasses.fields(base)]
    assert names == [f.name for f in dataclasses.fields(tforcing.Forcing)]
    full = base.replace(**{
        f.name: jnp.asarray(rng.rand(*(
            (jcfg.km, jcfg.ny, jcfg.nx) if f.name.endswith("interior_data")
            else (3, 2) if f.name == "tracer_atm"
            else () if f.name == "tidal_lnc" else (jcfg.ny, jcfg.nx))))
        for f in dataclasses.fields(base) if getattr(base, f.name) is None})
    leaves = jax_leaves(full)
    assert set(leaves) == set(names)
    tf = convert.forcing_from_numpy(leaves, tcfg, "cpu")
    for name in names:
        np.testing.assert_array_equal(getattr(tf, name).numpy(),
                                      leaves[name], err_msg=name)
    with pytest.raises(KeyError, match="runoff"):
        convert.forcing_from_numpy(dict(leaves, runoff=leaves["fw"]), tcfg,
                                   "cpu")


def test_assign_refuses_another_structure():
    model = TModel(torch_cfg(get_config("mini")), device="cpu")
    buf = graphs._clone_tree(model.forcing)
    more = buf.replace(chl=torch.ones_like(buf.fw))
    with pytest.raises(ValueError, match="built again"):
        graphs.assign(buf, more)
    fewer_buf = graphs._clone_tree(more)
    stf_before = fewer_buf.stf.clone()
    with pytest.raises(ValueError, match="built again"):
        graphs.assign(fewer_buf, model.forcing.replace(
            stf=fewer_buf.stf + 1.0))
    assert torch.equal(fewer_buf.stf, stf_before)  # nothing was copied
    assert graphs.structure(more) - graphs.structure(buf) == {"chl"}


def test_run_compiled_rebuilds_for_another_structure():
    cfg = torch_cfg(get_config("mini", **MINI, **_alone_config(
        "chl_file", 8), **_alone_config("estuary", 8)))
    model = TModel(cfg, device="cpu")
    g = model.grid
    clim = sample.forcing_climatology(
        g.kmask_t.numpy(), g.TLAT.numpy(), np.full(g.TLAT.shape, 10.0),
        np.full(g.TLAT.shape, 0.035), SEED)
    plain = model.forcing
    rich = plain.replace(chl=_t(clim["chl"][3]), roff_f=_t(clim["roff"]))
    schedule = [plain] * 4 + [rich] * 3 + [plain] * 2

    def run(compiled):
        state = model.initial_state()
        for f in schedule:
            state = (model.run_compiled(state, 1, f)[0] if compiled
                     else model.advance(state, f)[0])
        return state

    want = run(False)
    built = []
    step = graphs.CapturedStep.__init__

    def counting(self, *a, **kw):
        built.append(self)
        step(self, *a, **kw)
    graphs.CapturedStep.__init__ = counting
    try:
        got = run(True)
    finally:
        graphs.CapturedStep.__init__ = step
    assert len(built) == 3  # plain, rich, plain again
    assert graphs.structure(built[1].forcing) - graphs.structure(
        built[0].forcing) == {"chl", "roff_f"}
    for name, t in got.leaves():
        assert torch.equal(t, getattr(want, name)), name


def test_tavg_of_the_forcing_fields(mini_alone):
    r = mini_alone
    assert r.tstream.nsamples == TAVG_STEPS
    got = r.tstream.averages()
    for name in TAVG_FIELDS:
        want = r.javg[name]
        assert float(np.abs(want).max()) > 0.0, name
        _close(got[name], want, 1e-9, name)
