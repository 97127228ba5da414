"""The port's time-averaged output (``pop2_tpu_torch.tavg``, the step's
extras, ``Model.enable_tavg`` and ``run_compiled``'s captured
accumulation) against the JAX package's, and against itself, on the CPU in
float64.

Against ``pop2_tpu``: the registry (108 fields, 42 of them 3-D) has the
same names, long names, units, dimensions and methods; a stream of every
field each configuration evaluates, filled by four leapfrog steps of
``Model.advance`` from one perturbed state in both packages, gives every
average, minimum and maximum within 1e-9 of the field's scale (the band
``test_torch_run_loop.py`` holds the state to over 10 steps; KVMIX and
KVMIX_M on the first step's sample, ROADMAP.md Queue 3 F3). Two
configurations: 'mini' (closed, centered advection, Richardson mixing,
del2) and the production menu (``get_config("prod_full")``: KPP, GM with
the transition layer, the Robert filter, tripole, upwind3, the ideal age
and CFC tracers under a 7 m/s wind) at 32 x 16 x 10 on levels 10 m thick at
the surface, each half a level thicker than the one above
(``torch_port_helpers.stretched_pair``). In float64 on the CPU the JAX
package takes its jnp chains where its Pallas kernels would run on a TPU
(``gm_pallas.available``), as its own whole-model tests do. The files both
packages write from those averages hold equal variables, in NetCDF3 and in
netCDF-4.

Against itself: ``run_compiled`` (the accumulation at the end of the
captured step's ``post``) equal bitwise to ``advance``; the accumulation
with its shared intermediates memoised equal bitwise to each field computed
alone; accumulators saved and restored mid-run equal bitwise to a straight
run; a stream on the calendar, or a snapshot stream, sends every step
through ``advance``; unknown fields and missing extras raise.
"""

import dataclasses
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

jax.config.update("jax_enable_x64", True)

from pop2_tpu import eos as jeos, tavg as jtavg  # noqa: E402
from pop2_tpu.config import get_config  # noqa: E402
from pop2_tpu.model import Model as JModel  # noqa: E402

from pop2_tpu_torch import convert, production, tavg as ttavg  # noqa: E402
from pop2_tpu_torch.model import Model as TModel  # noqa: E402

from tests.torch_port_helpers import (jax_leaves, stretched_pair,  # noqa: E402
                                      torch_cfg)

BAND = 1e-9
NSTEPS = 4
# ROADMAP.md Queue 3, F3: the tidal part of KVMIX/KVMIX_M divides by N^2,
# the small difference of two densities; near neutral stratification the
# last-bit difference of the two packages' equations of state grows there
# to 1.1e-9 of scale after four steps (1e-11 after one). They are held at
# the band on the first step's sample, where both packages read the same
# state; the other fields after NSTEPS
F3 = ("KVMIX", "KVMIX_M")
U10_SQR = 4.9e5  # cm^2/s^2: a 7 m/s wind


def test_registry_is_the_jax_packages():
    assert list(ttavg.FIELDS) == list(jtavg.FIELDS)
    assert len(ttavg.FIELDS) == 108
    assert sum(d.ndims == 3 for d in ttavg.FIELDS.values()) == 42
    for name, d in ttavg.FIELDS.items():
        j = jtavg.FIELDS[name]
        assert (d.long_name, d.units, d.ndims, d.method) == (
            j.long_name, j.units, j.ndims, j.method), name
    assert {d.method for d in ttavg.FIELDS.values()} == {"avg", "min",
                                                         "max"}


class StreamRun:
    """One configuration in both packages from the same perturbed state and
    forcing, with a tavg stream of every field the configuration evaluates,
    NSTEPS leapfrog steps of ``advance`` each (the step counter starts past
    the Euler step: one compiled JAX step)."""

    def __init__(self, jcfg, tcfg, tgrid, tmp):
        self.jm = JModel(jcfg)
        self.tm = TModel(tcfg, grid=tgrid, device="cpu")
        jm, tm = self.jm, self.tm
        g = jm.grid
        mt = np.asarray(g.kmask_t)
        rng = np.random.RandomState(11)
        leaves = jax_leaves(jm.initial_state())
        tr = leaves["tracer_cur"].copy()
        tr[0] += 0.2 * rng.randn(*tr[0].shape) * mt
        cold = rng.rand(*tr[0, 0].shape) < 0.3
        tr[0, 0] = np.where(mt[0], np.where(cold, -2.5, tr[0, 0]), 0.0)
        if tr.shape[0] > 2:
            tr[2] = 10.0 * rng.rand(*tr[2].shape) * mt
        # the densities of the perturbed tracers
        rho = np.asarray(jnp.where(g.kmask_t, jeos.state(
            jcfg, g.vgrid.pressz, jnp.asarray(tr[0]), jnp.asarray(tr[1]),
            jm.ts_range), 0.0))
        leaves.update(tracer_cur=tr, tracer_old=tr, rho_cur=rho,
                      rho_old=rho)
        shape = mt.shape[1:]
        heat = 5.0e-4 * np.abs(rng.randn(*shape))
        stf = np.zeros((jcfg.nt,) + shape)
        stf[0] = np.where(rng.rand(*shape) < 0.4, -heat, 0.2 * heat) * mt[0]
        forcing = dict(stf=stf,
                       shf_qsw=2.0e-4 * np.abs(rng.randn(*shape)) * mt[0],
                       fw=1.0e-6 * rng.randn(*shape) * mt[0])
        if jcfg.passive_tracers:
            forcing.update(u10_sqr=np.full(shape, U10_SQR),
                           ifrac=np.zeros(shape))
        self.jforcing = jm.forcing.replace(
            **{k: jnp.asarray(v) for k, v in forcing.items()})
        self.tforcing = tm.forcing.replace(
            **{k: torch.as_tensor(v) for k, v in forcing.items()})
        self.fields = evaluable_fields(tm, self.tforcing)
        self.tmp = tmp

        self.jstream = jm.enable_tavg(self.fields, freq_steps=10 ** 6,
                                      outdir=str(tmp))
        state = jm.initial_state().replace(
            **{k: jnp.asarray(leaves[k]) for k in (
                "tracer_cur", "tracer_old", "rho_cur", "rho_old")})
        jm.nsteps_total = 1  # leapfrog steps from here
        self.jfirst = {}
        for i in range(NSTEPS):
            state, _ = jm.advance(state, self.jforcing)
            if i == 0:
                self.jfirst = {n: np.array(self.jstream.sums[n])
                               for n in F3 if n in self.fields}

        self.tstream = tm.enable_tavg(self.fields, freq_steps=10 ** 6,
                                      outdir=str(tmp))
        tm.initial_state()
        tm.nsteps_total = 1
        self.t0 = convert.state_from_numpy(
            {k: leaves[k] for k in leaves}, tm.cfg, "cpu")
        state = self.t0
        for i in range(NSTEPS):
            state, _ = tm.advance(state, self.tforcing)
            if i == 0:
                self.tfirst = {n: self.tstream.sums[n].numpy().copy()
                               for n in self.jfirst}
        self.tstate = state

    def jax_averages(self):
        norm = 1.0 / self.jstream.nsamples
        return {n: (np.asarray(a) if jtavg.FIELDS[n].method != "avg"
                    else np.asarray(a) * norm)
                for n, a in self.jstream.sums.items()}


def evaluable_fields(model, forcing):
    """The fields a configuration's step extras and forcing let one
    evaluate (the others raise as the JAX package's ``_need`` does)."""
    from pop2_tpu_torch import step as step_mod
    state = model.initial_state()
    out = step_mod.step(model.cfg, model.grid, model.bc, model.ts_range,
                        state, forcing, True, False,
                        **model.step_args(True), with_extras=True)
    aux = ttavg.TavgAux(forcing=forcing, bc=model.bc, **out[2])
    names = []
    for name, d in ttavg.FIELDS.items():
        try:
            d.fn(model.cfg, model.grid, out[0], aux)
        except ValueError as err:
            assert "needs step-internal" in str(err)
            continue
        names.append(name)
    return names


@pytest.fixture(scope="module", params=["mini", "prod"])
def run(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(f"tavg_{request.param}")
    if request.param == "mini":
        jcfg = get_config("mini")
        tcfg = torch_cfg(jcfg)
        from pop2_tpu_torch.grid import build_grid
        tgrid = build_grid(tcfg, "cpu")
    else:
        jcfg, tcfg, _, tgrid = stretched_pair(
            get_config("prod_full", nx=32, ny=16, km=10), tmp)
    return request.param, StreamRun(jcfg, tcfg, tgrid, tmp)


def test_every_field_matches_the_jax_package(run):
    which, r = run
    # mini has no KPP, GM or Robert filter; the production menu has all
    want_n = 83 if which == "mini" else 108
    assert len(r.fields) == want_n
    assert r.jstream.nsamples == r.tstream.nsamples == NSTEPS
    got, want = r.tstream.averages(), r.jax_averages()
    worst = {}
    for name in r.fields:
        g, w = got[name], want[name]
        if name in r.jfirst:
            g, w = r.tfirst[name], r.jfirst[name]
        assert g.shape == w.shape, name
        scale = np.abs(w).max()
        if scale == 0.0:
            np.testing.assert_array_equal(g, w, err_msg=name)
            continue
        worst[name] = float(np.abs(g - w).max() / scale)
    assert max(worst.values()) <= BAND, {k: v for k, v in worst.items()
                                         if v > BAND}
    if which == "prod":
        # the fields of the production menu see its physics
        for name in ("HBLT", "XBLT", "TBLT", "KAPPA_ISOP", "TLT",
                     "RF_TEND_TEMP", "HDIFT", "TPOWER", "QSW_HBL"):
            assert np.abs(want[name]).max() > 0.0, name
        assert (want["XBLT"] >= want["TBLT"]).all()


def test_files_match_the_jax_packages(run, tmp_path):
    from scipy.io import netcdf_file
    from pop2_tpu.io.netcdf4 import read_netcdf4 as j_read
    from pop2_tpu_torch.io.netcdf4 import read_netcdf4 as t_read
    _, r = run
    tfile = r.tstream.write(str(tmp_path / "port.nc"), 5)
    jfile = r.jstream.write(str(tmp_path / "jax.nc"), 5)
    with netcdf_file(tfile, mmap=False) as ft, \
            netcdf_file(jfile, mmap=False) as fj:
        assert set(ft.variables) == set(fj.variables)
        assert len(ft.variables) == len(r.fields) + 4
        for name, v in fj.variables.items():
            got, want = ft.variables[name][:], v[:]
            assert got.dtype == want.dtype and got.shape == want.shape
            scale = np.abs(want).max() or 1.0
            assert np.abs(got.astype(np.float64) - want).max() <= max(
                BAND * scale, np.spacing(np.float32(scale))), name
            assert ft.variables[name].units == v.units, name
    # netCDF-4 from the same averages
    tcfg = r.tm.cfg.with_(tavg_fmt_out="nc4")
    jcfg = r.jm.cfg.with_(tavg_fmt_out="nc4")
    t4 = ttavg.write_fields_netcdf(tcfg, r.tm.grid, str(tmp_path / "p4.nc"),
                                   r.fields, r.tstream.averages(), 5)
    j4 = jtavg.write_fields_netcdf(jcfg, r.jm.grid, str(tmp_path / "j4.nc"),
                                   r.fields, r.jax_averages(), 5)
    dt, vt, at = t_read(t4)
    dj, vj, aj = j_read(j4)
    assert dt == dj and at == aj and set(vt) == set(vj)
    for name, (dims, want, attrs) in vj.items():
        gdims, got, gattrs = vt[name]
        assert gdims == dims and gattrs == attrs, name
        scale = np.abs(want).max() or 1.0
        assert np.abs(got.astype(np.float64) - want).max() <= max(
            BAND * scale, np.spacing(np.float32(scale))), name


# -- the port against itself ---------------------------------------------------

def _prod_small(**over):
    return production.get_production_config(nx=40, ny=24, km=10,
                                            vert_grid="uniform", **over)


def _windy(model):
    f = model.forcing
    return f.replace(u10_sqr=torch.full_like(f.fw, U10_SQR),
                     ifrac=torch.zeros_like(f.fw))


def _stream_run(cfg, nsteps, compiled, freq=4, **kw):
    model = TModel(cfg, device="cpu")
    forcing = _windy(model) if cfg.passive_tracers else None
    stream = model.enable_tavg(list(ttavg.FIELDS), freq_steps=freq,
                               outdir=kw.pop("outdir", "."), **kw)
    state = model.initial_state()
    if compiled:
        state, _ = model.run_compiled(state, nsteps, forcing)
    else:
        state = model.run(state, nsteps, forcing)
    return model, stream, state


def test_run_compiled_accumulates_as_advance(tmp_path):
    """Seven steps of the production menu, the stream written after step 4
    and filled again from step 5: the captured step's accumulation equals
    advance's bitwise, as do the state and the file."""
    cfg = _prod_small()
    runs = []
    for compiled in (False, True):
        out = tmp_path / str(compiled)
        out.mkdir()
        runs.append(_stream_run(cfg, 7, compiled, outdir=str(out)))
    (ma, sa, a), (mb, sb, b) = runs
    assert mb._captured is not None and mb._captured.streams == (sb,)
    assert sa.nsamples == sb.nsamples == 3
    for k in sa.sums:
        assert torch.equal(sa.sums[k], sb.sums[k]), k
    for (name, x), (_, y) in zip(a.leaves(), b.leaves()):
        assert torch.equal(x, y), name
    from scipy.io import netcdf_file
    assert len(ma.tavg_files) == len(mb.tavg_files) == 1
    with netcdf_file(ma.tavg_files[0], mmap=False) as fa, \
            netcdf_file(mb.tavg_files[0], mmap=False) as fb:
        for name, v in fa.variables.items():
            np.testing.assert_array_equal(fb.variables[name][:], v[:])


def test_memoised_fields_equal_each_alone():
    cfg = _prod_small()
    model = TModel(cfg, device="cpu")
    forcing = _windy(model)
    from pop2_tpu_torch import step as step_mod
    state, _ = model.advance(model.initial_state(), forcing)
    state, _, extras = step_mod.step(
        cfg, model.grid, model.bc, model.ts_range, state, forcing, True,
        False, **model.step_args(True), with_extras=True)
    stream = ttavg.TavgStream(cfg, model.grid, list(ttavg.FIELDS), 1)
    aux = ttavg.TavgAux(forcing=forcing, bc=model.bc, **extras)
    stream.accumulate(state, aux)
    assert aux.memo is None
    zero = ttavg.TavgStream(cfg, model.grid, list(ttavg.FIELDS), 1)
    for name, d in ttavg.FIELDS.items():
        alone = d.fn(cfg, model.grid, state, aux)
        if d.method == "avg":
            alone = zero.sums[name] + alone
        else:
            alone = (torch.minimum if d.method == "min"
                     else torch.maximum)(zero.sums[name], alone)
        assert torch.equal(stream.sums[name], alone), name
    # the shared intermediates were computed once each
    memo = {}
    stream.accumulate_fields(state, aux._replace(memo=memo))
    assert sorted(k[0] for k in memo) == ["advt", "flux_vel", "hdifft_gm"]


def test_restore_mid_run_writes_into_the_same_buffers(tmp_path):
    """save_accumulators -> reset -> restore_accumulators between two
    run_compiled calls: the rest of the run accumulates into the restored
    sums, bitwise as a straight run does."""
    cfg = _prod_small()
    _, straight, _ = _stream_run(cfg, 7, True, freq=100)
    model, stream, state = _stream_run(cfg, 4, True, freq=100)
    buffer = stream.buffer.data_ptr()
    saved = stream.save_accumulators()
    assert saved["nsamples"] == 4
    stream.reset()
    assert float(stream.sums["TEMP"].abs().max()) == 0.0
    stream.restore_accumulators(saved)
    state, _ = model.run_compiled(state, 3, _windy(model))
    assert stream.buffer.data_ptr() == buffer
    assert stream.nsamples == straight.nsamples == 7
    for k in stream.sums:
        assert torch.equal(stream.sums[k], straight.sums[k]), k
    with pytest.raises(ValueError, match="not this stream's"):
        stream.restore_accumulators({"nsamples": 1,
                                     "sum_TEMP": saved["sum_TEMP"]})


def test_calendar_stream_and_snapshots_step_through_advance(tmp_path):
    cfg = get_config_mini()
    runs = {}
    for kind in ("calendar", "history"):
        model = TModel(cfg, device="cpu")
        if kind == "calendar":
            stream = model.enable_tavg(["TEMP", "SSH"],
                                       outdir=str(tmp_path), prefix=kind,
                                       freq_opt="nstep", freq=3)
        else:
            stream = model.enable_tavg(["TEMP", "SSH"], freq_steps=3,
                                       outdir=str(tmp_path), prefix=kind)
            model.enable_history(["TEMP"], freq_steps=2,
                                 outdir=str(tmp_path))
        state, _ = model.run_compiled(model.initial_state(), 7)
        assert model._captured is None  # every step through advance
        runs[kind] = (model, stream, state)
    ref = TModel(cfg, device="cpu")
    ref_stream = ref.enable_tavg(["TEMP", "SSH"], freq_steps=3,
                                 outdir=str(tmp_path), prefix="ref")
    ref_state = ref.run(ref.initial_state(), 7)
    for kind, (model, stream, state) in runs.items():
        assert stream.nsamples == ref_stream.nsamples == 1, kind
        assert [f[-11:] for f in model.tavg_files
                if "pop2_tpu.h" not in f] == ["00000003.nc", "00000006.nc"]
        for k in stream.sums:
            assert torch.equal(stream.sums[k], ref_stream.sums[k]), (kind, k)
        for (name, x), (_, y) in zip(state.leaves(), ref_state.leaves()):
            assert torch.equal(x, y), (kind, name)
    hist = [f for f in runs["history"][0].tavg_files if "pop2_tpu.h" in f]
    assert [f[-11:] for f in hist] == ["00000002.nc", "00000004.nc",
                                       "00000006.nc"]


def get_config_mini():
    from pop2_tpu_torch.config import get_config as t_get_config
    return t_get_config("mini")


def test_a_new_stream_drops_the_captured_step(tmp_path):
    model = TModel(get_config_mini(), device="cpu")
    state, _ = model.run_compiled(model.initial_state(), 4)
    assert model._captured is not None and model._captured.streams == ()
    stream = model.enable_tavg(["TEMP", "WVEL"], freq_steps=100,
                               outdir=str(tmp_path))
    assert model._captured is None and not model._eager_leapfrog_done
    state, _ = model.run_compiled(state, 3)
    assert model._captured.streams == (stream,)
    assert stream.nsamples == 3


def test_refusals_stay_loud(tmp_path):
    model = TModel(get_config_mini(), device="cpu")
    with pytest.raises(KeyError, match="NOT_A_FIELD"):
        model.enable_tavg(["TEMP", "NOT_A_FIELD"])
    with pytest.raises(ValueError, match="unknown history fields"):
        model.enable_history(["NOT_A_FIELD"])
    # mini has no KPP: HBLT needs the step's extras it does not produce
    model.enable_tavg(["HBLT"], freq_steps=2, outdir=str(tmp_path))
    with pytest.raises(ValueError, match="needs step-internal 'hblt'"):
        model.advance(model.initial_state())
    # the estuary fields: zeros unless the exchange is on, which is item 11d
    cfg = model.cfg
    aux = ttavg.TavgAux(forcing=types.SimpleNamespace(roff_f=1.0),
                        bc=model.bc)
    state = model.initial_state()
    f = ttavg.FIELDS["S_FLUX_ROFF_VSF_SRF"].fn
    assert float(f(cfg, model.grid, state, aux).abs().max()) == 0.0
    with pytest.raises(NotImplementedError, match="11d"):
        f(cfg.with_(lestuary_exch=True), model.grid, state, aux)


def test_step_extras_keys_are_the_jax_packages():
    """The extras dict has the JAX step's keys; the tendency is formed from
    the pre-step tracers."""
    cfg = _prod_small()
    model = TModel(cfg, device="cpu")
    from pop2_tpu_torch import step as step_mod
    state = model.initial_state()
    new, diags, extras = step_mod.step(
        cfg, model.grid, model.bc, model.ts_range, state, _windy(model),
        False, False, **model.step_args(False), with_extras=True)
    assert set(extras) == set(ttavg.TavgAux._fields) - {"forcing", "bc",
                                                         "memo"}
    assert all(v is not None for v in extras.values())
    assert dataclasses.is_dataclass(new) and diags.solver_iters > 0


def test_segment_replay_adds_the_mode_launches():
    """The chain kernel's diagnostic-column launches and the flux
    assembly's tripole-row launches count at every replay, as the plain
    launch counters do."""
    from pop2_tpu_torch import gm_chain_cuda, gm_cuda, graphs
    seg = graphs._Segment("post", lambda: None, None, capture=False)
    seg.graph = types.SimpleNamespace(replay=lambda: None)
    seg.mode_launches = {(gm_chain_cuda, "launches_with_diags"): 1,
                         (gm_cuda, "launches_fold"): 1}
    before = (gm_chain_cuda.launches_with_diags, gm_cuda.launches_fold)
    try:
        seg()
        seg()
        assert (gm_chain_cuda.launches_with_diags,
                gm_cuda.launches_fold) == (before[0] + 2, before[1] + 2)
        counts = graphs._counts()
        assert counts[2][(gm_cuda, "launches_fold")] == before[1] + 2
    finally:
        gm_chain_cuda.launches_with_diags, gm_cuda.launches_fold = before
