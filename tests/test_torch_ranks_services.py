"""The services of a decomposed run (``parallel/mesh.py`` blocks over
``torch.distributed``, gloo on the CPU) held bitwise against the same run on
the whole domain: ``Model.run_compiled``, the output streams, the
global-index diagnostics, every passive package, the coupler cap and the
overflows.

Two starts of the ranks, four ((2, 2) and (1, 4) blocks) and two ((2, 1)
slabs), run what ``tests/torch_parallel_ranks.py`` holds; the whole-domain
runs are the same functions in this process, on mesh (1, 1):

* 'mini' with averaging steps (``time_mix_freq`` 4), b4b, 10 steps through
  ``run_compiled`` with a tavg stream of every field 'mini' evaluates
  (written at steps 4 and 8), and through ``advance`` with history and movie
  streams beside it; prod_full at 32 x 16 x 10 (no averaging step: the
  Robert filter) 3 steps through ``run_compiled`` with a stream of all 108
  fields (BSF, UET/VNT, Q, PV, HDIFT/HDIFS included), written at step 2:
  the state, every file's bytes, the partial accumulation, the sections'
  transports and the streamfunction, in float64 and float32;
* each of ``ecosys``, ``abio_dic``, ``sf6`` and ``irf`` on 'mini', 3 steps;
* the coupler cap: two coupling intervals, a restart on request, the cap
  started again from it on another mesh for a third interval;
* the 'mini' overflow specs of ``tests/test_overflows.py`` (box-only and
  point data), 5 steps from dense source water, regions across block edges
  (these three, too, on every mesh in both dtypes);
* the port's decomposed tavg averages against the JAX package's ``Model``
  on a (2, 2) mesh of the virtual CPU devices, within PARITY.md's band;
* what stays refused: NCCL (a card a rank) and a captured step under it.
"""

import dataclasses
import functools

import numpy as np
import jax
import pytest
import torch

jax.config.update("jax_enable_x64", True)

from pop2_tpu.config import get_config as jget_config  # noqa: E402
from pop2_tpu.parallel import mesh as jmesh  # noqa: E402

from pop2_tpu_torch import overflows as tovf, tavg  # noqa: E402
from pop2_tpu_torch import step as step_mod  # noqa: E402
from pop2_tpu_torch.config import get_config  # noqa: E402
from pop2_tpu_torch.grid import build_grid  # noqa: E402
from pop2_tpu_torch.model import Model  # noqa: E402
from pop2_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from pop2_tpu_torch.parallel import multihost  # noqa: E402
from pop2_tpu_torch import sample  # noqa: E402

from tests import torch_parallel_ranks as ranks  # noqa: E402
from tests.test_overflows import _pt_spec, _spec  # noqa: E402
from tests.test_torch_parallel import whole_run  # noqa: E402
from tests.torch_port_helpers import scale_err, torch_cfg  # noqa: E402

MINI_STEPS = 10
PROD_STEPS = 3
PKG_STEPS = 3
OVF_STEPS = 5
U10_SQR = 4.9e5  # cm^2/s^2: a 7 m/s wind
#: the meshes of each start and their tags
MESHES = {"2x2": (2, 2), "1x4": (1, 4), "2x1": (2, 1)}
DTYPES = ("float64", "float32")
PACKAGES = {"ecosys": 32, "abio_dic": 2, "sf6": 1, "irf": 1}
#: PARITY.md's band after a few steps against the JAX package
PARITY_BAND = 1e-7


def mini_cfg(dtype):
    cfg = get_config("mini", b4b=True, dtype=dtype)
    return cfg.with_(time=dataclasses.replace(cfg.time, time_mix_freq=4))


@functools.lru_cache(maxsize=None)
def prod_inputs(dtype):
    """prod_full at 32 x 16 x 10 with b4b: its config, stratified tracers
    and the 10-m wind and ice fields of the production path's forcing."""
    cfg = get_config("prod_full", b4b=True, nx=32, ny=16, km=10,
                     vert_grid="uniform", dtype=dtype)
    tracers = sample.grid_tracers(cfg, build_grid(cfg, "cpu"), 7,
                                  noise=0.02).double().numpy()
    z = np.zeros((cfg.ny, cfg.nx))
    return cfg, tracers, {"u10_sqr": z + U10_SQR, "ifrac": z}


@functools.lru_cache(maxsize=None)
def evaluable(which):
    """The registered tavg fields ``which``'s configuration evaluates (the
    others need step extras it does not make), from one eager step."""
    if which == "mini":
        cfg, forcing_fields = mini_cfg("float64"), None
    else:
        cfg, _, forcing_fields = prod_inputs("float64")
    model = Model(cfg, device="cpu")
    forcing = model.forcing
    if forcing_fields:
        forcing = forcing.replace(**{k: torch.as_tensor(v) for k, v in
                                     forcing_fields.items()})
    new, _, extras = step_mod.step(
        cfg, model.grid, model.bc, model.ts_range, model.initial_state(),
        forcing, False, False, **model.step_args(False), with_extras=True)
    aux = tavg.TavgAux(forcing=forcing, bc=model.bc, **extras)
    names = []
    for name, d in tavg.FIELDS.items():
        try:
            d.fn(cfg, model.grid, new, aux)
        except ValueError:
            continue
        names.append(name)
    return tuple(names)


def stream_args(case, dtype, outdir):
    """(cfg on the whole domain, args after cfg, kwargs) of
    ``ranks.stream_run`` for a case: 'mini' through run_compiled, 'snap'
    ('mini' through advance with history and movie streams), 'prod'."""
    if case == "prod":
        cfg, tracers, ff = prod_inputs(dtype)
        return cfg, (PROD_STEPS, outdir, evaluable("prod")), dict(
            freq=2, tracers=tracers, forcing_fields=ff)
    kw = {}
    if case == "snap":
        kw = dict(compiled=False, history=("TEMP", "UVEL", "SSH", "BSF"),
                  movie=("SST", "VVEL", "KE"), snap_freq=5)
    return mini_cfg(dtype), (MINI_STEPS, outdir, evaluable("mini")), kw


def package_cfg(pkg, dtype):
    return get_config("mini", b4b=True, dtype=dtype, passive_tracers=(pkg,),
                      nt=2 + PACKAGES[pkg])


def package_forcing(cfg):
    z = torch.zeros((cfg.ny, cfg.nx), dtype=torch.float64)
    return {"u10_sqr": z + U10_SQR, "ifrac": z}


def ovf_cfg(kind, dtype="float64"):
    spec = _spec() if kind == "box" else _pt_spec()
    return torch_cfg(jget_config("mini").with_(overflows=(spec,))).with_(
        b4b=True, dtype=dtype)


@functools.lru_cache(maxsize=None)
def dense_tracers(kind, dtype):
    """The initial tracers of the overflow configuration, 4 K colder in
    the source region (the overflow runs), in ``dtype``."""
    cfg = ovf_cfg(kind)
    m = Model(cfg, device="cpu")
    src = tovf.region_mask3(cfg, m.ovf_statics, 0, tovf.REG_SRC) > 0
    tr = m.initial_state().tracer_cur.numpy().copy()
    tr[0][src] -= 4.0
    return tr.astype(np.dtype(dtype))


@functools.lru_cache(maxsize=None)
def cap_imports():
    """Three coupling intervals' seeded SI import fields on 'mini', at the
    magnitudes of the JAX package's own cap test."""
    cfg = get_config("mini")
    rng = np.random.RandomState(3)
    shape = (cfg.ny, cfg.nx)

    def f(lo, hi=None):
        return rng.uniform(-lo, lo, shape) if hi is None \
            else rng.uniform(lo, hi, shape)
    return [{"taux": f(0.1), "tauy": f(0.1), "swnet": f(0.0, 200.0),
             "sen": f(20.0), "lwup": f(50.0), "lwdn": f(50.0),
             "melth": f(5.0), "snow": f(1e-5), "rain": f(1e-5),
             "evap": f(1e-5), "melt": f(1e-6), "rofl": f(1e-6),
             "rofi": f(1e-7), "salt": f(1e-7), "ifrac": f(0.0, 0.3),
             "pslv": np.full(shape, 101325.0), "duu10n": f(0.0, 50.0)}
            for _ in range(3)]


#: the mesh the cap resumes on, after each mesh of MESHES
RESUME = {"2x2": (1, 4), "1x4": (2, 2), "2x1": (1, 2)}


def start_calls(tags, tmp):
    """What one start of the ranks computes, on the meshes of ``tags``."""
    calls = []
    for tag in tags:
        shape = MESHES[tag]
        for case in ("mini", "snap", "prod"):
            for dtype in DTYPES:
                cfg, args, kw = stream_args(case, dtype,
                                            str(tmp / f"{case}_{tag}_{dtype}"))
                calls.append((f"{case}_{tag}_{dtype}", ranks.stream_run,
                              (cfg.with_(mesh_shape=shape),) + args, kw))
        for dtype in DTYPES:
            for kind in ("box", "point"):
                calls.append((f"ovf_{kind}_{tag}_{dtype}", ranks.overflow_run,
                              (ovf_cfg(kind, dtype).with_(mesh_shape=shape),
                               OVF_STEPS, dense_tracers(kind, dtype)), {}))
            calls.append((f"cap_{tag}_{dtype}", ranks.cap_run,
                          (cap_cfg(dtype).with_(mesh_shape=shape),
                           cap_imports(), str(tmp / f"cap_{tag}_{dtype}")),
                          {"resume_shape": RESUME[tag]}))
            for pkg in PACKAGES:
                cfg = package_cfg(pkg, dtype)
                calls.append((f"pkg_{pkg}_{tag}_{dtype}", ranks.run_model,
                              (cfg.with_(mesh_shape=shape), PKG_STEPS),
                              {"forcing_fields": package_forcing(cfg)}))
    return calls


def cap_cfg(dtype):
    return get_config("mini", b4b=True, dtype=dtype)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The two starts of the ranks, four and two, at once: {mesh tag: a
    dict a rank of that start}."""
    from concurrent.futures import ThreadPoolExecutor
    tmp = tmp_path_factory.mktemp("ranks_services")
    starts = {4: start_calls(("2x2", "1x4"), tmp),
              2: start_calls(("2x1",), tmp)}
    with ThreadPoolExecutor(2) as pool:
        futures = {n: pool.submit(
            multihost.spawn_ranks, ranks.suite, n, device="cpu",
            args=([c[1:] for c in calls],), timeout=900)
            for n, calls in starts.items()}
        return {n: ranks.suite_results(futures[n].result(), starts[n])
                for n in starts}


def results(spawned, tag):
    return spawned[2 if tag == "2x1" else 4]


@functools.lru_cache(maxsize=None)
def _whole_stream(case, dtype, outdir):
    cfg, args, kw = stream_args(case, dtype, outdir)
    return ranks.stream_run(cfg, *args, **kw)


@pytest.fixture(scope="module")
def whole_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("whole_services")


def whole_stream(case, dtype, whole_dir):
    return _whole_stream(case, dtype, str(whole_dir / f"{case}_{dtype}"))


STREAM_CASES = [pytest.param(case, tag, dtype, id=f"{case}-{tag}-{dtype}")
                for case in ("mini", "snap", "prod") for tag in MESHES
                for dtype in DTYPES]


# ---- run_compiled and the streams -------------------------------------------

@pytest.mark.parametrize("case,tag,dtype", STREAM_CASES)
def test_decomposed_run_is_the_whole_domains(spawned, whole_dir, case, tag,
                                             dtype):
    """The state after ``run_compiled`` ('mini', prod) or ``advance``
    ('snap') on blocks is the whole domain's bitwise, the diagnostics the
    same on every rank; a rank's captured step runs its segments
    uncaptured, saying why."""
    want = whole_stream(case, dtype, whole_dir)
    got = [r[f"{case}_{tag}_{dtype}"] for r in results(spawned, tag)]
    for name in ranks.STATE_FIELDS:
        np.testing.assert_array_equal(got[0]["fields"][name],
                                      want["fields"][name], err_msg=name)
    assert all(g["diags"] == want["diags"] for g in got)
    assert got[0]["counts"]["exchanges"] > 0
    if case == "snap":  # snapshot streams: every step through advance
        assert got[0]["graphs"] is None and want["graphs"] is None
    else:
        assert want["graphs"] == 0 and want["uncaptured"] == "CPU tensors"
        for g in got:
            assert g["graphs"] == 0
            assert "gloo decomposition" in g["uncaptured"]


@pytest.mark.parametrize("case,tag,dtype", STREAM_CASES)
def test_stream_files_on_blocks_are_the_whole_domains(spawned, whole_dir,
                                                      case, tag, dtype):
    """Rank 0 writes each file the whole domain writes, the same bytes
    (tavg; history and movie beside it in 'snap'), and holds the same
    partial accumulation; the other ranks get none."""
    want = whole_stream(case, dtype, whole_dir)
    res = results(spawned, tag)
    got = res[0][f"{case}_{tag}_{dtype}"]
    assert got["names"] == want["names"]
    assert len(want["files"]) == (6 if case == "snap" else
                                  2 if case == "mini" else 1)
    assert set(got["files"]) == set(want["files"])
    for name, data in want["files"].items():
        assert got["files"][name] == data, name
    assert got["nsamples"] == want["nsamples"] > 0
    assert set(got["partial"]) == set(want["partial"])
    for name, a in want["partial"].items():
        np.testing.assert_array_equal(got["partial"][name], a,
                                      err_msg=name)
    assert all(r[f"{case}_{tag}_{dtype}"]["partial"] is None
               for r in res[1:])


@pytest.mark.parametrize("case,tag,dtype", STREAM_CASES)
def test_global_index_diagnostics_on_blocks(spawned, whole_dir, case, tag,
                                            dtype):
    """``section_transport`` (b4b sums of each block's part of a section)
    and ``barotropic_streamfunction`` (every column's whole strip summed
    from the south) are the whole domain's bitwise, on every rank."""
    want = whole_stream(case, dtype, whole_dir)["global_index"]
    assert any(abs(m) > 0.0 for m, _, _ in want["sections"])
    for r in results(spawned, tag):
        got = r[f"{case}_{tag}_{dtype}"]["global_index"]
        assert got["sections"] == want["sections"]
        np.testing.assert_array_equal(got["bsf"], want["bsf"])


# ---- passive packages, the cap, the overflows -------------------------------

@functools.lru_cache(maxsize=None)
def whole_package(pkg, dtype):
    cfg = package_cfg(pkg, dtype)
    return cfg, whole_run(cfg, PKG_STEPS,
                          forcing_fields=package_forcing(cfg))


@pytest.mark.parametrize("pkg,tag,dtype", [
    pytest.param(p, t, d, id=f"{p}-{t}-{d}") for p in PACKAGES
    for t in MESHES for d in DTYPES])
def test_passive_package_on_blocks(spawned, pkg, tag, dtype):
    """Each package on blocks, 3 steps: iterations and every tracer
    bitwise the whole domain's."""
    cfg, (iters, want, _) = whole_package(pkg, dtype)
    got = [r[f"pkg_{pkg}_{tag}_{dtype}"] for r in results(spawned, tag)]
    assert all(g["iters"] == iters for g in got)
    assert want["tracer_cur"].shape[0] == cfg.nt
    for name in ranks.STATE_FIELDS:
        np.testing.assert_array_equal(got[0]["fields"][name], want[name],
                                      err_msg=name)


@functools.lru_cache(maxsize=None)
def whole_cap(tmp, dtype):
    return ranks.cap_run(cap_cfg(dtype), cap_imports(), tmp)


@pytest.mark.parametrize("tag,dtype", [
    pytest.param(t, d, id=f"{t}-{d}") for t in MESHES for d in DTYPES])
def test_coupler_cap_on_blocks(spawned, tmp_path_factory, tag, dtype):
    """The cap on blocks: every interval's gathered export, the restart
    written on request (sharded, each rank its block), the cap started from
    it on another mesh and its third interval, bitwise the whole domain's
    (whose restart is one file); the time flags alike on every rank."""
    want = whole_cap(str(tmp_path_factory.mktemp(f"whole_cap_{dtype}")),
                     dtype)
    got = [r[f"cap_{tag}_{dtype}"] for r in results(spawned, tag)]
    assert want["resumed_at"] == 4
    for g in got:
        assert g["resumed_at"] == want["resumed_at"]
        assert g["flags"] == want["flags"]
        assert g["restart_files"] == ["4"]  # the sharded step directory
        assert len(g["exports"]) == len(want["exports"]) == 4
        for i, (a, b) in enumerate(zip(g["exports"], want["exports"])):
            assert set(a) == set(b)
            for k in b:
                np.testing.assert_array_equal(a[k], b[k],
                                              err_msg=f"{i}: {k}")
    for name in ranks.STATE_FIELDS:
        np.testing.assert_array_equal(got[0]["fields"][name],
                                      want["fields"][name], err_msg=name)


@functools.lru_cache(maxsize=None)
def whole_overflow(kind, dtype):
    return whole_run(ovf_cfg(kind, dtype), OVF_STEPS,
                     tracers=dense_tracers(kind, dtype))


@pytest.mark.parametrize("kind,tag,dtype", [
    pytest.param(k, t, d, id=f"{k}-{t}-{d}") for k in ("box", "point")
    for t in MESHES for d in DTYPES])
def test_overflows_on_blocks(spawned, kind, tag, dtype):
    """The 'mini' overflows from dense source water, 5 steps on blocks:
    iterations and fields bitwise the whole domain's, the region means
    formed from crops fetched from their owners, each block applying its
    own points."""
    iters, want, _ = whole_overflow(kind, dtype)
    got = [r[f"ovf_{kind}_{tag}_{dtype}"] for r in results(spawned, tag)]
    assert all(g["iters"] == iters for g in got)
    for name in ranks.STATE_FIELDS:
        np.testing.assert_array_equal(got[0]["fields"][name], want[name],
                                      err_msg=name)


def test_an_overflow_region_straddles_a_block_edge(spawned):
    """The box-only spec's source region meets two blocks of (1, 4) and
    the point spec's entrainment and product regions two of (2, 2)."""
    def straddling(key, tag):
        meets = np.array([r[key]["meets"] for r in results(spawned, tag)])
        return (meets.sum(axis=0) > 1).tolist()
    assert straddling("ovf_box_1x4_float64", "1x4")[tovf.REG_SRC]
    point = straddling("ovf_point_2x2_float64", "2x2")
    assert point[tovf.REG_ENT] and point[tovf.REG_PRD]


# ---- against the JAX package ------------------------------------------------

@pytest.fixture(scope="module")
def jax_mesh_tavg(tmp_path_factory):
    """The JAX package's 'mini' (time_mix_freq 4, b4b) on a (2, 2) mesh of
    the virtual CPU devices, ``run_compiled`` over MINI_STEPS with the
    same tavg stream: its averages of the last, partial interval."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    jcfg = jget_config("mini", b4b=True, mesh_shape=(2, 2))
    jcfg = jcfg.with_(time=dataclasses.replace(jcfg.time, time_mix_freq=4))
    m, mesh = jmesh.sharded_model(jcfg)
    st = jmesh.shard_pytree(m.initial_state(), mesh)
    stream = m.enable_tavg(list(evaluable("mini")), freq_steps=4,
                           outdir=str(tmp_path_factory.mktemp("jax_tavg")))
    m.run_compiled(st, MINI_STEPS)
    norm = 1.0 / stream.nsamples
    from pop2_tpu import tavg as jtavg
    return stream.nsamples, {
        n: np.asarray(a) * (norm if jtavg.FIELDS[n].method == "avg"
                            else 1.0) for n, a in stream.sums.items()}


def test_decomposed_tavg_against_the_jax_package(spawned, jax_mesh_tavg):
    """The port's tavg averages on (2, 2) blocks, gathered on rank 0,
    against the JAX package's on a (2, 2) mesh: within PARITY.md's band of
    each field's scale after ten steps."""
    nsamples, want = jax_mesh_tavg
    got = spawned[4][0]["mini_2x2_float64"]
    assert got["nsamples"] == nsamples == 2
    worst = {}
    for name, w in want.items():
        g = got["partial"][name]
        if np.abs(w).max() == 0.0:
            np.testing.assert_array_equal(g, w, err_msg=name)
            continue
        worst[name] = scale_err(g, w)
    assert len(want) == len(evaluable("mini")) == 83
    assert len(worst) > 40  # the others are zero in both, bitwise
    assert max(worst.values()) <= PARITY_BAND, {
        k: v for k, v in worst.items() if v > PARITY_BAND}


# ---- what stays refused -----------------------------------------------------

def test_nccl_stays_refused(monkeypatch):
    """A decomposition over NCCL (a card a rank) and a captured step under
    it are ROADMAP item 12b (across cards): ``make_mesh`` refuses a process
    group over NCCL, and ``run_compiled`` a model whose ranks talk over
    it."""
    import torch.distributed as dist
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    with pytest.raises(NotImplementedError, match=r"12b \(across cards\)"):
        pmesh.make_mesh((2, 1), 24, 32)
    monkeypatch.undo()
    cfg = get_config("mini")
    m = Model(cfg, device="cpu")
    m.mesh = pmesh.Decomposition(py=1, px=1, rank=0, ny=cfg.ny, nx=cfg.nx,
                                 comm=pmesh.Comm("nccl"))
    with pytest.raises(NotImplementedError, match=r"12b \(across cards\)"):
        m.run_compiled(m.initial_state(), 1)
