"""The one-process mesh (``model.MeshModel``): ``Model`` with ``mesh_shape``
and no process group runs every block in this process, a thread a block
(``parallel.mesh.LocalMesh``, ``multihost.BlockDriver``), the exchanges and
global sums meeting in one hub (``parallel.mesh.LocalComm``), as the JAX
package runs its mesh over the devices of one process.

* prod_full at 32 x 16 x 10 with b4b on (2, 2), (1, 4) and (2, 1) blocks,
  float64 and float32: three steps of ``run_compiled`` (the Euler and the
  first leapfrog step through ``advance``, the third through
  ``graphs.MeshCapturedStep``'s segments) with a tavg stream of every field
  it evaluates written at the third, and two steps of ``advance``: the
  state, the iterations, each block's launch counts and the file the
  whole domain's, bitwise; 'mini' with tavg, history and movie streams,
  every file the whole domain's;
* the JAX package's ``Model`` on a (2, 2) mesh of the virtual CPU devices
  against the port's one-process (2, 2) mesh on 'mini': PARITY.md's bands
  after one and five steps;
* a block that raises, or skips a collective, reaches the caller within the
  hub's timeout; launches count into each block's own counters;
* blocks on several cards and NCCL stay refused (ROADMAP item 12b, across
  cards).
"""

import os
import threading
import time

import numpy as np
import jax
import pytest
import torch

jax.config.update("jax_enable_x64", True)

from pop2_tpu.config import get_config as jget_config  # noqa: E402
from pop2_tpu.parallel import mesh as jmesh  # noqa: E402

from pop2_tpu_torch import baroclinic, launch_counts  # noqa: E402
from pop2_tpu_torch.config import get_config  # noqa: E402
from pop2_tpu_torch.model import MeshModel, Model  # noqa: E402
from pop2_tpu_torch.parallel import mesh as pmesh  # noqa: E402

from tests import torch_parallel_ranks as ranks  # noqa: E402
from tests.test_torch_ranks_services import (  # noqa: E402
    evaluable, prod_inputs)
from tests.torch_port_helpers import scale_err  # noqa: E402

MESHES = {"2x2": (2, 2), "1x4": (1, 4), "2x1": (2, 1)}
DTYPES = ("float64", "float32")
STEPS = 3          # run_compiled: Euler, eager leapfrog, a segment step
ADVANCE_STEPS = 2
#: PARITY.md's bands against the JAX package after one and five steps
PARITY = {1: 1e-11, 5: 1e-7}
COUNTERS = ("launches", "launches_pbc", "launches_with_diags",
            "launches_fold", "launches_aniso")


def prod_model(dtype, shape):
    """(model, state, forcing) of prod_full at 32 x 16 x 10 with b4b on a
    ``shape`` mesh (the whole domain for (1, 1)) from stratified tracers,
    under a 10-m wind."""
    cfg, tracers, ff = prod_inputs(dtype)
    model = Model(cfg.with_(mesh_shape=shape), device="cpu")
    t = torch.as_tensor(tracers).to(cfg.torch_dtype)
    rho = baroclinic._masked_density(model.cfg, model.grid, model.ts_range,
                                     t)
    state = model.initial_state().replace(tracer_cur=t, tracer_old=t,
                                          rho_cur=rho, rho_old=rho)
    forcing = model.forcing.replace(**{
        k: torch.as_tensor(v).to(cfg.torch_dtype) for k, v in ff.items()})
    return model, state, forcing


def module_counts():
    return {(m, n): getattr(mod, n) for m, mod in _wrappers().items()
            for n in COUNTERS if hasattr(mod, n)}


def _wrappers():
    from pop2_tpu_torch import (clinic_cuda, gm_chain_cuda, gm_cuda,
                                gm_slope_cuda, gm_tlt_cuda, tracer_cuda,
                                tridiag_cuda)
    return {m.__name__: m for m in (clinic_cuda, gm_chain_cuda, gm_cuda,
                                    gm_slope_cuda, gm_tlt_cuda, tracer_cuda,
                                    tridiag_cuda)}


def compiled_run(dtype, shape, outdir):
    """STEPS of ``run_compiled`` with a tavg stream of every field prod_full
    evaluates, written at the last: the state, the last step's iterations,
    the file's bytes, each block's launches (the module counters on the
    whole domain), the captured step's graphs and why uncaptured."""
    model, state, forcing = prod_model(dtype, shape)
    os.makedirs(outdir, exist_ok=True)
    model.enable_tavg(list(evaluable("prod")), freq_steps=STEPS,
                      outdir=outdir)
    before = module_counts()
    state, diags = model.run_compiled(state, STEPS, forcing)
    if isinstance(model, MeshModel):
        counts = [{(m, n): c.values[(m, n)] for (m, n) in before}
                  for c in model.block_counts()]
    else:
        counts = [{k: v - before[k] for k, v in module_counts().items()}]
    (path,) = model.tavg_files
    with open(path, "rb") as f:
        data = f.read()
    return dict(state=state, iters=int(diags.solver_iters), file=data,
                counts=counts, graphs=model._captured.graphs,
                uncaptured=model._captured.uncaptured)


_WHOLE = {}


def whole_compiled(dtype, tmp_path_factory):
    if dtype not in _WHOLE:
        _WHOLE[dtype] = compiled_run(
            dtype, (1, 1), str(tmp_path_factory.mktemp(f"whole_{dtype}")))
    return _WHOLE[dtype]


@pytest.mark.parametrize("tag", MESHES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_run_compiled_on_one_process_blocks_is_the_whole_domains(
        tmp_path_factory, tmp_path, dtype, tag):
    """``Model(cfg)`` with ``mesh_shape`` and no process group is a
    ``MeshModel``; its ``run_compiled`` (the captured step's segments run on
    every block at once, uncaptured on the CPU) gives the whole domain's
    state, iterations, tavg file and launches, bitwise; nothing is staged
    through the host."""
    want = whole_compiled(dtype, tmp_path_factory)
    got = compiled_run(dtype, MESHES[tag], str(tmp_path))
    for name in ranks.STATE_FIELDS:
        assert torch.equal(getattr(got["state"], name),
                           getattr(want["state"], name)), name
    assert got["iters"] == want["iters"] > 0
    assert got["file"] == want["file"]
    assert len(got["counts"]) == MESHES[tag][0] * MESHES[tag][1]
    assert all(c == want["counts"][0] for c in got["counts"])
    assert got["graphs"] == 0 and got["uncaptured"] == "CPU tensors"


@pytest.mark.parametrize("dtype", DTYPES)
def test_advance_on_one_process_blocks_is_the_whole_domains(dtype):
    """``MeshModel.advance`` takes and returns the whole domain's state:
    each step's fields and iterations the whole domain's bitwise; the
    exchanges are device (here host memory) copies, none staged."""
    whole = prod_model(dtype, (1, 1))
    mesh = prod_model(dtype, (2, 2))
    ws, ms = whole[1], mesh[1]
    for _ in range(ADVANCE_STEPS):
        ws, wd = whole[0].advance(ws, whole[2])
        ms, md = mesh[0].advance(ms, mesh[2])
        assert int(md.solver_iters) == int(wd.solver_iters)
        for name in ranks.STATE_FIELDS:
            assert torch.equal(getattr(ms, name), getattr(ws, name)), name
        assert torch.equal(md.hblt, wd.hblt)
    counts = mesh[0].mesh.comm_counts()
    assert all(c["exchanges"] > 0 and c["allreduces"] > 0
               and c["staged_bytes"] == 0 for c in counts)
    assert mesh[0].diagnostics(ms) == whole[0].diagnostics(ws)


def snapshot_files(shape, outdir):
    """'mini' with b4b on a ``shape`` mesh, four steps through
    ``run_compiled`` (every step through ``advance``: snapshot streams)
    with tavg, history and movie streams every two steps: {file: bytes}
    and the state."""
    model = Model(get_config("mini", b4b=True, mesh_shape=shape),
                  device="cpu")
    os.makedirs(outdir)
    model.enable_tavg(["TEMP", "SSH", "BSF", "KE"], freq_steps=2,
                      outdir=outdir)
    model.enable_history(["TEMP", "UVEL", "SSH", "BSF"], freq_steps=2,
                         outdir=outdir)
    model.enable_movie(["SST", "VVEL", "KE"], freq_steps=2, outdir=outdir,
                       level=1)
    state, _ = model.run_compiled(model.initial_state(), 4)
    files = {}
    for path in model.tavg_files:
        with open(path, "rb") as f:
            files[os.path.basename(path)] = f.read()
    return files, state


def test_snapshot_streams_on_one_process_blocks_are_the_whole_domains(
        tmp_path):
    """History, movie and tavg streams on a one-process (2, 2) mesh write
    one file each, the whole domain's bytes; the state the whole
    domain's."""
    whole, ws = snapshot_files((1, 1), str(tmp_path / "whole"))
    got, ms = snapshot_files((2, 2), str(tmp_path / "mesh"))
    assert len(whole) == 6 and got == whole
    for name in ranks.STATE_FIELDS:
        assert torch.equal(getattr(ms, name), getattr(ws, name)), name


# ---- against the JAX package ------------------------------------------------

@pytest.fixture(scope="module")
def jax_mesh_states():
    """The JAX package's 'mini' (b4b) on a (2, 2) mesh of the virtual CPU
    devices (``pop2_tpu.model.Model`` builds the mesh in one process), its
    state after one and after five steps of ``advance``."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    jm, mesh = jmesh.sharded_model(jget_config("mini", b4b=True,
                                               mesh_shape=(2, 2)))
    st = jmesh.shard_pytree(jm.initial_state(), mesh)
    out = {}
    for n in range(1, max(PARITY) + 1):
        st, _ = jm.advance(st)
        if n in PARITY:
            out[n] = {k: np.asarray(getattr(st, k))
                      for k in ranks.STATE_FIELDS}
    return out


def test_one_process_mesh_against_the_jax_packages_mesh(jax_mesh_states):
    """The port's one-process (2, 2) mesh on 'mini' in float64 against the
    JAX package's (2, 2) mesh: within PARITY.md's bands after one step
    (1e-11) and five (1e-7)."""
    model = Model(get_config("mini", b4b=True, mesh_shape=(2, 2)),
                  device="cpu")
    assert isinstance(model, MeshModel)
    state = model.initial_state()
    for n in range(1, max(PARITY) + 1):
        state, _ = model.advance(state)
        if n in PARITY:
            for name, want in jax_mesh_states[n].items():
                err = scale_err(getattr(state, name).numpy(), want)
                assert err <= PARITY[n], (n, name, err)


# ---- the driver: failures, launch counts ------------------------------------

def _mesh(monkeypatch, timeout=5.0):
    """A (2, 2) mesh of 24 x 32 whose hub waits ``timeout`` seconds."""
    monkeypatch.setattr(pmesh, "LOCAL_TIMEOUT", timeout)
    return pmesh.make_mesh((2, 2), 24, 32)


def test_a_block_that_raises_reaches_the_caller(monkeypatch):
    """A block that raises aborts the hub: the blocks waiting for it in a
    collective raise at once, and the caller gets the error with the
    block's rank, well within the hub's timeout; the mesh then refuses
    further calls (its exchanges are out of step)."""
    mesh = _mesh(monkeypatch, timeout=30.0)
    assert isinstance(mesh, pmesh.LocalMesh)

    def fn(rank):
        if rank == 2:
            raise ValueError("bad block")
        return float(mesh.blocks[rank].comm.all_reduce(torch.ones(()),
                                                       "sum"))
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="block 2 .* ValueError: bad"):
        mesh.run(fn)
    assert time.monotonic() - t0 < 10.0
    with pytest.raises(RuntimeError, match="failed in an earlier call"):
        mesh.run(lambda rank: rank)


def test_a_block_that_skips_a_collective_times_out(monkeypatch):
    """A block that skips a collective leaves its peers waiting: they raise
    after the hub's timeout (no hang), and so does the call."""
    mesh = _mesh(monkeypatch, timeout=1.0)

    def fn(rank):
        if rank != 3:
            mesh.blocks[rank].comm.barrier()
        return rank
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="TimeoutError"):
        mesh.run(fn)
    assert time.monotonic() - t0 < 8.0


def test_collectives_meet_in_rank_order_and_only_on_the_blocks(monkeypatch):
    """The hub's collectives give every block the same result (sums in
    rank order, maxima, gathers, broadcasts); point-to-point buffers reach
    their block; a collective from outside the mesh's threads raises at
    once."""
    mesh = _mesh(monkeypatch)

    def fn(rank):
        c = mesh.blocks[rank].comm
        got = torch.zeros(8)
        c.exchange({(rank + 1) % 4: [torch.full((8,), float(rank))]},
                   {(rank - 1) % 4: [got]})
        return (float(c.all_reduce(torch.tensor(2.0 ** rank), "sum")),
                float(c.all_reduce(torch.tensor(float(rank)), "max")),
                c.broadcast_floats([rank + 0.5], src=1),
                c.gather(torch.tensor([rank]), root=0),
                int(got[0]))
    out = mesh.run(fn)
    assert [o[0] for o in out] == [15.0] * 4
    assert [o[1] for o in out] == [3.0] * 4
    assert [o[2] for o in out] == [[1.5]] * 4
    assert [int(t) for t in out[0][3]] == [0, 1, 2, 3]
    assert all(o[3] is None for o in out[1:])
    assert [o[4] for o in out] == [3, 0, 1, 2]
    assert [c["exchanges"] for c in mesh.comm_counts()] == [1] * 4
    with pytest.raises(RuntimeError, match="outside the mesh's threads"):
        mesh.blocks[0].comm.barrier()


def test_the_hub_under_twelve_threads_and_short_switches(monkeypatch):
    """Twelve blocks (more threads than this machine's cores) with the
    interpreter switching threads every microsecond: every exchange and
    sum of many rounds arrives whole (a lost or crossed update would break
    the sums and the pieces), well inside the hub's timeout."""
    import sys
    monkeypatch.setattr(pmesh, "LOCAL_TIMEOUT", 60.0)
    mesh = pmesh.make_mesh((3, 4), 24, 32)
    rounds = 40

    def fn(rank):
        c, d = mesh.blocks[rank].comm, mesh.blocks[rank]
        field = torch.full((2, d.rows, d.cols), float(rank))
        bad = 0
        for k in range(rounds):
            total = float(c.all_reduce(torch.tensor(float(rank + k)),
                                       "sum"))
            bad += total != sum(r + k for r in range(12))
            (halo,) = d.halo([field + k])
            ext = halo.ext
            south = d.south
            if south is not None:
                bad += int((ext[:, 0, 1:-1] != south + k).any())
        return bad
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t0 = time.monotonic()
        assert mesh.run(fn) == [0] * 12
        assert time.monotonic() - t0 < 60.0
    finally:
        sys.setswitchinterval(old)


def test_launches_count_into_each_blocks_counters(monkeypatch):
    """A wrapper's launch counted in a block's thread goes to that block's
    counters, not the module's (threads never race on a module global);
    outside the blocks the module's counter counts."""
    from pop2_tpu_torch import gm_tlt_cuda, tridiag_cuda
    mesh = _mesh(monkeypatch)
    n0, nr0 = gm_tlt_cuda.launches, tridiag_cuda.launches_by_nr[2]

    def fn(rank):
        for _ in range(rank + 1):
            launch_counts.add(gm_tlt_cuda.__name__)
        launch_counts.add_by_nr(2)
        return threading.current_thread().name
    names = mesh.run(fn)
    assert len(set(names)) == 4
    assert [c.get(gm_tlt_cuda) for c in mesh.driver.counts] == [1, 2, 3, 4]
    assert [c.by_nr[2] for c in mesh.driver.counts] == [1] * 4
    assert gm_tlt_cuda.launches == n0
    assert tridiag_cuda.launches_by_nr[2] == nr0
    launch_counts.add(gm_tlt_cuda.__name__)
    assert gm_tlt_cuda.launches == n0 + 1
    gm_tlt_cuda.launches = n0


def test_spawned_ranks_that_do_not_join_fail_within_the_join_timeout(
        monkeypatch):
    """``spawn_ranks`` (the gloo ranks' driver) stops ranks that have not
    all joined their process group within ``JOIN_TIMEOUT`` (a stuck
    rendezvous), long before its whole-run timeout."""
    from pop2_tpu_torch.parallel import multihost
    monkeypatch.setattr(multihost, "JOIN_TIMEOUT", 0.05)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="did not all join"):
        multihost.spawn_ranks(ranks.suite, 2, device="cpu", args=([],),
                              timeout=600.0)
    assert time.monotonic() - t0 < 60.0


# ---- what stays refused -----------------------------------------------------

def test_several_cards_and_nccl_stay_refused(monkeypatch):
    """Blocks on several cards (peer copies in one process) and a process
    group over NCCL are ROADMAP item 12b (across cards): refused before
    anything touches a card."""
    cfg = get_config("mini", mesh_shape=(2, 2))
    cards = ["cuda:0", "cuda:1", "cuda:0", "cuda:1"]
    with pytest.raises(NotImplementedError, match=r"12b \(across cards\)"):
        pmesh.make_mesh((2, 2), cfg.ny, cfg.nx, devices=cards)
    with pytest.raises(NotImplementedError, match=r"12b \(across cards\)"):
        Model(cfg, device=cards)
    with pytest.raises(ValueError, match="devices for a mesh of 4"):
        pmesh.make_mesh((2, 2), cfg.ny, cfg.nx, devices=["cpu"])
    assert isinstance(pmesh.make_mesh((2, 2), cfg.ny, cfg.nx,
                                      devices=["cpu"] * 4), pmesh.LocalMesh)
    import torch.distributed as dist
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 4)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    with pytest.raises(NotImplementedError, match=r"12b \(across cards\)"):
        pmesh.make_mesh((2, 2), cfg.ny, cfg.nx)
