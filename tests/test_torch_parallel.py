"""The port decomposed over ranks (``pop2_tpu_torch/parallel``): y slabs
and 2-D blocks over ``torch.distributed`` with gloo on the CPU, held
against the JAX package and against the port on the whole domain.

The ranks run in processes of their own (``multihost.spawn_ranks``, one
intra-op thread each) what ``tests/torch_parallel_ranks.py`` holds; two
module fixtures start them, once on four ranks ((4, 1), (2, 2) and (1, 4)
meshes) and once on two ((2, 1) and (1, 2)):

* the b4b sum has the bits of ``pop2_tpu.reductions.global_sum(b4b=True)``
  on ``tests/test_b4b.py``'s data, on 1, 2 and 4 slabs and (2, 2) blocks;
* every shift (the eight neighbours on closed and cyclic edges, the
  tripole's of every location and kind, ``n_partner``, the top row's
  symmetry) on every mesh, and each of the five kernel wrappers' plain
  twins on 2 slabs and (2, 2) blocks, equal their whole-domain calls
  bitwise (float64; closed and tripole edges, centered and upwind3
  advection, the chain with the submesoscale fold-in, both branches of the
  flux assembly);
* 'mini' (the JAX package's 32 x 24 x 8 preset) with b4b on 4 slabs, (2, 2)
  and (1, 4) blocks, 5 steps: the solver's iterations are those of the JAX
  package on a (4, 1) mesh and of the port on the whole domain, the fields
  those of the port's whole-domain run (within 1e-12 of scale on slabs,
  bitwise on blocks) and within PARITY's 1e-7 of the JAX package's; without
  b4b atol 1e-11 on the tracers and u, 1e-9 on psurf
  (``tests/test_sharding.py``'s bands);
* prod_full at 32 x 16 x 10 on 2 slabs, (2, 2) and (1, 2) blocks (tripole,
  KPP, GM's chain with the transition layer and the submesoscale scheme,
  upwind3, anisotropic viscosity, PCSI with FSPAI) against the port on the
  whole domain;
* a forced 'mini' on 2 slabs as a standalone caller composes it (the
  bulk-NCEP freshwater flux with the precipitation balance, marginal-seas
  balancing, the river runoff's salt flux, the estuary exchange) against
  the same run on the whole domain, with its diagnostics and budgets;
* gathers and scatters, the sharded restart (a bitwise round trip, read
  under another mesh, a dims mismatch), the refusals and the rank entry
  points' defaults.
"""

import functools
import json
import os
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

jax.config.update("jax_enable_x64", True)

from pop2_tpu import reductions as jreductions  # noqa: E402
from pop2_tpu.config import get_config as jget_config  # noqa: E402
from pop2_tpu.parallel import mesh as jmesh  # noqa: E402

from pop2_tpu_torch import (eos, gm, gm_slope_cuda, gm_tlt_cuda,  # noqa: E402
                            sample, submeso, supported)
from pop2_tpu_torch.config import get_config  # noqa: E402
from pop2_tpu_torch.grid import build_grid  # noqa: E402
from pop2_tpu_torch.io import sharded_restart  # noqa: E402
from pop2_tpu_torch.model import Model  # noqa: E402
from pop2_tpu_torch.ocn_component import OcnComponent  # noqa: E402
from pop2_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from pop2_tpu_torch.parallel import multihost  # noqa: E402
from pop2_tpu_torch.reductions import global_sum  # noqa: E402
from pop2_tpu_torch.stencil import BC  # noqa: E402

from tests import torch_parallel_ranks as ranks  # noqa: E402
from tests.torch_port_helpers import scale_err  # noqa: E402

NSTEPS = 5
PROD_STEPS = 3
PROD = dict(nx=32, ny=16, km=10, vert_grid="uniform")
U10_SQR = 4.9e5  # cm^2/s^2: a 7 m/s wind
FIELDS = ("tracer_cur", "u_cur", "v_cur", "psurf_cur")


def b4b_arrays():
    """``tests/test_b4b.py``'s data: values over 16 decades, the same
    values shuffled, and over 12 decades on 128 x 128."""
    rng = np.random.RandomState(0)
    x = rng.randn(64, 96) * np.logspace(-8, 8, 64 * 96).reshape(64, 96)
    xs = x.flatten()
    rng.shuffle(xs)
    rng2 = np.random.RandomState(2)
    y = rng2.randn(128, 128) * np.logspace(-6, 6, 128 * 128).reshape(
        128, 128)
    return [x, xs.reshape(96, 64), y]


def ts_range_of(cfg, grid):
    return (eos.build_ts_range(grid.vgrid.zt.double().numpy(),
                               cfg.torch_dtype, "cpu")
            if cfg.state_range_opt == "enforce" else None)


def _rand(rng, shape, scale=1.0, mask=None):
    a = scale * rng.randn(*shape)
    return torch.as_tensor(a if mask is None else a * np.asarray(mask))


@functools.lru_cache(maxsize=None)
def wrapper_cases():
    """(name, wrapper, cfg, whole grid, arguments, keyword arguments) of
    the five wrappers: on 'mini' at 32 x 16 x 8 (closed north edge,
    centered advection with the Laplacian fused) and on prod_full at 32 x
    16 x 10 on the fold bottom with its top rows' faces opened (tripole,
    upwind3, the anisotropic path's clinic, GM's kernels)."""
    rng = np.random.RandomState(5)
    cases = []
    for tag, cfg in (("closed", get_config("mini", ny=16)),
                     ("tripole", get_config("prod_full", **PROD))):
        grid = build_grid(cfg, "cpu")
        if tag == "tripole":
            grid = sample.open_top_dxu(sample.open_top_face(
                ranks.fold_model_grid(cfg, 5)))
        km, ny, nx = cfg.km, cfg.ny, cfg.nx
        mt, mu = grid.kmask_t, grid.kmask_u
        tr = sample.grid_tracers(cfg, grid, 11, noise=0.05)
        to = sample.grid_tracers(cfg, grid, 12, noise=0.05)
        u, v, uo, vo = (_rand(rng, (km, ny, nx), 10.0, mu) for _ in range(4))
        vdc = _rand(rng, (2, km, ny, nx), 10.0, mt).abs()
        stf = _rand(rng, (cfg.nt, ny, nx), 1e-3, mt[0])
        dh = _rand(rng, (ny, nx), 1e-4, mt[0])
        cases.append((f"tracer_{tag}", "tracer_cuda.tracer_tendency", cfg,
                      grid, (u, v, tr, to, to, vdc, stf, dh), {}))
        rho = [1.02 + _rand(rng, (km, ny, nx), 1e-3, mt) for _ in range(3)]
        vvc = _rand(rng, (km, ny, nx), 10.0, mu).abs()
        smf = _rand(rng, (2, ny, nx), 1.0, mu[0])
        dhu = _rand(rng, (ny, nx), 1e-4)
        cases.append((f"clinic_{tag}", "clinic_cuda.clinic_rhs_fields", cfg,
                      grid, (u, v, uo, vo, uo, vo, rho[2], vvc, smf, dhu,
                             0.6, 0.4), {}))
        if tag != "tripole":
            continue
        bc = BC(cfg.ew_boundary, cfg.ns_boundary)
        ts_range = ts_range_of(cfg, grid)
        cases.append(("slopes", "gm_slope_cuda.slopes", cfg, grid,
                      (bc, ts_range, tr), {}))
        slp, sla, n2 = gm_slope_cuda.slopes(cfg, grid, bc, ts_range, tr)
        zt = grid.vgrid.zt
        hblt = (zt[1] + (zt[4] - zt[1]) * (0.5 + 0.5 * torch.cos(
            2 * grid.TLAT))) * (grid.KMT > 0)
        tlt = gm_tlt_cuda.transition_layer(
            cfg, grid, gm.diabatic_depth(cfg, grid, bc, hblt), sla,
            gm._rossby_radius(grid))
        kv = gm.kappa_vertical_bfre(cfg, grid, ts_range, tr,
                                    tlt.interior_depth, n2=n2)
        sm = submeso.amplitudes(cfg, grid, bc, ts_range, tr, 0.8 * hblt)
        cases.append(("chain", "gm_chain_cuda.chain", cfg, grid,
                      (bc, tr, slp, sla, kv, tlt, True, sm), {}))
        ops = list(sample.flux_operands(cfg, grid, bc, ts_range, tr,
                                        levels=(1, 4)))
        cases.append(("flux", "gm_cuda.flux_assembly", cfg, grid,
                      (bc, *ops, False), {}))
        ops[5], ops[6] = torch.zeros_like(ops[5]), torch.zeros_like(ops[6])
        cases.append(("flux_cancellation", "gm_cuda.flux_assembly", cfg,
                      grid, (bc, *ops, True), {}))
    return cases


@functools.lru_cache(maxsize=None)
def prod_inputs():
    """prod_full at 32 x 16 x 10: its config, stratified tracers and the
    10-m wind and ice fields of the production path's forcing."""
    cfg = get_config("prod_full", b4b=True, **PROD)
    tracers = sample.grid_tracers(cfg, build_grid(cfg, "cpu"), 7,
                                  noise=0.02).numpy()
    z = torch.zeros((cfg.ny, cfg.nx), dtype=torch.float64)
    return cfg, tracers, {"u10_sqr": z + U10_SQR, "ifrac": z}


FORCED_STEPS = 3


def forced_cfg():
    return get_config("mini", b4b=True, lestuary_exch=True,
                      sfwf_formulation="bulk-NCEP", ladjust_precip=True)


def forced_inputs(cfg):
    """Whole-domain fields of ``ranks.forced_run``: a latent heat flux,
    precipitation, a restoring salinity and some sea ice, a marginal sea on
    the south slab whose water goes to points on both slabs, and river
    mouths on both slabs and at their common edge; a monthly wind-stress
    climatology."""
    rng = np.random.RandomState(9)
    ny, nx = cfg.ny, cfg.nx
    ms = np.zeros((ny, nx))
    ms[3:6, 4:9] = 1.0
    roff = np.zeros((ny, nx))
    roff[[4, 11, 12, 19], [20, 6, 6, 25]] = [2e-3, 1e-3, 3e-3, 5e-4]
    return dict(qlat=-100.0 - 20.0 * rng.rand(ny, nx),
                precip=3e-5 * rng.rand(ny, nx),
                sss=34.5e-3 + 1e-4 * rng.randn(ny, nx),
                ifrac=np.clip(rng.rand(ny, nx) - 0.8, 0.0, 1.0),
                ms_mask=ms, roff=roff,
                dist_points=[(7, 5), (12, 8), (13, 9)],
                taux=rng.randn(12, ny, nx), tauy=rng.randn(12, ny, nx))


def whole_run(cfg, nsteps, tracers=None, forcing_fields=None):
    """(iterations, fields, diagnostics) of the port on the whole domain,
    as ``ranks.run_model`` runs a slab."""
    from pop2_tpu_torch import baroclinic
    m = Model(cfg, device="cpu")
    st = m.initial_state()
    if tracers is not None:
        t = torch.as_tensor(tracers)
        rho = baroclinic._masked_density(cfg, m.grid, m.ts_range, t)
        st = st.replace(tracer_cur=t, tracer_old=t, rho_cur=rho,
                        rho_old=rho)
    forcing = m.forcing.replace(**(forcing_fields or {}))
    iters = []
    for _ in range(nsteps):
        st, d = m.advance(st, forcing)
        iters.append(int(d.solver_iters))
    return iters, {k: getattr(st, k).numpy() for k in ranks.STATE_FIELDS}, \
        m.diagnostics(st)


@pytest.fixture(scope="module")
def restart_dir(tmp_path_factory):
    """The sharded restart the four ranks write on (4, 1)."""
    return str(tmp_path_factory.mktemp("sharded"))


@pytest.fixture(scope="module")
def restart_dir_two(tmp_path_factory):
    """The sharded restart the two ranks write on (1, 2)."""
    return str(tmp_path_factory.mktemp("sharded_two"))


#: the meshes of four ranks the shifts are held on, and their calls' tags
FOUR_MESHES = {"4x1": (4, 1), "2x2": (2, 2), "1x4": (1, 4)}
#: (tag, east-west edge, north edge) of the shifts' cases; a tripole fold
#: across x blocks needs a cyclic edge
SHIFT_EDGES = [("closed", "cyclic", "closed"), ("tripole", "cyclic", "tripole"),
               ("closed_ew", "closed", "closed")]


def shift_calls(meshes):
    """The shifts' calls of each mesh of ``meshes`` ({tag: shape}), on the
    field of ``shift_field``; the (4, 1) mesh's under their old names."""
    calls = []
    for tag, shape in meshes.items():
        for ns_tag, ew, ns in SHIFT_EDGES:
            if shape[1] > 1 and ns == "tripole" and ew != "cyclic":
                continue
            name = (f"shifts_{ns_tag}" if tag == "4x1"
                    else f"shifts_{tag}_{ns_tag}")
            calls.append((name, ranks.shifts, (shift_field(), ew, ns,
                                               shape), {}))
    return calls


def shift_field():
    return np.random.RandomState(4).randn(2, 24, 16)


def four_calls(restart_dir):
    """What four ranks compute in one start: on four slabs, on (2, 2) and on
    (1, 4) blocks."""
    mini = get_config("mini", mesh_shape=(4, 1))
    cfg, tracers, ff = prod_inputs()
    whole = np.random.RandomState(3).randn(3, 24, 32)
    return [
        ("b4b", ranks.b4b_sums, (b4b_arrays(), (4, 1)), {}),
        ("b4b_2x2", ranks.b4b_sums, (b4b_arrays(), (2, 2)), {}),
        ("mini_b4b", ranks.run_model, (mini.with_(b4b=True), NSTEPS),
         {"restart_dir": restart_dir}),
        ("mini", ranks.run_model, (mini, NSTEPS), {}),
        ("mini_b4b_2x2", ranks.run_model,
         (mini.with_(b4b=True, mesh_shape=(2, 2)), NSTEPS), {}),
        ("mini_b4b_1x4", ranks.run_model,
         (mini.with_(b4b=True, mesh_shape=(1, 4)), NSTEPS), {}),
        ("mini_2x2", ranks.run_model, (mini.with_(mesh_shape=(2, 2)),
                                       NSTEPS), {}),
        ("prod_2x2", ranks.run_model,
         (cfg.with_(mesh_shape=(2, 2)), PROD_STEPS),
         {"tracers": tracers, "forcing_fields": ff}),
        ("wrappers_2x2", ranks.wrapper_slabs, (wrapper_cases(), (2, 2)), {}),
        ("gather", ranks.gather_scatter, (whole, (4, 1)), {}),
        ("gather_2x2", ranks.gather_scatter, (whole, (2, 2)), {}),
        ("restart_2x2", ranks.read_restart,
         (get_config("mini", mesh_shape=(2, 2)), restart_dir), {}),
        ("forced_2x2", ranks.forced_run,
         (forced_cfg().with_(mesh_shape=(2, 2)), FORCED_STEPS,
          forced_inputs(forced_cfg())), {}),
    ] + shift_calls(FOUR_MESHES)


def two_calls(restart_dir):
    """What two ranks compute in one start, on two slabs and on (1, 2)
    blocks (prod_full's state written on (1, 2) and read on (2, 1))."""
    cfg, tracers, ff = prod_inputs()
    return [
        ("b4b", ranks.b4b_sums, (b4b_arrays(), (2, 1)), {}),
        ("wrappers", ranks.wrapper_slabs, (wrapper_cases(), (2, 1)), {}),
        ("prod", ranks.run_model,
         (cfg.with_(mesh_shape=(2, 1)), PROD_STEPS),
         {"tracers": tracers, "forcing_fields": ff}),
        ("prod_1x2", ranks.run_model,
         (cfg.with_(mesh_shape=(1, 2)), PROD_STEPS),
         {"tracers": tracers, "forcing_fields": ff,
          "restart_dir": restart_dir}),
        ("restart", ranks.read_restart,
         (cfg.with_(mesh_shape=(2, 1)), restart_dir), {}),
        ("forced", ranks.forced_run,
         (forced_cfg().with_(mesh_shape=(2, 1)), FORCED_STEPS,
          forced_inputs(forced_cfg())), {}),
    ] + shift_calls({"1x2": (1, 2)})


@pytest.fixture(scope="module")
def spawned(restart_dir, restart_dir_two):
    """The two starts of the ranks, four and two, at once (each start is
    a process group of its own, their processes side by side)."""
    from concurrent.futures import ThreadPoolExecutor
    starts = {4: four_calls(restart_dir), 2: two_calls(restart_dir_two)}
    with ThreadPoolExecutor(2) as pool:
        futures = {n: pool.submit(
            multihost.spawn_ranks, ranks.suite, n, device="cpu",
            args=([c[1:] for c in calls],), timeout=600)
            for n, calls in starts.items()}
        return {n: ranks.suite_results(futures[n].result(), starts[n])
                for n in starts}


@pytest.fixture(scope="module")
def four(spawned):
    """What the four ranks computed, a dict a rank."""
    return spawned[4]


@pytest.fixture(scope="module")
def two(spawned):
    """What the two ranks computed, a dict a rank."""
    return spawned[2]


@pytest.fixture(scope="module")
def whole_mini():
    cfg = get_config("mini")
    return {"b4b": whole_run(cfg.with_(b4b=True), NSTEPS),
            "plain": whole_run(cfg, NSTEPS)}


# ---- the b4b sum ------------------------------------------------------------

def fixed_point_sum(x, scale=None):
    """The JAX package's b4b algorithm (``pop2_tpu/reductions.py:37-75``)
    in NumPy, by default at the exact power-of-two scale 2^(floor(log2
    max|x|) + 1)."""
    if scale is None:
        scale = 2.0 ** np.frexp(np.abs(x).max())[1]
    y = x / scale
    limbs = []
    for s in (2.0 ** 30, 2.0 ** 60, 2.0 ** 90):
        r = np.round(y * s)
        y = y - r / s
        limbs.append(np.float64(r.astype(np.int64).sum()) / s)
    return (limbs[0] + limbs[1] + limbs[2]) * scale


@pytest.mark.parametrize("i", range(3))
def test_b4b_sum_is_the_jax_packages_on_every_decomposition(four, two, i):
    """The same bits on 1, 2 and 4 slabs, those of the JAX package's
    algorithm. The JAX package forms its scale as ``jnp.exp2`` of an
    integer, which XLA on the CPU rounds off the power of two for most
    exponents (exp2(28) = 268435455.9999997, these three arrays' included);
    the port forms the exact power of two (``frexp``), the same on the CPU
    and the card. So the JAX package's sum is the algorithm's at XLA's
    scale, bitwise, and the port's the algorithm's at the exact scale,
    bitwise, on every decomposition; the two differ by the scale's
    rounding (a few ulps)."""
    x = b4b_arrays()[i]
    want = fixed_point_sum(x)
    assert float(global_sum(torch.as_tensor(x), b4b=True)) == want
    for res, key in ((four, "b4b"), (four, "b4b_2x2"), (two, "b4b")):
        assert {r[key][i] for r in res} == {want}, "bits differ"
    jax_sum = float(jreductions.global_sum(jnp.asarray(x), b4b=True))
    ex = float(np.frexp(np.abs(x).max())[1])
    xla_scale = float(jnp.exp2(jnp.asarray(ex)))
    assert fixed_point_sum(x, xla_scale) == jax_sum
    rounding = abs(xla_scale / 2.0 ** ex - 1.0)
    assert abs(want - jax_sum) <= (rounding + 4e-16) * abs(want)


def test_b4b_sum_axes_and_zeros():
    x = torch.as_tensor(np.random.RandomState(1).randn(3, 8, 9))
    per = global_sum(x, b4b=True, axis=(1, 2))
    want = jreductions.global_sum(jnp.asarray(x.numpy()), b4b=True,
                                  axis=(1, 2))
    np.testing.assert_array_equal(per.numpy(), np.asarray(want))
    assert float(global_sum(torch.zeros(4, 5), b4b=True)) == 0.0
    x32 = torch.as_tensor(np.random.RandomState(2).randn(16, 16),
                          dtype=torch.float32)
    assert float(global_sum(x32, b4b=True)) == float(
        jreductions.global_sum(jnp.asarray(x32.numpy()), b4b=True))


# ---- shifts, the fold, the wrappers' halo'd plain twins ---------------------

def whole_shifts(ew, ns):
    """``ranks.shifts``'s operations on the whole domain."""
    from pop2_tpu_torch.tripole import enforce_top_symmetry
    f = torch.as_tensor(shift_field())
    bc = BC(ew, ns)
    want = {"n": bc.n(f), "s": bc.s(f), "e": bc.e(f), "w": bc.w(f),
            "ne": bc.ne(f), "nw": bc.nw(f), "se": bc.se(f), "sw": bc.sw(f),
            "nn": bc.nn(f),
            "n_partner": bc.n_partner(f, f * 2.0, "nface", "vector"),
            "n_partner_corner": bc.n_partner(f, f * 3.0, "necorner"),
            "symmetry": enforce_top_symmetry(f),
            "symmetry_nface": enforce_top_symmetry(f, "nface", "scalar")}
    for loc, kind in ranks.FOLD_CASES:
        want[f"n_{loc}_{kind}"] = bc.n(f, loc, kind)
        want[f"nn_{loc}_{kind}"] = bc.nn(f, loc, kind)
        want[f"ne_{loc}_{kind}"] = bc.ne(f, loc, kind)
        want[f"nw_{loc}_{kind}"] = bc.nw(f, loc, kind)
    return want


def check_shifts(res, name, ew, ns):
    want = whole_shifts(ew, ns)
    for r in res:
        got = r[name]
        for k, w in want.items():
            np.testing.assert_array_equal(got[k], w.numpy(), err_msg=k)


@pytest.mark.parametrize("ns", ["closed", "tripole"])
def test_shifts_on_four_slabs_are_the_whole_domains(four, ns):
    check_shifts(four, f"shifts_{ns}", "cyclic", ns)


@pytest.mark.parametrize("mesh,edges", [
    pytest.param(m, e, id=f"{m}-{e[0]}")
    for m in ("4x1", "2x2", "1x4", "1x2") for e in SHIFT_EDGES
    if m != "4x1" or e[0] == "closed_ew"])
def test_shifts_on_blocks_are_the_whole_domains(four, two, mesh, edges):
    """Every shift on the blocks of a (2, 2), (1, 4) and (1, 2) mesh (the
    tripole's partner columns on the mirror ranks, on (1, px) across every
    rank) and on four slabs of a closed east-west edge is the whole
    domain's, bitwise."""
    tag, ew, ns = edges
    res = two if mesh == "1x2" else four
    name = f"shifts_{tag}" if mesh == "4x1" else f"shifts_{mesh}_{tag}"
    check_shifts(res, name, ew, ns)


def test_stencil_many_is_the_shifts_one_by_one(four):
    """The distance-1 shifts of a field given its rows (``BC.halo``, one
    exchange for all of them) are the shifts one by one: on the whole
    domain (no rows) and on four slabs, closed and tripole."""
    f = torch.as_tensor(np.random.RandomState(6).randn(3, 12, 10))
    for ns in ("closed", "tripole"):
        bc = BC("cyclic", ns)
        rows, = bc.halo([f])
        assert rows is None
        for o in ("n", "s", "ne", "nw", "se", "sw"):
            assert torch.equal(getattr(bc, o)(f, rows=rows),
                               getattr(bc, o)(f)), (ns, o)
    f = torch.as_tensor(shift_field())
    for ns in ("closed", "tripole"):
        bc = BC("cyclic", ns)
        want = {o: getattr(bc, o)(f) for o in ("n", "s", "e", "w", "ne",
                                              "nw", "se", "sw")}
        want["n_corner_vec"] = bc.n(f, "necorner", "vector")
        for name in (f"shifts_{ns}", f"shifts_2x2_{ns}", f"shifts_1x4_{ns}"):
            for r in four:
                got = r[name]
                assert got["rows_exchanges"] == 1
                for k, w in want.items():
                    np.testing.assert_array_equal(
                        got["rows_" + k], w.numpy(), err_msg=(name, k))


@pytest.mark.parametrize("name", [
    "tracer_closed", "clinic_closed", "tracer_tripole", "clinic_tripole",
    "slopes", "chain", "flux", "flux_cancellation"])
def test_wrapper_halo_call_on_two_slabs_is_bitwise(two, name):
    """Each wrapper's plain twin, called on its slab under the
    decomposition (its operands extended by the halo rows of the
    neighbours, the kernel's closed instance below the top slab), has the
    whole-domain call's values on its rows, bitwise."""
    check_wrapper(two, "wrappers", name)


@functools.lru_cache(maxsize=None)
def whole_wrapper(name):
    """The leaves of case ``name``'s whole-domain call."""
    import importlib
    _, path, cfg, grid, args, kwargs = {c[0]: c
                                        for c in wrapper_cases()}[name]
    module, fn = path.rsplit(".", 1)
    fn = getattr(importlib.import_module("pop2_tpu_torch." + module), fn)
    leaves = []
    pmesh.tree_map(leaves.append, fn(cfg, grid, *args, **kwargs))
    return leaves


def check_wrapper(res, key, name):
    """The gathered outputs of every rank's halo'd call of case ``name``
    equal the whole-domain call's, bitwise, at one exchange a call (and
    one for the grid's halo at its first call)."""
    leaves = whole_wrapper(name)
    for r in res:
        got = []
        pmesh.tree_map(got.append, r[key][name])
        assert len(leaves) == len(got) > 0
        for k, (g, w) in enumerate(zip(got, leaves)):
            assert torch.equal(g, w), f"{name}: leaf {k}"
        assert r[key][name + ":exchanges"] <= 2


@pytest.mark.parametrize("name", [
    "tracer_closed", "clinic_closed", "tracer_tripole", "clinic_tripole",
    "slopes", "chain", "flux", "flux_cancellation"])
def test_wrapper_halo_call_on_blocks_is_bitwise(four, name):
    """Each wrapper's plain twin, called on its (2, 2) block (its operands
    extended by the rows and columns of its neighbours; on the top row of
    blocks a plane whose first rows are the mirror block's top rows, the
    tripole instance reading the fold's rows there), has the whole-domain
    call's values on its block, bitwise."""
    check_wrapper(four, "wrappers_2x2", name)


# ---- whole models -----------------------------------------------------------

@pytest.fixture(scope="module")
def jax_mesh_run():
    """The JAX package's 'mini' with b4b on a (4, 1) mesh of the virtual
    CPU devices, NSTEPS steps: iterations a step and the fields."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    cfg = jget_config("mini", b4b=True, mesh_shape=(4, 1))
    m, mesh = jmesh.sharded_model(cfg)
    st = jmesh.shard_pytree(m.initial_state(), mesh)
    iters = []
    for _ in range(NSTEPS):
        st, d = m.advance(st)
        iters.append(int(d.solver_iters))
    return iters, {k: np.asarray(getattr(st, k)) for k in FIELDS}


def test_mini_b4b_iterations_on_four_slabs(four, whole_mini, jax_mesh_run):
    got = [r["mini_b4b"]["iters"] for r in four]
    assert all(g == got[0] for g in got)
    assert got[0] == whole_mini["b4b"][0] == jax_mesh_run[0]


@pytest.mark.parametrize("name", FIELDS)
def test_mini_b4b_fields_on_four_slabs(four, whole_mini, jax_mesh_run,
                                       name):
    got = four[0]["mini_b4b"]["fields"][name]
    assert scale_err(got, whole_mini["b4b"][1][name]) <= 1e-12
    # PARITY.md's band after five steps against the JAX package
    assert scale_err(got, jax_mesh_run[1][name]) <= 1e-7


def test_mini_diagnostics_alike_on_every_rank(four, whole_mini):
    d = [r["mini_b4b"]["diags"] for r in four]
    assert all(x == d[0] for x in d)
    for k, v in whole_mini["b4b"][2].items():
        assert abs(d[0][k] - v) <= 1e-12 * max(abs(v), 1e-30), k


def test_mini_without_b4b_on_four_slabs(four, whole_mini):
    got = four[0]["mini"]
    _, want, _ = whole_mini["plain"]
    for name, atol in (("tracer_cur", 1e-11), ("u_cur", 1e-11),
                       ("psurf_cur", 1e-9)):
        np.testing.assert_allclose(got["fields"][name], want[name], rtol=0,
                                   atol=atol, err_msg=name)
    assert got["counts"]["exchanges"] > 0 and got["counts"]["allreduces"] > 0
    assert got["counts"]["staged_bytes"] == 0  # CPU fields: nothing staged


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
def test_mini_b4b_on_blocks(four, whole_mini, jax_mesh_run, mesh):
    """'mini' with b4b on (2, 2) and (1, 4) blocks: every rank's iterations
    those of the port on the whole domain and of the JAX package on a (4, 1)
    mesh (b4b sums do not depend on the layout), the fields the port's
    whole-domain run's bitwise and within PARITY's 1e-7 of the JAX
    package's, the diagnostics alike on every rank."""
    got = [r[f"mini_b4b_{mesh}"] for r in four]
    iters, want, diags = whole_mini["b4b"]
    assert all(g["iters"] == iters == jax_mesh_run[0] for g in got)
    for name in ranks.STATE_FIELDS:
        np.testing.assert_array_equal(got[0]["fields"][name], want[name],
                                      err_msg=name)
    for name in FIELDS:
        assert scale_err(got[0]["fields"][name],
                         jax_mesh_run[1][name]) <= 1e-7, name
    assert all(g["diags"] == got[0]["diags"] for g in got)
    assert got[0]["counts"]["exchanges"] > 0


def test_mini_without_b4b_on_blocks(four, whole_mini):
    """'mini' without b4b on (2, 2) blocks: the plain sums in another
    order, within ``tests/test_sharding.py``'s bands."""
    got = four[0]["mini_2x2"]
    _, want, _ = whole_mini["plain"]
    for name, atol in (("tracer_cur", 1e-11), ("u_cur", 1e-11),
                       ("psurf_cur", 1e-9)):
        np.testing.assert_allclose(got["fields"][name], want[name], rtol=0,
                                   atol=atol, err_msg=name)


@pytest.fixture(scope="module")
def whole_prod():
    cfg, tracers, ff = prod_inputs()
    return whole_run(cfg, PROD_STEPS, tracers, ff)


@pytest.mark.parametrize("mesh", ["2x2", "1x2"])
def test_prod_full_on_blocks(four, two, whole_prod, mesh):
    """prod_full at 32 x 16 x 10 on (2, 2) and (1, 2) blocks (the fold
    across two ranks; on (1, 2) every block holds it and the global south
    edge): iterations and fields those of the whole domain, bitwise."""
    iters, want, diags = whole_prod
    got = [r[f"prod_{mesh}"] for r in (four if mesh == "2x2" else two)]
    assert all(g["iters"] == iters for g in got)
    for name in ranks.STATE_FIELDS:
        np.testing.assert_array_equal(got[0]["fields"][name], want[name],
                                      err_msg=name)
    assert all(g["diags"] == got[0]["diags"] for g in got)


def test_prod_full_on_two_slabs(two, whole_prod):
    iters, want, diags = whole_prod
    got = [r["prod"] for r in two]
    assert got[0]["iters"] == got[1]["iters"] == iters
    for name in ranks.STATE_FIELDS:
        assert scale_err(got[0]["fields"][name], want[name]) <= 1e-12, name
    assert got[0]["diags"] == got[1]["diags"]


@pytest.fixture(scope="module")
def whole_forced():
    return ranks.forced_run(forced_cfg(), FORCED_STEPS,
                            forced_inputs(forced_cfg()))


def test_forced_run_on_two_slabs(two, whole_forced):
    """What a caller composes around ``advance`` reduces over both slabs
    (the slab grid carries its decomposition): the b4b sums of the forcing
    have the whole domain's bits, so the iterations are the same and the
    fields within 1e-12 of scale (they are bitwise)."""
    got = [r["forced"] for r in two]
    want = whole_forced
    assert got[0]["iters"] == got[1]["iters"] == want["iters"]
    assert got[0]["precip_totals"] == got[1]["precip_totals"] \
        == want["precip_totals"]
    for name in ranks.STATE_FIELDS:
        assert scale_err(got[0]["fields"][name],
                         want["fields"][name]) <= 1e-12, name
    for g, w in zip(got[0]["region"], want["region"]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0]["smft"], want["smft"])


def test_forced_run_on_blocks(four, whole_forced):
    """The forced 'mini' on (2, 2) blocks: the marginal sea's region built
    from global (j, i) and cut to the blocks, the forcing's b4b sums over
    every block: the whole domain's iterations and fields, bitwise."""
    got = [r["forced_2x2"] for r in four]
    want = whole_forced
    assert all(g["iters"] == want["iters"] for g in got)
    assert all(g["precip_totals"] == want["precip_totals"] for g in got)
    for name in ranks.STATE_FIELDS:
        np.testing.assert_array_equal(got[0]["fields"][name],
                                      want["fields"][name], err_msg=name)
    for g, w in zip(got[0]["region"], want["region"]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0]["smft"], want["smft"])


@pytest.mark.parametrize("part", ["balance", "diagnostics", "cfl",
                                  "transports", "budget", "export"])
def test_forced_run_host_sums_on_two_slabs(two, whole_forced, part):
    """The precipitation balance's host sums, the global diagnostics, the
    CFL numbers, the binned transports, the budgets and the coupler's
    exports of a slab grid are the whole domain's, the same on both ranks:
    within 1e-12 of each value (plain sums, in another order over two
    slabs)."""
    def flat(x):
        if isinstance(x, np.ndarray):
            return x.ravel().tolist()
        if isinstance(x, dict):
            return [v for k in sorted(x) for v in flat(x[k])]
        if isinstance(x, (list, tuple)):
            return [v for y in x for v in flat(y)]
        return [float(x)]
    got = [flat(r["forced"][part]) for r in two]
    assert got[0] == got[1]
    g, w = got[0], flat(whole_forced[part])
    assert len(g) == len(w) > 0
    scale = max(abs(v) for v in w) or 1.0
    for a, b in zip(g, w):
        assert abs(a - b) <= 1e-12 * max(abs(b), 1e-12 * scale), part


def test_forced_run_refuses_global_index_diagnostics_on_slabs(two, four,
                                                              whole_forced):
    """The global-index diagnostics, once refused on a block, are the whole
    domain's bitwise on two slabs and on (2, 2) blocks, on every rank:
    the sections' transports (b4b sums of each block's part) and the
    barotropic streamfunction (each column's whole strip)."""
    want = whole_forced["global_index"]
    assert len(want["sections"]) == len(ranks.SECTIONS)
    for r, key in [(r, "forced") for r in two] + [(r, "forced_2x2")
                                                   for r in four]:
        got = r[key]
        assert got["global_index"]["sections"] == want["sections"]
        np.testing.assert_array_equal(got["global_index"]["bsf"],
                                      want["bsf"])


# ---- gathers, scatters, the sharded restart ---------------------------------

@pytest.mark.parametrize("key,blocks", [
    ("gather", [(0, 6, 0, 32), (6, 12, 0, 32), (12, 18, 0, 32),
                (18, 24, 0, 32)]),
    ("gather_2x2", [(0, 12, 0, 16), (0, 12, 16, 32), (12, 24, 0, 16),
                    (12, 24, 16, 32)])])
def test_gather_scatter_round_trips(four, key, blocks):
    whole = np.random.RandomState(3).randn(3, 24, 32)
    got = []
    for r in four:
        g = r[key]
        np.testing.assert_array_equal(g["from_root"], whole)
        np.testing.assert_array_equal(g["from_last"], whole)
        assert g["slab_equal"]
        got.append(g["block"])
    assert got == blocks


def test_sharded_restart_round_trip_and_another_py(four, two, restart_dir):
    """'mini' written on (4, 1) is read whole, bitwise, and onto (2, 2)
    blocks; prod_full written on (1, 2) blocks is read onto 2 slabs: each
    rank reads its block only."""
    cfg = get_config("mini")
    written = four[0]["mini_b4b"]["fields"]
    state, n = sharded_restart.read_sharded_restart(restart_dir, cfg,
                                                    device="cpu")
    assert n == NSTEPS
    for name in ranks.STATE_FIELDS:
        np.testing.assert_array_equal(getattr(state, name).numpy(),
                                      written[name], err_msg=name)
    for res, key, n, written in (
            (four, "restart_2x2", NSTEPS, written),
            (two, "restart", PROD_STEPS, two[0]["prod_1x2"]["fields"])):
        for r in res:
            assert r[key]["n"] == n
            j0, j1, i0, i1 = r[key]["block"]
            np.testing.assert_array_equal(
                r[key]["slab"].tracer_cur.numpy(),
                written["tracer_cur"][..., j0:j1, i0:i1])
            for name in ranks.STATE_FIELDS:
                np.testing.assert_array_equal(r[key]["whole"][name],
                                              written[name], err_msg=name)


def test_sharded_restart_dims_mismatch(four, restart_dir):
    with pytest.raises(ValueError, match="nx"):
        sharded_restart.read_sharded_restart(
            restart_dir, get_config("mini", nx=40), device="cpu")


def test_sharded_restart_reads_the_slab_layout(four, restart_dir, tmp_path):
    """A checkpoint of y slabs in the layout written before blocks
    (``slab<r>`` files whose record names ``py`` and the slab's rows) is
    read whole, bitwise."""
    cfg = get_config("mini")
    step = os.path.join(restart_dir, str(NSTEPS))
    old = tmp_path / str(NSTEPS)
    old.mkdir()
    for r in range(4):
        with open(os.path.join(step, f"block{r}.json")) as f:
            meta = json.load(f)
        assert (meta["i0"], meta["i1"]) == (0, cfg.nx)
        meta["py"] = meta.pop("ranks")
        del meta["i0"], meta["i1"]
        (old / f"slab{r}.json").write_text(json.dumps(meta))
        shutil.copy(os.path.join(step, f"block{r}.npz"),
                    old / f"slab{r}.npz")
    (tmp_path / sharded_restart.POINTER_FILE).write_text(str(NSTEPS))
    state, n = sharded_restart.read_sharded_restart(str(tmp_path), cfg,
                                                    device="cpu")
    assert n == NSTEPS
    written = four[0]["mini_b4b"]["fields"]
    for name in ranks.STATE_FIELDS:
        np.testing.assert_array_equal(getattr(state, name).numpy(),
                                      written[name], err_msg=name)


# ---- what stays refused -----------------------------------------------------

def test_refusals():
    with pytest.raises(ValueError, match="nx=32 does not split"):
        pmesh.make_mesh((2, 3), 24, 32)
    with pytest.raises(ValueError, match="equal"):
        pmesh.make_mesh((5, 1), 24, 32)
    with pytest.raises(ValueError, match="rows"):
        pmesh.make_mesh((8, 1), 24, 32)
    with pytest.raises(RuntimeError, match="process group"):
        pmesh.make_mesh((2, 1), 24, 32)
    with pytest.raises(ValueError, match="columns: a block needs"):
        pmesh.make_mesh((1, 32), 24, 32)
    with pytest.raises(ValueError, match="cyclic"):
        pmesh.make_mesh((1, 2), 24, 32, tripole=True, cyclic=False)
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        pmesh.make_mesh((2, 2), 24, 32)
    mini = get_config("mini")
    assert not supported.unsupported(mini.with_(mesh_shape=(2, 2)))
    assert not supported.unsupported(mini.with_(mesh_shape=(1, 4)))
    assert not supported.unsupported(mini.with_(mesh_shape=(4, 1), b4b=True))
    # the overflows and every passive package run on blocks
    # (tests/test_torch_ranks_services.py)
    from tests.test_overflows import _spec
    from tests.torch_port_helpers import torch_cfg
    ovf = torch_cfg(jget_config("mini").with_(overflows=(_spec(),)))
    assert not supported.unsupported(ovf.with_(mesh_shape=(2, 1)))
    prod = get_config("prod_full", mesh_shape=(2, 1))
    assert not supported.unsupported(prod)  # its iage and cfc
    for pkg in ("ecosys", "abio_dic", "sf6", "irf"):
        assert not supported.unsupported(prod.with_(passive_tracers=(pkg,)))
        assert not supported.unsupported(prod.with_(
            passive_tracers=(pkg,), mesh_shape=(1, 1)))
    # the cap on blocks needs the ranks' process group, as a Model does
    with pytest.raises(RuntimeError, match="process group"):
        OcnComponent(mini.with_(mesh_shape=(2, 1)), device="cpu")
    with pytest.raises(ValueError, match="backend"):
        multihost.initialize_distributed("file:///nonexistent", 1, 0, "mpi")


def test_refusals_of_a_decomposed_model(tmp_path):
    """A model on a mesh of one slab runs as the whole domain: its
    ``run_compiled`` with a tavg stream, and ``advance`` with history and
    movie streams, give the whole domain's state and files (the blocks' are
    ``tests/test_torch_ranks_services.py``'s); nothing of it is refused."""
    cfg = get_config("mini")
    runs = []
    for tag, mesh in (("block", pmesh.make_mesh((1, 1), cfg.ny, cfg.nx)),
                      ("whole", None)):
        out = tmp_path / tag
        out.mkdir()
        m = Model(cfg, device="cpu", mesh=mesh)
        m.enable_tavg(["TEMP", "SSH", "BSF"], freq_steps=2, outdir=str(out))
        st, _ = m.run_compiled(m.initial_state(), 3)
        m.enable_history(["TEMP"], freq_steps=1, outdir=str(out))
        m.enable_movie(["UVEL"], freq_steps=1, outdir=str(out))
        st, _ = m.advance(st)
        runs.append((st, [(p.rsplit("/", 1)[1], open(p, "rb").read())
                          for p in m.tavg_files]))
    (a, fa), (b, fb) = runs
    assert len(fa) == 4 and fa == fb  # tavg at 2 and 4, history, movie
    for name in FIELDS:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_rank_entry_points_default_to_the_card():
    """``initialize_distributed``, ``spawn_ranks`` and ``sharded_model``
    put a rank's fields on the card unless the caller asks for the CPU, as
    ``Model`` does; ``make_global_array`` falls back to the card where no
    rank device was set (``default_device``)."""
    import inspect
    for fn in (multihost.initialize_distributed, multihost.spawn_ranks,
               pmesh.sharded_model, Model):
        assert inspect.signature(fn).parameters["device"].default \
            == "cuda", fn
    assert multihost._DEVICE is None  # no process group in this process
    assert multihost.default_device() == torch.device("cuda")
