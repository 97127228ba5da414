"""The port's run loop: ``Model.run_compiled`` over the split step
(``step.pre`` / the solver's runs / ``step.post``, ``graphs.CapturedStep``)
on the CPU, where nothing is captured and the same segments are called.

- Against ``pop2_tpu.model.Model.run_compiled`` over 10 'mini' steps (the
  Euler step, one scanned chunk of 8 on the JAX side, one step more), and
  with ``time_mix_freq=4`` (averaging steps between the fused runs), in
  float64. Band: 1e-9 of each leaf's largest value, the band the port's
  ``run`` meets against the JAX package's ``run`` at the same step (at most
  4.8e-10 there, in the barotropic gradients: the two packages' solvers
  stop on the same iteration at the criterion of 1e-13, and their global
  sums round in different orders).
- Equal to the port's own ``run``, bitwise, on 'mini' and on a small
  ``prod_full`` (the Robert filter, the passive tracers under a 10-m wind,
  PCSI with FSPAI).
- Each solver as its parts, equal bitwise with the same iteration counts to
  the loop the parts replaced (kept here as the reference), eagerly and
  with the runs written back into the carry as the captured step does.
"""

import dataclasses
import math
from collections import Counter

import numpy as np
import jax
import pytest
import torch

jax.config.update("jax_enable_x64", True)

from pop2_tpu.config import get_config  # noqa: E402
from pop2_tpu.model import Model as JModel  # noqa: E402

from pop2_tpu_torch import barotropic, graphs, production, solvers  # noqa: E402
from pop2_tpu_torch import tridiag_cuda  # noqa: E402
from pop2_tpu_torch.config import SolverConfig  # noqa: E402
from pop2_tpu_torch.config import get_config as t_get_config  # noqa: E402
from pop2_tpu_torch.grid import build_grid, grid_bc  # noqa: E402
from pop2_tpu_torch.model import Model as TModel  # noqa: E402

from tests.torch_port_helpers import jax_leaves, scale_err, torch_cfg  # noqa: E402

BAND = 1e-9
NSTEPS = 10


def _mini(time_mix_freq):
    jcfg = get_config("mini")
    if time_mix_freq is not None:
        jcfg = jcfg.with_(time=dataclasses.replace(
            jcfg.time, time_mix_freq=time_mix_freq))
    return jcfg


@pytest.fixture(scope="module", params=[None, 4], ids=["freq17", "freq4"])
def jax_runs(request):
    """The JAX package's run_compiled and run over NSTEPS (one model, so the
    jitted steps compile once)."""
    jcfg = _mini(request.param)
    jm = JModel(jcfg)
    rc, diags = jm.run_compiled(jm.initial_state(), NSTEPS)
    rc_leaves = jax_leaves(rc)
    run_leaves = jax_leaves(jm.run(jm.initial_state(), NSTEPS))
    return jcfg, rc_leaves, int(diags.solver_iters), run_leaves


def test_run_compiled_matches_jax_run_compiled(jax_runs):
    jcfg, j_rc, j_iters, j_run = jax_runs
    tcfg = torch_cfg(jcfg)
    tm = TModel(tcfg, device="cpu")
    t_rc, diags = tm.run_compiled(tm.initial_state(), NSTEPS)
    t_run = TModel(tcfg, device="cpu")
    t_run = t_run.run(t_run.initial_state(), NSTEPS)
    assert diags.solver_iters == j_iters
    assert tm.nsteps_total == NSTEPS
    assert tm.time_manager.calendar.nsteps_total == NSTEPS
    for (name, x), (_, y) in zip(t_rc.leaves(), t_run.leaves()):
        assert scale_err(x.numpy(), j_rc[name]) <= BAND, name
        assert scale_err(y.numpy(), j_run[name]) <= BAND, name


def _prod_small():
    cfg = production.get_production_config(nx=40, ny=24, km=10,
                                           vert_grid="uniform")
    assert cfg.time.time_mix_opt == "robert" and cfg.nt == 5
    return cfg


@pytest.mark.parametrize("which", ["mini", "mini_freq4", "prod_full"])
def test_run_compiled_equals_run_bitwise(which):
    if which == "prod_full":
        cfg, nsteps = _prod_small(), 6
    else:
        cfg = t_get_config("mini")
        if which == "mini_freq4":
            cfg = cfg.with_(time=dataclasses.replace(cfg.time,
                                                     time_mix_freq=4))
        nsteps = 9
    runs = []
    for compiled in (False, True):
        model = TModel(cfg, device="cpu")
        # a forcing of the caller's own: with the passive tracers a wind
        forcing = model.forcing
        if cfg.passive_tracers:
            forcing = forcing.replace(
                u10_sqr=torch.full_like(forcing.fw, 4.9e5),
                ifrac=torch.zeros_like(forcing.fw))
        state = model.initial_state()
        if compiled:
            state, diags = model.run_compiled(state, nsteps, forcing)
            cap = model._captured
            assert cap is not None and cap.graphs == 0
            assert cap.replays == 0 and not cap.capture
            assert diags.solver_iters > 0
        else:
            state = model.run(state, nsteps, forcing)
        runs.append((state, model.nsteps_total,
                     model.time_manager.calendar.seconds_this_day))
    (a, na, ca), (b, nb, cb) = runs
    assert na == nb == nsteps and ca == cb
    for (name, x), (_, y) in zip(a.leaves(), b.leaves()):
        assert torch.equal(x, y), name


def test_run_compiled_resumes_and_returns_own_tensors():
    """Two run_compiled calls equal one; the returned state is not the
    captured step's buffers (a later run does not change it)."""
    cfg = t_get_config("mini")
    m1 = TModel(cfg, device="cpu")
    whole, _ = m1.run_compiled(m1.initial_state(), 8)
    m2 = TModel(cfg, device="cpu")
    half, _ = m2.run_compiled(m2.initial_state(), 4)
    kept = {n: t.clone() for n, t in half.leaves()}
    rest, _ = m2.run_compiled(half, 4)
    for (name, x), (_, y) in zip(whole.leaves(), rest.leaves()):
        assert torch.equal(x, y), name
    for name, t in half.leaves():
        assert torch.equal(t, kept[name]), name
    with pytest.raises(ValueError, match="CUDA"):
        m2._captured._capture_all()


# -- the solvers as parts ------------------------------------------------------

def _reference_loop(cfg, op, bc, x0, b, choice, eigs=None, precond=None):
    """The eager loops the parts replaced (PCSI's coefficients as host
    scalars): (x, iterations, rr)."""
    sol = cfg.solver
    minv = solvers.make_precond_apply(cfg, op, bc, precond)
    sh = solvers._shifted_weights(op, bc)
    tol = solvers._tolerance(cfg, op)
    ncheck = sol.convergence_check_freq

    def A(x):
        return solvers.apply_op(op, x, bc, sh)

    def dot(x):
        return solvers._masked_sum(x, op.mask)

    safe = solvers._safe
    inf = torch.full((), math.inf, dtype=x0.dtype)
    m = 0
    if choice == "chrongear":
        r = b - A(x0)
        rr_init = dot(r * r)
        z = minv(r)
        s = z
        q = A(s)
        rho_old, sigma = dot(r * z), dot(s * q)
        alpha = rho_old / safe(sigma)
        x, r = x0 + alpha * s, r - alpha * q
        if float(rr_init) < tol:
            return x, 0, rr_init
        rr = inf
        while m < sol.max_iterations:
            z = minv(r)
            az = A(z)
            rho, delta = dot(r * z), dot(az * z)
            beta = rho / safe(rho_old)
            sigma = delta - beta ** 2 * sigma
            alpha = rho / safe(sigma)
            s, q = z + beta * s, az + beta * q
            x, r = x + alpha * s, r - alpha * q
            rho_old = rho
            m += 1
            if m % ncheck == 0:
                r = b - A(x)
                rr = dot(r * r)
                if float(rr) < tol:
                    break
        return x, m, rr
    if choice == "pcg":
        x, r, s = x0, b - A(x0), torch.zeros_like(x0)
        eta_old, rr = torch.ones((), dtype=x0.dtype), inf
        while m < sol.max_iterations:
            z = minv(r)
            eta = dot(r * z)
            s = z + s * (eta / safe(eta_old))
            q = A(s)
            alpha = eta / safe(dot(s * q))
            x, r = x + alpha * s, r - alpha * q
            eta_old = eta
            m += 1
            if m % ncheck == 0:
                r = b - A(x)
                rr = dot(r * r)
                if float(rr) < tol:
                    break
        return x, m, rr
    eig_min, eig_max = eigs
    csalpha = 2.0 / (eig_max - eig_min)
    csy = ((eig_max + eig_min) / (eig_max - eig_min)) / csalpha
    omga = 2.0 / csy
    r = b - A(x0)
    q = (1.0 / csy) * minv(r)
    x = x0 + q
    r = b - A(x)
    rr = inf
    while m < sol.max_iterations:
        omga = 1.0 / (csy - omga / (4.0 * csalpha * csalpha))
        q = omga * minv(r) + (csy * omga - 1.0) * q
        x = x + q
        r = b - A(x)
        m += 1
        if m % ncheck == 0 and m >= sol.convergence_check_start:
            rr = dot(r * r)
            if float(rr) < tol:
                break
    return x, m, rr


@pytest.mark.parametrize("choice,precond,crit,max_iter", [
    ("chrongear", "diagonal", 1e-13, 1000),
    ("chrongear", "diagonal", 1e-30, 95),   # to the last, shorter run
    ("chrongear", "fspai", 1e-13, 1000),
    ("pcg", "diagonal", 1e-13, 1000),
    ("pcg", "fspai", 1e-13, 1000),
    ("pcsi", "diagonal", 1e-13, 1000),
    ("pcsi", "fspai", 1e-13, 1000),
    ("pcsi", "fspai", 1e-30, 95),
])
def test_solver_parts_equal_the_loop(choice, precond, crit, max_iter):
    cfg = t_get_config("mini", solver=SolverConfig(
        choice=choice, preconditioner=precond, convergence_criterion=crit,
        max_iterations=max_iter, convergence_check_freq=10,
        convergence_check_start=25))
    grid, bc = build_grid(cfg, "cpu"), grid_bc(cfg)
    op = solvers.make_operator(
        grid, barotropic.diagonal_correction(cfg, grid, True))
    pre = solvers.build_fspai9(cfg, op) if precond == "fspai" else None
    eigs = None
    if choice == "pcsi":
        eigs = (solvers.pcg_lanczos_eigs(cfg, op, bc, pre) if pre is not None
                else solvers.lanczos_eigs(cfg, op, bc))
    rng = np.random.RandomState(5)
    mask = grid.RCALCT.numpy()
    b = solvers.apply_op(op, torch.as_tensor(
        rng.randn(*mask.shape) * 50.0 * mask), bc)
    x0 = torch.as_tensor(rng.randn(*mask.shape) * mask)

    want_x, want_m, want_rr = _reference_loop(cfg, op, bc, x0, b, choice,
                                              eigs, pre)
    if max_iter < 100:
        assert want_m == max_iter
    else:
        assert 0 < want_m < max_iter
    # eagerly
    x, m, rr = solvers.solve(cfg, op, bc, x0, b, eigs, pre)
    assert m == want_m
    assert torch.equal(x, want_x) and torch.equal(rr, want_rr)
    # as the captured step runs them: each run written into the carry, the
    # PCSI table built once beforehand
    if eigs is not None:
        eigs = solvers.PCSIBounds(*eigs, solvers.pcsi_table(
            cfg, *eigs, torch.float64, "cpu"))
    s = solvers.make_solver(cfg, op, bc, eigs, pre,
                            tol=solvers.tolerance(cfg, grid))
    carry = s.init(x0, b)

    def advance(c, n, check):
        for k, v in s.advance(c, n, check).items():
            c[k].copy_(v)
        return c
    carry, m, rr = s.run(carry, advance)
    assert m == want_m
    assert torch.equal(carry["x"], want_x) and torch.equal(rr, want_rr)


def test_chunk_schedule():
    assert solvers.chunk_schedule(25, 10) == ((10, True), (10, True),
                                              (5, False))
    # PCSI: no check before convergence_check_start
    assert solvers.chunk_schedule(40, 10, 25) == ((10, False), (10, False),
                                                  (10, True), (10, True))
    assert set(solvers.chunk_schedule(1000, 10, 60)) == {(10, False),
                                                         (10, True)}


# -- the captured step's bookkeeping -------------------------------------------

def test_assign_orders_the_level_rotation():
    """The new state hands the current level on as the old one: that copy
    goes first; a cycle raises."""
    cfg = t_get_config("mini")
    model = TModel(cfg, device="cpu")
    s0 = model.initial_state()
    buf = graphs._clone_tree(s0)
    new = buf.replace(u_old=buf.u_cur, u_cur=buf.u_cur + 1.0,
                      psurf_old=buf.psurf_cur, psurf_cur=buf.psurf_cur - 2.0)
    cur_before = buf.u_cur.clone()
    graphs.assign(buf, new)
    assert torch.equal(buf.u_old, cur_before)
    assert torch.equal(buf.u_cur, cur_before + 1.0)
    swap = buf.replace(u_old=buf.u_cur, u_cur=buf.u_old)
    with pytest.raises(RuntimeError, match="cycle"):
        graphs.assign(buf, swap)
    with pytest.raises(ValueError, match="float32"):
        graphs.assign(buf, buf.replace(pguess=buf.pguess.float()))
    # a forcing field the buffers were made without is not dropped
    f = graphs._clone_tree(model.forcing)
    with pytest.raises(ValueError, match="u10_sqr"):
        graphs.assign(f, f.replace(u10_sqr=torch.zeros_like(f.fw)))


class _Replay:
    def __init__(self):
        self.calls = 0

    def replay(self):
        self.calls += 1


def test_segment_replay_adds_the_captured_launches():
    seg = graphs._Segment("post", lambda: None, None, capture=False)
    seg.graph = _Replay()
    seg.launches = {tridiag_cuda: 3}
    seg.launches_by_nr = Counter({1: 2, 2: 1})
    before, by_nr = tridiag_cuda.launches, dict(tridiag_cuda.launches_by_nr)
    try:
        seg()
        seg()
        assert seg.graph.calls == seg.replays == 2
        assert tridiag_cuda.launches == before + 6
        assert tridiag_cuda.launches_by_nr[1] == by_nr.get(1, 0) + 4
    finally:
        tridiag_cuda.launches = before
        tridiag_cuda.launches_by_nr.clear()
        tridiag_cuda.launches_by_nr.update(by_nr)
