#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (pop2_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from the sources in the checkout,
holds each against its plain PyTorch version at the shapes the main path
gives it (320 x 384 x 60, the production gx1v7 dimensions, nt = 2) in float32
and float64, times both, drives the port's main path (``Model.advance``:
Euler step, leapfrog steps, averaging steps) at that size in float32 and in
float64, checks through the wrappers' launch counters that the path really
went through the kernels, compares five steps with the kernels against five
steps with the plain versions (and, in float32, both against the float64
run), breaks a step's time down by part and by device kernel, and compares
the GPU path with the CPU path on a small grid. Every phase that fails makes
the script exit non-zero; with no GPU it exits at once without a result. It
takes no arguments: every run is the whole check.

Output: one JSON object per line; the ``kernels`` line, then the card's name
and power limit, then the final ``{"ok": true, "device": ...}`` line.
"""

from __future__ import annotations

import contextlib
import json
import math
import re
import subprocess
import sys
import time

import torch

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke: no CUDA device; this script measures on "
                     "the GPU only\n")
    sys.exit(2)

from pop2_tpu_torch import _cuda_build as cb  # noqa: E402
from pop2_tpu_torch import clinic_cuda, tracer_cuda, tridiag_cuda  # noqa: E402
from pop2_tpu_torch import constants as const  # noqa: E402
from pop2_tpu_torch import pgrad  # noqa: E402
from pop2_tpu_torch.config import SolverConfig, get_config  # noqa: E402
from pop2_tpu_torch.grid import build_grid  # noqa: E402
from pop2_tpu_torch.model import Model  # noqa: E402

DEV = torch.device("cuda")
SEED = 20240613
STEPS_F32 = 40   # Euler step, leapfrog steps, averaging steps at 17 and 34
STEPS_F64 = 12
N_TIMED = 20     # timed launches per kernel, after warm-up

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): device memory rate and
# the non-tensor-core arithmetic rates the kernels can use
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}

# kernel-vs-plain bands: float32 as the fractions of the field's scale the
# JAX package holds its TPU kernels to; float64 relative to the scale
BAND = {
    ("thomas", torch.float32): 2e-5, ("tracer", torch.float32): 2e-5,
    ("clinic", torch.float32): 4e-5,
    ("thomas", torch.float64): 1e-12, ("tracer", torch.float64): 1e-12,
    ("clinic", torch.float64): 1e-12,
}
# whole-path bands, kernels against plain versions over 5 steps, relative to
# each field's scale. float64: the parity band of the JAX package's step-5
# test on every field. float32 is looser, by field: tracers get the band of
# the JAX package's own float32 kernel-dispatch test; the surface pressure is
# the solution of an ill-conditioned 2-D elliptic problem whose right-hand
# side (the vertical mean of a forcing made of large cancelling terms) carries
# float32 rounding, so two correct float32 runs differ there by about 1e-2
# during spin-up from rest, and the velocities inherit it through its gradient.
# That band alone would pass a slightly wrong float32 kernel, so the float32
# comparison also holds both runs against the float64 run of the same steps:
# the run with the kernels may lie at most WITNESS_RATIO times as far from it
# as the run with the plain versions does, on every field
PATH_FIELDS = ("u_cur", "v_cur", "tracer_cur", "psurf_cur", "ubtrop_cur",
               "vbtrop_cur")
PATH_BAND = {
    torch.float64: dict.fromkeys(PATH_FIELDS, 1e-7),
    torch.float32: {"tracer_cur": 1e-4, "u_cur": 1e-2, "v_cur": 1e-2,
                    "psurf_cur": 5e-2, "ubtrop_cur": 5e-2,
                    "vbtrop_cur": 5e-2},
}

WITNESS_RATIO = 1.5

SOURCES = {
    "thomas": ("pop2_tpu_torch/csrc/thomas.cu",
               "pop2_tpu/tridiag_pallas.py:112"),
    "tracer": ("pop2_tpu_torch/csrc/tracer.cu",
               "pop2_tpu/tracer_pallas.py:563"),
    "clinic": ("pop2_tpu_torch/csrc/clinic.cu",
               "pop2_tpu/clinic_pallas.py:461"),
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def full_config(dtype: str):
    """The dynamical-core slice at the production gx1v7 dimensions. Under a
    float32 model the 2-D solve runs in float64, as the production preset
    does: in float32 the residual floor of the solve lies above the
    convergence criterion of 1e-13 and ChronGear runs to max_iterations
    every step (in the JAX package too)."""
    solver = SolverConfig(solve_dtype="float64")
    return get_config("test", nx=320, ny=384, km=60, vmix="rich",
                      dtype=dtype, solver=solver)


def time_ms(fn, n_warm: int, n_timed: int) -> float:
    """Median time of one call, by CUDA events around each call."""
    for _ in range(n_warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n_timed):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    times.sort()
    return times[len(times) // 2]


def compare(name, dtype, got, want):
    """(max abs err, err relative to the reference's scale) over all outputs;
    raises if the band is broken or anything is not finite."""
    worst_abs, worst_rel = 0.0, 0.0
    for g, w in zip(got, want):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{name} {dtype}: kernel output not finite")
        scale = float(w.abs().max()) or 1.0
        err = float((g - w).abs().max())
        worst_abs = max(worst_abs, err)
        worst_rel = max(worst_rel, err / scale)
    band = BAND[(name, dtype)]
    if not worst_rel <= band:
        raise AssertionError(
            f"{name} {dtype}: kernel differs from plain version by "
            f"{worst_rel:.3e} of scale, band {band:.1e}")
    return worst_abs, worst_rel


def bound(nbytes: float, flops: float, dtype):
    t_b = nbytes / PEAK_BYTES_S * 1e3
    t_f = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def random_fields(cfg, grid, gen):
    """Kernel operands with the magnitudes the JAX package's kernel tests
    use, masked to ocean, from the seeded generator."""
    dt = cfg.torch_dtype
    km, ny, nx, nt = cfg.km, cfg.ny, cfg.nx, cfg.nt
    mu, mt = grid.kmask_u.to(dt), grid.kmask_t.to(dt)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=DEV, dtype=dt)

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device=DEV, dtype=dt)

    f = {}
    for name in ("ucur", "vcur", "uold", "vold"):
        f[name] = randn(km, ny, nx) * 10.0 * mu
    for name in ("trcr", "tmix", "told"):
        f[name] = randn(nt, km, ny, nx) * mt
    f["vdc"] = rand(2, km, ny, nx) * 10.0 * mt
    f["vvc"] = rand(km, ny, nx) * 10.0 * mu
    f["stf"] = randn(nt, ny, nx) * mt[0]
    f["smf"] = randn(2, ny, nx) * mu[0]
    f["dh"] = randn(ny, nx) * 1e-4 * mt[0]
    f["dhu"] = randn(ny, nx) * 1e-4 * mu[0]
    f["rho"] = [randn(km, ny, nx) * 1e-3 * mt for _ in range(3)]
    f["psurf"] = randn(ny, nx) * 100.0 * mt[0]
    f["rhs"] = randn(2, km, ny, nx) * mt
    return f


def kernel_phase(dtype_name: str, n_timed: int = N_TIMED):
    """Each kernel against its plain version at the main path's shapes and
    with the main path's aliasing of operands (a leapfrog step: the
    mixing-time fields are the old ones), with times and bounds. A bound
    counts each distinct tensor once. Returns {name: record}."""
    cfg = full_config(dtype_name)
    dt = cfg.torch_dtype
    grid = build_grid(cfg, DEV)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED)
    f = random_fields(cfg, grid, gen)
    km, ny, nx, nt = cfg.km, cfg.ny, cfg.nx, cfg.nt
    N, P, s = km * ny * nx, ny * nx, torch.finfo(dt).bits // 8
    vg = grid.vgrid
    rec = {}

    # ---- thomas: the tracer solve's operands, nr = 2 and nr = 1 -----------
    c2dt = 2.0 * cfg.time.dtt
    hfac = vg.dz / c2dt
    h1 = (hfac[0] + f["psurf"] / (const.GRAV * c2dt)).contiguous()
    a = cfg.aidif * vg.dzwr[1:km + 1].reshape(km, 1, 1) * f["vdc"][1]
    a[-1] = 0.0
    r = {}
    for nr in (2, 1):
        rhs = f["rhs"][:nr].contiguous()
        args = (hfac, h1, grid.KMT, a, rhs)
        got = tridiag_cuda.thomas(*args)
        torch.cuda.synchronize()
        want = tridiag_cuda.thomas_plain(*args)
        err_abs, err_rel = compare("thomas", dt, [got], [want])
        ms = time_ms(lambda: tridiag_cuda.thomas(*args), 3, n_timed)
        plain_ms = time_ms(lambda: tridiag_cuda.thomas_plain(*args), 1, 3)
        b_ms, b_by = bound(s * (N * (1 + 2 * nr) + P + km) + 4 * P,
                           N * (8 + 5 * nr), dt)
        tag = "" if nr == 2 else "_nr1"
        r.update({"max_abs_err" + tag: err_abs, "rel_err" + tag: err_rel,
                  "ms" + tag: ms, "plain_ms" + tag: plain_ms,
                  "bound_ms" + tag: b_ms, "bound_by" + tag: b_by})
    rec["thomas"] = r

    # ---- tracer tendency ----------------------------------------------------
    # u, v, vdc (2), trcr, told (= tmix) and the output per tracer
    args = (cfg, grid, f["ucur"], f["vcur"], f["trcr"], f["told"], f["told"],
            f["vdc"], f["stf"], f["dh"])
    got = tracer_cuda.tracer_tendency(*args)
    torch.cuda.synchronize()
    want = tracer_cuda.tracer_tendency_plain(*args)
    err_abs, err_rel = compare("tracer", dt, [got], [want])
    ms = time_ms(lambda: tracer_cuda.tracer_tendency(*args), 3, n_timed)
    plain_ms = time_ms(lambda: tracer_cuda.tracer_tendency_plain(*args), 1, 3)
    b_ms, b_by = bound(s * (N * (4 + 3 * nt) + P * (nt + 8) + 4 * km) + 4 * P,
                       N * (30 + 45 * nt), dt)
    rec["tracer"] = {"max_abs_err": err_abs, "rel_err": err_rel, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by}

    # ---- momentum forcing (leapfrog, pressure-averaged) ---------------------
    rhoavg = pgrad.rho_average(cfg, grid, f["rho"][0], f["rho"][1],
                               f["rho"][2], True)
    wc, wo = clinic_cuda.coriolis_weights(cfg, True)
    args = (cfg, grid, f["ucur"], f["vcur"], f["uold"], f["vold"], f["uold"],
            f["vold"], rhoavg, f["vvc"], f["smf"], f["dhu"], wc, wo)
    got = clinic_cuda.clinic_rhs_fields(*args)
    torch.cuda.synchronize()
    want = clinic_cuda.clinic_rhs_plain(*args)
    err_abs, err_rel = compare("clinic", dt, got, want)
    ms = time_ms(lambda: clinic_cuda.clinic_rhs_fields(*args), 3, n_timed)
    plain_ms = time_ms(lambda: clinic_cuda.clinic_rhs_plain(*args), 1, 3)
    # six distinct 3-D inputs (the mixing-time pair is the old pair again);
    # the kernel reads nothing below a column's bottom: count the inputs of
    # the ocean levels of this grid, and every output value
    wet = float(grid.kmask_u.to(torch.float64).mean())
    b_ms, b_by = bound(s * (N * (6 * wet + 2) + P * (19 + 2 + 1 + 2)
                            + 5 * km) + 4 * P, N * wet * 200, dt)
    rec["clinic"] = {"max_abs_err": err_abs, "rel_err": err_rel, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "ocean_fraction_u": wet}
    return rec


def other_modes_phase(dtype_name: str):
    """The modes of the tracer and momentum kernels that the main path's
    configuration does not select but the kernels carry (closed east-west
    boundary, rigid lid, Euler-step Coriolis weights), each against its plain
    version at full size. Not timed."""
    worst = {}
    for ew in ("cyclic", "closed"):
        for sfc in ("varthick", "rigid"):
            cfg = full_config(dtype_name).with_(ew_boundary=ew, sfc_layer=sfc)
            dt = cfg.torch_dtype
            grid = build_grid(cfg, DEV)
            gen = torch.Generator(device=DEV)
            gen.manual_seed(SEED + 1)
            f = random_fields(cfg, grid, gen)
            args = (cfg, grid, f["ucur"], f["vcur"], f["trcr"], f["tmix"],
                    f["told"], f["vdc"], f["stf"], f["dh"])
            got = tracer_cuda.tracer_tendency(*args)
            torch.cuda.synchronize()
            want = tracer_cuda.tracer_tendency_plain(*args)
            worst[f"tracer_{ew}_{sfc}"] = compare("tracer", dt, [got],
                                                  [want])[1]
            if sfc == "rigid":
                continue  # the momentum kernel does not read sfc_layer
            for leapfrog in (True, False):
                rhoavg = pgrad.rho_average(cfg, grid, *f["rho"], leapfrog)
                wc, wo = clinic_cuda.coriolis_weights(cfg, leapfrog)
                um, vm = ((f["uold"], f["vold"]) if leapfrog
                          else (f["ucur"], f["vcur"]))
                args = (cfg, grid, f["ucur"], f["vcur"], f["uold"],
                        f["vold"], um, vm, rhoavg, f["vvc"], f["smf"],
                        f["dhu"], wc, wo)
                got = clinic_cuda.clinic_rhs_fields(*args)
                torch.cuda.synchronize()
                want = clinic_cuda.clinic_rhs_plain(*args)
                step = "leapfrog" if leapfrog else "euler"
                worst[f"clinic_{ew}_{step}"] = compare("clinic", dt, got,
                                                       want)[1]
    emit({"phase": "other_modes", "dtype": dtype_name,
          "rel_err_of_scale": worst,
          "band": {"tracer": BAND[("tracer", cfg.torch_dtype)],
                   "clinic": BAND[("clinic", cfg.torch_dtype)]}})


def reset_counts():
    tridiag_cuda.launches = 0
    tracer_cuda.launches = 0
    clinic_cuda.launches = 0


def read_counts():
    return {"thomas": tridiag_cuda.launches, "tracer": tracer_cuda.launches,
            "clinic": clinic_cuda.launches}


def path_phase(dtype_name: str, nsteps: int):
    """Drive Model.advance for nsteps at full size; the launch counters are
    zeroed just before and read just after."""
    cfg = full_config(dtype_name)
    model = Model(cfg)  # default device: the GPU
    state = model.initial_state()
    torch.cuda.synchronize()
    reset_counts()
    iters = []
    diag_step4 = None
    t0 = time.perf_counter()
    for n in range(1, nsteps + 1):
        state, diags = model.advance(state)
        iters.append(int(diags.solver_iters))
        if n == 4:  # early spin-up, for comparison with the JAX package
            diag_step4 = model.diagnostics(state)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()

    n_avg = sum(model.step_flags(n)[1] for n in range(1, nsteps + 1))
    expect = {"thomas": 3 + 5 * (nsteps - 1), "tracer": nsteps,
              "clinic": nsteps}
    if counts != expect:
        raise AssertionError(f"launch counts {counts}, expected {expect}")
    for name, t in state.leaves():
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{dtype_name} path: {name} not finite")
    diag = model.diagnostics(state)
    model.check_ke(state)
    if not all(math.isfinite(v) for v in diag.values()):
        raise AssertionError(f"diagnostics not finite: {diag}")
    points = cfg.nx * cfg.ny * cfg.km
    emit({"phase": "path", "dtype": dtype_name,
          "dims": [cfg.nx, cfg.ny, cfg.km], "nt": cfg.nt, "steps": nsteps,
          "averaging_steps": n_avg, "seconds": seconds,
          "steps_per_s": nsteps / seconds,
          "grid_point_steps_per_s": points * nsteps / seconds,
          "solver_iters_per_step": iters, "launches": counts,
          "diagnostics_step4": diag_step4, "diagnostics": diag,
          "peak_device_mem_bytes": torch.cuda.max_memory_allocated()})
    return counts


def _run_steps(cfg, nsteps, device=DEV):
    model = Model(cfg, device=device)
    state = model.initial_state()
    iters = []
    for _ in range(nsteps):
        state, diags = model.advance(state)
        iters.append(int(diags.solver_iters))
    return state, iters


def _state_diffs(a, b):
    out = {}
    for name in PATH_FIELDS:
        x, y = getattr(a, name), getattr(b, name).to(getattr(a, name).device)
        if not bool(torch.isfinite(x).all() and torch.isfinite(y).all()):
            raise AssertionError(f"{name} not finite")
        out[name] = float((x - y).abs().max()) / (float(y.abs().max())
                                                  or 1.0)
    return out


@contextlib.contextmanager
def plain_versions():
    """Inside the block the three wrappers are replaced by their plain
    PyTorch versions, so a whole run on the card can be compared with and
    without the kernels. The package itself has no such switch: its wrappers
    choose by the tensor's device alone."""
    saved = (tridiag_cuda.thomas, tracer_cuda.tracer_tendency,
             clinic_cuda.clinic_rhs_fields)
    tridiag_cuda.thomas = tridiag_cuda.thomas_plain
    tracer_cuda.tracer_tendency = tracer_cuda.tracer_tendency_plain
    clinic_cuda.clinic_rhs_fields = clinic_cuda.clinic_rhs_plain
    try:
        yield
    finally:
        (tridiag_cuda.thomas, tracer_cuda.tracer_tendency,
         clinic_cuda.clinic_rhs_fields) = saved


def path_vs_plain_phase(nsteps: int = 5):
    """nsteps with the kernels against nsteps with the plain versions forced,
    same initial state, at full size: float64 first, then float32, where both
    runs are also held against the float64 run (the witness that their
    difference is float32 rounding and not a fault of a kernel)."""
    ref = None
    for dtype_name in ("float64", "float32"):
        cfg = full_config(dtype_name)
        reset_counts()
        s_kernel, it_k = _run_steps(cfg, nsteps)
        n_kernel = read_counts()
        reset_counts()
        with plain_versions():
            s_plain, it_p = _run_steps(cfg, nsteps)
        if any(read_counts().values()) or not all(n_kernel.values()):
            raise AssertionError("the comparison did not separate the "
                                 "kernel run from the plain run")
        diffs = _state_diffs(s_kernel, s_plain)
        band = PATH_BAND[cfg.torch_dtype]
        out = {"phase": "path_vs_plain", "dtype": dtype_name,
               "steps": nsteps, "rel_diff": diffs, "band": band,
               "solver_iters_kernel": it_k, "solver_iters_plain": it_p}
        broken = {k: v for k, v in diffs.items() if not v <= band[k]}
        if ref is None:
            ref = s_kernel
        else:
            d_k, d_p = _state_diffs(s_kernel, ref), _state_diffs(s_plain, ref)
            out.update({"kernel_run_vs_float64": d_k,
                        "plain_run_vs_float64": d_p,
                        "witness_ratio_limit": WITNESS_RATIO})
            broken.update({k + "_vs_float64": (d_k[k], d_p[k]) for k in d_k
                           if not d_k[k] <= WITNESS_RATIO * d_p[k]})
        emit(out)
        if broken:
            raise AssertionError(f"{dtype_name} path with kernels differs "
                                 f"from the plain path beyond its band: "
                                 f"{broken}")


def breakdown_phase(dtype_name: str, nsteps: int = 6, nprof: int = 2):
    """Where a leapfrog step's time goes at full size. First the three parts
    of ``step.step`` by the host clock with a synchronize around each (so the
    parts do not overlap and their sum exceeds an unsynchronized step
    slightly); then ``nprof`` steps under ``torch.profiler`` for the device's
    busy time and the kernels that hold it. The profiler adds host time to
    every launch, so the busy share of its own window is a lower bound; the
    device time of the profiled steps over the unprofiled step time is the
    estimate of the share in normal running."""
    from torch.profiler import ProfilerActivity, profile

    from pop2_tpu_torch import baroclinic, barotropic

    cfg = full_config(dtype_name)
    model = Model(cfg)
    state = model.run(model.initial_state(), 3)  # past the Euler step
    parts = {"baroclinic_driver": 0.0, "barotropic_driver": 0.0,
             "correct_adjust": 0.0}

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            parts[name] += time.perf_counter() - t0
            return out
        return wrapper

    saved = (baroclinic.driver, barotropic.driver, baroclinic.correct_adjust)
    baroclinic.driver = timed("baroclinic_driver", saved[0])
    barotropic.driver = timed("barotropic_driver", saved[1])
    baroclinic.correct_adjust = timed("correct_adjust", saved[2])
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        iters = 0
        for _ in range(nsteps):
            state, diags = model.advance(state)
            iters += int(diags.solver_iters)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        (baroclinic.driver, barotropic.driver,
         baroclinic.correct_adjust) = saved

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(nprof):
            state, _ = model.advance(state)
        torch.cuda.synchronize()
        window = time.perf_counter() - t0

    # kernel rows only: an operator's row repeats its kernels' device time
    kernels = [ev for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda ev: ev.self_device_time_total, reverse=True)
    busy_us = sum(ev.self_device_time_total for ev in kernels)
    emit({"phase": "breakdown", "dtype": dtype_name, "steps": nsteps,
          "ms_per_step": total / nsteps * 1e3,
          "ms_per_step_by_part": {k: v / nsteps * 1e3
                                  for k, v in parts.items()},
          "solver_iters_per_step": iters / nsteps,
          "profiled_steps": nprof,
          "profiled_ms_per_step": window / nprof * 1e3,
          "device_busy_ms_per_step": (busy_us / nprof / 1e3
                                      if busy_us else None),
          "device_busy_share_under_profiler": (busy_us / (window * 1e6)
                                               if busy_us else None),
          "device_busy_share_of_unprofiled_step": (
              busy_us / nprof / (total / nsteps * 1e6) if busy_us else None),
          "top_device_kernels_ms_per_step": [
              [ev.key[:60], ev.self_device_time_total / nprof / 1e3,
               ev.count // nprof] for ev in kernels[:10]]})


def small_vs_cpu_phase(nsteps: int = 5):
    """The GPU path (kernels) against the CPU path (plain versions) on the
    small 'mini' grid in float64: the parity band of the step-5 test."""
    cfg = get_config("mini")
    s_gpu, it_g = _run_steps(cfg, nsteps, DEV)
    s_cpu, it_c = _run_steps(cfg, nsteps, torch.device("cpu"))
    diffs = _state_diffs(s_gpu, s_cpu)
    emit({"phase": "small_vs_cpu", "dims": [cfg.nx, cfg.ny, cfg.km],
          "dtype": cfg.dtype, "steps": nsteps, "rel_diff": diffs,
          "band": 1e-7, "solver_iters_gpu": it_g, "solver_iters_cpu": it_c})
    if not max(diffs.values()) <= 1e-7:
        raise AssertionError(f"GPU and CPU paths differ: {diffs}")


def ptxas_summary():
    """{kernel: [registers, spill-store bytes]} at the worst instantiation of
    each kernel, from what nvcc printed when the library was built."""
    worst, entry = {}, None
    for line in cb.build_log().splitlines():
        m = re.search(r"entry function '\w*?(thomas|tracer|clinic)_kernel",
                      line)
        if m:
            entry = worst.setdefault(m.group(1), [0, 0])
        for slot, pattern in ((0, r"Used (\d+) registers"),
                              (1, r"(\d+) bytes spill stores")):
            m = re.search(pattern, line)
            if m and entry is not None:
                entry[slot] = max(entry[slot], int(m.group(1)))
    return worst


def main():
    if len(sys.argv) > 1:
        sys.exit("chip_smoke.py takes no arguments: it always runs every "
                 "phase")
    t_start = time.perf_counter()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]

    cb.lib()  # build (or reuse) and load the kernels
    emit({"phase": "build", "card": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_seconds": cb.build_seconds,
          "library": "nvcc sm_90a, ctypes",
          "max_registers_and_spill_bytes": ptxas_summary()})

    records = {}
    for dtype_name in ("float32", "float64"):
        records[dtype_name] = kernel_phase(dtype_name)
        other_modes_phase(dtype_name)
    launches = {"float32": path_phase("float32", STEPS_F32)}
    path_vs_plain_phase()
    launches["float64"] = path_phase("float64", STEPS_F64)
    breakdown_phase("float32")
    small_vs_cpu_phase()

    kernels = []
    for dtype_name, recs in records.items():
        for name, r in recs.items():
            source, replaces = SOURCES[name]
            n = launches[dtype_name][name]
            if not n:
                raise AssertionError(
                    f"{name} ({dtype_name}) was not launched on the main "
                    "path")
            kernels.append({"name": f"{name}_{dtype_name}", "route": "cuda",
                            "source": source, "replaces": replaces,
                            "launches": n, **r, "library_ms": None})
    emit({"kernels": kernels})
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True,
          "device": {"platform": "gpu",
                     "kind": torch.cuda.get_device_name(0),
                     "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
