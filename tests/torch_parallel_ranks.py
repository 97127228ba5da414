"""What the ranks of ``tests/test_torch_parallel.py`` run, in processes of
their own (``parallel.multihost.spawn_ranks``, gloo on the CPU): every
function takes whole-domain inputs and a mesh shape (py, px), cuts its
rank's block, and returns what the test compares. This module imports the port alone (no JAX), so a rank
starts in about a second.
"""

import functools
import importlib
import os

import torch

from pop2_tpu_torch import sample
from pop2_tpu_torch.grid import build_aniso, build_grid
from pop2_tpu_torch.io import sharded_restart
from pop2_tpu_torch.model import Model
from pop2_tpu_torch.parallel import mesh as pmesh
from pop2_tpu_torch.parallel import multihost
from pop2_tpu_torch.reductions import global_sum
from pop2_tpu_torch.stencil import BC

STATE_FIELDS = ("tracer_cur", "u_cur", "v_cur", "psurf_cur", "ubtrop_cur",
                "vbtrop_cur", "rho_cur", "tracer_old")


def _mesh(shape, ny, nx, tripole=False, cyclic=True):
    return pmesh.make_mesh(shape, ny, nx, tripole, cyclic)


def fold_model_grid(cfg, seed):
    """The internal tripole grid of ``cfg`` on ``sample.fold_grid``'s bottom
    (ocean across the fold), its anisotropic statics rebuilt for that
    bottom: the grid a whole model runs on to see the fold."""
    grid = sample.fold_grid(cfg, build_grid(cfg, "cpu"), seed)
    if cfg.hmix_momentum == "aniso":
        grid = grid.replace(aniso=build_aniso(
            cfg, *(getattr(grid, n).numpy() for n in (
                "HTN", "HTE", "DXU", "DYU", "DXUR", "DYUR", "ULAT")),
            grid.KMU.numpy(), "cpu"))
    return grid


def b4b_sums(arrays, shape):
    """Each array's b4b sum (its trailing axes the grid) over the blocks of
    a (py, px) mesh."""
    out = []
    for a in arrays:
        d = _mesh(shape, *a.shape[-2:])
        with pmesh.scope(d):
            out.append(float(global_sum(d.slab(torch.as_tensor(a)),
                                        b4b=True)))
    return out


def wrapper_slabs(cases, shape):
    """{name: outputs gathered} of each case (name, wrapper's dotted path
    in the port, config, whole grid, whole-domain arguments, keyword
    arguments): the wrapper called on this rank's block of a (py, px) mesh
    with the decomposition in scope (its halo'd launch)."""
    out = {}
    for name, path, cfg, grid, args, kwargs in cases:
        module, fn = path.rsplit(".", 1)
        fn = getattr(importlib.import_module("pop2_tpu_torch." + module), fn)
        d = _mesh(shape, cfg.ny, cfg.nx, cfg.ns_boundary == "tripole",
                  cfg.ew_boundary == "cyclic")
        with pmesh.scope(d):
            got = fn(cfg, d.slab(grid), *d.slab(args), **d.slab(kwargs))
        out[name] = pmesh.tree_map(
            lambda t: torch.as_tensor(multihost.to_host_replicated(t, d)),
            got)
        out[name + ":exchanges"] = d.comm.exchanges
    return out


def run_model(cfg, nsteps, grid=None, tracers=None, forcing_fields=None,
              restart_dir=None):
    """``nsteps`` of ``Model.advance`` on this rank's block of ``cfg`` (on
    its ``mesh_shape``) from its initial state, with ``tracers``
    (whole domain) in place of the initial tracers and the forcing's fields
    replaced by ``forcing_fields`` (whole domain) where given. Returns the
    iterations a step, the gathered fields, the diagnostics, the exchange
    counts; with ``restart_dir`` the state is also written there as a
    sharded restart."""
    model = Model(cfg, grid=grid, device="cpu")
    d = model.mesh
    state = model.initial_state()
    if tracers is not None:
        from pop2_tpu_torch import baroclinic
        t = d.slab(torch.as_tensor(tracers))
        rho = baroclinic._masked_density(model.step_cfg, model.grid,
                                         model.ts_range, t)
        state = state.replace(tracer_cur=t, tracer_old=t, rho_cur=rho,
                              rho_old=rho)
    forcing = model.forcing
    if forcing_fields:
        forcing = forcing.replace(**d.slab(forcing_fields))
    iters = []
    d.comm.reset_counts()
    for _ in range(nsteps):
        state, diags = model.advance(state, forcing)
        iters.append(int(diags.solver_iters))
    counts = d.comm.counts()
    if restart_dir is not None:
        sharded_restart.write_sharded_restart(restart_dir, state,
                                              model.nsteps_total, cfg, d)
    return dict(iters=iters, counts=counts, diags=model.diagnostics(state),
                fields={k: multihost.to_host_replicated(getattr(state, k), d)
                        for k in STATE_FIELDS},
                block=(d.j0, d.j1, d.i0, d.i1))


def read_restart(cfg, directory):
    """This rank's block of a sharded restart, gathered, and the block it
    read."""
    d = multihost.global_mesh(cfg)
    state, n = sharded_restart.read_sharded_restart(directory, cfg, mesh=d,
                                                    device="cpu")
    return dict(n=n, slab=state, block=(d.j0, d.j1, d.i0, d.i1),
                whole={k: multihost.to_host_replicated(getattr(state, k), d)
                       for k in STATE_FIELDS})


def gather_scatter(whole, shape):
    """Round trips of a whole field through the blocks of a (py, px) mesh:
    scattered from rank 0 and from the last rank, then gathered on every
    rank."""
    d = _mesh(shape, *whole.shape[-2:])
    a = multihost.make_global_array(whole if d.rank == 0 else None, d,
                                    device="cpu")
    last = d.py * d.px - 1
    b = multihost.make_global_array(whole if d.rank == last else None, d,
                                    src=last, device="cpu")
    sl = multihost.process_local_slice(whole.shape, d)
    return dict(from_root=multihost.to_host_replicated(a, d),
                from_last=multihost.to_host_replicated(b, d),
                slab_equal=bool(torch.equal(a, torch.as_tensor(whole[sl]))),
                block=(d.j0, d.j1, d.i0, d.i1))


#: the fold's locations and kinds the shifts are held in
FOLD_CASES = [(loc, kind) for loc in ("center", "necorner", "eface", "nface")
              for kind in ("scalar", "vector")]


def shifts(f, ew, ns, shape):
    """Every shift of ``stencil.BC`` on the blocks of ``f`` on a (py, px)
    mesh: the eight neighbours, the distance-2 north shift, the fold's
    ghost rows of every location and kind, ``n_partner`` and the top row's
    symmetry; then the distance-1 shifts given their halo, all fetched in
    one exchange."""
    d = _mesh(shape, *f.shape[-2:], tripole=ns == "tripole",
              cyclic=ew == "cyclic")
    bc = BC(ew, ns)
    x = d.slab(torch.as_tensor(f))
    ops = {"n": bc.n, "s": bc.s, "e": bc.e, "w": bc.w, "ne": bc.ne,
           "nw": bc.nw, "se": bc.se, "sw": bc.sw, "nn": bc.nn,
           "n_partner": functools.partial(bc.n_partner, partner=x * 2.0,
                                          loc="nface", kind="vector"),
           "n_partner_corner": functools.partial(
               bc.n_partner, partner=x * 3.0, loc="necorner")}
    for loc, kind in FOLD_CASES:
        ops[f"n_{loc}_{kind}"] = functools.partial(bc.n, loc=loc, kind=kind)
        ops[f"nn_{loc}_{kind}"] = functools.partial(bc.nn, loc=loc,
                                                    kind=kind)
        ops[f"ne_{loc}_{kind}"] = functools.partial(bc.ne, loc=loc,
                                                    kind=kind)
        ops[f"nw_{loc}_{kind}"] = functools.partial(bc.nw, loc=loc,
                                                    kind=kind)
    from pop2_tpu_torch.tripole import enforce_top_symmetry
    with pmesh.scope(d):
        out = {k: op(x) for k, op in ops.items()}
        out["symmetry"] = enforce_top_symmetry(x)
        out["symmetry_nface"] = enforce_top_symmetry(x, "nface", "scalar")
        # the distance-1 shifts given their halo, fetched in one exchange
        e0 = d.comm.exchanges
        rows, = bc.halo([x])
        for k in ("n", "s", "e", "w", "ne", "nw", "se", "sw"):
            out["rows_" + k] = getattr(bc, k)(x, rows=rows)
        out["rows_n_corner_vec"] = bc.n(x, "necorner", "vector", rows=rows)
        exchanges = d.comm.exchanges - e0
    out = {k: multihost.to_host_replicated(v, d) for k, v in out.items()}
    out["rows_exchanges"] = exchanges
    return out


def forced_run(cfg, nsteps, inputs):
    """``nsteps`` of a forced run of ``cfg`` as a standalone caller composes
    it around ``Model.advance``, on this rank's block of its
    ``mesh_shape`` or, for ``mesh_shape`` (1, 1), on the whole domain: the
    bulk-NCEP freshwater flux (its weak restoring's global mean and the
    precipitation total) with the precipitation balance's accumulator,
    marginal-seas balancing of a region given by global (j, i) points, the
    river runoff's virtual salt flux (its global correction), the estuary
    exchange in the step, a monthly wind stress interpolated from a
    climatology, then the diagnostics, budgets and coupler exports of the
    final state. ``inputs``: whole-domain NumPy fields (qlat, precip, sss,
    ifrac, ms_mask, roff, taux, tauy) and the distribution points. Returns
    what the test compares, gathered."""
    from pop2_tpu_torch import (budget, coupled, diagnostics, estuary,
                                forcing as forcing_mod, forcing_sfwf,
                                ms_balance)
    model = Model(cfg, device="cpu")
    d = model.mesh
    cut = d.slab if d is not None else (lambda t: t)
    g = model.grid
    f = {k: cut(torch.as_tensor(v)) for k, v in inputs.items()
         if k != "dist_points"}
    region = ms_balance.build_region(g, inputs["ms_mask"],
                                     inputs["dist_points"])
    balance = forcing_sfwf.PrecipBalance(cfg, g)
    ocn_wgt = g.RCALCT * (1.0 - f["ifrac"])
    state = model.initial_state()
    iters, totals = [], []
    for n in range(nsteps):
        sfc = state.tracer_cur[:, 0]
        out = forcing_sfwf.sfwf_bulk_ncep(
            cfg, g, f["qlat"], f["precip"], f["sss"], sfc[1], sfc[0],
            ocn_wgt, mask_sr=1.0 - region.ms_mask,
            precip_fact=balance.precip_fact)
        balance.accumulate(out.precip_total, cfg.time.dtt)
        salt = ms_balance.ms_balancing(cfg, g, out.stf_salt, [region])
        salt = salt + estuary.river_vsf(cfg, g, f["roff"], sfc[1])
        stf = model.forcing.stf.clone()
        stf[1] = salt
        forcing = forcing_mod.file_wind_stress(
            cfg, g, model.forcing, f["taux"], f["tauy"], 300.0 + 200.0 * n)
        forcing = forcing.replace(stf=stf, roff_f=f["roff"])
        state, diags = model.advance(state, forcing)
        iters.append(int(diags.solver_iters))
        totals.append(float(out.precip_total))
    gather = (functools.partial(multihost.to_host_replicated, mesh=d)
              if d is not None else (lambda t: t.numpy()))
    return dict(
        iters=iters, precip_totals=totals,
        fields={k: gather(getattr(state, k)) for k in STATE_FIELDS},
        smft=gather(forcing.smft),
        region=[gather(region.ms_mask), gather(region.dist_frac),
                float(region.ms_area)],
        balance=[balance.area_t, balance.volume_t_k.tolist(),
                 balance.salinity_means(g, state.tracer_cur[1]).tolist(),
                 balance.sum_precip],
        diagnostics=diagnostics.global_diagnostics(cfg, g, state),
        cfl=diagnostics.cfl_numbers(cfg, g, state),
        transports=[diagnostics.zonal_transport(cfg, g, state, 7),
                    *(t.tolist() if hasattr(t, "tolist") else t
                      for t in diagnostics.meridional_transport(
                          cfg, g, state, 6)[1:]),
                    diagnostics.moc_streamfunction(cfg, g, state,
                                                   6)[1].tolist()],
        budget=[budget.tracer_totals(cfg, g, state).tolist(),
                float(budget.ocean_volume(cfg, g, state)),
                budget.surface_flux_integral(cfg, g, forcing).tolist()],
        export={k: gather(v) for k, v in coupled.ocn_export(
            cfg, g, state).items()},
        global_index=global_index_diagnostics(cfg, g, state, gather))


#: sections of the global-index diagnostics on 'mini' (32 x 24): each
#: crosses the edges of the (2, 2), (1, 4) and two-slab blocks
SECTIONS = [(2, 5, 2, 5, 0, 3, "merid", "s"),
            (7, 9, 10, 14, 0, 7, "merid", "across"),
            (14, 18, 11, 11, 1, 6, "zonal", "row"),
            (3, 25, 6, 13, 0, 7, "zonal", "wide")]


def global_index_diagnostics(cfg, grid, state, gather):
    """Each of SECTIONS' transports and the barotropic streamfunction
    (gathered) of ``state``."""
    from pop2_tpu_torch import diagnostics
    return dict(
        sections=[diagnostics.section_transport(
            cfg, grid, state, diagnostics.TransportSection(*sec))
            for sec in SECTIONS],
        bsf=gather(diagnostics.barotropic_streamfunction(cfg, grid, state)))


def _whole(t):
    return t.detach().cpu().numpy()


def _read_files(paths):
    """{file name: bytes} of the files this rank finds (rank 0 writes)."""
    out = {}
    for p in paths:
        if os.path.exists(p):
            with open(p, "rb") as f:
                out[os.path.basename(p)] = f.read()
    return out


def stream_run(cfg, nsteps, outdir, tavg_fields, compiled=True, freq=4,
               tracers=None, forcing_fields=None, history=(), movie=(),
               snap_freq=5):
    """``nsteps`` of ``cfg`` on this rank's block of its ``mesh_shape`` (on
    the whole domain for (1, 1), in the caller's process) through
    ``Model.run_compiled`` (or ``run``), with a tavg stream of
    ``tavg_fields`` every ``freq`` steps and, where named, history and
    movie streams every ``snap_freq``, all into ``outdir``. Returns the
    gathered state, the files' bytes (rank 0's), the stream's partial
    accumulation (rank 0's), the global-index diagnostics, the captured
    step's graphs and why it was not captured, and the exchange counts."""
    model = Model(cfg, device="cpu")
    d = model.mesh if model.mesh is not None and model.mesh.comm else None
    cut = d.slab if d is not None else (lambda t: t)
    gather = (functools.partial(multihost.to_host_replicated, mesh=d)
              if d is not None else _whole)
    state = model.initial_state()
    if tracers is not None:
        from pop2_tpu_torch import baroclinic
        t = cut(torch.as_tensor(tracers).to(cfg.torch_dtype))
        rho = baroclinic._masked_density(model.step_cfg, model.grid,
                                         model.ts_range, t)
        state = state.replace(tracer_cur=t, tracer_old=t, rho_cur=rho,
                              rho_old=rho)
    forcing = model.forcing
    if forcing_fields:
        forcing = forcing.replace(**{
            k: cut(torch.as_tensor(v).to(cfg.torch_dtype))
            for k, v in forcing_fields.items()})
    os.makedirs(outdir, exist_ok=True)
    stream = model.enable_tavg(list(tavg_fields), freq_steps=freq,
                               outdir=outdir)
    if history:
        model.enable_history(list(history), freq_steps=snap_freq,
                             outdir=outdir)
    if movie:
        model.enable_movie(list(movie), freq_steps=snap_freq,
                           outdir=outdir, level=1)
    if d is not None:
        d.comm.reset_counts()
    if compiled:
        state, _ = model.run_compiled(state, nsteps, forcing)
    else:
        state = model.run(state, nsteps, forcing)
    cap = model._captured
    partial = stream.averages()
    return dict(
        fields={k: gather(getattr(state, k)) for k in STATE_FIELDS},
        files=_read_files(model.tavg_files),
        names=[os.path.basename(p) for p in model.tavg_files],
        nsamples=stream.nsamples, partial=partial,
        diags=model.diagnostics(state),
        global_index=global_index_diagnostics(model.step_cfg, model.grid,
                                              state, gather),
        graphs=None if cap is None else cap.graphs,
        uncaptured=None if cap is None else cap.uncaptured,
        counts=d.comm.counts() if d is not None else None)


def cap_run(cfg, x2o, outdir, resume_shape=None, nsteps=2):
    """The coupler cap on this rank's block of ``cfg.mesh_shape`` (the
    whole domain for (1, 1)): two coupling intervals of ``nsteps`` steps
    under ``x2o[0]`` and ``x2o[1]`` (whole-domain SI fields, which the cap
    cuts to the block), a restart requested at the second's end, then a
    cap on ``resume_shape`` (the same shape by default) started from that
    restart for a third interval under ``x2o[2]``. Returns each export
    gathered and the final state gathered."""
    from pop2_tpu_torch.ocn_component import OcnComponent

    def cap(c):
        return OcnComponent(c, coupling_freq_opt="nstep",
                            coupling_freq=nsteps, outdir=outdir,
                            device="cpu")

    def fields(v):
        return {k: torch.as_tensor(a).to(cfg.torch_dtype)
                for k, a in v.items()}
    first = cap(cfg)
    exports = [first.gather_export(first.initialize())]
    exports.append(first.gather_export(first.run(fields(x2o[0]))))
    exports.append(first.gather_export(first.run(fields(x2o[1]),
                                                 rstwr=True)))
    flags = [first.model.time_manager.check_time_flag("cpl_ts")]
    second = cap(cfg.with_(mesh_shape=tuple(resume_shape
                                            or cfg.mesh_shape)))
    second.initialize(restart_dir=outdir)
    resumed_at = second.model.nsteps_total
    exports.append(second.gather_export(second.run(fields(x2o[2]))))
    d = second.mesh
    gather = (functools.partial(multihost.to_host_replicated, mesh=d)
              if d is not None else _whole)
    return dict(exports=exports, resumed_at=resumed_at, flags=flags,
                fields={k: gather(getattr(second.state, k))
                        for k in STATE_FIELDS},
                restart_files=[os.path.basename(p)
                               for p in first.restart_files])


def overflow_run(cfg, nsteps, tracers):
    """``nsteps`` of ``Model.advance`` of an overflow configuration on this
    rank's block of its ``mesh_shape`` from ``tracers`` (whole domain),
    with the blocks each of its regions' boxes meets. Returns the gathered
    fields and iterations."""
    out = run_model(cfg, nsteps, tracers=tracers)
    model_cfg = cfg
    boxes = [(b.jmin, b.jmax, b.imin, b.imax) for spec in model_cfg.overflows
             for b in (spec.inf, spec.src, spec.ent, spec.prd)]
    j0, j1, i0, i1 = out["block"]
    out["meets"] = [max(a, j0) <= min(b, j1 - 1) and max(c, i0)
                    <= min(e, i1 - 1) for a, b, c, e in boxes]
    return out


def suite(calls):
    """[fn(*args, **kwargs) for fn, args, kwargs in calls]: the checks of
    one start of the ranks."""
    return [fn(*args, **kwargs) for fn, args, kwargs in calls]


def suite_results(per_rank, calls):
    """Each rank's ``suite`` results keyed by the calls' names."""
    return [{c[0]: r for c, r in zip(calls, res)} for res in per_rank]

