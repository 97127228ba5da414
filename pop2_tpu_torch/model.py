"""Top-level model driver: wiring of grid, forcing, state and the step, the
time manager's step-type policy, and the run loops.

Replaces the reference's driver layer (``drivers/mct/ocn_comp_mct.F90`` run
loop + ``source/time_management.F90`` switches) for standalone runs:
Euler-forward first step, leapfrog afterwards, and the 'avg' policy
(averaging filter every ``time_mix_freq`` steps,
source/time_management.F90:2157-2175), 'avgfit' (the same within each
coupling interval, its timestep fitted, :2195-2213) or 'robert' (the Robert
filter inside every step). The calendar (``time_management.TimeManager``)
advances once a step, by half a step on averaging steps. With
``preconditioner='fspai'`` or ``'spai'`` the barotropic preconditioner's
9-point stencil is built once here, on the host in float64 from the
operator of the 2-D solve (the float64 operator under
``solve_dtype='float64'``); with ``'file'`` it is read from the config's
``preconditioner_file`` (an .npz of ``solvers.Precond9``'s fields).

``advance``/``run`` take one eager step at a time. ``run_compiled`` (the JAX
package's ``lax.scan`` loop) runs the Euler first step and the averaging
steps eagerly and every plain leapfrog step through ``graphs.CapturedStep``:
on the GPU CUDA graphs of the step's segments, whose only host reads are
the solver's convergence checks.

Output streams (``enable_tavg``, ``enable_history``, ``enable_movie``;
source/tavg.F90, history.F90, movie.F90) are served by the per-step hook
``_output_driver`` (history -> movie -> tavg, output.F90:53), which
``advance`` calls with the step's extras whenever a stream exists.
``run_compiled`` keeps the JAX package's policy: snapshot streams, or a tavg
stream scheduled on the calendar, take every step through ``advance``;
step-frequency tavg streams accumulate inside the captured step, and a
stream is written (and reset) on the host after the step that fills it.

``Model(cfg)`` runs on the GPU: the default device is ``cuda`` and a machine
without one gets an error, not a silent CPU run. ``Model(cfg, device="cpu")``
runs the same code with the kernels' plain PyTorch versions.

Under ``mesh_shape = (py, px)`` (``parallel.mesh``) the model is one rank's
block: it is built on the whole domain as above (the grid and its host
precomputations, KPP's statics, the preconditioner, PCSI's bounds and
table), rank 0's set-up scalars are broadcast so every rank holds the same
bits, and then every horizontal field is cut to the block (``_decompose``).
``advance`` runs the step with the decomposition in scope: shifts and the
kernels take halo rows and columns from the neighbouring blocks (the
tripole fold's from the mirror block), global
sums are reduced over the ranks, and ``diagnostics`` reduces globally, so
every rank decides alike. ``run_compiled`` runs its segments there without
capture (gloo's exchanges are host calls, which no CUDA graph holds;
``graphs.CapturedStep``); the output streams accumulate each rank's block
and gather the blocks on rank 0, which writes one whole-domain file
(``tavg.TavgStream``, ``history``). Every rank calls every entry point
alike: the exchanges and gathers are collective. Ranks with a card each
(NCCL) are refused (ROADMAP.md Queue 1 item 12b, across cards).

Under ``mesh_shape = (py, px)`` with no process group, ``Model(cfg)`` is a
``MeshModel``: every block in this process on one device, as the JAX
package runs its mesh, the whole-domain model cut py px times, the caller's
state the whole domain's, and ``run_compiled`` captured across the blocks
(``graphs.MeshCapturedStep``).
"""

from __future__ import annotations

import copy
import math
from typing import Dict, List, Optional, Tuple

import torch

from pop2_tpu_torch import constants as const
from pop2_tpu_torch import eos, graphs, kpp, overflows, solvers
from pop2_tpu_torch import step as step_mod, sw_absorption, tidal_mixing
from pop2_tpu_torch.passive_tracers import PassiveTracers
from pop2_tpu_torch.barotropic import diagonal_correction
from pop2_tpu_torch.config import ModelConfig
from pop2_tpu_torch.forcing import Forcing, analytic_forcing
from pop2_tpu_torch.grid import Grid, build_grid, grid_bc, resolve_device
from pop2_tpu_torch.parallel import mesh as pmesh
from pop2_tpu_torch.reductions import global_max, global_sum
from pop2_tpu_torch.state import State, initial_state
from pop2_tpu_torch.supported import check_supported
from pop2_tpu_torch.time_management import TimeManager


class Model:
    """Standalone ocean model instance on one device: the whole domain, or
    under ``mesh_shape = (py, px)`` this rank's block of it (``mesh``: the
    ``parallel.mesh.Decomposition``; default: the process group's, from
    ``parallel.multihost.global_mesh``)."""

    #: the plain leapfrog steps of ``run_compiled``
    _captured_step = graphs.CapturedStep

    def __init__(self, cfg: ModelConfig, grid: Optional[Grid] = None,
                 device="cuda", mesh: Optional[pmesh.Decomposition] = None):
        check_supported(cfg)
        if mesh is None and tuple(cfg.mesh_shape) != (1, 1):
            from pop2_tpu_torch.parallel import multihost
            mesh = multihost.global_mesh(cfg)
        self.mesh = mesh
        device = resolve_device(device)
        if cfg.overflows and grid is None:
            # the overflow point data must agree with the topography
            # (init_overflows_kmt, source/overflows.F90:1196-1275): strict
            # mode raises, otherwise the inconsistent overflows are
            # deactivated with a warning, as in the JAX package
            cfg = overflows.validate_geometry(cfg)
        self.cfg = cfg
        self.device = device
        self.grid = (grid.to(device) if grid is not None
                     else build_grid(cfg, device))
        self.bc = grid_bc(cfg)
        self.ts_range = (
            eos.build_ts_range(self.grid.vgrid.zt.double().cpu().numpy(),
                               cfg.torch_dtype, device)
            if cfg.state_range_opt == "enforce" else None)
        self.forcing = analytic_forcing(cfg, self.grid)
        self.nsteps_total = 0
        self.time_manager = TimeManager(
            cfg.time.dtt, start_year=cfg.time.start_year,
            start_month=cfg.time.start_month, start_day=cfg.time.start_day,
            allow_leapyear=cfg.time.allow_leapyear)
        # the lunar factor of the tidal energy: one 0-d device tensor,
        # refilled from the calendar before every step (``_lunar_forcing``),
        # in the model's forcing before any capture
        self._lnc = None
        if cfg.ltidal_mixing and cfg.ltidal_lunar_cycle:
            self._lnc = torch.zeros((), dtype=cfg.torch_dtype, device=device)
            self.forcing = self._lunar_forcing(self.forcing)
        # the captured leapfrog step of run_compiled, made once an eager
        # leapfrog step has built every lazily made operand
        self._captured: Optional[graphs.CapturedStep] = None
        self._eager_leapfrog_done = False
        # output streams and the files they wrote
        self.tavg_streams = []
        self.history_streams = []
        self._tavg_outdir = "."
        self.tavg_files = []
        self.sw_profile = (sw_absorption.absorb_profile(cfg, self.grid)
                           if cfg.sw_absorption == "jerlov" else None)
        # KPP's background profiles, surface-layer pair weights and tidal
        # coefficient, built once
        self.kpp_statics = (kpp.build_statics(cfg, self.grid)
                            if cfg.vmix == "kpp" else None)
        self.passive = (PassiveTracers(cfg, cfg.passive_tracers)
                        if cfg.passive_tracers else None)
        self.ovf_statics = None
        if cfg.overflows:
            self.ovf_statics = overflows.build_statics(cfg, self.grid)
            # the overflow columns fold into the barotropic operator weights
            # (ovf_solvers_9pt, source/overflows.F90:5515-5728), before the
            # preconditioner and the eigenvalue bounds below
            self.grid = overflows.solvers_9pt(cfg, self.grid)
        solve64 = (cfg.solver.solve_dtype == "float64"
                   and cfg.torch_dtype != torch.float64)

        def operator(leapfrog):
            op = solvers.make_operator(
                self.grid, diagonal_correction(cfg, self.grid, leapfrog))
            return op.to(torch.float64) if solve64 else op

        # the barotropic preconditioner's stencil, built once on the host in
        # float64 from the leapfrog operator (the Euler first step reuses
        # it) and kept in the solve's dtype: the factored SPAI (SPD by
        # construction), the plain SPAI, or a stencil read from the file
        # the config names (without one, the diagonal preconditioner, as in
        # the JAX package)
        self.precond = None
        choice = cfg.solver.preconditioner.lower()
        if choice == "file" and cfg.solver.preconditioner_file:
            self.precond = solvers.load_precond(
                cfg.solver.preconditioner_file,
                torch.float64 if solve64 else cfg.torch_dtype, device)
        elif choice == "fspai":
            self.precond = solvers.build_fspai9(cfg, operator(True))
        elif choice == "spai":
            self.precond = solvers.build_spai9(cfg, operator(True))
        # PCSI eigenvalue bounds and the recurrence's coefficient table are
        # prepared once per leapfrog flag: the diagonal correction is a pure
        # function of (cfg, grid, leapfrog)
        self._pcsi_eigs: Dict[bool, solvers.PCSIBounds] = {}
        if cfg.solver.choice.lower() == "pcsi":
            for leapfrog in (False, True):
                op = operator(leapfrog)
                emin, emax = (
                    solvers.pcg_lanczos_eigs(cfg, op, self.bc, self.precond)
                    if self.precond is not None
                    else solvers.lanczos_eigs(cfg, op, self.bc))
                self._pcsi_eigs[leapfrog] = solvers.PCSIBounds(
                    emin, emax, solvers.pcsi_table(
                        cfg, emin, emax, op.center.dtype, device))
        # the model of the whole domain, or of this rank's block
        self.step_cfg = cfg
        self._state0 = None
        if mesh is not None:
            self._decompose(mesh)

    def __new__(cls, cfg: ModelConfig, grid: Optional[Grid] = None,
                device="cuda", mesh=None):
        # a mesh of several blocks and no process group: every block in
        # this process (``MeshModel``)
        if cls is Model and (isinstance(mesh, pmesh.LocalMesh)
                             or (mesh is None and one_process_mesh(cfg))):
            cls = MeshModel
        return super().__new__(cls)

    def _decompose(self, mesh: pmesh.Decomposition,
                   state0: Optional[State] = None) -> None:
        """Cut the whole-domain model to ``mesh``'s block: rank 0's residual
        norm and PCSI bounds broadcast (every rank's solve then stops at
        the same iteration), the initial state made on the whole grid, and
        every horizontal field of the grid, the forcing, the statics and
        the preconditioner cut to the block. The step sees the block's
        config, ny and nx its rows and columns (the edges stay the whole
        domain's: the stencil and the fold ask the decomposition where an
        edge is)."""
        cfg = self.cfg
        if mesh.ny != cfg.ny or mesh.nx != cfg.nx:
            raise ValueError(f"mesh of {mesh.ny}x{mesh.nx} for a "
                             f"{cfg.ny}x{cfg.nx} grid")
        scalars = [float(self.grid.residual_norm)]
        for leapfrog in (False, True):
            if leapfrog in self._pcsi_eigs:
                scalars += self._pcsi_eigs[leapfrog][:2]
        # a rank's own build may round apart from rank 0's: its set-up
        # scalars are rank 0's
        broadcast = mesh.comm is not None and not mesh.comm.shares_build
        if broadcast:
            scalars = mesh.comm.broadcast_floats(scalars)
        self._state0 = mesh.slab(self.initial_state() if state0 is None
                                 else state0)
        for leapfrog, at in ((False, 1), (True, 3)):
            if broadcast and leapfrog in self._pcsi_eigs:
                emin, emax = scalars[at:at + 2]
                table = self._pcsi_eigs[leapfrog].table
                self._pcsi_eigs[leapfrog] = solvers.PCSIBounds(
                    emin, emax, solvers.pcsi_table(
                        cfg, emin, emax, table.dtype, table.device))
        # the block grid carries its decomposition, so what a caller gives
        # it outside a step (the forcing's builders, the diagnostics)
        # reduces over every block (``parallel.mesh.grid_scope``)
        self.grid = pmesh.attach(mesh.slab(self.grid), mesh)
        self.grid.__dict__["_residual_norm_host"] = scalars[0]
        self.forcing = mesh.slab(self.forcing)
        self.precond = mesh.slab(self.precond)
        self.kpp_statics = mesh.slab(self.kpp_statics)
        self.sw_profile = mesh.slab(self.sw_profile)
        self.ovf_statics = overflows.decompose_statics(self.ovf_statics,
                                                       mesh)
        self.step_cfg = pmesh.block_cfg(cfg, mesh.rows, mesh.cols)

    def _block(self, mesh: pmesh.Decomposition, state0: State) -> "Model":
        """A model of ``mesh``'s block cut from this whole-domain model
        (which stays as it is): its own calendar, streams, captured step
        and lunar-factor tensor, and the whole domain's fields cut to the
        block (``_decompose``), the initial state from ``state0``."""
        block = object.__new__(Model)
        block.__dict__.update(self.__dict__)
        block.mesh = mesh
        block.time_manager = copy.deepcopy(self.time_manager)
        block._pcsi_eigs = dict(self._pcsi_eigs)
        block._captured = None
        block._eager_leapfrog_done = False
        block.tavg_streams, block.history_streams = [], []
        block.tavg_files = []
        if self._lnc is not None:
            block._lnc = torch.zeros_like(self._lnc)
            block.forcing = self.forcing.replace(tidal_lnc=block._lnc)
        block._decompose(mesh, state0)
        return block

    # -- time manager (source/time_management.F90:2157-2234) ----------------
    def step_flags(self, nsteps_total: int) -> Tuple[bool, bool]:
        """(leapfrog, avg_ts) for 1-based step number ``nsteps_total``."""
        leapfrog = nsteps_total != 1
        avg_ts = False  # robert filtering happens inside every step
        tm = self.cfg.time
        if tm.time_mix_opt == "avg":
            avg_ts = (nsteps_total % tm.time_mix_freq == 0
                      and nsteps_total > 1)
        elif tm.time_mix_opt == "avgfit":
            # averaging at step 2 of each interval and every time_mix_freq
            # steps within it, never on the interval's last step
            # (set_switches, source/time_management.F90:2195-2213)
            _, _, n, _ = tm.avgfit_params()
            nsti = (nsteps_total - 1) % n + 1
            avg_ts = (nsteps_total > 1
                      and (nsti == 2 or (nsti % tm.time_mix_freq == 0
                                         and nsti != n)))
        return leapfrog, avg_ts

    def initial_state(self) -> State:
        self.nsteps_total = 0
        self.time_manager.reset()
        if self._state0 is not None:  # the block of the whole domain's
            return self._state0
        return initial_state(self.cfg, self.grid, self.device,
                             passive=self.passive)

    def _next_step(self) -> Tuple[bool, bool]:
        """Count the step and advance the calendar; its (leapfrog,
        avg_ts)."""
        self.nsteps_total += 1
        leapfrog, avg_ts = self.step_flags(self.nsteps_total)
        # averaging steps are half steps on the calendar
        # (source/time_management.F90:1854-1858)
        self.time_manager.advance(
            0.5 * self.cfg.time.dtt if avg_ts else None)
        return leapfrog, avg_ts

    def lunar_factor(self) -> float:
        """The lunar nodal factor of the tidal energy at the calendar's
        date (``tidal_mixing.lunar_nodal_modulation``)."""
        return tidal_mixing.lunar_nodal_modulation(
            self.time_manager.calendar.year_fraction)

    def _lunar_forcing(self, forcing: Forcing) -> Forcing:
        """``forcing`` with the next step's lunar factor, read from the
        calendar before the step advances it (the JAX package's
        ``advance``), under ``ltidal_lunar_cycle``; else ``forcing``. The
        factor is written into the model's one device tensor (a fill, no
        host-device copy), which the captured step copies into its static
        buffer before each replay."""
        if self._lnc is None:
            return forcing
        self._lnc.fill_(self.lunar_factor())
        return forcing.replace(tidal_lnc=self._lnc)

    def step_args(self, leapfrog: bool):
        """The step's keyword arguments after (leapfrog, avg_ts)."""
        return dict(pcsi_eigs=self._pcsi_eigs.get(leapfrog),
                    precond=self.precond, sw_profile=self.sw_profile,
                    kpp_statics=self.kpp_statics, passive=self.passive,
                    ovf_statics=self.ovf_statics)

    # -- output streams (source/tavg.F90, history.F90, movie.F90) -----------
    def _streams_changed(self) -> None:
        """A new stream set: the captured step is captured again, after an
        eager leapfrog step has built what the new streams read (the JAX
        package rebuilds its scan, ``_scan_tavg_fn = None``)."""
        self._captured = None
        self._eager_leapfrog_done = False

    def _register_stream_flag(self, stream, kind: str, prefix: str,
                              freq_opt, freq: int):
        """Calendar-based scheduling: register a time flag for the stream
        (each reference stream owns a time flag, source/tavg.F90:569-585)."""
        if freq_opt is None:
            stream.flag_name = None
            return
        stream.flag_name = f"{kind}:{prefix}"
        self.time_manager.init_time_flag(stream.flag_name, freq_opt, freq,
                                         owner=kind)

    def enable_tavg(self, contents, freq_steps: int = 0, outdir: str = ".",
                    prefix: str = "tavg", freq_opt: str = None,
                    freq: int = 1):
        """Add a tavg output stream (source/tavg.F90 stream mechanism).
        Schedule by step count (``freq_steps``) or by calendar frequency
        (``freq_opt`` in nyear/nmonth/nday/nhour/nsecond/nstep + ``freq``).
        An unknown field raises KeyError. Under a decomposition each rank
        accumulates its block and rank 0 writes the whole domain's file."""
        from pop2_tpu_torch.tavg import TavgStream
        stream = TavgStream(self.cfg, self.grid, contents,
                            freq_steps if freq_opt is None else 10 ** 9,
                            outfile_prefix=prefix, mesh=self.mesh)
        self._register_stream_flag(stream, "tavg", prefix, freq_opt, freq)
        self.tavg_streams.append(stream)
        self._tavg_outdir = outdir
        self._streams_changed()
        return stream

    def enable_history(self, contents, freq_steps: int = 0,
                       outdir: str = ".", prefix: str = "pop2_tpu.h",
                       freq_opt: str = None, freq: int = 1):
        """Add an instantaneous snapshot stream (source/history.F90)."""
        from pop2_tpu_torch.history import HistoryStream
        stream = HistoryStream(self.cfg, self.grid, contents, freq_steps,
                               outfile_prefix=prefix, mesh=self.mesh)
        self._register_stream_flag(stream, "history", prefix, freq_opt, freq)
        self.history_streams.append(stream)
        self._tavg_outdir = outdir
        self._streams_changed()
        return stream

    def enable_movie(self, contents, freq_steps: int = 0, outdir: str = ".",
                     level: int = 0, prefix: str = "pop2_tpu.m",
                     freq_opt: str = None, freq: int = 1):
        """Add a 2-D snapshot stream (source/movie.F90)."""
        from pop2_tpu_torch.history import MovieStream
        stream = MovieStream(self.cfg, self.grid, contents, freq_steps,
                             level=level, outfile_prefix=prefix,
                             mesh=self.mesh)
        self._register_stream_flag(stream, "movie", prefix, freq_opt, freq)
        self.history_streams.append(stream)
        self._tavg_outdir = outdir
        self._streams_changed()
        return stream

    def _stream_due(self, stream):
        """Calendar-flag scheduling when the stream registered one
        (time-flag service, source/time_management.F90:2241-3021);
        otherwise None (step-frequency)."""
        flag = getattr(stream, "flag_name", None)
        if flag is not None:
            return self.time_manager.check_time_flag(flag)
        return None

    def _write_if(self, stream, due: bool) -> None:
        """Write a due tavg stream that holds samples, and reset it."""
        if due and stream.nsamples > 0:
            self.tavg_files.append(stream.write(self._tavg_outdir,
                                                self.nsteps_total))
            stream.reset()

    def _output_driver(self, state: State, forcing: Forcing, extras: dict):
        """Per-step output hook: history -> movie -> tavg
        (output_driver, source/output.F90:53), with the decomposition in
        scope (the fields' shifts take their halos, a write gathers the
        blocks)."""
        from pop2_tpu_torch.tavg import TavgAux
        aux = TavgAux(forcing=forcing, bc=self.bc, **(extras or {}),
                      memo={})
        with pmesh.scope(self.mesh):
            self._drive_streams(state, aux)

    def _write_ready(self) -> None:
        """Write the tavg streams that a captured step filled."""
        with pmesh.scope(self.mesh):
            for stream in self.tavg_streams:
                self._write_if(stream, stream.ready)

    def _drive_streams(self, state: State, aux) -> None:
        for stream in self.history_streams:
            stream.aux = aux
            due = self._stream_due(stream)
            if due is None:
                due = stream.due(self.nsteps_total)
            if due:
                self.tavg_files.append(
                    stream.write(self._tavg_outdir, state,
                                 self.nsteps_total))
        for stream in self.tavg_streams:
            stream.accumulate(state, aux)
            due = self._stream_due(stream)
            self._write_if(stream, stream.ready if due is None else due)

    def advance(self, state: State, forcing: Optional[Forcing] = None):
        """Advance one step; returns (state, StepDiagnostics). With output
        streams the step returns its extras and the output hook runs."""
        forcing = self._lunar_forcing(forcing or self.forcing)
        leapfrog, avg_ts = self._next_step()
        with_output = bool(self.tavg_streams or self.history_streams)
        with pmesh.scope(self.mesh):
            out = step_mod.step(self.step_cfg, self.grid, self.bc,
                                self.ts_range, state, forcing, leapfrog,
                                avg_ts, **self.step_args(leapfrog),
                                with_extras=with_output)
        self._eager_leapfrog_done |= leapfrog
        if with_output:
            state, diags, extras = out
            self._output_driver(state, forcing, extras)
            return state, diags
        return out

    def run(self, state: State, nsteps: int,
            forcing: Optional[Forcing] = None) -> State:
        for _ in range(nsteps):
            state, _ = self.advance(state, forcing)
        return state

    def run_compiled(self, state: State, nsteps: int,
                     forcing: Optional[Forcing] = None):
        """Advance ``nsteps``: the Euler first step and averaging steps
        through ``advance``, every plain leapfrog step through the captured
        step (``graphs.CapturedStep``: on the GPU CUDA graphs, captured at
        the first plain leapfrog step after an eager leapfrog step; on the
        CPU the same segments called without capture). Step-frequency tavg
        streams accumulate inside the captured step; a full stream is
        written after the step that filled it. Snapshot streams and
        calendar-scheduled tavg streams need the host every step: then
        every step goes through ``advance``. Under ``ltidal_lunar_cycle``
        the lunar factor is read from the calendar before every step and
        copied into the captured step's static forcing buffer before its
        replay. A forcing whose set of tensor fields differs from the one
        the step was captured with builds a new captured step. Under a
        decomposition over gloo the segments run uncaptured on every rank
        (``graphs.CapturedStep.uncaptured``: the exchanges are host calls);
        over NCCL this raises (ROADMAP.md Queue 1 item 12b, across cards).
        A one-process mesh (``MeshModel``) runs the same loop over every
        block (``graphs.MeshCapturedStep``). Returns (state, diagnostics of
        the last step). The state returned is the caller's own; the graphs'
        buffers stay inside the model."""
        if pmesh.over_ranks(self.mesh) and self.mesh.comm.backend == "nccl":
            pmesh.refuse_across_cards("run_compiled's captured step over "
                                      "NCCL")
        forcing = forcing or self.forcing
        diags = None
        if self.history_streams or any(s.flag_name
                                       for s in self.tavg_streams):
            for _ in range(nsteps):
                state, diags = self.advance(state, forcing)
            return state, diags
        in_graph = False  # the state lies in the captured step's buffers
        for _ in range(nsteps):
            leapfrog, avg_ts = self.step_flags(self.nsteps_total + 1)
            if leapfrog and not avg_ts and (self._captured is not None
                                            or self._eager_leapfrog_done):
                step_forcing = self._lunar_forcing(forcing)
                if self._captured is not None \
                        and not self._captured.accepts(step_forcing):
                    # another set of forcing fields: its buffers differ, so
                    # the step is built and captured again (the JAX
                    # package traces its scan again)
                    if in_graph:
                        state, in_graph = self._captured.export(), False
                    self._captured = None
                if self._captured is None:
                    self._captured = self._captured_step(self, state,
                                                         step_forcing)
                if not in_graph:
                    self._captured.load(state)
                    in_graph = True
                self._next_step()
                self._captured.step(step_forcing)
                self._write_ready()
                diags = None
                continue
            if in_graph:
                state, in_graph = self._captured.export(), False
            state, diags = self.advance(state, forcing)
        if in_graph:
            state, diags = self._captured.export(), \
                self._captured.diagnostics()
        return state, diags

    # -- diagnostics (source/diagnostics.F90:1174-, check_KE :3260) ---------
    def diagnostics(self, state: State) -> Dict[str, float]:
        """Global means and maxima; under a decomposition reduced over the
        ranks (b4b sums under ``cfg.b4b``), so every rank reads the same
        values."""
        g = self.grid
        b4b = self.cfg.b4b
        dz = g.vgrid.dz.reshape(-1, 1, 1)
        wu = torch.where(g.kmask_u, dz * g.UAREA, 0.0)
        wt = torch.where(g.kmask_t, dz * g.TAREA, 0.0)
        with pmesh.scope(self.mesh):
            def total(x):
                return global_sum(x, b4b=b4b)
            ke = 0.5 * total(wu * (state.u_cur ** 2 + state.v_cur ** 2)) \
                / total(wu)
            tvol = total(wt)
            tmean = total(wt * state.tracer_cur[0]) / tvol
            smean = total(wt * state.tracer_cur[1]) / tvol
            ssh = torch.sqrt(total((state.psurf_cur / const.GRAV) ** 2
                                   * g.RCALCT) / total(g.RCALCT))
            umax = global_max(torch.abs(state.u_cur))
        return {
            "KE": float(ke),
            "TEMP_mean": float(tmean),
            "SALT_mean": float(smean) * const.SALT_TO_PPT,
            "SSH_rms_cm": float(ssh),
            "U_max": float(umax),
        }

    def check_ke(self, state: State, ke_limit: float = 100.0) -> None:
        """Blow-up guard (source/diagnostics.F90:3260)."""
        ke = self.diagnostics(state)["KE"]
        if not math.isfinite(ke) or ke > ke_limit:
            raise FloatingPointError(
                f"KE blow-up detected: KE={ke} exceeds {ke_limit} cm^2/s^2")


def one_process_mesh(cfg: ModelConfig) -> bool:
    """``cfg`` runs on a mesh of several blocks in this process
    (``MeshModel``): its ``mesh_shape`` is not (1, 1) and no process group
    exists."""
    import torch.distributed as dist
    return tuple(cfg.mesh_shape) != (1, 1) and not (
        dist.is_available() and dist.is_initialized())


#: the attributes of a ``MeshModel`` that are its blocks' (block 0's: the
#: blocks step alike), not the whole-domain model's
_OF_THE_BLOCKS = ("nsteps_total", "time_manager", "tavg_streams",
                  "history_streams", "tavg_files", "_eager_leapfrog_done")


class MeshModel(Model):
    """``Model`` over a (py, px) mesh in one process, as the JAX package
    runs ``mesh_shape`` on the devices of one process: every block on one
    device (``device``: the card, or 'cpu'; a list of a device a block must
    name one card, ``parallel.mesh.refuse_across_cards``), a thread a block
    (``parallel.mesh.LocalMesh``), their halo exchanges and global sums
    device copies (``mesh.LocalComm``). ``Model(cfg)`` is one where
    ``cfg.mesh_shape`` is not (1, 1) and no process group exists.

    The whole-domain model is built once (grid, statics, preconditioner,
    PCSI's bounds and table) and cut py px times (``Model._block``); this
    object keeps the whole domain's grid, forcing and config, so what a
    caller makes from them is the whole domain's. The caller's state is the
    whole domain's, as a JAX global array is: ``advance`` cuts it to the
    blocks, runs every block's step at once and joins the blocks' new
    states; ``run_compiled`` cuts it once, steps the blocks' static buffers
    (``graphs.MeshCapturedStep``: on the card CUDA graphs that hold every
    block and every exchange) and joins them once. The streams
    (``enable_tavg``, ``enable_history``, ``enable_movie``) are made on
    every block; each write gathers the blocks' buffers on block 0 on the
    device and writes one whole-domain file (``tavg_files``). Each block's
    launches are counted apart (``launch_counts``; ``block_counts``), and
    each reads as the whole domain's."""

    _captured_step = graphs.MeshCapturedStep

    def __init__(self, cfg: ModelConfig, grid: Optional[Grid] = None,
                 device="cuda", mesh=None):
        shape = tuple(cfg.mesh_shape)
        devices = (list(device) if isinstance(device, (list, tuple))
                   else None)
        if mesh is None:
            mesh = pmesh.make_mesh(
                shape, cfg.ny, cfg.nx,
                tripole=cfg.ns_boundary == "tripole",
                cyclic=cfg.ew_boundary == "cyclic",
                devices=devices)
        if devices is not None:
            device = devices[0]
        device = resolve_device(device)
        mesh.device = device
        whole = Model(cfg.with_(mesh_shape=(1, 1)), grid=grid,
                      device=device)
        whole.cfg = whole.cfg.with_(mesh_shape=(mesh.py, mesh.px))
        whole.step_cfg = whole.cfg
        self.__dict__.update({k: v for k, v in whole.__dict__.items()
                              if k not in _OF_THE_BLOCKS})
        self.mesh = mesh
        self._whole = whole
        state0 = whole.initial_state()
        self.blocks: List[Model] = [whole._block(d, state0)
                                    for d in mesh.blocks]
        self._captured = None

    # the calendar, the streams and the files are the blocks' (block 0's)
    nsteps_total = property(lambda self: self.blocks[0].nsteps_total)
    time_manager = property(lambda self: self.blocks[0].time_manager)
    tavg_streams = property(lambda self: self.blocks[0].tavg_streams)
    history_streams = property(lambda self: self.blocks[0].history_streams)
    tavg_files = property(lambda self: self.blocks[0].tavg_files)
    _eager_leapfrog_done = property(
        lambda self: self.blocks[0]._eager_leapfrog_done)

    def block_counts(self):
        """Each block's kernel launches (``launch_counts.Counts``)."""
        return self.mesh.driver.counts

    def on_blocks(self, fn):
        """``[fn(block model) for every block]``, the blocks at once (what
        a caller runs on every block: a stream's ``averages``, a
        collective)."""
        return self.mesh.run(lambda r: fn(self.blocks[r]))

    def initial_state(self) -> State:
        """The whole domain's initial state; the blocks' calendars and step
        counts start again."""
        for block in self.blocks:
            block.initial_state()
        return initial_state(self.cfg, self.grid, self.device,
                             passive=self.passive)

    def advance(self, state: State, forcing: Optional[Forcing] = None):
        """One step of every block from the whole domain's ``state``;
        returns (the whole domain's new state, StepDiagnostics over the
        whole domain)."""
        states = self.mesh.cut(state)
        forcings = self.mesh.cut(forcing or self.forcing)
        outs = self.mesh.run(
            lambda r: self.blocks[r].advance(states[r], forcings[r]))
        return (self.mesh.join([o[0] for o in outs]),
                self.mesh.join([o[1] for o in outs]))

    def _streams_changed(self) -> None:
        self._captured = None

    def enable_tavg(self, contents, freq_steps: int = 0, outdir: str = ".",
                    prefix: str = "tavg", freq_opt: str = None,
                    freq: int = 1):
        """A tavg stream on every block (collective); block 0's writes the
        whole domain's files. Returns block 0's stream."""
        self._streams_changed()
        return self.on_blocks(lambda b: b.enable_tavg(
            contents, freq_steps, outdir, prefix, freq_opt, freq))[0]

    def enable_history(self, contents, freq_steps: int = 0,
                       outdir: str = ".", prefix: str = "pop2_tpu.h",
                       freq_opt: str = None, freq: int = 1):
        self._streams_changed()
        return self.on_blocks(lambda b: b.enable_history(
            contents, freq_steps, outdir, prefix, freq_opt, freq))[0]

    def enable_movie(self, contents, freq_steps: int = 0, outdir: str = ".",
                     level: int = 0, prefix: str = "pop2_tpu.m",
                     freq_opt: str = None, freq: int = 1):
        self._streams_changed()
        return self.on_blocks(lambda b: b.enable_movie(
            contents, freq_steps, outdir, level, prefix, freq_opt, freq))[0]

    def _next_step(self) -> Tuple[bool, bool]:
        for block in self.blocks:
            flags = block._next_step()
        return flags

    def _write_ready(self) -> None:
        self.on_blocks(lambda b: b._write_ready())

    def diagnostics(self, state: State) -> Dict[str, float]:
        """Global means and maxima of the whole domain's ``state`` (b4b
        sums under ``cfg.b4b``: the blocks' own give the same bits)."""
        return self._whole.diagnostics(state)
