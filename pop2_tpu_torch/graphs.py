"""The captured leapfrog step: ``Model.run_compiled``'s plain leapfrog steps
as CUDA graphs.

The JAX package fuses runs of plain leapfrog steps into one compiled
``lax.scan`` with the solver's ``lax.while_loop`` on the device
(``pop2_tpu/model.py`` ``_scan_leapfrog``). Eagerly the port sends every
small 2-D operation of the solver's loop from the host, a few dozen an
iteration for over a hundred iterations a step, and the host, not the card,
sets the pace. Here a step is three kinds of segment, each captured once as
a ``torch.cuda.CUDAGraph`` and replayed:

- ``pre`` (``step.pre``): dh/dt, the overflows, ``baroclinic.driver``,
  ``barotropic.rhs`` and the solver's first pass;
- a run of iterations between two host reads (``Solver.chunks``): one graph
  for each (iterations, check) pair the schedule holds, at most three (a
  run ended by a check, one without a check before PCSI's
  ``convergence_check_start``, a shorter last run);
- ``post`` (``step.post``), which ends by copying the new state into the
  static state buffers that ``pre`` reads, and, when the model has tavg
  streams, by their accumulation.

With tavg streams (``Model.run_compiled`` captures only step-frequency
ones) ``pre`` and ``post`` run with the step's extras, and the accumulation
of every stream is the end of the ``post`` graph: it reads the new state
from the static buffers, after the copy, and the extras, which ``post``
formed before the copy overwrote the pre-step tracers they read. In the
same graph the extras and the accumulation's intermediates are the
graph's own temporaries (nothing has to outlive the segment), and a step
stays three kinds of segment. The streams' accumulators are static
buffers updated in place (``tavg.TavgStream``); counting the samples and
writing a full stream happen on the host, between steps.

A step is ``pre``, runs until the host reads ``rr < tol`` at a check (the
reads the eager loop makes) or the iterations run out, then ``post``. The
state and the forcing live in static buffers of this object; a run copies
the caller's state in once (``load``) and out once (``export``).

What a capture may not do, and how it is kept out:

- read the device: the solver's tolerance is a host value kept on the grid
  (``solvers.tolerance``), PCSI's coefficients a device table;
- keep a host value that changes from step to step: a plain leapfrog step
  takes none (the calendar reaches it only as the lunar factor of the
  tidal energy, which the model writes into its forcing tensor before the
  step and ``step`` copies into the static forcing buffer);
- fill a cache on the ``Grid`` object (the kernel wrappers' operands, the
  tavg streams' static fields): a cache first filled inside a capture
  would hold graph memory that no kernel has written. The graphs are
  captured only after an eager leapfrog step (with the same streams), and
  each capture raises if the grid's cache entries changed.

The kernel wrappers count a launch when their Python runs, which on this
path is once, at capture. Each segment therefore takes back what its
capture counted and adds it again at every replay, so the counts stay those
of the launches the card makes.

On CPU tensors nothing is captured: the same segments are called anew each
step (the CPU tests reach the split step that way). On the GPU a capture or
replay that fails raises; there is no eager fallback.

On a rank's block of a decomposition over gloo the segments run with the
decomposition in scope and are never captured, by rule: a halo exchange or
a global sum there is a host call of ``torch.distributed`` (the buffers
staged through host memory), which no CUDA graph can hold. Such a step
reports ``graphs == 0`` and says why (``uncaptured``); every rank runs the
same segments, so the ranks' exchanges still pair up. Under NCCL, whose
collectives a graph could hold, ``Model.run_compiled`` refuses (ROADMAP.md
Queue 1 item 12b, across cards).

The blocks of a one-process mesh (``model.MeshModel``) exchange by device
copies, which a graph holds: ``MeshCapturedStep`` captures each segment
once for every block, each block issuing on a stream of its own.
"""

from __future__ import annotations

import dataclasses
import time
from collections import Counter
from typing import Dict, Tuple

import torch

from pop2_tpu_torch import clinic_cuda, gm_chain_cuda, gm_cuda
from pop2_tpu_torch import gm_slope_cuda, gm_tlt_cuda, launch_counts
from pop2_tpu_torch import tracer_cuda
from pop2_tpu_torch import step as step_mod, tavg, tridiag_cuda
from pop2_tpu_torch.forcing import Forcing
from pop2_tpu_torch.parallel import mesh as pmesh
from pop2_tpu_torch.state import State

#: the modules whose ``launches`` counters the segments keep exact, and
#: the mode counters a module names in ``MODE_COUNTERS``
COUNTED = (tridiag_cuda, tracer_cuda, clinic_cuda, gm_slope_cuda,
           gm_chain_cuda, gm_cuda, gm_tlt_cuda)


def _counts():
    """This thread's launch counters of the ``COUNTED`` wrappers (the
    modules', or a block's of a one-process mesh, ``launch_counts``):
    ({module: launches}, thomas's launches by right-hand sides,
    {(module, mode counter): n})."""
    values, by_nr = launch_counts.snapshot(COUNTED)
    return ({mod: values[(mod.__name__, "launches")] for mod in COUNTED},
            by_nr,
            {(mod, name): values[(mod.__name__, name)] for mod in COUNTED
             for name in getattr(mod, "MODE_COUNTERS", ())})


def _set_counts(counts) -> None:
    """Set this thread's launch counters to ``counts`` (``_counts``')."""
    launches, by_nr, modes = counts
    values = {(mod.__name__, "launches"): n for mod, n in launches.items()}
    values.update({(mod.__name__, name): n
                   for (mod, name), n in modes.items()})
    launch_counts.restore((values, by_nr))


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _tensor_fields(tree):
    return [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)
            if isinstance(getattr(tree, f.name), torch.Tensor)]


def structure(tree) -> frozenset:
    """The names of ``tree``'s tensor fields: two trees of one dataclass
    with the same structure fill the same buffers."""
    return frozenset(name for name, _ in _tensor_fields(tree))


def assign(dst, src) -> None:
    """Copy each tensor field of ``src`` into ``dst``'s (same dataclass).
    The two must hold tensors in the same fields: a field that is a tensor
    in one and None in the other raises before anything is copied (a
    buffer captured without a field cannot carry it, and one captured with
    it would step a stale value), and so does a dtype or shape that
    differs. A field of ``src`` may be one of ``dst``'s buffers (the step
    hands the current level on as the old one): such a copy goes before
    the copy that overwrites its source."""
    missing = sorted(structure(dst) - structure(src))
    extra = sorted(structure(src) - structure(dst))
    if missing or extra:
        raise ValueError(
            f"{type(src).__name__} fields {extra} have no buffer and "
            f"{missing} have no value: the captured step was built for "
            "another structure and must be built again")
    pending = []
    for name, d in _tensor_fields(dst):
        s = getattr(src, name)
        if s.shape != d.shape or s.dtype != d.dtype:
            raise ValueError(f"{name}: {s.dtype} {tuple(s.shape)} into a "
                             f"buffer of {d.dtype} {tuple(d.shape)}")
        if s is not d:
            pending.append((d, s))
    while pending:
        reads = Counter(_storage(s) for _, s in pending)
        ready = [i for i, (d, _) in enumerate(pending)
                 if reads[_storage(d)] == 0]
        if not ready:
            raise RuntimeError("the new state's fields read the buffers "
                               "they overwrite in a cycle")
        for i in ready:
            pending[i][0].copy_(pending[i][1])
        pending = [p for i, p in enumerate(pending) if i not in ready]


def _clone_tree(tree):
    return dataclasses.replace(tree, **{
        name: t.clone() for name, t in _tensor_fields(tree)})


class _Segment:
    """``fn`` captured once as a CUDA graph and replayed, or (``capture``
    False) called anew each time."""

    def __init__(self, name: str, fn, grid, capture: bool,
                 stream=None):
        self.name, self.fn = name, fn
        self.graph = None
        self.replays = 0
        self.launches: Dict[object, int] = {}
        self.launches_by_nr: Counter = Counter()
        self.mode_launches: Dict[Tuple[object, str], int] = {}
        if capture:
            self._capture(grid, stream)

    def _capture(self, grid, stream) -> None:
        caches = {k: id(v) for k, v in grid.__dict__.items()}
        before = _counts()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, stream=stream):
                self.fn()
        finally:
            after = _counts()
            _set_counts(before)  # the replays make these launches
        _check_caches(self.name, grid, caches)
        self.launches = {mod: after[0][mod] - before[0][mod]
                         for mod in COUNTED
                         if after[0][mod] != before[0][mod]}
        self.launches_by_nr = after[1] - before[1]
        self.mode_launches = {key: n - before[2][key]
                              for key, n in after[2].items()
                              if n != before[2][key]}
        self.graph = graph

    def __call__(self) -> None:
        if self.graph is None:
            self.fn()
            return
        self.graph.replay()
        self.replays += 1
        values = {(mod.__name__, "launches"): n
                  for mod, n in self.launches.items()}
        values.update({(mod.__name__, name): n
                       for (mod, name), n in self.mode_launches.items()})
        launch_counts.add_delta((values, self.launches_by_nr))


def _check_caches(name: str, grid, caches) -> None:
    if {k: id(v) for k, v in grid.__dict__.items()} != caches:
        raise RuntimeError(
            f"capturing {name} filled or replaced a cache on the grid: run "
            "an eager step of the same kind first")


class CapturedStep:
    """Plain leapfrog steps of ``model`` (no averaging step) over static
    state and forcing buffers, made from ``state`` and ``forcing``. On CUDA
    tensors the first ``step`` runs its segments on the capture stream (the
    warm-up a capture needs, and the step itself) and then captures them;
    later steps replay. On CPU tensors, and on a rank's block of a
    decomposition (``uncaptured`` says why), the segments are called
    directly.

    The step runs its segment bodies on its ``parts``: here itself, in a
    ``MeshCapturedStep`` every block's step. A subclass changes only how a
    body runs on the parts (``_on_parts``), how a segment is captured
    (``_capture``), and how a whole-domain tree is cut to the parts
    (``_cut``) and joined (``export``, ``diagnostics``)."""

    def __init__(self, model, state: State, forcing: Forcing,
                 block_of_mesh: bool = False):
        self.model = model
        # the tavg streams the post graph accumulates into
        self.streams = tuple(model.tavg_streams)
        self.state = _clone_tree(state)
        self.forcing = _clone_tree(forcing)
        self.pre_out = None
        # the last step's (pre's output, iterations, rr)
        self._last: Tuple[object, int, torch.Tensor] = (None, 0, None)
        self.parts = [self]
        # a block of a one-process mesh lends its buffers and segment
        # bodies to the mesh's step, which captures every block
        self._capturing(
            "a block of a one-process mesh: MeshCapturedStep captures it"
            if block_of_mesh
            else f"a block of a {model.mesh.comm.backend} decomposition: "
            "its exchanges and global sums are host calls"
            if pmesh.over_ranks(model.mesh)
            else None if state.tracer_cur.is_cuda
            else "CPU tensors")

    def _capturing(self, uncaptured) -> None:
        #: why the segments are not captured (None: they are, on CUDA)
        self.uncaptured = uncaptured
        self.capture = uncaptured is None
        self.stream = torch.cuda.Stream() if self.capture else None
        self.segments: Dict[object, _Segment] = {}
        self.capture_seconds = 0.0

    # -- the segments' bodies ------------------------------------------------
    def _pre(self) -> None:
        m = self.model
        self.pre_out = step_mod.pre(
            m.step_cfg, m.grid, m.bc, m.ts_range, self.state, self.forcing,
            True,
            **m.step_args(True), with_extras=bool(self.streams))

    def _chunk(self, n: int, check: bool):
        def fn():
            carry = self.pre_out.carry
            for k, v in self.pre_out.solver.advance(carry, n, check).items():
                carry[k].copy_(v)
        return fn

    def _post(self) -> None:
        m, p = self.model, self.pre_out
        out = step_mod.post(
            m.step_cfg, m.grid, m.bc, m.ts_range, self.state, self.forcing,
            True, False, p, p.carry["x"].to(self.state.pguess.dtype),
            passive=m.passive, ovf_statics=m.ovf_statics,
            with_extras=bool(self.streams))
        if not self.streams:
            assign(self.state, out)
            return
        new, extras = out  # formed before the copy below
        assign(self.state, new)
        aux = tavg.TavgAux(forcing=self.forcing, bc=m.bc, **extras,
                           memo={})
        for stream in self.streams:
            stream.accumulate_fields(self.state, aux)

    def _check_carry(self) -> None:
        """The carry entries the runs write own their memory: a copy into
        one changes nothing else the step reads."""
        carry, written = self.pre_out.carry, self.pre_out.solver.written
        others = [t for k, t in carry.items() if k not in written]
        others += [t for _, t in _tensor_fields(self.state)]
        others += [t for _, t in _tensor_fields(self.forcing)]
        seen = {_storage(t) for t in others}
        for k in written:
            ptr = _storage(carry[k])
            if ptr in seen:
                raise RuntimeError(f"the solver's carry entry {k!r} shares "
                                   "memory with another tensor of the step")
            seen.add(ptr)

    # -- the parts -----------------------------------------------------------
    def _on_parts(self, body, forked: bool = False) -> list:
        """``[body(part) for every part]``; ``forked``: in the warm-up
        before a capture."""
        with pmesh.scope(self.model.mesh):
            return [body(self)]

    def _capture(self, name: str, body) -> "_Segment":
        """``body`` on the parts captured as one segment."""
        return _Segment(name, lambda: self._on_parts(body), self.model.grid,
                        True, self.stream)

    def _cut(self, tree) -> list:
        """The parts' shares of the whole-domain ``tree``."""
        return [tree]

    # -- one step ------------------------------------------------------------
    def _capture_all(self) -> None:
        if not self.parts[0].state.tracer_cur.is_cuda:
            raise ValueError("CUDA graphs capture work on CUDA tensors; on "
                             "the CPU the segments are called directly")
        t0 = time.perf_counter()
        pre = self._capture("pre", lambda p: p._pre())
        for part in self.parts:
            part._check_carry()
        chunks = {key: self._capture(f"iterations {key}",
                                     lambda p, key=key: p._chunk(*key)())
                  for key in dict.fromkeys(
                      self.parts[0].pre_out.solver.chunks)}
        post = self._capture("post", lambda p: p._post())
        torch.cuda.synchronize()
        self.segments = {"pre": pre, **chunks, "post": post}
        self.capture_seconds = time.perf_counter() - t0

    def _run(self, pre, chunk, post) -> None:
        """One step: ``pre()``, the solver's runs ``chunk(n, check)``
        between its checks, ``post()``. A check reads the host once: the
        first part's residual, which every part's global sum gave the same
        bits."""
        pre()
        p = self.parts[0].pre_out

        def advance(carry, n, check):
            chunk(n, check)
            return carry
        _, iters, rr = p.solver.run(p.carry, advance)
        post()
        key = next(k for k, v in p.carry.items() if v is rr)
        for part in self.parts:
            for stream in part.streams:
                stream.nsamples += 1
            part._last = (part.pre_out, iters, part.pre_out.carry[key])

    def _step(self) -> None:
        if self.segments:
            seg = self.segments
            self._run(seg["pre"], lambda n, check: seg[(n, check)](),
                      seg["post"])
            return

        def bodies(forked):
            on = self._on_parts
            return (lambda: on(lambda p: p._pre(), forked),
                    lambda n, check: on(lambda p: p._chunk(n, check)(),
                                        forked),
                    lambda: on(lambda p: p._post(), forked))
        if not self.capture:
            self._run(*bodies(False))
            return
        # warm-up on the capture stream (libraries' lazy set-up there), as
        # the capture will issue it, which is this step; then the capture
        self.stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(self.stream):
            self._run(*bodies(True))
        torch.cuda.current_stream().wait_stream(self.stream)
        self._capture_all()

    # -- the interface -------------------------------------------------------
    def load(self, state: State) -> None:
        """Copy ``state`` into the static state buffers."""
        for part, s in zip(self.parts, self._cut(state)):
            assign(part.state, s)

    def export(self) -> State:
        """The current state, in tensors of the caller's own."""
        return _clone_tree(self.state)

    def accepts(self, forcing: Forcing) -> bool:
        """Whether ``forcing`` fills the static forcing buffers (the same
        tensor fields); if not, the step must be built again."""
        return structure(forcing) == structure(self.parts[0].forcing)

    def step(self, forcing: Forcing) -> None:
        """One plain leapfrog step of the buffered state under
        ``forcing``."""
        for part, f in zip(self.parts, self._cut(forcing)):
            if f is not part.forcing:
                assign(part.forcing, f)
        self._step()

    def diagnostics(self) -> step_mod.StepDiagnostics:
        """The last step's diagnostics, cloned out of the graphs' memory."""
        diags = step_mod.diagnostics(*self._last)
        return diags._replace(**{
            k: v.clone() for k, v in diags._asdict().items()
            if isinstance(v, torch.Tensor)})

    @property
    def graphs(self) -> int:
        return sum(s.graph is not None for s in self.segments.values())

    @property
    def replays(self) -> int:
        return sum(s.replays for s in self.segments.values())


class MeshCapturedStep(CapturedStep):
    """``CapturedStep`` of a one-process mesh (``model.MeshModel``) from
    the whole domain's ``state`` and ``forcing``: its parts are the
    blocks' steps (a ``CapturedStep`` a block, for its buffers and segment
    bodies), and every segment runs on all blocks at once
    (``LocalMesh.run``, a thread a block). On the card each of its graphs
    holds every block: ``pre``, each run of solver iterations between two
    checks, ``post`` with the streams' accumulation. In a capture (and in
    the warm-up step before it) each block issues on a stream of its own,
    forked from the capture stream by an event and joined back before the
    capture ends; the blocks' exchanges and collectives
    (``mesh.LocalComm``) are device copies ordered by events, edges of the
    graph between the block streams. Each block's launches are counted
    into its own counters. A capture that fails raises; there is no eager
    fallback. On CPU tensors the segments run on the blocks uncaptured."""

    def __init__(self, model, state: State, forcing: Forcing):
        self.model = model
        mesh = model.mesh
        self.parts = [CapturedStep(b, s, f, block_of_mesh=True)
                      for b, s, f in zip(model.blocks, mesh.views(state),
                                         mesh.views(forcing))]
        self._capturing(None if state.tracer_cur.is_cuda else "CPU tensors")
        self.block_streams = ([torch.cuda.Stream() for _ in self.parts]
                              if self.capture else None)

    def _on_parts(self, body, forked: bool = False) -> list:
        """``body(part)`` on every block at once; with ``forked`` each
        block issues on its own stream, forked from the current stream by
        an event and joined back into it."""
        mesh = self.model.mesh
        if not forked:
            return mesh.run(lambda r: body(self.parts[r]))
        origin = torch.cuda.current_stream()
        fork = torch.cuda.Event()
        fork.record(origin)

        def task(rank):
            stream = self.block_streams[rank]
            stream.wait_event(fork)
            with torch.cuda.stream(stream):
                out = body(self.parts[rank])
            joined = torch.cuda.Event()
            joined.record(stream)
            return out, joined
        try:
            outs = mesh.run(task)
        except BaseException:
            # every block stream joined back, so a capture ends on the
            # block's own error, not on unjoined work
            for stream in self.block_streams:
                origin.wait_stream(stream)
            raise
        for _, joined in outs:
            origin.wait_event(joined)
        return [out for out, _ in outs]

    def _grids(self):
        """Every grid a block's segment reads: the block grid and the
        extended grids of its halo'd kernel calls, where the kernels keep
        their operands (``Decomposition.ext_grids``)."""
        return [g for p in self.parts
                for g in [p.model.grid] + p.model.mesh.ext_grids()]

    def _capture(self, name: str, body) -> "_MeshSegment":
        grids = self._grids()
        caches = [{k: id(v) for k, v in g.__dict__.items()} for g in grids]

        def counted(part):
            before = launch_counts.snapshot(COUNTED)
            try:
                body(part)
            finally:
                after = launch_counts.snapshot(COUNTED)
                launch_counts.restore(before)
            return launch_counts.delta(before, after)
        graph = torch.cuda.CUDAGraph()
        # the blocks' threads issue into the capture: their allocator calls
        # run in relaxed mode whichever the capture's, and no block reads
        # the device inside a segment
        with torch.cuda.graph(graph, stream=self.stream,
                              capture_error_mode="relaxed"):
            counts = self._on_parts(counted, forked=True)
        if [id(g) for g in self._grids()] != [id(g) for g in grids]:
            raise RuntimeError(
                f"capturing {name} extended a block grid anew: run an eager "
                "step of the same kind first")
        for g, c in zip(grids, caches):
            _check_caches(name, g, c)
        return _MeshSegment(graph, counts, self.model.mesh.driver.counts)

    def _cut(self, tree) -> list:
        return self.model.mesh.views(tree)

    def export(self) -> State:
        """The whole domain's current state, in tensors of the caller's
        own."""
        return self.model.mesh.join([p.state for p in self.parts])

    def diagnostics(self) -> step_mod.StepDiagnostics:
        """The last step's diagnostics over the whole domain."""
        return self.model.mesh.join([p.diagnostics() for p in self.parts])


class _MeshSegment:
    """A graph of every block's work on a segment, and each block's
    launches in it, counted into the blocks' counters at each replay."""

    def __init__(self, graph, counted, counts):
        self.graph, self.counted, self.counts = graph, counted, counts
        self.replays = 0

    def __call__(self) -> None:
        self.graph.replay()
        self.replays += 1
        for d, c in zip(self.counted, self.counts):
            launch_counts.add_delta(d, c)
