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
"""

from __future__ import annotations

import dataclasses
import time
from collections import Counter
from typing import Dict, Tuple

import torch

from pop2_tpu_torch import clinic_cuda, gm_chain_cuda, gm_cuda
from pop2_tpu_torch import gm_slope_cuda, gm_tlt_cuda, tracer_cuda
from pop2_tpu_torch import step as step_mod, tavg, tridiag_cuda
from pop2_tpu_torch.forcing import Forcing
from pop2_tpu_torch.parallel import mesh as pmesh
from pop2_tpu_torch.state import State

#: the modules whose ``launches`` counters the segments keep exact, and
#: the mode counters a module names in ``MODE_COUNTERS``
COUNTED = (tridiag_cuda, tracer_cuda, clinic_cuda, gm_slope_cuda,
           gm_chain_cuda, gm_cuda, gm_tlt_cuda)


def _counts():
    return ({mod: mod.launches for mod in COUNTED},
            Counter(tridiag_cuda.launches_by_nr),
            {(mod, name): getattr(mod, name) for mod in COUNTED
             for name in getattr(mod, "MODE_COUNTERS", ())})


def _set_counts(counts) -> None:
    launches, by_nr, modes = counts
    for mod, n in launches.items():
        mod.launches = n
    tridiag_cuda.launches_by_nr.clear()
    tridiag_cuda.launches_by_nr.update(by_nr)
    for (mod, name), n in modes.items():
        setattr(mod, name, n)


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
        if {k: id(v) for k, v in grid.__dict__.items()} != caches:
            raise RuntimeError(
                f"capturing {self.name} filled or replaced a cache on the "
                "grid: run an eager step of the same kind first")
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
        for mod, n in self.launches.items():
            mod.launches += n
        tridiag_cuda.launches_by_nr.update(self.launches_by_nr)
        for (mod, name), n in self.mode_launches.items():
            setattr(mod, name, getattr(mod, name) + n)


class CapturedStep:
    """Plain leapfrog steps of ``model`` (no averaging step) over static
    state and forcing buffers, made from ``state`` and ``forcing``. On CUDA
    tensors the first ``step`` runs its segments on the capture stream (the
    warm-up a capture needs, and the step itself) and then captures them;
    later steps replay. On CPU tensors, and on a rank's block of a
    decomposition (``uncaptured`` says why), the segments are called
    directly."""

    def __init__(self, model, state: State, forcing: Forcing):
        self.model = model
        # the tavg streams the post graph accumulates into
        self.streams = tuple(model.tavg_streams)
        #: why the segments are not captured (None: they are, on CUDA)
        self.uncaptured = (
            f"a block of a {model.mesh.comm.backend} decomposition: its "
            "exchanges and global sums are host calls"
            if pmesh.over_ranks(model.mesh)
            else None if state.tracer_cur.is_cuda
            else "CPU tensors")
        self.capture = self.uncaptured is None
        self.state = _clone_tree(state)
        self.forcing = _clone_tree(forcing)
        self.stream = torch.cuda.Stream() if self.capture else None
        self.pre_out = None
        self.segments: Dict[object, _Segment] = {}
        self.capture_seconds = 0.0
        # the last step's (pre's output, iterations, rr)
        self._last: Tuple[object, int, torch.Tensor] = (None, 0, None)

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

    # -- capture -------------------------------------------------------------
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

    def _capture_all(self) -> None:
        if not self.state.tracer_cur.is_cuda:
            raise ValueError("CUDA graphs capture work on CUDA tensors; on "
                             "the CPU the segments are called directly")
        t0 = time.perf_counter()
        grid = self.model.grid
        pre = _Segment("pre", self._pre, grid, True, self.stream)
        self._check_carry()
        chunks = {key: _Segment(f"iterations {key}", self._chunk(*key),
                                grid, True, self.stream)
                  for key in dict.fromkeys(self.pre_out.solver.chunks)}
        post = _Segment("post", self._post, grid, True, self.stream)
        torch.cuda.synchronize()
        self.segments = {"pre": pre, **chunks, "post": post}
        self.capture_seconds = time.perf_counter() - t0

    def _run(self, pre, chunk, post) -> None:
        pre()
        p = self.pre_out

        def advance(carry, n, check):
            chunk(n, check)
            return carry
        _, iters, rr = p.solver.run(p.carry, advance)
        post()
        for stream in self.streams:
            stream.nsamples += 1
        self._last = (p, iters, rr)

    # -- the interface -------------------------------------------------------
    def load(self, state: State) -> None:
        """Copy ``state`` into the static state buffers."""
        assign(self.state, state)

    def export(self) -> State:
        """The current state, in tensors of the caller's own."""
        return _clone_tree(self.state)

    def accepts(self, forcing: Forcing) -> bool:
        """Whether ``forcing`` fills the static forcing buffers (the same
        tensor fields); if not, the step must be built again."""
        return structure(forcing) == structure(self.forcing)

    def step(self, forcing: Forcing) -> None:
        """One plain leapfrog step of the buffered state under
        ``forcing``."""
        if forcing is not self.forcing:
            assign(self.forcing, forcing)
        with pmesh.scope(self.model.mesh):
            self._step()

    def _step(self) -> None:
        if self.segments:
            seg = self.segments
            self._run(seg["pre"], lambda n, check: seg[(n, check)](),
                      seg["post"])
            return
        uncaptured = (self._pre, lambda n, check: self._chunk(n, check)(),
                      self._post)
        if not self.capture:
            self._run(*uncaptured)
            return
        # warm-up on the capture stream (libraries' lazy set-up there), which
        # is this step; then the capture
        self.stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(self.stream):
            self._run(*uncaptured)
        torch.cuda.current_stream().wait_stream(self.stream)
        self._capture_all()

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
