"""Domain decomposition over ranks: every (..., ny, nx) field in y slabs.

Counterpart of the JAX package's ``parallel/mesh.py``, where XLA's SPMD
partitioner inserts the halo exchanges of every shifted access and turns
masked sums into psum trees. PyTorch has no partitioner, so this module
does explicitly what XLA did implicitly:

* ``Decomposition``: one process (rank) holds one y slab, the global rows
  [j0, j1) with x whole (``mesh_shape = (py, 1)``; an x decomposition, with
  the fold's partner columns on other ranks, is ROADMAP.md Queue 1 item
  12c). The vertical and tracer axes are never decomposed.
* ``scope``: the decomposition the stencil (``stencil.py``), the tripole
  fold (``tripole.py``), the reductions (``reductions.py``) and the kernel
  wrappers read while a step runs (the counterpart of
  ``tridiag_pallas.dispatch_mesh``). Outside a scope every function works
  on the whole domain, as before. A slab grid carries its decomposition
  (``attach``), and what is given a slab grid outside a step (the
  forcing's builders, the diagnostics) enters it (``grid_scope``), so a
  global sum there is global too.
* ``Comm``: the rows a shift or a kernel needs from the neighbouring slabs
  (``halo_rows``: one ``batch_isend_irecv`` a call, every field's rows
  packed into one buffer each way) and the all-reduces of the global sums.
  Under gloo (ranks on the CPU, or sharing one card, where NCCL refuses two
  ranks on one device) the buffers go through host memory, explicitly, and
  the bytes staged are counted; under NCCL (a card a rank) they stay on the
  device. The fields themselves stay where they are and every kernel runs
  there.
* ``halo_call``: a kernel wrapper's launch on its slab extended by H rows
  from each neighbour that exists, the extended rows trimmed from its
  outputs. The tripole instance runs on the top slab only; the others run
  the closed one, whose zero rows lie in the trimmed halo.

Rank r holds rows [r ny/py, (r+1) ny/py): its south neighbour is r-1 and
its north neighbour r+1; the top slab (r = py-1) holds the tripole fold.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Optional, Tuple

import torch

from pop2_tpu_torch._tree import TensorTree

#: widest kernel frame: upwind3's tracer tendency (tracer_cuda.UPW_HALO)
HALO_MAX = 2
#: rows of the top slab the tripole fold reads (distance-2 shifts of
#: corner fields reach ny-3)
FOLD_ROWS = 3

_ACTIVE: Optional["Decomposition"] = None


def active() -> Optional["Decomposition"]:
    """The decomposition of the running scope, or None (whole domain)."""
    return _ACTIVE


@contextlib.contextmanager
def scope(decomp: Optional["Decomposition"]):
    """Run the enclosed code on ``decomp``'s slab (None: the whole domain,
    which is how ``halo_call`` runs a kernel on its extended slab)."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, decomp
    try:
        yield decomp
    finally:
        _ACTIVE = prev


def attach(grid, decomp: Optional["Decomposition"]):
    """Mark ``grid`` (a slab grid) as ``decomp``'s, so that what is given
    the grid outside a step (``grid_scope``) reduces over every slab."""
    grid.__dict__["_decomposition"] = decomp
    return grid


def of_grid(grid) -> Optional["Decomposition"]:
    """The decomposition whose slab ``grid`` is (``attach``), or None."""
    return grid.__dict__.get("_decomposition")


@contextlib.contextmanager
def grid_scope(grid):
    """``scope`` of ``grid``'s decomposition where none is active: a
    function given a slab grid (the forcing's builders, the diagnostics)
    sums and shifts over every slab, called in a step or outside one."""
    d = of_grid(grid)
    if _ACTIVE is None and d is not None:
        with scope(d):
            yield d
    else:
        yield _ACTIVE


def halo_wrapped(halo: int):
    """Decorator of a kernel wrapper ``fn(cfg, grid, *args, **kwargs)``:
    under a decomposition over ranks the wrapper runs on its y slab
    extended by ``halo`` rows from each neighbour
    (``Decomposition.halo_call``: the operands' rows in one exchange, the
    tripole instance on the top slab only) and keeps the slab's rows; the
    plain version it calls for CPU tensors is wrapped the same way. On the
    whole domain the call goes straight through."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(cfg, grid, *args, **kwargs):
            d = _ACTIVE
            if d is not None and d.comm is not None:
                return d.halo_call(fn, cfg, grid, halo, *args, **kwargs)
            return fn(cfg, grid, *args, **kwargs)
        return call
    return wrap


def tree_map(fn, obj):
    """``fn`` applied to every tensor of a tree of tuples, lists, dicts,
    NamedTuples and ``TensorTree`` containers (Grid, State, Forcing);
    anything else is kept."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, TensorTree):
        return type(obj)(**{f.name: tree_map(fn, getattr(obj, f.name))
                            for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(tree_map(fn, v) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(tree_map(fn, v) for v in obj)
    if isinstance(obj, dict):
        return {k: tree_map(fn, v) for k, v in obj.items()}
    return obj


def _as_bytes(t):
    return t.contiguous().reshape(-1).view(torch.uint8)


class Comm:
    """Row exchanges and all-reduces between the slabs' ranks over
    ``torch.distributed``, with what they cost: ``exchanges`` (calls of
    ``batch_isend_irecv``), ``allreduces``, ``staged_bytes`` (device to host
    and back, gloo on a card) and ``sent_bytes``."""

    def __init__(self, backend: str, group=None):
        self.backend = backend
        self.group = group
        self.reset_counts()

    def reset_counts(self):
        self.exchanges = 0
        self.allreduces = 0
        self.staged_bytes = 0
        self.sent_bytes = 0

    def counts(self) -> dict:
        return {"exchanges": self.exchanges, "allreduces": self.allreduces,
                "staged_bytes": self.staged_bytes,
                "sent_bytes": self.sent_bytes}

    def _stages(self, t) -> bool:
        return self.backend == "gloo" and t.device.type != "cpu"

    def _to_wire(self, t):
        if self._stages(t):
            self.staged_bytes += t.numel() * t.element_size()
            return t.cpu()
        return t

    def _from_wire(self, t, device):
        if t.device != device:
            self.staged_bytes += t.numel() * t.element_size()
            return t.to(device)
        return t

    def sendrecv(self, sends, recvs, device):
        """``sends``: [(peer, uint8 buffer)], ``recvs``: [(peer, nbytes)];
        one batch of point-to-point operations. Returns the received
        buffers on ``device``."""
        import torch.distributed as dist
        wire = torch.device("cpu") if self.backend == "gloo" else device
        out = [torch.empty(n, dtype=torch.uint8, device=wire)
               for _, n in recvs]
        ops = [dist.P2POp(dist.isend, self._to_wire(b), peer,
                          group=self.group) for peer, b in sends]
        ops += [dist.P2POp(dist.irecv, b, peer, group=self.group)
                for (peer, _), b in zip(recvs, out)]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            self.exchanges += 1
            self.sent_bytes += sum(b.numel() for _, b in sends)
        return [self._from_wire(b, device) for b in out]

    def all_reduce(self, t, op: str):
        """``t`` reduced over the ranks (``op`` 'sum' or 'max'); a new
        tensor on ``t``'s device, the same bits on every rank."""
        import torch.distributed as dist
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        w = self._to_wire(t).clone()
        dist.all_reduce(w, op=red, group=self.group)
        self.allreduces += 1
        return self._from_wire(w, t.device)

    def broadcast_floats(self, values, src: int = 0):
        """Rank ``src``'s Python floats on every rank (float64, so the
        bits are kept)."""
        import torch.distributed as dist
        t = torch.tensor(list(values), dtype=torch.float64,
                         device="cuda" if self.backend == "nccl" else "cpu")
        dist.broadcast(t, src=src, group=self.group)
        return [float(v) for v in t.tolist()]

    def barrier(self):
        import torch.distributed as dist
        dist.barrier(group=self.group)

    def all_gather(self, t):
        """Every rank's ``t`` (the same shape on every rank), in rank
        order, on ``t``'s device."""
        import torch.distributed as dist
        w = self._to_wire(t.contiguous())
        out = [torch.empty_like(w) for _ in range(
            dist.get_world_size(self.group))]
        dist.all_gather(out, w, group=self.group)
        return [self._from_wire(o, t.device) for o in out]


@dataclasses.dataclass(frozen=True, eq=False)
class Decomposition:
    """One rank's y slab: global rows [j0, j1) of (ny, nx), its neighbours'
    ranks (None at the global south / north edge), whether it holds the
    tripole fold, and the communicator (None for a single slab)."""
    py: int
    rank: int
    ny: int
    nx: int
    j0: int
    j1: int
    south: Optional[int]
    north: Optional[int]
    fold: bool
    comm: Optional[Comm] = None

    @property
    def rows(self) -> int:
        return self.j1 - self.j0

    @property
    def top(self) -> bool:
        return self.north is None

    def __post_init__(self):
        # the extended grids of ``halo_call``, by slab grid: (grid, {halo:
        # extended grid}); the slab grid is kept so its id stays its own
        object.__setattr__(self, "_ext_grids", {})

    # -- slabs of whole-domain data -----------------------------------------
    def is_field(self, t, rows: Optional[int] = None) -> bool:
        """A horizontal field of ``rows`` rows (default: the global ny)."""
        rows = self.ny if rows is None else rows
        return (isinstance(t, torch.Tensor) and t.dim() >= 2
                and tuple(t.shape[-2:]) == (rows, self.nx))

    def slab(self, tree):
        """Every whole-domain horizontal field of ``tree`` cut to this
        slab's rows (a copy, so the whole field can be freed); anything
        else kept."""
        def cut(t):
            if self.is_field(t):
                return t.narrow(-2, self.j0, self.rows).clone()
            return t
        return tree_map(cut, tree)

    def kernel_cfg(self, cfg, rows: int):
        """``cfg`` as a kernel launched on this slab extended to ``rows``
        rows sees it: ny the rows, and a closed north edge unless the slab
        holds the fold (the closed instance's zero ghost row lies past the
        trimmed halo)."""
        ns = cfg.ns_boundary
        if ns == "tripole" and not self.fold:
            ns = "closed"
        return cfg.with_(ny=rows, ns_boundary=ns)

    # -- halo rows ----------------------------------------------------------
    def halo_rows(self, tensors, south: int, north: int):
        """([rows from the south], [rows from the north]): for each tensor
        (..., rows, nx), the ``south`` last rows of the south neighbour's
        and the ``north`` first rows of the north neighbour's, each list
        None where there is no such neighbour (or no rows). Every rank
        sends the rows its neighbours ask for in the same call: one
        exchange, all tensors packed into one buffer each way."""
        tensors = list(tensors)
        if self.comm is None or not tensors:
            return None, None
        device = tensors[0].device

        def shapes(k):
            return [tuple(t.shape[:-2]) + (k, t.shape[-1]) for t in tensors]

        def nbytes(k):
            return sum(math.prod(s) * t.element_size()
                       for s, t in zip(shapes(k), tensors))

        def pack(rows_of):
            return torch.cat([_as_bytes(rows_of(t)) for t in tensors])

        sends, recvs = [], []
        n = tensors[0].shape[-2]
        if self.south is not None and north > 0:
            sends.append((self.south, pack(lambda t: t.narrow(-2, 0, north))))
        if self.north is not None and south > 0:
            sends.append((self.north,
                          pack(lambda t: t.narrow(-2, n - south, south))))
        want = []
        if self.south is not None and south > 0:
            recvs.append((self.south, nbytes(south)))
            want.append(("s", south))
        if self.north is not None and north > 0:
            recvs.append((self.north, nbytes(north)))
            want.append(("n", north))
        got = self.comm.sendrecv(sends, recvs, device)
        out = {"s": None, "n": None}
        for (side, k), buf in zip(want, got):
            parts, at = [], 0
            for s, t in zip(shapes(k), tensors):
                size = math.prod(s) * t.element_size()
                parts.append(buf[at:at + size].clone().view(t.dtype)
                             .reshape(s))
                at += size
            out[side] = parts
        return out["s"], out["n"]

    def extend(self, tensors, south: int, north: int):
        """Each tensor with ``south`` rows of its south neighbour's below
        and ``north`` of its north neighbour's above (where those exist)."""
        from_s, from_n = self.halo_rows(tensors, south, north)
        out = []
        for i, t in enumerate(tensors):
            parts = ([from_s[i]] if from_s else []) + [t] + (
                [from_n[i]] if from_n else [])
            out.append(torch.cat(parts, dim=-2) if len(parts) > 1 else t)
        return out

    def ext_grid(self, grid, halo: int):
        """The slab grid ``grid`` extended by ``halo`` rows from each
        neighbour (``extend`` of every horizontal field of it), made once a
        grid and kept, so that the kernels' statics cached on it are built
        once. Every rank makes it at the same call (its first halo'd call
        on that grid), so the exchange is joined by all."""
        entry = self._ext_grids.get(id(grid))
        if entry is None or entry[0] is not grid:
            entry = (grid, {})
            self._ext_grids[id(grid)] = entry
        ext = entry[1].get(halo)
        if ext is None:
            leaves = []
            tree_map(lambda t: leaves.append(t) if self.is_field(
                t, self.rows) else None, grid)
            wide = iter(self.extend(leaves, halo, halo))
            ext = tree_map(lambda t: next(wide) if self.is_field(
                t, self.rows) else t, grid)
            entry[1][halo] = ext
        return ext

    def halo_call(self, fn, cfg, grid, halo: int, *args, **kwargs):
        """``fn(cfg, grid, *args, **kwargs)`` (a kernel wrapper) on this
        slab extended by ``halo`` rows from each neighbour that exists: the
        horizontal fields among ``args`` and ``kwargs`` (tensors, or inside
        NamedTuples) exchanged in one call, the grid extended once,
        ``stencil.BC`` arguments and ``cfg`` closed at the north edge unless
        the slab holds the fold, the wrapper run with no decomposition
        active, and its outputs' extended rows trimmed."""
        from pop2_tpu_torch.stencil import BC
        hs = halo if self.south is not None else 0
        hn = halo if self.north is not None else 0
        rows = self.rows + hs + hn
        leaves = []
        tree_map(lambda t: leaves.append(t) if self.is_field(
            t, self.rows) else None, (args, kwargs))
        # every rank asks the same rows of its neighbours: the halo'd call
        # is one exchange on every rank
        wide = iter(self.extend(leaves, halo, halo))
        lcfg = self.kernel_cfg(cfg, rows)

        def widen(v):
            if isinstance(v, BC):
                return BC(v.ew, lcfg.ns_boundary)
            return tree_map(lambda t: next(wide) if self.is_field(
                t, self.rows) else t, v)
        args = tuple(widen(a) for a in args)
        kwargs = {k: widen(v) for k, v in kwargs.items()}
        with scope(None):
            out = fn(lcfg, self.ext_grid(grid, halo), *args, **kwargs)
        return tree_map(lambda t: t.narrow(-2, hs, self.rows).contiguous()
                        if self.is_field(t, rows) else t, out)


def make_mesh(shape: Tuple[int, int], ny: int, nx: int,
              tripole: bool = False) -> Decomposition:
    """This rank's slab of an (ny, nx) grid on a (py, 1) mesh over the
    process group (``multihost.initialize_distributed``; one slab needs
    none). Refuses ``px != 1`` (Queue 1 item 12c), ``ny % py != 0`` and
    slabs thinner than the widest kernel halo plus the fold's rows."""
    py, px = (int(s) for s in shape)
    if px != 1:
        raise NotImplementedError(
            f"mesh_shape={tuple(shape)}: an x decomposition (the tripole "
            "fold's partner columns on other ranks) is not ported yet "
            "(ROADMAP.md Queue 1 item 12c); use (py, 1)")
    if py < 1 or ny % py != 0:
        raise ValueError(f"ny={ny} does not split into {py} slabs of equal "
                         "rows")
    rows = ny // py
    if py > 1 and rows < HALO_MAX + FOLD_ROWS:
        raise ValueError(
            f"slabs of {rows} rows: a slab needs at least {HALO_MAX} rows "
            f"(the widest kernel halo) + {FOLD_ROWS} (the fold's rows)")
    if py > 1:
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError(
                f"a mesh of {py} slabs needs a process group: "
                "parallel.multihost.initialize_distributed first")
        if dist.get_world_size() != py:
            raise ValueError(f"mesh of {py} slabs on "
                             f"{dist.get_world_size()} ranks")
        rank, comm = dist.get_rank(), Comm(dist.get_backend())
    else:
        rank, comm = 0, None
    return Decomposition(
        py=py, rank=rank, ny=ny, nx=nx, j0=rank * rows, j1=(rank + 1) * rows,
        south=rank - 1 if rank > 0 else None,
        north=rank + 1 if rank < py - 1 else None,
        fold=bool(tripole) and rank == py - 1, comm=comm)


def shard_pytree(tree, mesh: Decomposition):
    """Every whole-domain horizontal field of ``tree`` cut to ``mesh``'s
    slab (the JAX package places each leaf with its (y, x) sharding)."""
    return mesh.slab(tree)


def sharded_model(cfg, mesh: Optional[Decomposition] = None, grid=None,
                  device="cuda"):
    """(model, mesh): a ``Model`` of this rank's slab of ``cfg`` on
    ``mesh`` (default: ``cfg.mesh_shape`` over the process group). The
    model is built on the whole domain and then cut to the slab
    (``Model._decompose``)."""
    from pop2_tpu_torch.model import Model
    model = Model(cfg, grid=grid, device=device, mesh=mesh)
    return model, model.mesh
