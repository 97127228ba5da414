"""Domain decomposition over ranks: every (..., ny, nx) field in 2-D blocks.

Counterpart of the JAX package's ``parallel/mesh.py``, where XLA's SPMD
partitioner inserts the halo exchanges of every shifted access and turns
masked sums into psum trees. PyTorch has no partitioner, so this module
does explicitly what XLA did implicitly:

* ``Decomposition``: one process (rank) holds one block of a (py, px)
  mesh, the global rows [j0, j1) and columns [i0, i1); rank r = ry px + rx,
  y slower, as the JAX package reshapes its devices to ('y', 'x'). The
  vertical and tracer axes are never decomposed.
* ``scope``: the decomposition the stencil (``stencil.py``), the tripole
  fold (``tripole.py``), the reductions (``reductions.py``) and the kernel
  wrappers read while a step runs (the counterpart of
  ``tridiag_pallas.dispatch_mesh``). Outside a scope every function works
  on the whole domain, as before. A block grid carries its decomposition
  (``attach``), and what is given a block grid outside a step (the
  forcing's builders, the diagnostics) enters it (``grid_scope``), so a
  global sum there is global too.
* ``Decomposition.fetch``: any global rectangles of a set of fields, from
  whichever ranks own them, in one ``batch_isend_irecv`` (every field's
  pieces packed into one buffer a peer each way; fields of one dtype and
  shape travel stacked, and a region that holds the block whole starts as
  the block padded, so an exchange costs a few operations, not a few a
  field): the halo of a stencil (``halo``: rows, columns and corners from
  up to eight neighbours, and on the top row of blocks of a tripole grid
  the strip of the mirror block's top rows the fold reads), the window of
  a single shift (``tripole.window``: only the rows and columns it reads),
  the extended planes of a kernel call. Every rank knows every rank's
  geometry, so each computes what the others ask of it.
* ``Comm``: the point-to-point batches and the all-reduces of the global
  sums. Under gloo (ranks on the CPU, or sharing one card, where NCCL
  refuses two ranks on one device) the buffers go through host memory,
  explicitly, and the bytes staged are counted; under NCCL (a card a rank)
  they would stay on the device, but that branch has not run across cards
  and ``make_mesh`` refuses it (``refuse_across_cards``). The fields
  themselves stay where they are and every kernel runs there.
* ``halo_call``: a kernel wrapper's launch on its block extended by H rows
  and columns from its neighbours, the extension trimmed from its outputs.
  A block below the top row runs the closed instance (and, with px > 1,
  a closed east-west edge: its extended columns hold the neighbours'
  values); a top slab of a (py, 1) mesh runs the tripole instance on its
  whole rows. A top-row block of an x decomposition runs the tripole
  instance on a plane whose first ``STRIP_ROWS`` rows are the mirror
  block's top rows (``kernel_layout``): the kernels take the fold's rows
  from there (the ``fold`` argument of ``csrc/common.cuh``), the plain
  versions too (``fold_top``).

Block (ry, rx) holds rows [ry ny/py, (ry+1) ny/py) and columns [rx nx/px,
(rx+1) nx/px); the top row of blocks (ry = py-1) holds the tripole fold,
whose partner columns nx-1-i lie on the mirror block px-1-rx.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from pop2_tpu_torch._tree import TensorTree

#: widest kernel frame: upwind3's tracer tendency (tracer_cuda.UPW_HALO)
HALO_MAX = 2
#: rows of the top slab the tripole fold reads (distance-2 shifts of
#: corner fields reach ny-3)
FOLD_ROWS = 3
#: rows of the mirror strip in a top-row block's kernel plane under an x
#: decomposition: the fold's rows and one below them (the plain versions
#: fold face values formed with the row below, ``advect.advu``'s vus)
STRIP_ROWS = FOLD_ROWS + 1

_ACTIVE: Optional["Decomposition"] = None
#: inside a kernel call on a strip plane: the rows through the fold's top
#: row (``fold_top``)
_FOLD_TOP: Optional[int] = None


def active() -> Optional["Decomposition"]:
    """The decomposition of the running scope, or None (whole domain)."""
    return _ACTIVE


def over_ranks(d: Optional["Decomposition"]) -> bool:
    """``d`` splits the domain over ranks (a block with a communicator),
    not None and not a mesh of one block."""
    return d is not None and d.comm is not None


def block_cfg(cfg, ny: int, nx: int):
    """``cfg`` with a block's dims: ``ny``, ``nx`` its rows and columns, and
    the Laplacian coefficients that scale with the grid's width
    (``auto_am``, ``auto_ah``) kept at the whole domain's."""
    return cfg.with_(ny=ny, nx=nx, am=cfg.auto_am, ah=cfg.auto_ah)


def fold_top(ny: int) -> int:
    """The rows through the tripole fold's top row in a plane of ``ny``
    rows: ``ny`` (the plane's own top rows fold), or inside a kernel call on
    a top-row block of an x decomposition the mirror strip's rows
    (``Decomposition.halo_call``), below which the plane's domain ends (a
    southward shift meets the south edge there)."""
    return ny if _FOLD_TOP is None else _FOLD_TOP


def kernel_fold(cfg, ny: int) -> int:
    """A kernel's ``fold`` argument (``csrc/common.cuh``): 0 on a closed
    north edge, else ``fold_top(ny)``."""
    return fold_top(ny) if cfg.ns_boundary == "tripole" else 0


@contextlib.contextmanager
def _fold_scope(top: Optional[int]):
    global _FOLD_TOP
    prev, _FOLD_TOP = _FOLD_TOP, top
    try:
        yield
    finally:
        _FOLD_TOP = prev


@contextlib.contextmanager
def scope(decomp: Optional["Decomposition"]):
    """Run the enclosed code on ``decomp``'s block (None: the whole domain,
    which is how ``halo_call`` runs a kernel on its extended block)."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, decomp
    try:
        yield decomp
    finally:
        _ACTIVE = prev


def attach(grid, decomp: Optional["Decomposition"]):
    """Mark ``grid`` (a block grid) as ``decomp``'s, so that what is given
    the grid outside a step (``grid_scope``) reduces over every block."""
    grid.__dict__["_decomposition"] = decomp
    return grid


def of_grid(grid) -> Optional["Decomposition"]:
    """The decomposition whose block ``grid`` is (``attach``), or None."""
    return grid.__dict__.get("_decomposition")


@contextlib.contextmanager
def grid_scope(grid):
    """``scope`` of ``grid``'s decomposition where none is active: a
    function given a block grid (the forcing's functions, the diagnostics)
    sums and shifts over every block, called in a step or outside one."""
    d = of_grid(grid)
    if _ACTIVE is None and d is not None:
        with scope(d):
            yield d
    else:
        yield _ACTIVE


def halo_wrapped(halo: int):
    """Decorator of a kernel wrapper ``fn(cfg, grid, *args, **kwargs)``:
    under a decomposition over ranks the wrapper runs on its block
    extended by ``halo`` rows and columns from its neighbours
    (``Decomposition.halo_call``: the operands' planes in one exchange, the
    tripole instance on the top row of blocks only) and keeps the block;
    the plain version it calls for CPU tensors is wrapped the same way. On
    the whole domain the call goes straight through."""
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


#: the bytes a piece of an exchange's buffer is padded to, so that every
#: piece starts where any dtype's values can be viewed in place
_ALIGN = 8


def _as_bytes(t):
    """``t``'s bytes, padded with zeros to a multiple of ``_ALIGN``."""
    b = t.contiguous().reshape(-1).view(torch.uint8)
    pad = -b.numel() % _ALIGN
    return torch.nn.functional.pad(b, (0, pad)) if pad else b


def _padded(t) -> int:
    """The bytes ``t``'s values take in an exchange's buffer."""
    n = t.numel() * t.element_size()
    return n + (-n % _ALIGN)


class Comm:
    """Halo exchanges and all-reduces between the blocks' ranks over
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

    def gather(self, t, root: int = 0):
        """Every rank's ``t`` (the same shape on every rank) on rank
        ``root``, in rank order, on the CPU; None on the other ranks."""
        import torch.distributed as dist
        w = self._to_wire(t.contiguous())
        out = None
        if dist.get_rank(self.group) == root:
            out = [torch.empty_like(w) for _ in range(
                dist.get_world_size(self.group))]
        dist.gather(w, out, dst=root, group=self.group)
        return None if out is None else [o.cpu() for o in out]

    def all_gather(self, t):
        """Every rank's ``t`` (the same shape on every rank), in rank
        order, on ``t``'s device."""
        import torch.distributed as dist
        w = self._to_wire(t.contiguous())
        out = [torch.empty_like(w) for _ in range(
            dist.get_world_size(self.group))]
        dist.all_gather(out, w, group=self.group)
        return [self._from_wire(o, t.device) for o in out]


#: a global rectangle: rows [ja, jb), columns [ia, ib), and whether the
#: columns wrap around the east-west edge (else zero past it); rows past the
#: global south and north edges are zero
Region = Tuple[int, int, int, int, bool]


class Halo(NamedTuple):
    """A block's field with ``depth`` rows and columns of its neighbours'
    around it (``ext``; zeros past a closed edge and past the global south
    and north edges) and, on a top-row block of a tripole grid, the strip of
    the top ``FOLD_ROWS`` rows its ghost rows fold from (``strip``, natural
    order: global columns nx - i1 - depth - 1 .. nx - i0 + depth - 1, the
    mirrors of the extended columns under both column maps of the fold);
    None elsewhere. ``Decomposition.halo`` makes them; a shift given one
    exchanges nothing."""
    ext: torch.Tensor
    depth: int
    strip: Optional[torch.Tensor]


@dataclasses.dataclass(frozen=True, eq=False)
class Decomposition:
    """One rank's block of an (ny, nx) grid on a (py, px) mesh: rank =
    ry px + rx, global rows [j0, j1) and columns [i0, i1); whether the
    east-west edge wraps, whether the north edge is a tripole fold, and the
    communicator (None for a single block)."""
    py: int
    px: int
    rank: int
    ny: int
    nx: int
    cyclic: bool = True
    tripole: bool = False
    comm: Optional[Comm] = None

    def __post_init__(self):
        # the extended grids of ``halo_call``, by block grid: (grid, {halo:
        # extended grid}); the block grid is kept so its id stays its own
        object.__setattr__(self, "_ext_grids", {})
        # the pieces of ``fetch`` by the name of their regions
        object.__setattr__(self, "_plans", {})
        # ``static_halo``'s halos by their tensors' ids: (tensors, halos)
        object.__setattr__(self, "_static", {})

    # -- geometry -----------------------------------------------------------
    @property
    def ry(self) -> int:
        return self.rank // self.px

    @property
    def rx(self) -> int:
        return self.rank % self.px

    @property
    def rows(self) -> int:
        return self.ny // self.py

    @property
    def cols(self) -> int:
        return self.nx // self.px

    @property
    def j0(self) -> int:
        return self.ry * self.rows

    @property
    def j1(self) -> int:
        return self.j0 + self.rows

    @property
    def i0(self) -> int:
        return self.rx * self.cols

    @property
    def i1(self) -> int:
        return self.i0 + self.cols

    @property
    def south(self) -> Optional[int]:
        return self.rank - self.px if self.ry > 0 else None

    @property
    def north(self) -> Optional[int]:
        return self.rank + self.px if self.ry < self.py - 1 else None

    def _x_neighbour(self, step: int) -> Optional[int]:
        if self.px == 1:
            return None  # the block holds every column
        rx = self.rx + step
        if not 0 <= rx < self.px:
            if not self.cyclic:
                return None
            rx %= self.px
        return self.ry * self.px + rx

    @property
    def west(self) -> Optional[int]:
        return self._x_neighbour(-1)

    @property
    def east(self) -> Optional[int]:
        return self._x_neighbour(+1)

    @property
    def top(self) -> bool:
        return self.north is None

    @property
    def fold(self) -> bool:
        """The block holds the tripole fold's rows (the top row of
        blocks of a tripole grid)."""
        return self.tripole and self.top

    def block(self, rank: int) -> "Decomposition":
        """Rank ``rank``'s block of the same mesh (no communicator)."""
        return dataclasses.replace(self, rank=rank, comm=None)

    # -- blocks of whole-domain data ----------------------------------------
    def is_field(self, t, shape: Optional[Tuple[int, int]] = None) -> bool:
        """A horizontal field of trailing ``shape`` (default: the global
        (ny, nx))."""
        shape = (self.ny, self.nx) if shape is None else tuple(shape)
        return (isinstance(t, torch.Tensor) and t.dim() >= 2
                and tuple(t.shape[-2:]) == shape)

    def is_block(self, t) -> bool:
        """A horizontal field of this block's (rows, cols)."""
        return self.is_field(t, (self.rows, self.cols))

    def slab(self, tree):
        """Every whole-domain horizontal field of ``tree`` cut to this
        block (a copy, so the whole field can be freed); anything else
        kept."""
        def cut(t):
            if self.is_field(t):
                return t[..., self.j0:self.j1, self.i0:self.i1].clone()
            return t
        return tree_map(cut, tree)

    # -- exchanges of global rectangles ---------------------------------------
    def _pieces(self, region: Region):
        """[(owner rank, (a, b, c, e) rows and columns of the owner's block,
        (r0, c0) where they land in the region)] of a global rectangle, in
        a fixed order (every rank enumerates a region alike)."""
        ja, jb, ia, ib, wrap = region
        rows, cols, nx = self.rows, self.cols, self.nx
        segs = []  # (global column range, its offset in the region)
        if wrap:
            for k in range(ia // nx, (ib - 1) // nx + 1):
                s, e = max(ia, k * nx), min(ib, (k + 1) * nx)
                if s < e:
                    segs.append((s - k * nx, e - k * nx, s - ia))
        elif max(ia, 0) < min(ib, nx):
            segs.append((max(ia, 0), min(ib, nx), max(ia, 0) - ia))
        out = []
        for ry in range(self.py):
            a, b = max(ja, ry * rows), min(jb, (ry + 1) * rows)
            if a >= b:
                continue
            for g0, g1, dc in segs:
                for rx in range(self.px):
                    c, e = max(g0, rx * cols), min(g1, (rx + 1) * cols)
                    if c < e:
                        out.append((ry * self.px + rx,
                                    (a - ry * rows, b - ry * rows,
                                     c - rx * cols, e - rx * cols),
                                    (a - ja, dc + c - g0)))
        return out

    def _plan(self, regions_of, key):
        """(this block's regions, [(region index, owner, (a, b, c, e),
        (r0, c0))] of their pieces, {peer: [(a, b, c, e)] of this block's
        pieces it asks for}, [the padding (west, east, south, north) that
        puts this block where a region holds it whole, else None]): what
        ``fetch`` moves, kept by ``key``. A region's piece of this whole
        block is left out: ``fetch`` pads the block into it instead."""
        plan = self._plans.get(key)
        if plan is None:
            mine = regions_of(self)
            pads = []
            for ja, jb, ia, ib, _ in mine:
                inner = ja <= self.j0 and jb >= self.j1 and \
                    ia <= self.i0 and ib >= self.i1
                pads.append((self.i0 - ia, ib - self.i1, self.j0 - ja,
                             jb - self.j1) if inner else None)
            whole = (0, self.rows, 0, self.cols)
            pieces = [(ri, owner, src, dst) for ri, reg in enumerate(mine)
                      for owner, src, dst in self._pieces(reg)
                      if not (pads[ri] is not None and owner == self.rank
                              and src == whole
                              and dst == (pads[ri][2], pads[ri][0]))]
            asked = {}
            for q in range(self.py * self.px):
                if q != self.rank and self.comm is not None:
                    got = [src for reg in regions_of(self.block(q))
                           for owner, src, _ in self._pieces(reg)
                           if owner == self.rank]
                    if got:
                        asked[q] = got
            plan = self._plans[key] = (mine, pieces, asked, pads)
        return plan

    def _fetch_groups(self, tensors, regions_of, key):
        """``fetch`` of the tensors stacked by dtype and shape: ([the
        indices into ``tensors`` of each group], [for each region, each
        group's values over it, (k, ..., jb - ja, ib - ia) for a group of k
        > 1, else the tensor's own shape]). An exchange then costs a
        group's operations, not a field's."""
        groups = {}
        for ti, t in enumerate(tensors):
            groups.setdefault((t.dtype, tuple(t.shape)), []).append(ti)
        groups = list(groups.values())
        stacks = [tensors[g[0]] if len(g) == 1
                  else torch.stack([tensors[i] for i in g]) for g in groups]
        mine, pieces, asked, pads = self._plan(regions_of, key)
        out = [[torch.nn.functional.pad(s, pad) if pad is not None
                else s.new_zeros(s.shape[:-2] + (r[1] - r[0], r[3] - r[2]))
                for s in stacks] for r, pad in zip(mine, pads)]
        want = {}  # owner -> the slices of ``out`` its bytes land in
        for ri, owner, (a, b, c, e), (r0, c0) in pieces:
            for gi, s in enumerate(stacks):
                dst = out[ri][gi][..., r0:r0 + b - a, c0:c0 + e - c]
                if owner == self.rank:
                    dst.copy_(s[..., a:b, c:e])
                else:
                    want.setdefault(owner, []).append(dst)
        if not stacks or self.comm is None:
            return groups, out
        sends = [(q, torch.cat([_as_bytes(s[..., a:b, c:e])
                                for a, b, c, e in srcs for s in stacks]))
                 for q, srcs in asked.items()]
        peers = sorted(want)
        got = self.comm.sendrecv(
            sends, [(q, sum(_padded(d) for d in want[q])) for q in peers],
            stacks[0].device)
        for q, buf in zip(peers, got):
            at = 0
            for dst in want[q]:
                size = dst.numel() * dst.element_size()
                dst.copy_(buf[at:at + size].view(dst.dtype)
                          .reshape(dst.shape))
                at += _padded(dst)
        return groups, out

    @staticmethod
    def _ungroup(groups, parts, n: int):
        """A list of ``n`` tensors from ``_fetch_groups``' groups: each
        group's parts unstacked (views) into their tensors' places."""
        out = [None] * n
        for g, p in zip(groups, parts):
            for i, v in zip(g, (p,) if len(g) == 1 else p.unbind(0)):
                out[i] = v
        return out

    def fetch(self, tensors, regions_of, key):
        """For each region of ``regions_of(self)`` (a list of ``Region``;
        ``regions_of`` is called with every rank's ``block``, so each rank
        knows what the others ask of it), each of ``tensors`` (this block's
        fields, (..., rows, cols)) over it: (..., jb - ja, ib - ia), the
        owners' values, zero where no block lies. One exchange a call (none
        where every piece is this block's own); every rank of the mesh
        calls it. ``key``: the name of ``regions_of``, under which its
        pieces are kept for the next call."""
        tensors = list(tensors)
        groups, out = self._fetch_groups(tensors, regions_of, key)
        return [self._ungroup(groups, parts, len(tensors)) for parts in out]

    def strip_region(self, depth: int, nrows: int) -> Region:
        """The top ``nrows`` rows over the mirrors of columns [i0 - depth,
        i1 + depth) under both column maps of the fold (nx-1-i, nx-2-i),
        wrapping (the fold's nx-1 -> nx-1 is the wrap of -1)."""
        a = self.nx - self.i1 - depth - 1
        return (self.ny - nrows, self.ny, a, a + self.cols + 2 * depth + 1,
                True)

    def halo(self, tensors, depth: int = 1):
        """A ``Halo`` of each of ``tensors`` (this block's fields), all in
        one exchange: ``depth`` rows and columns of the neighbours, the
        corners included, and on a top-row block of a tripole grid the
        fold's strip."""
        wrap = self.px == 1 and self.cyclic

        def regions(b):
            if wrap:  # every column is the block's: they wrap here
                ext = (b.j0 - depth, b.j1 + depth, 0, b.nx, False)
            else:
                ext = (b.j0 - depth, b.j1 + depth, b.i0 - depth,
                       b.i1 + depth, b.cyclic)
            return [ext] + ([b.strip_region(depth, FOLD_ROWS)] if b.fold
                            else [])
        tensors = list(tensors)
        groups, got = self._fetch_groups(tensors, regions, ("halo", depth))
        ext = got[0]
        if wrap:
            ext = [torch.cat([e[..., -depth:], e, e[..., :depth]], dim=-1)
                   for e in ext]
        ext = self._ungroup(groups, ext, len(tensors))
        strips = (self._ungroup(groups, got[1], len(tensors)) if self.fold
                  else [None] * len(ext))
        return [Halo(e, depth, s) for e, s in zip(ext, strips)]

    def static_halo(self, tensors, depth: int = 1):
        """``halo`` of tensors that do not change (a preconditioner's
        weights), fetched at the first call with these tensors and kept.
        Every rank meets that first call at the same place, so the
        exchange is joined by all."""
        tensors = list(tensors)
        key = tuple(id(t) for t in tensors) + (depth,)
        entry = self._static.get(key)
        if entry is None or any(a is not b
                                for a, b in zip(entry[0], tensors)):
            entry = self._static[key] = (tensors,
                                         self.halo(tensors, depth))
        return entry[1]

    # -- kernel calls on extended blocks ------------------------------------
    def kernel_layout(self, halo: int):
        """(strip, south, north, west, east) of a kernel's plane: the rows of
        the mirror strip below it (``STRIP_ROWS`` on a top-row block of a
        tripole grid with px > 1, else 0; the domain's south edge lies
        between the strip and the rows above it, ``csrc/common.cuh``
        ``first_row``) and the rows and columns of the neighbours around
        the block. A strip plane has ``halo`` + 1 columns each side (the
        fold's corner map reads one column further); a slab of a (py, 1)
        mesh keeps its whole rows; a global edge adds nothing (but a
        cyclic one's columns)."""
        s = halo if self.south is not None else 0
        if self.px > 1 and self.fold:
            return STRIP_ROWS, s, 0, halo + 1, halo + 1
        n = halo if self.north is not None else 0
        w = halo if self.west is not None else 0
        e = halo if self.east is not None else 0
        return 0, s, n, w, e

    def kernel_regions(self, halo: int):
        """The regions of a kernel's plane (``kernel_layout``): the strip
        (natural order, its last column the mirror of the plane's first,
        so the fold's index map nx-1-i of the plane's columns lands on it)
        and the extended block."""
        k, s, n, w, e = self.kernel_layout(halo)
        main = (self.j0 - s, self.j1 + n, self.i0 - w, self.i1 + e,
                self.cyclic)
        if not k:
            return [main]
        a = self.nx - self.i1 - e
        return [(self.ny - k, self.ny, a, a + self.cols + w + e, True), main]

    def kernel_planes(self, tensors, halo: int):
        """Each of ``tensors`` (this block's fields) as a kernel's plane
        (``kernel_layout``), all in one exchange."""
        tensors = list(tensors)
        groups, got = self._fetch_groups(
            tensors, lambda b: b.kernel_regions(halo), ("kernel", halo))
        planes = got[0] if len(got) == 1 else [
            torch.cat(parts, dim=-2) for parts in zip(*got)]
        return self._ungroup(groups, planes, len(tensors))

    def kernel_cfg(self, cfg, rows: int, cols: int):
        """``cfg`` as a kernel launched on this block's plane of ``rows``
        x ``cols`` sees it: a closed north edge unless the block holds the
        fold (the closed instance's zero ghost row lies past the trimmed
        halo), and with px > 1 a closed east-west edge (the plane's columns
        hold the neighbours' values; a wrap would read its own far edge)."""
        ns = cfg.ns_boundary
        if ns == "tripole" and not self.fold:
            ns = "closed"
        ew = cfg.ew_boundary if self.px == 1 else "closed"
        return block_cfg(cfg, rows, cols).with_(ns_boundary=ns,
                                                ew_boundary=ew)

    def ext_grid(self, grid, halo: int):
        """The block grid ``grid`` as a kernel's plane (``kernel_planes`` of
        every horizontal field of it), made once a grid and kept, so that
        the kernels' statics cached on it are built once. Every rank makes
        it at the same call (its first halo'd call on that grid), so the
        exchange is joined by all."""
        entry = self._ext_grids.get(id(grid))
        if entry is None or entry[0] is not grid:
            entry = (grid, {})
            self._ext_grids[id(grid)] = entry
        ext = entry[1].get(halo)
        if ext is None:
            leaves = []
            tree_map(lambda t: leaves.append(t) if self.is_block(t)
                     else None, grid)
            wide = iter(self.kernel_planes(leaves, halo))
            ext = tree_map(lambda t: next(wide) if self.is_block(t) else t,
                           grid)
            entry[1][halo] = ext
        return ext

    def halo_call(self, fn, cfg, grid, halo: int, *args, **kwargs):
        """``fn(cfg, grid, *args, **kwargs)`` (a kernel wrapper) on this
        block's plane (``kernel_layout``): the horizontal fields among
        ``args`` and ``kwargs`` (tensors, or inside NamedTuples) exchanged
        in one call, the grid extended once, ``stencil.BC`` arguments and
        ``cfg`` as ``kernel_cfg`` makes them, the wrapper run with no
        decomposition active (on a strip plane with ``fold_top`` the
        strip's rows), and the extension trimmed from its outputs."""
        from pop2_tpu_torch.stencil import BC
        k, s, n, w, e = self.kernel_layout(halo)
        rows, cols = k + s + self.rows + n, w + self.cols + e
        leaves = []
        tree_map(lambda t: leaves.append(t) if self.is_block(t) else None,
                 (args, kwargs))
        # every rank asks the same regions of its neighbours: the halo'd
        # call is one exchange on every rank
        wide = iter(self.kernel_planes(leaves, halo))
        lcfg = self.kernel_cfg(cfg, rows, cols)

        def widen(v):
            if isinstance(v, BC):
                return BC(lcfg.ew_boundary, lcfg.ns_boundary)
            return tree_map(lambda t: next(wide) if self.is_block(t) else t,
                            v)
        args = tuple(widen(a) for a in args)
        kwargs = {key: widen(v) for key, v in kwargs.items()}
        ext = self.ext_grid(grid, halo)
        with scope(None), _fold_scope(k or None):
            out = fn(lcfg, ext, *args, **kwargs)
        return tree_map(
            lambda t: t[..., k + s:k + s + self.rows, w:w + self.cols]
            .contiguous() if self.is_field(t, (rows, cols)) else t, out)


def refuse_across_cards(what: str) -> None:
    """Raise for what runs only with a card a rank: NCCL's exchanges and a
    captured step under them have not run on a machine of several cards
    (ROADMAP.md Queue 1 item 12b, across cards). Ranks that share a card,
    or run on the CPU, take gloo."""
    raise NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md Queue 1 item 12b (across "
        "cards)); ranks on one card or on the CPU run over gloo")


def make_mesh(shape: Tuple[int, int], ny: int, nx: int,
              tripole: bool = False, cyclic: bool = True) -> Decomposition:
    """This rank's block of an (ny, nx) grid on a (py, px) mesh over the
    process group (``multihost.initialize_distributed``; one block needs
    none). Refuses ``ny % py``, ``nx % px`` other than 0, blocks of fewer
    rows than the widest kernel halo plus the fold's rows, blocks narrower
    than the widest kernel halo, and a tripole fold across blocks of a
    closed east-west edge (its seam's ghost columns would need both a wrap
    and a zero; POP's tripole grids are cyclic), and a process group over
    NCCL (``refuse_across_cards``)."""
    py, px = (int(v) for v in shape)
    if py < 1 or ny % py != 0:
        raise ValueError(f"ny={ny} does not split into {py} blocks of equal "
                         "rows")
    if px < 1 or nx % px != 0:
        raise ValueError(f"nx={nx} does not split into {px} blocks of equal "
                         "columns")
    rows, cols = ny // py, nx // px
    if py > 1 and rows < HALO_MAX + FOLD_ROWS:
        raise ValueError(
            f"blocks of {rows} rows: a block needs at least {HALO_MAX} rows "
            f"(the widest kernel halo) + {FOLD_ROWS} (the fold's rows)")
    if px > 1 and cols < HALO_MAX:
        raise ValueError(
            f"blocks of {cols} columns: a block needs at least {HALO_MAX} "
            "columns (the widest kernel halo)")
    if px > 1 and tripole and not cyclic:
        raise ValueError("a tripole fold across x blocks needs a cyclic "
                         "east-west edge")
    n = py * px
    if n > 1:
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError(
                f"a mesh of {n} blocks needs a process group: "
                "parallel.multihost.initialize_distributed first")
        if dist.get_world_size() != n:
            raise ValueError(f"mesh of {n} blocks on "
                             f"{dist.get_world_size()} ranks")
        backend = dist.get_backend()
        if backend == "nccl":
            refuse_across_cards("a decomposition over NCCL (a card a rank)")
        rank, comm = dist.get_rank(), Comm(backend)
    else:
        rank, comm = 0, None
    return Decomposition(py=py, px=px, rank=rank, ny=ny, nx=nx,
                         cyclic=bool(cyclic), tripole=bool(tripole),
                         comm=comm)


def shard_pytree(tree, mesh: Decomposition):
    """Every whole-domain horizontal field of ``tree`` cut to ``mesh``'s
    block (the JAX package places each leaf with its (y, x) sharding)."""
    return mesh.slab(tree)


def sharded_model(cfg, mesh: Optional[Decomposition] = None, grid=None,
                  device="cuda"):
    """(model, mesh): a ``Model`` of this rank's block of ``cfg`` on
    ``mesh`` (default: ``cfg.mesh_shape`` over the process group). The
    model is built on the whole domain and then cut to the block
    (``Model._decompose``)."""
    from pop2_tpu_torch.model import Model
    model = Model(cfg, grid=grid, device=device, mesh=mesh)
    return model, model.mesh
