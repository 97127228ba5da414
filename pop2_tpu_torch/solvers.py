"""Barotropic elliptic solvers: ChronGear, PCSI, and standard PCG.

Reference: ``source/POP_SolversMod.F90`` — ChronGear (:1841, one fused 2-field
reduction per iteration), PCSI (:1510, Stiefel iteration with no
per-iteration reduction; eigenvalue bounds from a Lanczos pass at init,
:2699), PCG (:1200), and the 9-point operator (:2376) exploiting weight
symmetry.

Each solver is a ``Solver``: an initial pass, runs of iterations and a
check, over a carry of device tensors. The scalars of the recurrences
(alpha, beta, rho, sigma; PCSI's coefficients, from a table at a device
counter) stay on the device; the residual norm comes back to the host only
on the convergence-check iterations (every ``convergence_check_freq``), so
the loop stops at the same iteration numbers as the JAX package's
``lax.while_loop`` and iteration counts are comparable. Between checks
nothing synchronizes. Eagerly the loop is launch-bound on a GPU (a dozen
small kernels an iteration); ``graphs.py`` replays each run of iterations
between checks as one CUDA graph.

The preconditioner is the diagonal one, the factored sparse approximate
inverse ``FSPAI9`` (``build_fspai9``), or a 9-point stencil ``Precond9``:
the plain SPAI (``build_spai9``) or one read from a file (``load_precond``,
the reference's 'file' preconditioner). The stencils are built once on the
host in float64 NumPy. PCSI's eigenvalue bounds come from a Lanczos pass
(diagonal) or from the CG-Lanczos coefficients of a preconditioned CG run
(``pcg_lanczos_eigs``).

The JAX package's double-single ``solve_refined`` exists because its target
has no float64 datapath; the GPU has one, so ``solve_dtype='float64'`` under
a float32 model simply casts the 2-D solve to float64 (``solve``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from pop2_tpu_torch.config import ModelConfig
from pop2_tpu_torch.grid import Grid
from pop2_tpu_torch.parallel import mesh as _mesh
from pop2_tpu_torch.reductions import global_sum
from pop2_tpu_torch.stencil import BC
from pop2_tpu_torch.tripole import folded


class BtropOperator(NamedTuple):
    """9-point operator weights on T points, compressed form: the S/W/SW
    weights are shifted copies of N/E/NE. ``center`` includes the
    time-dependent free-surface diagonal term (POP_SolversPrep,
    source/POP_SolversMod.F90:181-270)."""
    center: torch.Tensor
    north: torch.Tensor
    east: torch.Tensor
    ne: torch.Tensor
    mask: torch.Tensor    # RCALCT (1/0) — reductions masked to ocean points
    resid_norm: torch.Tensor  # 1/sum(TAREA^2 over ocean): rms normalization

    def to(self, dtype):
        return BtropOperator(*(t.to(dtype) for t in self))


def make_operator(grid: Grid, diagonal_correction) -> BtropOperator:
    """center = centerWgtClinicIndep - diagonalCorrection
    (source/POP_SolversMod.F90:249-253)."""
    return BtropOperator(
        center=grid.btrop_c_indep - diagonal_correction,
        north=grid.btrop_n, east=grid.btrop_e, ne=grid.btrop_ne,
        mask=grid.RCALCT, resid_norm=grid.residual_norm)


def _shifted_weights(op: BtropOperator, bc: BC):
    """The S, W, SE, NW, SW weights of the compressed operator."""
    return (bc.s(op.north), bc.w(op.east), bc.s(op.ne), bc.w(op.ne),
            bc.sw(op.ne))


def apply_op(op: BtropOperator, x, bc: BC, shifted=None):
    """A @ x via the 9-point stencil (source/POP_SolversMod.F90:2412-2426).
    ``shifted`` takes the precomputed ``_shifted_weights`` so a solver loop
    shifts the weights once instead of at every application."""
    w_s, w_w, w_se, w_nw, w_sw = shifted or _shifted_weights(op, bc)
    rows, = bc.halo([x])  # the shifts' halo in one exchange
    return (op.center * x
            + op.north * bc.n(x, rows=rows) + w_s * bc.s(x, rows=rows)
            + op.east * bc.e(x, rows=rows) + w_w * bc.w(x, rows=rows)
            + op.ne * bc.ne(x, rows=rows) + w_se * bc.se(x, rows=rows)
            + w_nw * bc.nw(x, rows=rows) + w_sw * bc.sw(x, rows=rows))


def _masked_sum(x, mask, b4b: bool = False):
    """Masked global dot-product sum (POP_GlobalSum)."""
    return global_sum(x * mask, b4b=b4b)


def _diag_precond(op: BtropOperator):
    nz = op.center != 0.0
    return torch.where(nz, 1.0 / torch.where(nz, op.center, 1.0), 0.0)


class FSPAI9(NamedTuple):
    """Factored sparse approximate inverse: a 9-point stencil G with
    M = -G^T G ~ A^-1 (A negative definite), SPD by construction
    (the JAX package's ``solvers.FSPAI9``)."""
    center: torch.Tensor
    north: torch.Tensor
    south: torch.Tensor
    east: torch.Tensor
    west: torch.Tensor
    ne: torch.Tensor
    nw: torch.Tensor
    se: torch.Tensor
    sw: torch.Tensor

    def to(self, dtype):
        return FSPAI9(*(t.to(dtype) for t in self))


class Precond9(NamedTuple):
    """A 9-point preconditioner stencil M^-1 ~ A^-1 (the reference's 'file'
    preconditioner, source/POP_SolversMod.F90:2310-2324, coefficients read
    from a preconditioner file at init :700-760; the JAX package's
    ``solvers.Precond9``)."""
    center: torch.Tensor
    north: torch.Tensor
    south: torch.Tensor
    east: torch.Tensor
    west: torch.Tensor
    ne: torch.Tensor
    nw: torch.Tensor
    se: torch.Tensor
    sw: torch.Tensor

    def to(self, dtype):
        return Precond9(*(t.to(dtype) for t in self))


def load_precond(path: str, dtype, device="cuda") -> Precond9:
    """A 9-point preconditioner from an .npz with the field names of
    ``Precond9`` (the counterpart of the reference's binary preconditioner
    file), as tensors of ``dtype`` on ``device``."""
    from pop2_tpu_torch.convert import precond_from_numpy  # imports solvers
    with np.load(path) as data:
        return precond_from_numpy(data, dtype, device)


def precond9_apply(p: Precond9, bc: BC):
    """Closure z = M r of a 9-point stencil."""
    def apply9(r):
        rows, = bc.halo([r])  # the shifts' halo in one exchange
        return (p.center * r
                + p.north * bc.n(r, rows=rows) + p.south * bc.s(r, rows=rows)
                + p.east * bc.e(r, rows=rows) + p.west * bc.w(r, rows=rows)
                + p.ne * bc.ne(r, rows=rows) + p.nw * bc.nw(r, rows=rows)
                + p.se * bc.se(r, rows=rows) + p.sw * bc.sw(r, rows=rows))
    return apply9


#: a 9-point preconditioner stencil of either form
Preconditioner = Union[FSPAI9, Precond9]

_OFFS9 = ((0, 0), (1, 0), (-1, 0), (0, 1), (0, -1),
          (1, 1), (1, -1), (-1, 1), (-1, -1))
_FIELD_OF_OFF = {(0, 0): "center", (1, 0): "north", (-1, 0): "south",
                 (0, 1): "east", (0, -1): "west", (1, 1): "ne",
                 (1, -1): "nw", (-1, 1): "se", (-1, -1): "sw"}
_REV_FIELD = {"center": "center", "north": "south", "south": "north",
              "east": "west", "west": "east", "ne": "sw", "sw": "ne",
              "nw": "se", "se": "nw"}
_SHIFT_OF_FIELD = {"north": "n", "south": "s", "east": "e", "west": "w",
                   "ne": "ne", "nw": "nw", "se": "se", "sw": "sw"}


def _row_stencils(op: BtropOperator, sh):
    """Dense per-point row weights W1[(dj, di)] of the 9-point operator as
    float64 NumPy (``apply_op``'s layout: the S/W/SW weights are shifted
    N/E/NE)."""
    def host(t):
        return t.double().cpu().numpy()

    c, n_, e_, ne_ = (host(op.center), host(op.north), host(op.east),
                      host(op.ne))
    return {
        (0, 0): c,
        (1, 0): n_, (-1, 0): sh(n_, 0, -1),
        (0, 1): e_, (0, -1): sh(e_, -1, 0),
        (1, 1): ne_, (-1, 1): sh(ne_, 0, -1),
        (1, -1): sh(ne_, -1, 0), (-1, -1): sh(ne_, -1, -1),
    }


def build_fspai9(cfg: ModelConfig, op: BtropOperator,
                 triangular: bool = True) -> FSPAI9:
    """Build G on the host in float64: for each ocean point p the row g_p
    on its 9-point neighbourhood solves the local SPD system
    (-A)[S_p, S_p] y = e_p, normalized g_p = y / sqrt(y_p) (the factored
    SPAI, Kaporin row). With ``triangular`` the support is the
    lexicographically lower neighbours (the classical FSPAI structure, an
    approximate inverse Cholesky factor). The tripole seam is treated as
    closed for the build only (any SPD M preconditions; the solve keeps
    the fold). Returns the stencil in the operator's dtype on its
    device."""
    from pop2_tpu_torch.grid import _np_shift
    ew = cfg.ew_boundary
    ny, nx = op.center.shape

    def sh(f, di, dj):
        return _np_shift(f, di, dj, ew, "closed", 0.0)

    w1 = _row_stencils(op, sh)
    w1 = {o: -w for o, w in w1.items()}          # -A: SPD
    mask = op.mask.double().cpu().numpy() * (w1[(0, 0)] != 0.0)

    P = ny * nx
    L = np.zeros((P, 9, 9))
    valid = np.zeros((P, 9), bool)
    J, I = np.mgrid[0:ny, 0:nx]
    lex = (J * nx + I).ravel()
    for a, (dja, dia) in enumerate(_OFFS9):
        ok = (sh(mask, dia, dja) > 0).ravel()
        if triangular and a > 0:
            # the neighbour's lexicographic index (a cyclic edge wraps the
            # column, triangular but for the seam column)
            jn = J + dja
            in_ = (I + dia) % nx if ew == "cyclic" else I + dia
            inside = (jn >= 0) & (jn < ny) & (in_ >= 0) & (in_ < nx)
            lex_n = np.where(inside, jn * nx + np.clip(in_, 0, nx - 1), -1)
            ok = ok & (lex_n.ravel() < lex) & (lex_n.ravel() >= 0)
        valid[:, a] = ok
        for bb, (djb, dib) in enumerate(_OFFS9):
            o = (djb - dja, dib - dia)
            if o in w1:
                L[:, a, bb] = sh(w1[o], dia, dja).ravel()

    act = valid[:, :, None] & valid[:, None, :]
    L = np.where(act, L, 0.0)
    eye = np.eye(9)[None]
    # inactive support points get a unit diagonal (decoupled), land rows
    # the identity, so the batched solve stays nonsingular
    for a in range(9):
        L[:, a, a] = np.where(valid[:, a], L[:, a, a], 1.0)
    L[~valid[:, 0]] = eye

    e0 = np.zeros((P, 9))
    e0[:, 0] = 1.0
    y = np.linalg.solve(L, e0[..., None])[..., 0]
    yp = np.maximum(y[:, 0], 1e-300)
    G = y / np.sqrt(yp)[:, None]
    G = np.where(valid, G, 0.0)
    G[~valid[:, 0]] = 0.0

    return FSPAI9(**{
        _FIELD_OF_OFF[o]: torch.as_tensor(G[:, a].reshape(ny, nx)).to(
            device=op.center.device, dtype=op.center.dtype)
        for a, o in enumerate(_OFFS9)})


def build_spai9(cfg: ModelConfig, op: BtropOperator, ridge: float = 1e-10
                ) -> Precond9:
    """Build the symmetric 9-point SPAI stencil M ~ A^-1 on the host in
    float64.

    G_p[a,b] = (A^2)[p+o_a, p+o_b] (A symmetric), so the normal-equation
    Gram matrices come from the 25-point stencil of A^2, assembled as
    shifted products of the row stencils. The tripole seam is treated as
    closed for the build only (the solve keeps the exact fold). The
    symmetrized stencil can be indefinite (the JAX package measured it on
    gx1v7), which ``FSPAI9`` is not. Returns the stencil in the operator's
    dtype on its device."""
    from pop2_tpu_torch.grid import _np_shift
    ew = cfg.ew_boundary
    ny, nx = op.center.shape

    def sh(f, di, dj):
        return _np_shift(f, di, dj, ew, "closed", 0.0)

    w1 = _row_stencils(op, sh)
    mask = op.mask.double().cpu().numpy() * (w1[(0, 0)] != 0.0)

    # A^2 stencil: W2[o2][p] = sum_o W1[o][p] * W1[o2-o][p+o]
    w2 = {}
    for (dj, di), wa in w1.items():
        for (dj2, di2), _ in w1.items():
            o2 = (dj + dj2, di + di2)
            contrib = wa * sh(w1[(dj2, di2)], di, dj)
            w2[o2] = w2.get(o2, 0.0) + contrib

    P = ny * nx
    G = np.zeros((P, 9, 9))
    b = np.zeros((P, 9))
    valid = np.zeros((P, 9), bool)
    for a, (dja, dia) in enumerate(_OFFS9):
        ok_a = sh(mask, dia, dja) > 0      # support point p+o_a is ocean
        valid[:, a] = ok_a.ravel()
        b[:, a] = w1[(dja, dia)].ravel()
        for bb, (djb, dib) in enumerate(_OFFS9):
            o = (djb - dja, dib - dia)
            if o in w2:
                # (A^2)[p+o_a, p+o_b] = W2[o_b-o_a] evaluated at p+o_a
                G[:, a, bb] = sh(w2[o], dia, dja).ravel()

    # deactivate invalid support points; regularize
    act = valid[:, :, None] & valid[:, None, :]
    G = np.where(act, G, 0.0)
    diag_scale = np.maximum(np.abs(G[:, 0, 0]), 1.0)
    eye = np.eye(9)[None]
    G = G + (ridge * diag_scale[:, None, None] + 1e-300) * eye
    G[~valid[:, 0]] = eye                  # land rows: trivial system
    b = np.where(valid, b, 0.0)

    m = np.linalg.solve(G, b[..., None])[..., 0]     # (P, 9)
    m = np.where(valid, m, 0.0)
    m[~valid[:, 0]] = 0.0

    fields = {_FIELD_OF_OFF[o]: m[:, a].reshape(ny, nx)
              for a, o in enumerate(_OFFS9)}

    # symmetrize: M[p, p+o] <- (M[p, p+o] + M[p+o, p]) / 2
    pairs = (((1, 0), (-1, 0)), ((0, 1), (0, -1)),
             ((1, 1), (-1, -1)), ((1, -1), (-1, 1)))
    for o_f, o_r in pairs:
        f_name, r_name = _FIELD_OF_OFF[o_f], _FIELD_OF_OFF[o_r]
        f_val, r_val = fields[f_name], fields[r_name]
        # counterpart of forward entry at p: reverse entry at p+o_f
        fields[f_name] = 0.5 * (f_val + sh(r_val, o_f[1], o_f[0]))
        fields[r_name] = 0.5 * (r_val + sh(f_val, o_r[1], o_r[0]))

    return Precond9(**{k: torch.as_tensor(v).to(
        device=op.center.device, dtype=op.center.dtype)
        for k, v in fields.items()})


def fspai_apply(p: FSPAI9, bc: BC):
    """Closure z = M r = -(G^T (G r)): two 9-point passes. G^T's weight for
    offset o at point p is G's weight for -o at p+o, so the transposed pass
    shifts the products."""
    def bsh(f, name, rows=None):
        if name == "center":
            return f
        return getattr(bc, _SHIFT_OF_FIELD[name])(f, rows=rows)

    shifted = [f_ for f_ in FSPAI9._fields if f_ != "center"]

    def apply(r):
        rr, = bc.halo([r])  # each pass's shifts' halo in one exchange
        gr = sum(getattr(p, f_) * bsh(r, f_, rr) for f_ in FSPAI9._fields)
        # (G^T v)[q] = sum_o G[q+o, q] v[q+o] = sum_o bsh_o(G_rev(o) * v)
        hg, = bc.halo([gr])
        d = _mesh.active()
        if hg is None:  # the whole domain, or each shift fetching its own
            prods = [getattr(p, _REV_FIELD[f_]) * gr
                     for f_ in FSPAI9._fields]
            return -sum(bsh(v, f_) for f_, v in zip(FSPAI9._fields, prods))
        # on a block the products past its edges are formed from gr's halo
        # and the weights' (fetched once): one field travels, not eight,
        # and each product has the bits its owner's would
        hw = d.static_halo([getattr(p, _REV_FIELD[f_]) for f_ in shifted])
        ext = dict(zip(shifted, hw))
        g = folded(hg)

        def term(f_):
            if f_ == "center":
                return p.center * gr
            return bsh(gr, f_, _mesh.Halo(folded(ext[f_]) * g, 1, None))
        return -sum(term(f_) for f_ in FSPAI9._fields)
    return apply


def make_precond_apply(cfg: ModelConfig, op: BtropOperator, bc: BC,
                       precond=None):
    """Returns z = M^-1 r as a closure: the diagonal preconditioner (where
    the config asks for it or no stencil is given), the FSPAI stencil, or
    the 9-point file or SPAI stencil (preconditioner dispatch,
    source/POP_SolversMod.F90:2273-2364)."""
    choice = cfg.solver.preconditioner.lower()
    if choice == "diagonal" or precond is None:
        a0r = _diag_precond(op)
        return lambda r: r * a0r
    if isinstance(precond, FSPAI9):
        return fspai_apply(precond, bc)
    if choice in ("file", "spai"):
        return precond9_apply(precond, bc)
    raise NotImplementedError(f"preconditioner {cfg.solver.preconditioner}")


def _safe(x):
    """x where nonzero, else 1: guards the recurrences' divisions so an
    already-converged (e.g. zero-RHS) system stays finite."""
    return torch.where(x != 0.0, x, 1.0)


def _tolerance(cfg: ModelConfig, op: BtropOperator) -> float:
    """Squared-residual threshold (source/POP_SolversMod.F90:906)."""
    return cfg.solver.convergence_criterion ** 2 / float(op.resid_norm)


def tolerance(cfg: ModelConfig, grid: Grid) -> float:
    """``_tolerance`` of the grid's operator, its norm read from the device
    once and kept on the grid: a step then reads nothing from the device but
    the convergence checks."""
    norm = grid.__dict__.get("_residual_norm_host")
    if norm is None:
        norm = float(grid.residual_norm)
        grid.__dict__["_residual_norm_host"] = norm
    return cfg.solver.convergence_criterion ** 2 / norm


def chunk_schedule(max_iter: int, ncheck: int, nstart: int = 0):
    """((n, check), ...): the runs of iterations between the host's reads.
    A check (the true residual and rr) ends every run that ends on a
    multiple of ``ncheck`` at or past ``nstart``; a last run shorter than
    ``ncheck`` has none, as the loop makes no check there."""
    out, m = [], 0
    while m < max_iter:
        n = min(ncheck, max_iter - m)
        m += n
        out.append((n, m % ncheck == 0 and m >= nstart))
    return tuple(out)


class PCSIBounds(NamedTuple):
    """PCSI's eigenvalue bounds and, built once, its coefficient table
    (``pcsi_table``); ``table`` None builds it at each solve."""
    eig_min: float
    eig_max: float
    table: Optional[torch.Tensor] = None


def pcsi_table(cfg: ModelConfig, eig_min: float, eig_max: float, dtype,
               device, max_iter: Optional[int] = None) -> torch.Tensor:
    """(max_iter, 2): omega_m and csy*omega_m - 1 of the Stiefel recurrence
    for m = 1.., computed on the host in float64 as the loop computed them.
    The sequence has no data in it but changes every iteration, so both the
    eager loop and a captured run of iterations read it from the device at
    an iteration counter: a graph would keep a host value it captured."""
    if max_iter is None:
        max_iter = cfg.solver.max_iterations
    csalpha = 2.0 / (eig_max - eig_min)
    csbeta = (eig_max + eig_min) / (eig_max - eig_min)
    csy = csbeta / csalpha
    omga = 2.0 / csy
    rows = []
    for _ in range(max_iter):
        omga = 1.0 / (csy - omga / (4.0 * csalpha * csalpha))
        rows.append((omga, csy * omga - 1.0))
    table = torch.tensor(rows, dtype=torch.float64).reshape(max_iter, 2)
    return table.to(device=device, dtype=dtype)


class Solver:
    """A barotropic solver as three parts over a carry, a dict of device
    tensors: ``init(x0, b)`` (the first pass and the initial residual),
    ``iterate(carry, n)`` (n iterations, no reduction read) and ``check``
    (the residual and ``rr``). ``run`` is the host loop: the runs of
    ``chunks``, each ended where it says by a check whose ``rr`` the host
    reads. The eager ``solve`` and the captured step (``graphs.py``) run
    these same parts, so both compute the same arithmetic and stop at the
    same iterations as the JAX package's ``lax.while_loop``.

    ``written``: the carry entries ``advance`` replaces; the carry owns
    them (no other tensor shares their memory), so a captured run may copy
    into them."""

    written: Tuple[str, ...] = ()
    initial_check = False  # the host reads rr of the first pass

    def __init__(self, cfg: ModelConfig, op: BtropOperator, bc: BC,
                 precond: Optional[Preconditioner] = None,
                 tol: Optional[float] = None,
                 max_iter: Optional[int] = None, nstart: int = 0):
        sol = cfg.solver
        self.cfg, self.op, self.bc = cfg, op, bc
        self.dtype = op.center.dtype
        self.minv = make_precond_apply(cfg, op, bc, precond)
        self.sh = _shifted_weights(op, bc)
        self.tol = _tolerance(cfg, op) if tol is None else tol
        self.max_iter = sol.max_iterations if max_iter is None else max_iter
        self.chunks = chunk_schedule(self.max_iter,
                                     sol.convergence_check_freq, nstart)

    def _apply(self, x):
        return apply_op(self.op, x, self.bc, self.sh)

    def _sum(self, x):
        return _masked_sum(x, self.op.mask, self.cfg.b4b)

    def _inf(self):
        return torch.full((), math.inf, dtype=self.dtype,
                          device=self.op.center.device)

    def advance(self, carry, n: int, check: bool):
        """n iterations and, where ``check``, the check: the new values of
        the ``written`` entries."""
        new = self.iterate(carry, n)
        if check:
            new.update(self.check({**carry, **new}))
        return new

    def run(self, carry, advance=None):
        """The iteration loop from ``init``'s carry; returns (carry,
        iterations, rr), ``rr`` the squared residual of the last check (inf
        if none ran). ``advance(carry, n, check)`` returns the carry after a
        run: by default the eager parts, in the captured step a replay."""
        if advance is None:
            def advance(c, n, check):
                return {**c, **self.advance(c, n, check)}
        if self.initial_check and float(carry["rr0"]) < self.tol:
            return carry, 0, carry["rr0"]
        m = 0
        for n, check in self.chunks:
            carry = advance(carry, n, check)
            m += n
            # the only host read of the loop
            if check and float(carry["rr"]) < self.tol:
                break
        return carry, m, carry["rr"]


class ChronGear(Solver):
    """Chronopoulos-Gear preconditioned CG
    (source/POP_SolversMod.F90:1841-2266): one fused 2-field reduction an
    iteration; the check replaces r by the true residual."""

    written = ("x", "r", "s", "q", "rho_old", "sigma", "rr")
    initial_check = True

    def init(self, x0, b):
        x0, b = x0.to(self.dtype), b.to(self.dtype)
        # initial residual + one pass of the standard algorithm
        r = b - self._apply(x0)
        rr0 = self._sum(r * r)
        z = self.minv(r)
        s = z
        q = self._apply(s)
        rho_old = self._sum(r * z)
        sigma = self._sum(s * q)
        alpha = rho_old / _safe(sigma)
        return dict(b=b, x=x0 + alpha * s, r=r - alpha * q, s=s, q=q,
                    rho_old=rho_old, sigma=sigma, rr0=rr0,
                    rr=torch.full_like(rr0, math.inf))

    def iterate(self, c, n: int):
        x, r, s, q = c["x"], c["r"], c["s"], c["q"]
        rho_old, sigma = c["rho_old"], c["sigma"]
        for _ in range(n):
            z = self.minv(r)
            az = self._apply(z)
            rho = self._sum(r * z)
            delta = self._sum(az * z)
            beta = rho / _safe(rho_old)
            sigma = delta - beta ** 2 * sigma
            alpha = rho / _safe(sigma)
            s = z + beta * s
            q = az + beta * q
            x = x + alpha * s
            r = r - alpha * q
            rho_old = rho
        return dict(x=x, r=r, s=s, q=q, rho_old=rho_old, sigma=sigma)

    def check(self, c):
        r = c["b"] - self._apply(c["x"])
        return dict(r=r, rr=self._sum(r * r))


class PCSI(Solver):
    """Preconditioned Classical Stiefel Iteration
    (source/POP_SolversMod.F90:1510-1835; Hu et al. 2013): no reduction in
    the loop body; the recurrence's coefficients come from ``pcsi_table``
    at the device counter ``k``; checks from ``convergence_check_start``
    on."""

    written = ("x", "r", "q", "k", "rr")

    def __init__(self, cfg: ModelConfig, op: BtropOperator, bc: BC,
                 eig_min: float, eig_max: float, precond=None, tol=None,
                 max_iter=None, table: Optional[torch.Tensor] = None):
        super().__init__(cfg, op, bc, precond, tol, max_iter,
                         nstart=cfg.solver.convergence_check_start)
        csalpha = 2.0 / (eig_max - eig_min)
        csbeta = (eig_max + eig_min) / (eig_max - eig_min)
        self.csy = csbeta / csalpha
        if table is None or table.shape[0] < self.max_iter:
            table = pcsi_table(cfg, eig_min, eig_max, self.dtype,
                               op.center.device, self.max_iter)
        self.table = table

    def init(self, x0, b):
        x0, b = x0.to(self.dtype), b.to(self.dtype)
        r = b - self._apply(x0)
        q = (1.0 / self.csy) * self.minv(r)
        x = x0 + q
        return dict(b=b, x=x, r=b - self._apply(x), q=q,
                    k=torch.zeros(1, dtype=torch.long, device=x.device),
                    rr=self._inf())

    def iterate(self, c, n: int):
        b, x, r, q, k = c["b"], c["x"], c["r"], c["q"], c["k"]
        for _ in range(n):
            w = self.table.index_select(0, k)  # (1, 2): omega, csy*omega-1
            q = w[:, 0] * self.minv(r) + w[:, 1] * q
            x = x + q
            r = b - self._apply(x)
            k = k + 1
        return dict(x=x, r=r, q=q, k=k)

    def check(self, c):
        return dict(rr=self._sum(c["r"] * c["r"]))


class PCG(Solver):
    """Standard preconditioned CG (source/POP_SolversMod.F90:1200-1508);
    the check replaces r by the true residual."""

    written = ("x", "r", "s", "eta_old", "rr")

    def init(self, x0, b):
        x0, b = x0.to(self.dtype), b.to(self.dtype)
        return dict(b=b, x=x0.clone(), r=b - self._apply(x0),
                    s=torch.zeros_like(x0),
                    eta_old=torch.ones((), dtype=x0.dtype, device=x0.device),
                    rr=self._inf())

    def iterate(self, c, n: int):
        x, r, s, eta_old = c["x"], c["r"], c["s"], c["eta_old"]
        for _ in range(n):
            z = self.minv(r)
            eta = self._sum(r * z)
            s = z + s * (eta / _safe(eta_old))
            q = self._apply(s)
            sq = self._sum(s * q)
            alpha = eta / _safe(sq)
            x = x + alpha * s
            r = r - alpha * q
            eta_old = eta
        return dict(x=x, r=r, s=s, eta_old=eta_old)

    def check(self, c):
        r = c["b"] - self._apply(c["x"])
        return dict(r=r, rr=self._sum(r * r))


def chron_gear(cfg: ModelConfig, op: BtropOperator, bc: BC, x0, b,
               precond: Optional[Preconditioner] = None,
               tol: Optional[float] = None, max_iter: Optional[int] = None):
    """ChronGear's solve. Returns (x, iterations, rr) with ``iterations`` a
    Python int and ``rr`` the squared residual of the last check (a 0-d
    tensor; inf if no check ran)."""
    s = ChronGear(cfg, op, bc, precond, tol, max_iter)
    carry, m, rr = s.run(s.init(x0, b))
    return carry["x"], m, rr


def pcsi(cfg: ModelConfig, op: BtropOperator, bc: BC, x0, b,
         eig_min: float, eig_max: float, precond: Optional[Preconditioner] = None,
         tol: Optional[float] = None, max_iter: Optional[int] = None):
    """PCSI's solve; eig_min/eig_max bound the preconditioned operator's
    spectrum. Returns (x, iterations, rr)."""
    s = PCSI(cfg, op, bc, eig_min, eig_max, precond, tol, max_iter)
    carry, m, rr = s.run(s.init(x0, b))
    return carry["x"], m, rr


def pcg(cfg: ModelConfig, op: BtropOperator, bc: BC, x0, b,
        precond: Optional[Preconditioner] = None,
        tol: Optional[float] = None, max_iter: Optional[int] = None):
    """Standard PCG's solve. Returns (x, iterations, rr)."""
    s = PCG(cfg, op, bc, precond, tol, max_iter)
    carry, m, rr = s.run(s.init(x0, b))
    return carry["x"], m, rr


def lanczos_eigs(cfg: ModelConfig, op: BtropOperator, bc: BC,
                 n_iter: Optional[int] = None,
                 seed: int = 0) -> Tuple[float, float]:
    """Estimate extreme eigenvalues of the diagonally-preconditioned operator
    by a Lanczos pass (PcsiLanczos, source/POP_SolversMod.F90:2699-3120; the
    reference then solves the tridiagonal eigenproblem with ratqr :3122 —
    here numpy does it on the host at init time).

    Returns (eig_min, eig_max) scaled with the reference's safety margins.
    """
    if n_iter is None:
        n_iter = cfg.solver.lanczos_iterations
    mask = op.mask.double().cpu().numpy()

    # Lanczos needs a symmetric operator: use the symmetrized
    # D^{-1/2} (-A) D^{-1/2} with D = |diag(A)|, which is similar to the
    # diagonally-preconditioned M^{-1}A used by the PCSI recurrence and
    # therefore shares its (positive) spectrum.
    d = torch.abs(op.center)
    pos = d > 0.0
    dmh = torch.where(pos, 1.0 / torch.sqrt(torch.where(pos, d, 1.0)), 0.0)
    sh = _shifted_weights(op, bc)

    rng = np.random.RandomState(seed)
    v0 = rng.rand(*mask.shape) * mask
    v0 /= np.sqrt((v0 * v0).sum())
    v = torch.as_tensor(v0).to(device=op.center.device, dtype=op.center.dtype)

    # the recurrence stays on the device; alphas and betas come back once
    v_prev = torch.zeros_like(v)
    beta = torch.zeros((), dtype=v.dtype, device=v.device)
    alphas, betas = [], []
    for _ in range(n_iter):
        w = -dmh * apply_op(op, dmh * v, bc, sh) * op.mask
        alpha = torch.sum(w * v)
        w = w - alpha * v - beta * v_prev
        beta = torch.sqrt(torch.sum(w * w))
        broke = beta < 1e-30
        v_prev, v = v, torch.where(broke, v, w / torch.where(broke, 1.0,
                                                             beta))
        alphas.append(alpha)
        betas.append(beta)
    alphas = torch.stack(alphas).double().cpu().numpy()
    betas = torch.stack(betas).double().cpu().numpy()
    # truncate at breakdown (beta ~ 0)
    stop = np.nonzero(betas < 1e-30)[0]
    if stop.size:
        ncut = int(stop[0]) + 1
        alphas, betas = alphas[:ncut], betas[:ncut]
    T = np.diag(alphas) + np.diag(betas[:-1], 1) + np.diag(betas[:-1], -1)
    eigs = np.linalg.eigvalsh(T)
    # |eigs| bounds with margins like the reference (PcsiLanczos scales nu
    # by 1/1.05 and mu by 1.05 empirically)
    emin = float(np.min(np.abs(eigs))) / 1.05
    emax = float(np.max(np.abs(eigs))) * 1.05
    return emin, emax


def pcg_lanczos_eigs(cfg: ModelConfig, op: BtropOperator, bc: BC,
                     precond, n_iter: Optional[int] = None,
                     seed: int = 0) -> Tuple[float, float]:
    """Extreme eigenvalues of the preconditioned operator M^-1 A for a
    9-point preconditioner (``FSPAI9`` or ``Precond9``), from the CG-Lanczos identity: PCG on (-A)x = b
    with M' = -M gives alpha, beta whose tridiagonal
    T_kk = 1/alpha_k + beta_{k-1}/alpha_{k-1},
    T_{k,k+1} = sqrt(beta_k)/alpha_k has the Ritz values of M^-1 A. The
    recurrence runs on the device; the coefficients come back once and the
    tridiagonal eigenproblem is solved on the host (as the reference's
    ratqr, source/POP_SolversMod.F90:3122). Returns (eig_min, eig_max) with
    the reference's safety margins."""
    if n_iter is None:
        n_iter = cfg.solver.lanczos_iterations
    minv = (fspai_apply(precond, bc) if isinstance(precond, FSPAI9)
            else precond9_apply(precond, bc))
    sh = _shifted_weights(op, bc)
    mask_np = op.mask.double().cpu().numpy()
    rng = np.random.RandomState(seed)
    r = torch.as_tensor(rng.rand(*mask_np.shape) * mask_np).to(
        device=op.center.device, dtype=op.center.dtype)
    mask = op.mask.to(r.dtype)

    z = -minv(r) * mask
    rz_old = torch.sum(r * z)
    p = z
    al, be, rzs = [], [], []
    for _ in range(n_iter):
        q = -apply_op(op, p, bc, sh) * mask
        pq = torch.sum(p * q)
        alpha = rz_old / torch.where(pq != 0.0, pq, 1.0)
        r = r - alpha * q
        z = -minv(r) * mask
        rz = torch.sum(r * z)
        beta = rz / torch.where(rz_old != 0.0, rz_old, 1.0)
        p = z + beta * p
        rz_old = rz
        al.append(alpha)
        be.append(beta)
        rzs.append(rz)
    al, be, rz = (torch.stack(v).double().cpu().numpy()
                  for v in (al, be, rzs))
    # truncate once the recurrence degenerates (rz ~ 0 or not positive)
    bad = np.nonzero(~((rz > 0) & np.isfinite(al) & (al > 0)))[0]
    ncut = max(int(bad[0]) if bad.size else n_iter, 2)
    al, be = al[:ncut], be[:ncut]
    diag = 1.0 / al
    diag[1:] += be[:-1] / al[:-1]
    offd = np.sqrt(np.maximum(be[:-1], 0.0)) / al[:-1]
    T = np.diag(diag) + np.diag(offd, 1) + np.diag(offd, -1)
    eigs = np.linalg.eigvalsh(T)
    return float(np.min(eigs)) / 1.05, float(np.max(eigs)) * 1.05


def make_solver(cfg: ModelConfig, op: BtropOperator, bc: BC, eigs=None,
                precond: Optional[Preconditioner] = None,
                tol: Optional[float] = None) -> Solver:
    """The solver of cfg.solver.choice (source/POP_SolversMod.F90:327-500)
    for ``op``. With ``solve_dtype='float64'`` under a float32 model the
    whole 2-D solve runs in float64 (the preconditioner too). ``eigs``:
    PCSI's bounds, a pair or ``PCSIBounds``."""
    if (cfg.solver.solve_dtype == "float64"
            and op.center.dtype != torch.float64):
        op = op.to(torch.float64)
    if precond is not None and precond.center.dtype != op.center.dtype:
        precond = precond.to(op.center.dtype)
    choice = cfg.solver.choice.lower()
    if choice == "chrongear":
        return ChronGear(cfg, op, bc, precond, tol)
    if choice == "pcsi":
        if eigs is None:
            raise ValueError("PCSI requires Lanczos eigenvalue bounds")
        return PCSI(cfg, op, bc, eigs[0], eigs[1], precond, tol,
                    table=getattr(eigs, "table", None))
    if choice == "pcg":
        return PCG(cfg, op, bc, precond, tol)
    raise NotImplementedError(choice)


def solve(cfg: ModelConfig, op: BtropOperator, bc: BC, x0, b,
          eigs=None, precond: Optional[Preconditioner] = None,
          tol: Optional[float] = None):
    """``make_solver``'s solve from x0, its solution cast back to x0's
    dtype. Returns (x, iterations, rr)."""
    s = make_solver(cfg, op, bc, eigs, precond, tol)
    carry, m, rr = s.run(s.init(x0, b))
    return carry["x"].to(x0.dtype), m, rr
