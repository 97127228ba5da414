"""The masked batched Thomas sweep: CUDA kernel, wrapper and plain version.

Replaces the TPU kernel ``tridiag_pallas.py`` (``_thomas_kernel`` /
``thomas_tiles``) with ``csrc/thomas.cu``.

On an H100 the sweep is bound by bytes: the least it can move is the coupling
``a`` once, each right-hand side once and each solution once, (1 + 2 nr)
fields, with about ten flops per value. The kernel gives one thread to each
water column and stages a block's columns of ``a`` and the right-hand sides,
all levels, in shared memory by asynchronous copies started ahead of the
sweep; the elimination coefficients and forward solutions stay there, and
the back substitution writes the solution once (see the note in
``csrc/thomas.cu``). ``launch_plan`` chooses the columns a block and the
shared memory in plain Python. Unlike the TPU kernel it
is instantiated for float32 and float64. The TPU kernel takes any number of
right-hand sides; this one is instantiated for 1 to ``MAX_RHS`` (4: the
production menu's salinity and three passive tracers on one factorisation),
and ``rhs_groups`` splits more into launches of at most ``MAX_RHS`` that
share the coupling, each reading it again.

``thomas`` launches the kernel for CUDA tensors and calls ``thomas_plain``
for CPU tensors; it never falls back from one to the other. Both form
``hfac_k * rhs_k`` themselves: callers pass the right-hand side unscaled.
Under partial bottom cells the diagonal term of each column's bottom level
differs from the level table's: the kernel's ``PBC`` instances read it as
one more (ny, nx) plane, ``hbot``, and use it at k = kmax (counter
``launches_pbc``); the plain version takes the 3-D hfac (``bottom_hfac``).
"""

from __future__ import annotations

from collections import Counter
from typing import NamedTuple

import torch

from pop2_tpu_torch import _cuda_build as cb

#: kernel launches so far (a plain counter; reset it to measure a run), and
#: the same by the right-hand sides a launch took
launches = 0
launches_by_nr: Counter = Counter()
#: launches of the partial-bottom-cell (PBC) instances
launches_pbc = 0
#: the mode counters ``graphs.CapturedStep`` keeps exact under replay
MODE_COUNTERS = ("launches_pbc",)

MAX_RHS = 4  # right-hand sides a launch: kMaxRhs of csrc/thomas.cu
MAX_LEVELS = 64  # kMaxLevels of csrc/thomas.cu
_COLS = 32  # columns a block: a warp


class ThomasPlan(NamedTuple):
    cols: int  # columns (threads) a block
    smem: int  # dynamic shared memory a block, bytes


def rhs_groups(nr: int):
    """[(n0, n)]: the launches that solve ``nr`` right-hand sides on one
    factorisation, each n <= MAX_RHS right-hand sides from n0, as even as
    the count allows (five are 3 + 2, not 4 + 1: the smaller slab keeps
    more blocks an SM); one launch for nr <= MAX_RHS."""
    if nr < 1:
        raise ValueError(f"a tridiagonal solve of {nr} right-hand sides")
    return cb.even_groups(nr, MAX_RHS)


def launch_plan(value_bytes: int, nr: int, km: int) -> ThomasPlan:
    """The launch of the kernel for ``nr`` right-hand sides (1 to MAX_RHS,
    a group of ``rhs_groups``) of ``km`` levels in values of
    ``value_bytes``: a warp of columns a block, each block staging (1 + nr)
    values a level of each of its columns (at most 80 KB, so that two
    blocks fit an SM). Raises for what the kernel does not take: km over
    MAX_LEVELS, nr outside 1 to MAX_RHS (``rhs_groups`` splits more), a
    slab over the card's shared memory."""
    if not 1 <= km <= MAX_LEVELS:
        raise NotImplementedError(
            f"km={km} exceeds the kernel's bound of {MAX_LEVELS} levels")
    if not 1 <= nr <= MAX_RHS:
        raise NotImplementedError(
            f"{nr} right-hand sides in one launch: the kernel takes 1 to "
            f"{MAX_RHS}; rhs_groups splits more into launches")
    smem = (1 + nr) * km * value_bytes * _COLS
    cb.check_smem(smem, f"thomas (nr={nr}, km={km})")
    return ThomasPlan(_COLS, smem)


def bottom_hfac(hfac, hbot, kmax):
    """(km, ny, nx): the level table ``hfac`` with each column's bottom
    level (kmax, 1-based) taking ``hbot`` (partial bottom cells)."""
    km = hfac.shape[0]
    kidx = torch.arange(km, device=hfac.device).reshape(km, 1, 1)
    return torch.where(kidx == kmax[None].long() - 1, hbot[None],
                       hfac.reshape(km, 1, 1))


def thomas_plain(hfac, h1, kmax, a, rhs, hbot=None):
    """Plain PyTorch version of the sweep (the reference's Thomas algorithm,
    source/vertical_mix.F90:1164, :1679), vectorized over every column.

    hfac: (km,) diagonal mass terms dz_k/c2dt_k, or (km, ny, nx) under
    partial bottom cells (or (km,) with the bottom level's term ``hbot``,
    formed into the 3-D one by ``bottom_hfac``).
    h1: (ny, nx) surface diagonal term (incl. the psurf correction).
    kmax: (ny, nx) int32 deepest level (1-based; 0 = land).
    a: (km, ny, nx) subdiagonal coupling, zero at the last level.
    rhs: (nr, km, ny, nx) right-hand sides before the hfac scaling.
    Returns (nr, km, ny, nx) solutions, zero below kmax.
    """
    if hbot is not None:
        hfac = bottom_hfac(hfac, hbot, kmax)
    km = a.shape[0]
    kmax = kmax[None]  # broadcast over the right-hand sides
    zero = torch.zeros_like(rhs[:, 0])

    # level-1 set-up (source/vertical_mix.F90:1263-1274)
    A_prev = a[0]
    D = h1 + A_prev
    E = [A_prev / D]
    B = h1 * E[0]
    F = [hfac[0] * rhs[:, 0] / D]

    # forward elimination
    for k in range(1, km):
        kk = k + 1  # 1-based level
        at_bottom = (kmax == kk)[0]
        wet = kmax >= kk  # level kk is ocean
        A_k = a[k]
        D = torch.where(at_bottom, hfac[k] + B, hfac[k] + A_k + B)
        D = torch.where(wet[0], D, torch.ones_like(D))  # no 0/0 on land
        E_k = torch.where(wet[0], A_k / D, torch.zeros_like(D))
        B = (hfac[k] + B) * E_k
        F.append(torch.where(wet, (hfac[k] * rhs[:, k] + A_prev * F[-1])
                             / D, zero))
        E.append(E_k)
        A_prev = A_k

    # back substitution (source/vertical_mix.F90:1338-1349)
    for k in range(km - 2, -1, -1):
        interior = (k + 1) < kmax
        F[k] = torch.where(interior, F[k] + E[k] * F[k + 1], F[k])
    return torch.stack(F, dim=1)


def thomas(hfac, h1, kmax, a, rhs, hbot=None):
    """Solve the masked tridiagonal systems of every column; shapes as in
    ``thomas_plain`` with ``hfac`` (km,) and, under partial bottom cells,
    ``hbot`` (ny, nx) the bottom level's diagonal term. CUDA tensors go
    through the kernel (float32 or float64, contiguous, km within
    ``launch_plan``'s bound; any number of right-hand sides, a launch for
    each of ``rhs_groups``), CPU tensors through the plain version."""
    global launches, launches_pbc
    if not rhs.is_cuda:
        return thomas_plain(hfac, h1, kmax, a, rhs, hbot)
    nr, km, ny, nx = rhs.shape
    dev, dt = rhs.device, rhs.dtype
    groups = [(n0, n, launch_plan(rhs.element_size(), n, km))
              for n0, n in rhs_groups(nr)]
    cb.check_operand("hfac", hfac, (km,), dt, dev)
    cb.check_operand("h1", h1, (ny, nx), dt, dev)
    cb.check_operand("kmax", kmax, (ny, nx), torch.int32, dev)
    cb.check_operand("a", a, (km, ny, nx), dt, dev)
    cb.check_operand("rhs", rhs, (nr, km, ny, nx), dt, dev)
    if hbot is not None:
        cb.check_operand("hbot", hbot, (ny, nx), dt, dev)
    lib = cb.lib()
    out = torch.empty_like(rhs)
    for n0, n, plan in groups:
        err = lib.pop2_thomas(
            cb.dtype_code(rhs), n, km, ny * nx, *plan, hfac.data_ptr(),
            h1.data_ptr(), kmax.data_ptr(), a.data_ptr(),
            rhs[n0].data_ptr(), out[n0].data_ptr(),
            0 if hbot is None else hbot.data_ptr(), cb.stream_ptr())
        cb.check_launch(err, "thomas")
        launches += 1
        launches_by_nr[n] += 1
        if hbot is not None:
            launches_pbc += 1
    return out
