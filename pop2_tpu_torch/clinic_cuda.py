"""The fused momentum forcing: CUDA kernel, wrapper and plain version.

Replaces the TPU kernel ``clinic_pallas.py`` (``_kernel`` /
``clinic_rhs_tiles``) with ``csrc/clinic.cu``:

    fx = -L(u) + f*(wc*v_cur + wo*v_old) - PKX + am*Lap(u,v) + D_v(u_old)
    fy = -L(v) - f*(wc*u_cur + wo*u_old) - PKY + am*Lap(v,-u) + D_v(v_old)

masked to ocean, plus the thickness-weighted vertical means ZX, ZY.

On an H100 the forcing is bound by bytes: six distinct 3-D inputs on the
model's path (the mixing-time velocities are the old ones on a leapfrog step
and the current ones on an Euler step, so they alias two of the other inputs)
and two 3-D outputs plus two dozen 2-D fields, against about 150 flops per
output pair.
The plain version materializes the four U-face flux fields, every shifted
operand and the pressure cumsum in device memory. The kernel reads each
operand once: a block is a 2-D tile of columns in a one-column frame that
walks down k and stages each level in shared memory by asynchronous copies
ahead of the arithmetic; every column forms its T-face fluxes once a level
and then its west and south U faces from its neighbours', and takes the east
and north faces from its neighbours, all through shared memory; w from
continuity, the running pressure integral, the friction flux and the ZX/ZY
sums go down k in registers, so the vertical means need no second pass and
no atomics and are deterministic (see the note in ``csrc/clinic.cu``).
``launch_plan`` chooses the tile and its shared memory in plain Python.
Float32 and float64.

Two modes, chosen by ``cfg.hmix_momentum``: ``'del2'`` fuses the Laplacian
friction (``with_hdiffu=True``, the dynamical-core path); ``'aniso'`` and
``'del4'`` run the kernel without it (``with_hdiffu=False``: the um, vm
planes and the ten weights are not read) and ``clinic_rhs`` adds the
anisotropic or biharmonic friction of ``hmix`` afterwards, ZX/ZY included,
as the JAX package's wrapper does. The um, vm operands feed the Laplacian
friction alone: under ``ltopostress`` ``clinic_rhs`` hands the kernel their
departure from the topographic-stress velocities
(``hmix.topostress_relative``, formed once a step), and the kernel's fold
of the north ghost row folds that difference, as the JAX package's
``bc.n(umixk - TSU, ...)`` does. Closed or tripole north edge (the kernel
reads the fold of the north ghost row: u, v as NE-corner vectors, the
density as a centre scalar, the ghost row's south-face flux vus as the fold
of an E-face vector), full or partial bottom cells: under partial bottom
cells (``Grid.DZBU`` set) the ``PBC`` instances read the bottom level's
thickness at U points, one (ny, nx) plane besides KMU, and stage it with
KMU on the frame (counter ``launches_pbc``).

The pressure averaging, the Boussinesq scaling of the density and the choice
of Coriolis weights stay in the wrapper, as in the JAX package.
"""

from __future__ import annotations

import torch

from pop2_tpu_torch import _cuda_build as cb
from pop2_tpu_torch import launch_counts
from pop2_tpu_torch import advect, constants as const, hmix, pgrad, vmix
from pop2_tpu_torch.grid import grid_bc, thickness_u
from pop2_tpu_torch.parallel import mesh as pmesh

#: kernel launches so far (a plain counter; reset it to measure a run)
launches = 0
#: launches of the partial-bottom-cell (PBC) instances
launches_pbc = 0
#: the mode counters ``graphs.CapturedStep`` keeps exact under replay
MODE_COUNTERS = ("launches_pbc",)

#: order of the stacked 2-D metric operand; DUCM = DUC + DUM, the combined
#: centre weight of hmix_del2.F90:892 (must match enum G2D in csrc/clinic.cu)
G2D = ("DYU", "DXU", "UAREA_R", "FCOR", "KXU", "KYU", "DXUR", "DYUR",
       "DUCM", "DUN", "DUS", "DUE", "DUW",
       "DMC", "DMN", "DMS", "DME", "DMW", "HUR")


TILE_COLS = 32  # interior columns a tile row (kFrameCols: one warp)
# interior rows a tile by value size (ClinicTile<T>::kRows of csrc/clinic.cu)
TILE_ROWS = {4: 8, 8: 6}
N_WEIGHTS = 10  # Laplacian weights DUCM .. DMW, kept in shared memory


def smem_values(rows: int, pbc: bool = False) -> int:
    """Values of shared memory a tile of ``rows`` rows takes: the DYU, DXU
    frame planes (and KMU, DZBU under partial bottom cells), four staged
    levels of u, v (frame planes), three of um, vm, the density (frame
    planes) and uo, vo, the viscosity (tile planes), two buffers each of
    the published a, b and uuw, vus, and the Laplacian weights
    (``ClinicTile<T, PBC>::kValues`` of csrc/clinic.cu, which chip_smoke.py
    holds this against)."""
    plane, tile = (TILE_COLS + 2) * (rows + 2), TILE_COLS * rows
    return ((4 if pbc else 2) * plane + 4 * 2 * plane + 3 * (3 * plane + 3 * tile)
            + 2 * 2 * plane + 2 * 2 * plane + N_WEIGHTS * tile)


def launch_plan(value_bytes: int, pbc: bool = False):
    """(block shape (TILE_COLS, rows), dynamic shared memory bytes) of a
    momentum kernel launch in values of ``value_bytes``, full or partial
    bottom cells. Raises for values other than float32 or float64, or a
    tile over the card's 227 KB."""
    if value_bytes not in TILE_ROWS:
        raise TypeError(f"kernels take float32 or float64, got "
                        f"{value_bytes}-byte values")
    rows = TILE_ROWS[value_bytes]
    smem = smem_values(rows, pbc) * value_bytes
    cb.check_smem(smem, f"momentum tile ({TILE_COLS} x {rows}, pbc={pbc})")
    return (TILE_COLS, rows), smem


def with_hdiffu(cfg) -> bool:
    """Whether the Laplacian friction is fused into the kernel."""
    return cfg.hmix_momentum == "del2"


def _check_mode(cfg, grid):
    todo = []
    if cfg.hmix_momentum not in ("del2", "aniso", "del4"):
        todo.append(f"hmix_momentum={cfg.hmix_momentum!r} (with_hdiffu="
                    "False beside a friction that is not ported)")
    if cfg.ns_boundary not in ("closed", "tripole"):
        todo.append(f"ns_boundary={cfg.ns_boundary!r}")
    if cfg.ew_boundary not in ("cyclic", "closed"):
        todo.append(f"ew_boundary={cfg.ew_boundary!r}")
    if todo:
        raise NotImplementedError(
            "momentum forcing kernel mode not ported yet (ROADMAP.md Queue 2 "
            "kernel 3): " + "; ".join(todo))


def pack_g2d(cfg, grid):
    """Stack the static 2-D metric operands in ``G2D`` order,
    (19, ny, nx)."""
    fields = {name: getattr(grid, name) for name in G2D if name != "DUCM"}
    fields["DUCM"] = grid.DUC + grid.DUM
    return torch.stack([fields[name] for name in G2D])


def kernel_statics(cfg, grid):
    """The kernel's operands that depend on the grid alone: ``(g2d, dzwr2,
    facs)`` = the stacked metrics, 1/(mid-level spacing below level k) and
    the half-level pressure factors dzw*g/2. Built at the first launch on a
    ``Grid`` object and kept on it, so a step does not rebuild them; a
    ``replace``d or moved grid is a new object and gets its own."""
    hit = grid.__dict__.get("_clinic_statics")
    if hit is None:
        facs = grid.vgrid.dzw[0:cfg.km] * (const.GRAV * 0.5)
        hit = (pack_g2d(cfg, grid), vmix.dzwr2(grid), facs)
        grid.__dict__["_clinic_statics"] = hit
    return hit


def coriolis_weights(cfg, leapfrog: bool):
    """(wc, wo): weights of the current and old velocity in the Coriolis
    term (source/baroclinic.F90:971-995)."""
    if cfg.time.impcor and leapfrog:
        return cfg.time.gamma, 1.0 - cfg.time.gamma
    if leapfrog:
        return 1.0, 0.0
    return 0.0, 1.0


def clinic_rhs_plain(cfg, grid, ucur, vcur, uold, vold, umix, vmixm, rhoavg,
                     vvc, smf, dhu, wc: float, wo: float):
    """Plain PyTorch version: -advu + Coriolis - gradp [+ the Laplacian
    friction of umix, vmixm] + vdiffu, masked, and the ZX/ZY sums (clinic,
    source/baroclinic.F90:1635-1895 and :1035-1057); the Laplacian only in
    the ``with_hdiffu`` mode. ``rhoavg`` is the averaged, Boussinesq-scaled
    density (``pgrad.rho_average``)."""
    bc = grid_bc(cfg)
    luk, lvk = advect.advu(cfg, grid, bc, ucur, vcur, dhu)
    fx = -luk + grid.FCOR * (wc * vcur + wo * vold)
    fy = -lvk - grid.FCOR * (wc * ucur + wo * uold)

    pkx, pky = pgrad.gradp(cfg, grid, bc, rhoavg)
    fx = fx - pkx
    fy = fy - pky

    if with_hdiffu(cfg):
        hduk, hdvk = hmix.del2_friction(cfg, grid, bc, umix, vmixm)
        fx = fx + hduk
        fy = fy + hdvk

    du, dv = vmix.vdiffu(cfg, grid, vvc, uold, vold, smf)
    fx = torch.where(grid.kmask_u, fx + du, 0.0)
    fy = torch.where(grid.kmask_u, fy + dv, 0.0)

    # vertical average of the forcing (fx/fy are zero below the bottom)
    dzc = thickness_u(cfg, grid)
    zx = grid.HUR * _level_sum(fx * dzc)
    zy = grid.HUR * _level_sum(fy * dzc)
    return fx, fy, zx, zy


def _level_sum(x):
    """x summed over its levels (dim 0) one level after another, as the
    kernel's thread down its column: the same bits at every point of any
    plane (torch.sum's order on the CPU depends on where a point lies in
    the tensor, so a block's plane would round some points otherwise);
    one call, the scan's last level."""
    return torch.cumsum(x, 0)[-1]


@pmesh.halo_wrapped(pmesh.HALO_MAX)
def clinic_rhs_fields(cfg, grid, ucur, vcur, uold, vold, umix, vmixm, rhoavg,
                      vvc, smf, dhu, wc: float, wo: float):
    """(fx, fy, zx, zy) from explicit fields: eight (km, ny, nx) tensors,
    smf (2, ny, nx), dhu (ny, nx) and the Coriolis weights. CUDA tensors go
    through the kernel, CPU tensors through the plain version."""
    _check_mode(cfg, grid)
    if not ucur.is_cuda:
        return clinic_rhs_plain(cfg, grid, ucur, vcur, uold, vold, umix,
                                vmixm, rhoavg, vvc, smf, dhu, wc, wo)
    km, ny, nx = ucur.shape
    dev, dt = ucur.device, ucur.dtype
    pbc = grid.DZBU is not None
    (_, rows), smem = launch_plan(ucur.element_size(), pbc)
    vg = grid.vgrid
    dz = vg.dz
    g2d, dzwr2, facs = kernel_statics(cfg, grid)
    f3, f2 = (km, ny, nx), (ny, nx)
    for name, t in (("ucur", ucur), ("vcur", vcur), ("uold", uold),
                    ("vold", vold), ("umix", umix), ("vmix", vmixm),
                    ("rhoavg", rhoavg), ("vvc", vvc)):
        cb.check_operand(name, t, f3, dt, dev)
    cb.check_operand("g2d", g2d, (len(G2D), ny, nx), dt, dev)
    cb.check_operand("KMU", grid.KMU, f2, torch.int32, dev)
    cb.check_operand("dhu", dhu, f2, dt, dev)
    cb.check_operand("smf", smf, (2, ny, nx), dt, dev)
    cb.check_operand("dz", dz, (km,), dt, dev)
    if pbc:
        cb.check_operand("DZBU", grid.DZBU, f2, dt, dev)
    lib = cb.lib()
    if lib.pop2_clinic_g2d_count() != len(G2D):
        raise RuntimeError("G2D layout differs between clinic_cuda.py and "
                           "csrc/clinic.cu")
    fx = torch.empty_like(ucur)
    fy = torch.empty_like(ucur)
    zx = torch.empty_like(dhu)
    zy = torch.empty_like(dhu)
    err = lib.pop2_clinic(
        cb.dtype_code(ucur), int(with_hdiffu(cfg)), km, ny, nx,
        int(cfg.ew_boundary == "cyclic"), pmesh.kernel_fold(cfg, ny),
        rows, smem, ucur.data_ptr(), vcur.data_ptr(), uold.data_ptr(),
        vold.data_ptr(), umix.data_ptr(), vmixm.data_ptr(),
        rhoavg.data_ptr(), vvc.data_ptr(), g2d.data_ptr(),
        grid.KMU.data_ptr(), dhu.data_ptr(), smf.data_ptr(), dz.data_ptr(),
        vg.dzr.data_ptr(), vg.dz2r.data_ptr(), dzwr2.data_ptr(),
        facs.data_ptr(),
        float(cfg.auto_am), float(cfg.bottom_drag), float(wc), float(wo),
        fx.data_ptr(), fy.data_ptr(), zx.data_ptr(), zy.data_ptr(),
        grid.DZBU.data_ptr() if pbc else 0, cb.stream_ptr())
    cb.check_launch(err, "clinic_rhs")
    launch_counts.add(__name__)
    if pbc:
        launch_counts.add(__name__, "launches_pbc")
    return fx, fy, zx, zy


def clinic_rhs(cfg, grid, state, umix, vmixm, rho_new, vvc, smf, dhu,
               leapfrog: bool):
    """Model-facing wrapper: form the pressure-averaged, Boussinesq-scaled
    density, pick the Coriolis time weights, and compute (fx, fy, zx, zy)
    (source/baroclinic.F90:935-1057). The fused Laplacian acts on the
    velocities' departure from the topographic-stress ones under
    ``ltopostress``. Without it the anisotropic or biharmonic friction is
    added to the forcing and its vertical mean (clinic_pallas.py's wrapper
    does the same for aniso)."""
    rhoavg = pgrad.rho_average(cfg, grid, state.rho_old, state.rho_cur,
                               rho_new, leapfrog)
    wc, wo = coriolis_weights(cfg, leapfrog)
    um, vm = (hmix.topostress_relative(cfg, grid, umix, vmixm)
              if with_hdiffu(cfg) else (umix, vmixm))
    fx, fy, zx, zy = clinic_rhs_fields(
        cfg, grid, state.u_cur, state.v_cur, state.u_old, state.v_old, um,
        vm, rhoavg, vvc, smf, dhu, wc, wo)
    if not with_hdiffu(cfg):
        hdu, hdv = hmix.hdiffu(cfg, grid, grid_bc(cfg), umix, vmixm)
        dzc = thickness_u(cfg, grid)
        fx = fx + hdu
        fy = fy + hdv
        zx = zx + grid.HUR * torch.sum(hdu * dzc, dim=0)
        zy = zy + grid.HUR * torch.sum(hdv * dzc, dim=0)
    return fx, fy, zx, zy
