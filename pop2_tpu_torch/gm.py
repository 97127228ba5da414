"""Gent-McWilliams eddy transport + Redi isopycnal diffusion (skew-flux form).

Reference: ``source/hmix_gm.F90`` (hdifft_gm :1102-2219, init :283-1095) and
``source/hmix_gm_submeso_share.F90`` (tracer_diffs_and_isopyc_slopes
:149-434): constant or buoyancy-frequency-dependent ('bfre') isopycnal and
thickness diffusivities, 'notanh' slope control, the Large et al. (1997)
near-surface Rossby-radius taper or the transition-layer scheme with its
merged streamfunction, surface-boundary-layer horizontal diffusion, and the
|S|^2 vertical flux folded into the implicit vertical diffusivity (VDC_GM).

This module is the plain whole-field chain. The reference's level-by-level
sweep with carried two-level ring buffers and the FZTOP carry becomes
whole-column tensors: every quantity is computed for all (half, face, k) at
once. Three hand-written CUDA kernels replace parts of it on the GPU:
``gm_slope_cuda`` (``_slopes``/``_sla``/N^2), ``gm_chain_cuda`` (everything
after the slopes when the transition layer is on) and ``gm_cuda`` (the flux
assembly at the end of ``hdifft_gm``); each holds its plain version built
from the functions here.

Slope indexing: arrays carry a leading axis pair (face, half) with
face 0 = east/north, face 1 = west/south; half 0 = top (ktp), 1 = bottom
(kbt), matching the reference's (ieast/iwest, ktp/kbt) quarter cells.

On a tripole grid the north face differences fold as centre scalars and the
south-face skew weights' ghost row is the fold of the north-face ones with
the sign flipped (``BC.n_partner``, in the flux assembly).

With KPP the diabatic depth of the transition layer is the smoothed
boundary-layer depth (``kpp.smooth_hblt``), and without the transition
layer the boundary-layer depth bounds the near-surface taper.

The diffusivity types are the JAX package's: 'const', 'bfre' (the N^2
profile), 'depth' (an exponential profile), 'vmhs' (Visbeck et al. 1997)
and 'eg' (Eden & Greatbatch 2008), isopycnal and thickness diffusivities of
one type or of two (``kappa_fields``); without the transition layer GM may
be anisotropic (``gm_aniso`` 'grid' or 'flow', ``_aniso_factors``): the
flux assembly then takes the x and y faces' diffusivities apart, in its
kernel's ``ANISO`` instances. The 'vmhs' and 'eg' diffusivities and 'flow'
read the mixing-time velocities (``hdifft_gm``'s ``umix``, ``vmix_m``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from pop2_tpu_torch import constants as const
from pop2_tpu_torch import eos, kpp
from pop2_tpu_torch.config import ModelConfig
from pop2_tpu_torch.gm_cuda import flux_assembly, flux_assembly_plain
from pop2_tpu_torch.gm_cuda import level_below as _down
from pop2_tpu_torch.grid import Grid
from pop2_tpu_torch.stencil import BC, ugrid_to_tgrid

__all__ = ["GMOut", "TLT", "hdifft_gm", "flux_assembly",
           "flux_assembly_plain"]

EPS = 1.0e-10
EPS2 = 1.0e-20


class GMOut(NamedTuple):
    gtk: torch.Tensor       # (nt, km, ny, nx) tracer tendency
    vdc_gm: torch.Tensor    # (km, ny, nx) addition to implicit diffusivity
    # cell averages of the tapered top/bottom-half diffusivities
    # (KAPPA_ISOP/KAPPA_THIC/HOR_DIFF, source/hmix_gm.F90:1401-1421,1630)
    kappa_isop: Optional[torch.Tensor] = None   # (km, ny, nx)
    kappa_thic: Optional[torch.Tensor] = None
    hor_diff: Optional[torch.Tensor] = None
    # transition-layer depths (source/hmix_gm.F90:2198-2209); None when the
    # scheme is off
    dia_depth: Optional[torch.Tensor] = None    # (ny, nx)
    tlt_thick: Optional[torch.Tensor] = None
    int_depth: Optional[torch.Tensor] = None


class TLT(NamedTuple):
    """Transition-layer fields (the reference's TLT derived type,
    source/hmix_gm.F90:222-245)."""
    diabatic_depth: torch.Tensor   # (ny, nx) base of the diabatic region
    thickness: torch.Tensor        # (ny, nx) transition-layer thickness
    interior_depth: torch.Tensor   # (ny, nx) start of the adiabatic interior
    k_level: torch.Tensor          # (ny, nx) int32, 1-based level of the base
    ztw: torch.Tensor              # (ny, nx) int32, 1 = base at zt, 2 = at zw


def _kidx(km: int, device):
    """1-based level index, (km, 1, 1) int32."""
    return torch.arange(1, km + 1, device=device,
                        dtype=torch.int32).reshape(km, 1, 1)


def _up(f, dim=0):
    """f at level k-1 along ``dim``, zero above the first level."""
    n = f.shape[dim]
    return torch.cat([torch.zeros_like(f.narrow(dim, 0, 1)),
                      f.narrow(dim, 0, n - 1)], dim=dim)


def first_layer_depth(grid: Grid):
    """zw(1) as a (ny, nx) field: the diabatic / boundary-layer depth when
    no KPP boundary layer is carried."""
    return grid.vgrid.zw[0].expand(grid.FCORT.shape)


def tracer_diffs(cfg: ModelConfig, grid: Grid, bc: BC, tmix):
    """(tx, ty, tz): masked east/north face differences of every tracer and
    tz[:, k] = T(k-1) - T(k) with tz[:, 0] = 0, each (nt, km, ny, nx)."""
    kidx = _kidx(cfg.km, tmix.device)
    in_c = kidx <= grid.KMT[None]
    kmaske = in_c & (kidx <= grid.KMTE[None])
    kmaskn = in_c & (kidx <= grid.KMTN[None])
    tx = torch.where(kmaske[None], bc.e(tmix) - tmix, 0.0)
    ty = torch.where(kmaskn[None], bc.n(tmix) - tmix, 0.0)
    tz = _up(tmix, 1) - tmix
    tz[:, 0] = 0.0
    return tx, ty, tz


def face_density_diffs(cfg: ModelConfig, grid: Grid, bc: BC, ts_range, tmix):
    """Tracer face differences and face/vertical density differences shared
    by GM and the submesoscale scheme (tracer_diffs_and_isopyc_slopes,
    source/hmix_gm_submeso_share.F90:149-434).

    Returns (tx, ty, tz, rx, ry, rz_ktp_raw, rz_kbt_raw) with tx/ty/tz as
    ``tracer_diffs``; rx/ry (2 faces, km, ny, nx) density differences across
    the east/north (0) and west/south (1) faces; rz_* the unclamped vertical
    density differences across the interface above (ktp) / below (kbt) each
    level, with level-k expansion coefficients."""
    kidx = _kidx(cfg.km, tmix.device)
    in_c = kidx <= grid.KMT[None]
    kmaske = in_c & (kidx <= grid.KMTE[None])
    kmaskn = in_c & (kidx <= grid.KMTN[None])
    tx, ty, tz = tracer_diffs(cfg, grid, bc, tmix)

    tclip = torch.clamp(tmix[0], min=-2.0)
    txp = torch.where(kmaske, bc.e(tclip) - tclip, 0.0)
    typ = torch.where(kmaskn, bc.n(tclip) - tclip, 0.0)
    tzp_c = _up(tclip) - tclip
    tzp_c[0] = 0.0

    _, drdt, drds = eos.state(cfg, grid.vgrid.pressz, tmix[0], tmix[1],
                              ts_range, want_drhodt=True, want_drhods=True,
                              fit=grid.vgrid.poly)

    # face density differences with this cell's expansion coefficients
    rx = torch.stack([drdt * txp + drds * tx[1],
                      drdt * bc.w(txp) + drds * bc.w(tx[1])])
    ry = torch.stack([drdt * typ + drds * ty[1],
                      drdt * bc.s(typ) + drds * bc.s(ty[1])])

    # the interface below level k uses level-k coefficients with the
    # difference at k+1, the interface above uses the difference at k
    rz_kbt_raw = drdt * _down(tzp_c) + drds * _down(tz[1])
    rz_ktp_raw = drdt * tzp_c + drds * tz[1]
    return tx, ty, tz, rx, ry, rz_ktp_raw, rz_kbt_raw


def _slopes(cfg: ModelConfig, grid: Grid, bc: BC, ts_range, tmix):
    """Isopycnal slopes per quarter cell: (tx, ty, tz, slx, sly) with slx,
    sly of shape (2 faces, 2 halves, km, ny, nx)."""
    kidx = _kidx(cfg.km, tmix.device)
    tx, ty, tz, rx, ry, rz_ktp_raw, rz_kbt_raw = face_density_diffs(
        cfg, grid, bc, ts_range, tmix)
    rz_kbt = torch.clamp(rz_kbt_raw, max=-EPS2)
    rz_ktp = torch.clamp(rz_ktp_raw, max=-EPS2)
    below_mask = kidx < grid.KMT[None]
    in_mask = kidx <= grid.KMT[None]

    def halves(r):
        ktp = torch.where(in_mask, r / rz_ktp, 0.0)
        ktp[:, 0] = 0.0  # the top half of level 1 has no interface above
        return torch.stack([ktp, torch.where(below_mask, r / rz_kbt, 0.0)],
                           dim=1)  # (face, half, km, ny, nx)

    return tx, ty, tz, halves(rx), halves(ry)


def _sla(cfg: ModelConfig, grid: Grid, slx, sly):
    """Absolute-slope measure |S| per (half, k) (SLA / SLA_SAVE,
    source/hmix_gm.F90:1236-1242, 1431-1436). Returns (2, km, ny, nx)."""
    km = cfg.km
    dzw = grid.vgrid.dzw
    dzw_h = torch.stack([dzw[0:km], dzw[1:km + 1]]).reshape(2, km, 1, 1)
    return dzw_h * torch.sqrt(0.5 * (
        (slx[0] ** 2 + slx[1] ** 2) / grid.DXT ** 2
        + (sly[0] ** 2 + sly[1] ** 2) / grid.DYT ** 2)) + EPS


def _notanh(sla, slm: float):
    x = sla / slm
    mid = 0.5 * (1.0 - (2.5 * x - 1.0) * (4.0 - torch.abs(10.0 * x - 4.0)))
    return torch.where(x <= 0.2, 1.0, torch.where(x >= 0.6, 0.0, mid))


def _tapers(cfg: ModelConfig, grid: Grid, sla, bl_depth, tlt=None):
    """Near-surface Rossby-radius taper (Large et al. 1997) and slope control
    (source/hmix_gm.F90:1405-1601, 'notanh'). With the transition layer the
    Rossby taper is skipped (TAPER1 = 1, :1440) and the slope tapers are
    disabled inside the diabatic region (:1596-1601). Returns (taper_isop,
    taper_thic), each (2 halves, km, ny, nx)."""
    km = cfg.km
    zt, zw = grid.vgrid.zt, grid.vgrid.zw

    taper2 = _notanh(sla, cfg.gm_slm_r)
    taper3 = (_notanh(sla, cfg.gm_slm_b)
              if cfg.gm_slm_b != cfg.gm_slm_r else taper2)
    if tlt is None:
        # inverse Rossby radius |f|/c1, bounded to [15 km, 100 km]
        # (source/hmix_gm.F90:889-894)
        rbr = torch.clamp(torch.abs(grid.FCORT) / 200.0, 1.0e-7,
                          1.0 / 1.5e6)
        w1 = torch.clamp(zt.reshape(1, km, 1, 1) * rbr / sla, max=1.0)
        taper1 = 0.5 + 2.0 * (w1 - 0.5) * (1.0 - torch.abs(w1 - 0.5))
        in_bl = _up(zt).reshape(1, km, 1, 1) <= bl_depth
        taper1 = torch.where(in_bl, taper1, 1.0)
        return taper1 * taper2, taper1 * taper3

    # no slope tapering inside the diabatic region; the test depths are
    # zt(k+1) (ktp) / zw(k+1) (kbt) (:1406-1411)
    ref_ktp = _down(zt, repeat_last=True).clone()
    ref_ktp[km - 1] = zw[km - 1]
    ref_d = torch.stack([ref_ktp, _down(zw, repeat_last=True)])
    in_dia = ref_d.reshape(2, km, 1, 1) <= tlt.diabatic_depth
    return (torch.where(in_dia, 1.0, taper2),
            torch.where(in_dia, 1.0, taper3))


def _displaced_density_diff(cfg, grid, ts_range, tmix, clamp=False):
    """drho/dT*(T_k - T_{k+1}) + drho/dS*(S_k - S_{k+1}) with level-k
    coefficients displaced to the pressure of level k+1 and T clamped at
    -2C: the stratification measure of the bfre N^2 profile
    (source/hmix_gm.F90:3104-3111); with ``clamp`` at most -1e-20, the
    measure of kappa_lon_lat_vmhs (:2320-2331) and kappa_eg (:2546-2556)."""
    vg = grid.vgrid
    _, drdt, drds = eos.state(cfg, _down(vg.pressz, repeat_last=True),
                              tmix[0], tmix[1], ts_range, want_drhodt=True,
                              want_drhods=True,
                              fit=eos.fit_rows(vg.poly, "down"))
    tclip = torch.clamp(tmix[0], min=-2.0)
    work3 = (drdt * (tclip - _down(tclip, repeat_last=True))
             + drds * (tmix[1] - _down(tmix[1], repeat_last=True)))
    return torch.clamp(work3, max=-EPS2) if clamp else work3


def buoyancy_frequency(cfg: ModelConfig, grid: Grid, ts_range, tmix):
    """N^2 = max(0, -g * displaced density difference / dzw) at the
    interface below each level, zero at and below the bottom level."""
    km = cfg.km
    dzwr = grid.vgrid.dzwr[1:km + 1].reshape(km, 1, 1)
    work3 = _displaced_density_diff(cfg, grid, ts_range, tmix)
    below = _kidx(km, tmix.device) < grid.KMT[None]
    return torch.where(below,
                       torch.clamp(-const.GRAV * work3 * dzwr, min=0.0), 0.0)


def kappa_vertical_bfre(cfg: ModelConfig, grid: Grid, ts_range, tmix, sdl,
                        n2=None):
    """Normalized buoyancy-frequency vertical profile KAPPA_VERTICAL =
    clip(N^2 / N^2_ref, 0.1, 1) at T points, the 'bfre' vertical structure
    (buoyancy_frequency_dependent_profile, source/hmix_gm.F90:3011-3176).
    ``sdl`` is the surface-diabatic-layer depth (zw(1) or the transition
    layer's interior depth, :3085-3087); ``n2`` the N^2 of
    ``buoyancy_frequency`` where the caller has it already.

    Returns (km, ny, nx); 1 at and above the reference level."""
    km = cfg.km
    kmt = grid.KMT[None]
    if n2 is None:
        n2 = buoyancy_frequency(cfg, grid, ts_range, tmix)
    kidx = _kidx(km, n2.device)
    zw = grid.vgrid.zw.reshape(km, 1, 1)
    below = kidx < kmt

    # reference level: first k with zw(k) > SDL, k <= KMT, N^2 > 0 (:3126-
    # 3133; the loop runs k=1..km-1 so the bottom interface never qualifies)
    cand = (zw > sdl[None]) & (kidx <= kmt) & (n2 > 0.0)
    cand[-1] = False
    exists = cand.any(dim=0)
    k_min0 = torch.argmax(cand.to(torch.uint8), dim=0)   # first candidate
    n2_ref = torch.gather(n2, 0, k_min0[None])
    k_min = torch.where(exists, k_min0 + 1, km + 1)[None]  # 1-based

    norm = torch.where(
        (kidx >= k_min) & below & exists[None] & (n2_ref != 0.0),
        torch.clamp(n2 / torch.where(n2_ref == 0.0, 1.0, n2_ref), 0.1, 1.0),
        1.0)
    # copy interface values from above to T points (:3167-3171):
    # KAPPA_VERTICAL(k) = NORM(k-1) for K_MIN < k <= KMT. (The reference
    # first copies NORM(KMT-1) to the bottom interface, :3153-3157; no T
    # point reads that value.)
    norm_up = torch.cat([norm[:1], norm[:-1]])
    return torch.where((kidx > k_min) & (kidx <= kmt), norm_up, 1.0)


def _rossby_radius(grid: Grid):
    """Rossby deformation radius Cg/|f| bounded to [15 km, 100 km]
    (source/hmix_gm.F90:887-898), cm."""
    return 1.0 / torch.clamp(torch.abs(grid.FCORT) / 200.0, 1.0e-7,
                             1.0 / 1.5e6)


def transition_layer(cfg: ModelConfig, grid: Grid, diabatic_depth, sla,
                     rb) -> TLT:
    """Transition-layer thickness/extent search (transition_layer,
    source/hmix_gm.F90:3183-3434). ``sla`` is the (half, km, ny, nx)
    absolute-slope measure SLA_SAVE (:1236-1242); ``rb`` the Rossby radius.

    The reference's three k sweeps with per-column state: the first is a
    closed-form first-k search, the other two stay loops over k on 2-D
    fields that end at the deepest level any column is still searching."""
    km = cfg.km
    zt, zw = grid.vgrid.zt, grid.vgrid.zw
    dd = diabatic_depth
    kmt = grid.KMT
    i32 = torch.int32
    zeros = torch.zeros_like(dd)
    izeros = torch.zeros_like(kmt)

    # ---- pass 1 (:3248-3276): minimum thickness = down to the first grid
    # interface (zw) or centre (zt) below the diabatic depth
    lt = dd[None] < zw.reshape(km, 1, 1)
    fired = lt.any(dim=0) & (kmt != 0)
    kidx0 = torch.argmax(lt.to(torch.uint8), dim=0)   # first 0-based k
    k1b = (kidx0 + 1).to(i32)
    zw_k, zt_k = zw[kidx0], zt[kidx0]
    c2 = fired & (k1b != 1) & (dd < zt_k)
    k_level = torch.where(fired, k1b, izeros)
    k_sub = torch.where(c2, 1, izeros)
    thick = torch.where(fired, torch.where(c2, zt_k - dd, zw_k - dd), zeros)
    ztw = torch.where(fired, torch.where(c2, 1, 2).to(i32), izeros)
    k_start = torch.where(fired, torch.where(c2, k1b, k1b + 1), izeros)

    # ---- pass 2 (:3297-3331): extend through levels whose Rossby-scale
    # vertical displacement R*|S| reaches above the diabatic depth (columns
    # whose minimum layer ended at a cell centre, K_SUB = kbt)
    compute = ~((kmt == 0) | (k_start > kmt)
                | ((k_start == kmt) & (k_sub == 1)))
    sla_ktp, sla_kbt = sla[0], sla[1]
    sla_ktp_kp1 = _down(sla_ktp)

    for k0 in range(km - 1):
        k, zwk = k0 + 1, zw[k0]
        # a column acts at its own K_START only: below the deepest one that
        # is still searching nothing changes (one host read a level, cheaper
        # than the level's two dozen small launches)
        if not bool((compute & (k_sub == 1) & (k_start >= k)).any()):
            break
        work = torch.where(
            compute & (k_sub == 1) & (k_start < kmt) & (k_start == k),
            torch.maximum(sla_kbt[k0], sla_ktp_kp1[k0]) * rb, 0.0)
        hit = work != 0.0
        reach = dd >= (zwk - work)
        compute = compute & ~(hit & ~reach)
        grow = hit & reach
        k_start = torch.where(grow, k_start + 1, k_start)
        k_sub = torch.where(grow, 0, k_sub)
        thick = torch.where(grow, zwk - dd, thick)
        k_level = torch.where(grow, k, k_level)
        ztw = torch.where(grow, 2, ztw)

    # ---- pass 3 (:3339-3388): deeper levels, checking both the top (zt)
    # and bottom (zw) halves of each level
    for k0 in range(1, km):
        k = k0 + 1
        if not bool((compute & (k_start >= k)).any()):
            break
        here = compute & (k_start == k)
        for half, refd in ((0, zt[k0]), (1, zw[k0])):
            if half == 0:
                work = torch.where(
                    here & (k_start <= kmt),
                    torch.maximum(sla_ktp[k0], sla_kbt[k0]) * rb, 0.0)
            else:
                work = torch.zeros_like(dd)
                if k < km:
                    work = torch.where(
                        here & (k_start < kmt),
                        torch.maximum(sla_kbt[k0], sla_ktp_kp1[k0]) * rb,
                        0.0)
                work = torch.where(here & (k_start == kmt),
                                   sla_kbt[k0] * rb, work)
            hit = work != 0.0
            reach = dd >= (refd - work)
            compute = compute & ~(hit & ~reach)
            here = here & compute
            grow = hit & reach
            thick = torch.where(grow, refd - dd, thick)
            k_level = torch.where(grow, k, k_level)
            ztw = torch.where(grow, half + 1, ztw)
        k_start = torch.where(compute & (k_start == k), k_start + 1, k_start)

    # ---- interior-region start depth (:3404-3413)
    klev0 = torch.clamp(k_level - 1, 0, km - 1).long()
    int_depth = torch.where(ztw == 1, zt[klev0],
                            torch.where(ztw == 2, zw[klev0], zeros))
    ocean = kmt > 0
    return TLT(diabatic_depth=dd.contiguous(),
               thickness=torch.where(ocean, thick, zeros),
               interior_depth=torch.where(ocean, int_depth, zeros),
               k_level=k_level.to(i32), ztw=ztw.to(i32))


def merged_streamfunction(cfg: ModelConfig, grid: Grid, tlt: TLT, kthic,
                          slx, sly):
    """Merged eddy-induced streamfunction SF = kappa_thic * S * dz with
    linear interpolation through the diabatic region and quadratic
    interpolation through the transition layer (merged_streamfunction,
    source/hmix_gm.F90:3441-3738).

    kthic: (half, km, ny, nx); slx/sly: (face, half, km, ny, nx).
    Returns (sf_slx, sf_sly) of shape (face, half, km, ny, nx)."""
    km = cfg.km
    vg = grid.vgrid
    dz, zt = vg.dz, vg.zt
    dzwr = vg.dzwr[1:km + 1]
    kmt = grid.KMT
    klev = tlt.k_level                              # 1-based; 0 = none
    k0 = torch.clamp(klev - 1, 0, km - 1).long()

    def idx(dk):
        return torch.clamp(k0 + dk, 0, km - 1)

    def at(field, dk):
        """``field`` (..., km, ny, nx) at level K_LEVEL + dk."""
        i = idx(dk).expand(field.shape[:-3] + (1,) + field.shape[-2:])
        return torch.gather(field, -3, i).squeeze(-3)

    dz_k, dz_kp1, dz_kp2 = dz[idx(0)], dz[idx(1)], dz[idx(2)]
    dzwr_k, dzwr_kp1 = dzwr[idx(0)], dzwr[idx(1)]
    kth_kbt_k, kth_ktp_kp1 = at(kthic[1], 0), at(kthic[0], 1)
    kth_kbt_kp1, kth_ktp_kp2 = at(kthic[1], 1), at(kthic[0], 2)
    inside = (klev < kmt) & (klev > 0)
    m1 = (tlt.ztw == 1) & inside                    # base at zt(k)
    m2 = (tlt.ztw == 2) & inside                    # base at zw(k)
    deeper = m2 & (klev + 1 < kmt)                  # => k+2 in range

    def work_pair(sl):
        """WORK1 (streamfunction) and WORK2 (first derivative) at the
        interior-depth level for one slope field; (face, ny, nx) each."""
        sl_kbt_k, sl_ktp_kp1 = at(sl[:, 1], 0), at(sl[:, 0], 1)
        sl_kbt_kp1, sl_ktp_kp2 = at(sl[:, 1], 1), at(sl[:, 0], 2)

        w1_a = kth_kbt_k * sl_kbt_k * dz_k
        w2_a = 2.0 * dzwr_k * (w1_a - kth_ktp_kp1 * sl_ktp_kp1 * dz_kp1)
        w2n_a = 2.0 * (kth_ktp_kp1 * sl_ktp_kp1 - kth_kbt_kp1 * sl_kbt_kp1)
        w2_a = torch.where(torch.abs(w2n_a) < torch.abs(w2_a), w2n_a, w2_a)

        w1_b0 = kth_ktp_kp1 * sl_ktp_kp1
        w2_b = 2.0 * (w1_b0 - kth_kbt_kp1 * sl_kbt_kp1)
        w1_b = w1_b0 * dz_kp1
        w2n_b = 2.0 * dzwr_kp1 * (kth_kbt_kp1 * sl_kbt_kp1 * dz_kp1
                                  - kth_ktp_kp2 * sl_ktp_kp2 * dz_kp2)
        w2_b = torch.where(deeper & (torch.abs(w2n_b) < torch.abs(w2_b)),
                           w2n_b, w2_b)

        w1 = torch.where(m1, w1_a, torch.where(m2, w1_b, 0.0))
        w2 = torch.where(m1, w2_a, torch.where(m2, w2_b, 0.0))
        return w1, w2

    # interpolation factors (:3613-3622)
    ocean = kmt != 0
    thick_ok = tlt.thickness > EPS
    w5 = torch.where(ocean, 1.0 / (2.0 * tlt.diabatic_depth + tlt.thickness),
                     0.0)
    w6 = torch.where(ocean & thick_ok,
                     w5 / torch.where(thick_ok, tlt.thickness, 1.0), 0.0)

    # per-(half, k) reference depths: mid top / bottom quarter of the cell
    ref_d = torch.stack([zt - 0.25 * dz, zt + 0.25 * dz]).reshape(
        1, 2, km, 1, 1)
    in_col = (_kidx(km, kmt.device) <= kmt[None])[None, None]
    dd, idp = tlt.diabatic_depth, tlt.interior_depth
    z_dia = (ref_d <= dd) & in_col
    z_tl = (ref_d > dd) & (ref_d <= idp) & in_col
    z_int = (ref_d > idp) & in_col
    dz5 = dz.reshape(1, 1, km, 1, 1)

    def merge_sf(sl):
        w1, w2 = work_pair(sl)
        w1, w2 = w1[:, None, None], w2[:, None, None]
        lin = ref_d * w5 * (2.0 * w1 + tlt.thickness * w2)
        quad = -(dd - ref_d) ** 2 * w6 * (w1 + idp * w2) + lin
        interior = kthic[None] * sl * dz5
        return torch.where(z_dia, lin,
                           torch.where(z_tl, quad,
                                       torch.where(z_int, interior, 0.0)))

    return merge_sf(slx), merge_sf(sly)


def apply_transition_profile(cfg: ModelConfig, grid: Grid, tlt: TLT,
                             kisop, hor_diff):
    """Vertical tapering of KAPPA_ISOP and HOR_DIFF across the diabatic /
    transition / interior regions (apply_vertical_profile_to_isop_hor_diff,
    source/hmix_gm.F90:3745-3840). Both args (half, km, ny, nx)."""
    km = cfg.km
    dz, zt = grid.vgrid.dz, grid.vgrid.zt
    in_col = (_kidx(km, kisop.device) <= grid.KMT[None])[None]
    ref_d = torch.stack([zt - 0.25 * dz, zt + 0.25 * dz]).reshape(
        2, km, 1, 1)
    dd, idp, thick = tlt.diabatic_depth, tlt.interior_depth, tlt.thickness

    z_dia = (ref_d <= dd) & in_col
    z_tl = (ref_d > dd) & (ref_d <= idp) & in_col & (thick > EPS)
    z_int = (ref_d > idp) & in_col

    safe_thick = torch.where(thick > EPS, thick, 1.0)
    kisop = torch.where(z_dia, 0.0, kisop)
    kisop = torch.where(z_tl, (ref_d - dd) * kisop / safe_thick, kisop)
    hor_diff = torch.where(z_tl, (idp - ref_d) * hor_diff / safe_thick,
                           hor_diff)
    hor_diff = torch.where(z_int, 0.0, hor_diff)
    return kisop, hor_diff


# ---------------------------------------------------------------------------
# Flow-dependent diffusivities (kappa_lon_lat_vmhs source/hmix_gm.F90:
# 2226-2456, kappa_eg :2463-2659, the kappa_type_depth profile :850-872)
# and anisotropic GM (hmix_gm_aniso.F90)
# ---------------------------------------------------------------------------

def _btp(grid: Grid, bc: BC):
    """Beta at T points (source/hmix_gm.F90:902-904)."""
    return (2.0 * const.OMEGA * torch.cos(ugrid_to_tgrid(grid.ULAT, bc))
            / const.RADIUS)


def kappa_vmhs(cfg: ModelConfig, grid: Grid, bc: BC, ts_range, tmix,
               umix, vmix_m):
    """Visbeck et al. (1997) lateral diffusivity KAPPA_LATERAL = C l^2/T
    (kappa_lon_lat_vmhs, source/hmix_gm.F90:2226-2456). Returns (ny, nx),
    cm^2/s, bounded to [3.0e6, 4.0e7]. The integration limits k1, k2 of
    -2000 m < z < -100 m (:2290) are found on the device, as 0-d tensors
    (no host read in a step)."""
    km = cfg.km
    zt = grid.vgrid.zt
    kidx = _kidx(km, tmix.device)
    lev = kidx.reshape(km)
    in_range = (zt >= 1.0e4) & (zt <= 2.0e5)
    k1 = torch.argmax(in_range.to(torch.uint8)) + 1           # 1-based
    after = ~in_range & (lev > k1)
    k2 = torch.where(after.any(), torch.argmax(after.to(torch.uint8)) + 1,
                     km)                                      # 1-based

    work3 = _displaced_density_diff(cfg, grid, ts_range, tmix, clamp=True)
    ut = ugrid_to_tgrid(umix, bc)
    vt = ugrid_to_tgrid(vmix_m, bc)
    ut_kp1 = _down(ut, repeat_last=True)
    vt_kp1 = _down(vt, repeat_last=True)

    dzw = grid.vgrid.dzw[1:km + 1].reshape(km, 1, 1)
    contrib = (kidx >= k1) & (kidx < k2) & (kidx < grid.KMT[None])
    rnum = -dzw / ((ut - ut_kp1) ** 2 + (vt - vt_kp1) ** 2 + EPS)
    grate = torch.sum(torch.where(contrib,
                                  const.GRAV * rnum * dzw * work3, 0.0),
                      dim=0)
    lsc = torch.sum(torch.where(contrib, -const.GRAV * work3, 0.0), dim=0)

    # normalize by the depth span actually integrated (:2399-2410)
    zt_kmt = zt[torch.clamp(grid.KMT - 1, min=0).long()]
    # (take: an index by a 0-d tensor would read it back to the host)
    span = (torch.minimum(torch.take(zt, k2 - 1), zt_kmt)
            - torch.minimum(torch.take(zt, k1 - 1), zt_kmt))
    grate = grate / (span + EPS)               # mean Ri
    lsc = lsc * span                           # c_g^2 = N^2 H^2

    btp = _btp(grid, bc)
    cg = torch.sqrt(torch.clamp(lsc, min=0.0))
    w1 = torch.sqrt(2.0 * cg * btp)
    w2 = cg / (2.0 * btp)
    inv_t = torch.maximum(torch.abs(grid.FCORT), w1)
    grate = inv_t / torch.sqrt(torch.clamp(grate, min=0.0) + EPS)   # 1/T
    lsc = lsc / (grid.FCORT + EPS) ** 2                             # L^2
    lsc = torch.minimum(lsc, w2)
    lsc = torch.maximum(lsc, torch.minimum(grid.DXT ** 2, grid.DYT ** 2))

    kappa = torch.clamp(0.13 * grate * lsc, 3.0e6, 4.0e7)
    return torch.where(grid.KMT <= k1, 3.0e6, kappa)


def _sigma_topo_mask(grid: Grid, bc: BC, km: int):
    """1 where k < KMT and no bottom of the 8 neighbours (folded on a
    tripole grid) lies at level k (source/hmix_gm.F90:1001-1030)."""
    kidx = _kidx(km, grid.KMT.device)
    kmt = grid.KMT
    at_edge = torch.zeros((km,) + tuple(kmt.shape), dtype=torch.bool,
                          device=kmt.device)
    for nb in (bc.e(kmt), bc.w(kmt), bc.n(kmt), bc.s(kmt), bc.ne(kmt),
               bc.nw(kmt), bc.se(kmt), bc.sw(kmt)):
        at_edge = at_edge | (kidx == nb[None])
    return ((kidx < kmt[None]) & ~at_edge).to(grid.FCORT.dtype)


def kappa_eg(cfg: ModelConfig, grid: Grid, bc: BC, ts_range, tmix,
             umix, vmix_m, hblt=None):
    """Eden & Greatbatch (2008) 3-D diffusivity KAPPA = c L^2 sigma
    (kappa_eg, source/hmix_gm.F90:2463-2659). Returns (km, ny, nx) cm^2/s,
    bounded to [gm_kappa_min_eg, gm_kappa_max_eg]. ``hblt``: the surface
    diabatic layer (the first layer without one)."""
    km = cfg.km
    vg = grid.vgrid
    kidx = _kidx(km, tmix.device)
    dzw = vg.dzw[1:km + 1].reshape(km, 1, 1)
    dzwr = vg.dzwr[1:km + 1].reshape(km, 1, 1)

    work3 = _displaced_density_diff(cfg, grid, ts_range, tmix, clamp=True)
    below = kidx < grid.KMT[None]
    n2 = torch.where(below, -const.GRAV * work3 * dzwr, 0.0)

    du2 = ((umix - _down(umix, repeat_last=True)) ** 2
           + (vmix_m - _down(vmix_m, repeat_last=True)) ** 2)
    ri = torch.where(below, dzw ** 2 / (ugrid_to_tgrid(du2, bc) + EPS2) * n2,
                     0.0)

    # first-baroclinic wave speed, Chelton et al. (1998) (:2580-2596): the
    # sum of sqrt(N^2) dzw over k < KMT, the surface half-layer at k = 1
    # and the bottom half-layer with N^2 at KMT-1
    sqn = torch.sqrt(torch.clamp(n2, min=0.0))
    c_rossby = torch.where(grid.KMT > 1, sqn[0] * vg.dzw[0], 0.0)
    c_rossby = c_rossby + torch.sum(torch.where(below, sqn * dzw, 0.0),
                                    dim=0)
    at_bot = (kidx == grid.KMT[None]) & (kidx > 1)
    c_rossby = c_rossby + torch.sum(
        torch.where(at_bot, torch.cat([sqn[:1], sqn[:-1]]) * dzw, 0.0),
        dim=0)
    c_rossby = c_rossby / math.pi

    btp = _btp(grid, bc)
    l_rossby = torch.minimum(c_rossby / (torch.abs(grid.FCORT) + EPS),
                             torch.sqrt(c_rossby / (2.0 * btp)))
    inv_t = torch.maximum(torch.abs(grid.FCORT),
                          torch.sqrt(c_rossby * 2.0 * btp))
    sigma = (_sigma_topo_mask(grid, bc, km) * inv_t[None]
             / torch.sqrt(ri + cfg.gm_gamma_eg))
    sigma = torch.where(below, sigma, 0.0)
    lscale = torch.minimum(l_rossby[None], sigma / btp[None])
    kappa = cfg.gm_const_eg * sigma * lscale ** 2

    # within the surface diabatic layer the value of the first level below
    # it (:2640-2648): the reference's upward copy kappa(k) = kappa(k+1)
    # where zw(k) <= bl reaches level k from the first level k* whose zw
    # lies below bl (zw increases), so it is one gather at min(max(k, k*),
    # km-1)
    bl = first_layer_depth(grid) if hblt is None else hblt
    kstar = (vg.zw.reshape(km, 1, 1) <= bl[None]).sum(dim=0)
    src = torch.clamp(torch.maximum(kidx.long() - 1, kstar[None]),
                      max=km - 1)
    kappa = torch.gather(kappa, 0, src)
    return torch.clamp(kappa, cfg.gm_kappa_min_eg, cfg.gm_kappa_max_eg)


def kappa_fields(cfg: ModelConfig, grid: Grid, bc: BC, ts_range, tmix,
                 umix=None, vmix_m=None, hblt=None, sdl=None,
                 kappa_vert=None):
    """(kappa_isop, kappa_thic) diffusivities, broadcastable to (km, ny, nx)
    (KAPPA_ISOP/KAPPA_THIC assembly, source/hmix_gm.F90:1345-1399), the
    'cancellation' flag (equal isop/thic diffusivities, :970-987), and
    KAPPA_VERTICAL (the depth/bfre vertical profile, 1 otherwise). ``sdl``
    is the surface-diabatic-layer depth for the bfre profile; a caller that
    has the profile already hands it as ``kappa_vert``. A 'const'
    diffusivity is a Python float; 'vmhs' and 'eg' read the mixing-time
    velocities ``umix``, ``vmix_m``, 'eg' the boundary layer ``hblt``."""
    km = cfg.km
    kinds = (cfg.gm_kappa_isop_type, cfg.gm_kappa_thic_type)
    if kappa_vert is None:
        # the depth profile for 'depth' (init_gm :866-873), the normalized
        # N^2 profile for 'bfre' (:1309-1319), 1 otherwise
        if "bfre" in kinds:
            if sdl is None:
                sdl = first_layer_depth(grid)
            kappa_vert = kappa_vertical_bfre(cfg, grid, ts_range, tmix, sdl)
        elif "depth" in kinds:
            prof = (cfg.gm_kappa_depth_1 + cfg.gm_kappa_depth_2 * torch.exp(
                -grid.vgrid.zt / cfg.gm_kappa_depth_scale))
            kappa_vert = prof.reshape(km, 1, 1).expand(
                (km,) + tuple(grid.FCORT.shape))
        else:
            kappa_vert = torch.ones((1, 1, 1), dtype=tmix.dtype,
                                    device=tmix.device)

    def build(ktype, ah, deep):
        if ktype == "const":
            return ah
        if ktype == "depth":
            return ah * kappa_vert
        if ktype == "bfre":
            # KAPPA_LATERAL stays at its init value ah for pure bfre
            # (init_gm :859, assembly :1353-1359 / :1381-1387)
            return ah * torch.clamp(kappa_vert, min=deep)
        if umix is None or vmix_m is None:
            raise ValueError(f"{ktype} kappa needs mix-time velocities")
        if ktype == "vmhs":
            return kappa_vmhs(cfg, grid, bc, ts_range, tmix, umix,
                              vmix_m)[None]
        if ktype == "eg":
            return kappa_eg(cfg, grid, bc, ts_range, tmix, umix, vmix_m,
                            hblt)
        raise NotImplementedError(f"gm kappa type {ktype}")

    kisop = build(cfg.gm_kappa_isop_type, cfg.gm_ah, cfg.gm_kappa_isop_deep)
    same_type = kinds[0] == kinds[1]
    if same_type and kinds[0] in ("vmhs", "eg"):
        kthic = kisop  # ah/ah_bolus do not enter (KAPPA_THIC = KAPPA_ISOP)
    else:
        kthic = build(cfg.gm_kappa_thic_type, cfg.gm_ah_bolus,
                      cfg.gm_kappa_thic_deep)
    if same_type and kinds[0] in ("const", "depth", "bfre"):
        # the reference's cancellation test ignores the kappa_*_deep floors
        # (init_gm :970-983)
        cancellation = cfg.gm_ah == cfg.gm_ah_bolus
    else:
        cancellation = same_type  # vmhs/eg ignore ah/ah_bolus scaling
    # always off with the transition layer (:985-987)
    cancellation = cancellation and not cfg.gm_transition_layer
    return kisop, kthic, cancellation, kappa_vert


def _aniso_factors(cfg: ModelConfig, grid: Grid, bc: BC, umix, vmix_m):
    """Directional diffusivity factors (ax, ay) of anisotropic GM
    (source/hmix_gm_aniso.F90, Smith & Gent 2004), as the JAX package keeps
    the scheme: the diagonal of the 2x2 diffusivity tensor in the rotated
    frame, kappa_x = kmaj cos^2(theta) + kmin sin^2(theta) and the
    complement for kappa_y, theta the local flow direction ('flow', (km, ny,
    nx) each) or zero ('grid', floats)."""
    r = cfg.gm_aniso_ratio
    if cfg.gm_aniso == "grid":
        return 1.0, r
    if cfg.gm_aniso == "flow":
        if umix is None or vmix_m is None:
            raise ValueError("gm_aniso='flow' needs mix-time velocities")
        u2 = ugrid_to_tgrid(umix, bc) ** 2
        v2 = ugrid_to_tgrid(vmix_m, bc) ** 2
        s = u2 + v2 + EPS
        cos2, sin2 = u2 / s, v2 / s
        return cos2 + r * sin2, sin2 + r * cos2
    raise NotImplementedError(f"gm_aniso {cfg.gm_aniso}")


def assemble(cfg: ModelConfig, grid: Grid, bc: BC, tx, ty, tz, slx, sly,
             sla, tlt: Optional[TLT], kappa_isop, kappa_thic, kappa_equal,
             kappa_vert, flux=flux_assembly, bl_depth=None,
             aniso=None) -> GMOut:
    """Everything of hdifft_gm after the slopes, the transition-layer search
    and the diffusivities: tapers, boundary conditions, horizontal diffusion
    of the surface layer, merged streamfunction and vertical profile (with
    the transition layer), and the flux assembly ``flux``. ``bl_depth``:
    the KPP boundary-layer depth, the first layer without one. ``aniso``:
    anisotropic GM's directional factors (``_aniso_factors``), or None."""
    km = cfg.km
    dz = grid.vgrid.dz.reshape(km, 1, 1)
    kidx = _kidx(km, sla.device)
    if bl_depth is None:
        bl_depth = first_layer_depth(grid)
    tap_isop, tap_thic = _tapers(cfg, grid, sla, bl_depth, tlt)

    kisop = tap_isop * kappa_isop         # (half, km, ny, nx)
    kthic = tap_thic * kappa_thic
    # zero in the top quarter of level 1 and the bottom quarter of the
    # deepest cell (source/hmix_gm.F90:1650-1663)
    at_bottom = kidx == grid.KMT[None]
    kisop[0, 0] = 0.0
    kthic[0, 0] = 0.0
    kisop[1] = torch.where(at_bottom, 0.0, kisop[1])
    kthic[1] = torch.where(at_bottom, 0.0, kthic[1])

    # surface-boundary-layer horizontal diffusion (HOR_DIFF,
    # source/hmix_gm.F90:1603-1632)
    if tlt is not None:
        # the vertical profile below replaces the (1 - taper) weighting
        if cfg.gm_use_const_ah_bkg_srfbl:
            hor_diff = torch.full_like(kisop, cfg.gm_ah_bkg_srfbl)
        else:
            hor_diff = kappa_isop * torch.ones_like(kisop)
    else:
        in_bl = _up(grid.vgrid.zt).reshape(1, km, 1, 1) <= bl_depth
        if cfg.gm_use_const_ah_bkg_srfbl:
            hor_diff = torch.where(
                in_bl, cfg.gm_ah_bkg_srfbl * (1.0 - tap_isop) * kappa_vert,
                0.0)
        else:
            hor_diff = torch.where(in_bl, kappa_isop * (1.0 - tap_isop), 0.0)
        hor_diff[0, 0] = cfg.gm_ah_bkg_srfbl

    # the flux assembly's diffusivities of the x and the y faces (kisop_y
    # None: one for both)
    kisop_y = None
    if tlt is not None:
        sf_slx, sf_sly = merged_streamfunction(cfg, grid, tlt, kthic, slx,
                                               sly)
        kisop, hor_diff = apply_transition_profile(cfg, grid, tlt, kisop,
                                                   hor_diff)
        kisop_x = kisop
    else:
        in_mask = (kidx <= grid.KMT[None])[None, None]
        kisop_x, kthic_x, kthic_y = kisop, kthic, kthic
        if aniso is not None:  # anisotropic GM (hmix_gm_aniso.F90)
            ax, ay = aniso
            kisop_x, kisop_y = kisop * ax, kisop * ay
            kthic_x, kthic_y = kthic * ax, kthic * ay
        sf_slx = torch.where(in_mask, kthic_x[None] * slx * dz, 0.0)
        sf_sly = torch.where(in_mask, kthic_y[None] * sly * dz, 0.0)

    # bottom-cell horizontal diffusion floor, after any transition profiling
    # (source/hmix_gm.F90:1757-1761)
    if cfg.gm_ah_bkg_bottom != 0.0:
        hor_diff[1] = torch.where(at_bottom, cfg.gm_ah_bkg_bottom,
                                  hor_diff[1])

    cancellation = kappa_equal and cfg.gm_slm_r == cfg.gm_slm_b
    gtk, vdc_gm = flux(cfg, grid, bc, tx, ty, tz, slx, sly, sf_slx, sf_sly,
                       kisop_x, hor_diff, cancellation, kisop_y=kisop_y)
    return GMOut(gtk=gtk, vdc_gm=vdc_gm,
                 kappa_isop=0.5 * (kisop[0] + kisop[1]),
                 kappa_thic=0.5 * (kthic[0] + kthic[1]),
                 hor_diff=0.5 * (hor_diff[0] + hor_diff[1]),
                 dia_depth=tlt.diabatic_depth if tlt is not None else None,
                 tlt_thick=tlt.thickness if tlt is not None else None,
                 int_depth=tlt.interior_depth if tlt is not None else None)


def diabatic_depth(cfg: ModelConfig, grid: Grid, bc: BC, hblt=None):
    """The transition layer's diabatic depth: the KPP boundary-layer depth
    smoothed once more (hdifft_gm :1227-1228, smooth_hblt's SMOOTH_OUT
    path), or the first layer without KPP."""
    if hblt is None:
        return first_layer_depth(grid)
    return kpp.smooth_hblt(cfg, grid, bc, hblt)[0]


def hdifft_gm(cfg: ModelConfig, grid: Grid, bc: BC, ts_range, tmix,
              hblt=None, umix=None, vmix_m=None) -> GMOut:
    """GM/Redi tracer tendency + VDC_GM (hdifft_gm,
    source/hmix_gm.F90:1102-2219); kappa per cfg.gm_kappa_*_type, optionally
    anisotropic (cfg.gm_aniso, hmix_gm_aniso.F90). ``hblt``: the KPP
    boundary-layer depth; ``umix``, ``vmix_m``: the mixing-time velocities
    ('vmhs', 'eg', gm_aniso='flow'). On CUDA tensors the transition-layer
    search goes through the ``gm_tlt_cuda`` kernel (``transition_layer``
    here reads the device once a level, which a captured step cannot) and
    the flux assembly at the end through the ``gm_cuda`` kernel."""
    from pop2_tpu_torch import gm_tlt_cuda  # deferred: it imports this module
    if cfg.gm_aniso is not None and cfg.gm_transition_layer:
        raise NotImplementedError(
            "gm_aniso with the transition layer is not supported (the "
            "reference's aniso GM is a separate scheme)")
    tx, ty, tz, slx, sly = _slopes(cfg, grid, bc, ts_range, tmix)
    sla = _sla(cfg, grid, slx, sly)

    # transition-layer geometry (:1221-1247)
    tlt = None
    if cfg.gm_transition_layer:
        tlt = gm_tlt_cuda.transition_layer(
            cfg, grid, diabatic_depth(cfg, grid, bc, hblt), sla,
            _rossby_radius(grid))
    # surface-diabatic-layer depth of the bfre normalization (:3085-3087)
    sdl = tlt.interior_depth if tlt is not None else hblt
    kappa_isop, kappa_thic, kappa_equal, kappa_vert = kappa_fields(
        cfg, grid, bc, ts_range, tmix, umix, vmix_m, hblt, sdl=sdl)
    aniso = (_aniso_factors(cfg, grid, bc, umix, vmix_m)
             if cfg.gm_aniso is not None else None)
    return assemble(cfg, grid, bc, tx, ty, tz, slx, sly, sla, tlt,
                    kappa_isop, kappa_thic, kappa_equal, kappa_vert,
                    flux=flux_assembly, bl_depth=hblt, aniso=aniso)
