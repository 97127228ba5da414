"""Anisotropic horizontal viscosity (the production momentum closure).

Reference: ``source/hmix_aniso.F90`` — friction as the divergence of a stress
linearly related to the rate-of-strain tensor, with distinct viscosities
parallel and perpendicular to an alignment direction; the quarter-cell
discretization dissipates energy for ``visc_para > visc_perp``
(hdiffu_aniso :557-1062). The four quarter cells are a leading axis of size
4 on (4, km, ny, nx) strain and stress tensors; the time-invariant metric
factors and the CCSM variable viscosities are built once on the host in
float64 NumPy (init_aniso :119-550) into ``AnisoStatics`` on ``Grid.aniso``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from pop2_tpu_torch import constants as const
from pop2_tpu_torch._tree import TensorTree
from pop2_tpu_torch.config import ModelConfig
from pop2_tpu_torch.stencil import BC

EPS = 1.0e-10           # pop_constants eps
DIST_MAX = 1.0e10       # distance used where a row has no western boundary


@dataclass(frozen=True)
class AnisoStatics(TensorTree):
    """Precomputed metric factors and viscosity fields (init_aniso)."""
    h1w: torch.Tensor     # = HTN           (ny, nx)
    h1e: torch.Tensor     # = HTN at i+1
    h2s: torch.Tensor     # = HTE
    h2n: torch.Tensor     # = HTE at j+1
    k1w: torch.Tensor
    k1e: torch.Tensor
    k2s: torch.Tensor
    k2n: torch.Tensor
    amax_cfl: torch.Tensor                 # 1/2 max CFL-allowed viscosity
    dsmin: Optional[torch.Tensor] = None   # min(DXU, DYU), smag only
    f_para: Optional[torch.Tensor] = None  # (km, ny, nx) variable viscosity
    f_perp: Optional[torch.Tensor] = None
    f_perp_smag: Optional[torch.Tensor] = None  # (ny, nx) smag latitude


def _np_shift(f, di: int, dj: int, bc: BC, loc: str = "center",
              kind: str = "scalar"):
    """Value at (i+di, j+dj) of a host array with the model's boundaries,
    the tripole fold included."""
    from pop2_tpu_torch.grid import _np_shift as gsh
    return gsh(np.asarray(f, dtype=np.float64), di, dj, bc.ew, bc.ns,
               0.0, loc, kind)


def _west_boundary_distance(kmu: np.ndarray, htn: np.ndarray, k: int,
                            nwb_buffer: int) -> np.ndarray:
    """Zonal distance (cm) to `nwb_buffer` points east of the nearest
    western boundary at level k (1-based), per row
    (compute_ccsm_var_viscosity :1170-1244)."""
    ny, nx = kmu.shape
    dist = np.full((ny, nx), DIST_MAX)
    wet = kmu >= k
    for j in range(ny):
        w = wet[j]
        if not w.any():
            continue
        # land cell immediately west of an ocean cell (cyclic in i)
        b = np.nonzero((~w) & np.roll(w, -1))[0]
        if b.size == 0:
            continue
        # zero zone: each boundary cell plus nwb_buffer cells to its east
        zero = np.zeros(nx, dtype=bool)
        for m in range(nwb_buffer + 1):
            zero[(b + m) % nx] = True
        b0 = b[0]
        x = np.roll(htn[j], -b0)
        z = np.roll(zero, -b0)
        s = np.cumsum(x)
        last_reset = np.maximum.accumulate(np.where(z, s, -np.inf))
        dist[j] = np.roll(s - last_reset, b0)
    return dist


def build_statics(cfg: ModelConfig, bc: BC, HTN, HTE, DXU, DYU, DXUR, DYUR,
                  ULAT, KMU, device="cpu") -> AnisoStatics:
    """Host-side setup of the metric factors, the CFL cap and, optionally,
    the CCSM spatially variable viscosities (init_aniso :350-550,
    compute_ccsm_var_viscosity :1069-1296), as tensors of the config's
    dtype on ``device``. Takes NumPy arrays or tensors."""
    def host(a):
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        return np.asarray(a, dtype=np.float64)

    HTN, HTE, DXU, DYU = host(HTN), host(HTE), host(DXU), host(DYU)
    DXUR, DYUR, ULAT = host(DXUR), host(DYUR), host(ULAT)
    KMU = np.asarray(KMU.cpu().numpy() if isinstance(KMU, torch.Tensor)
                     else KMU)
    h2s = HTE
    h1w = HTN
    h2n = _np_shift(h2s, 0, 1, bc, loc="eface")
    h1e = _np_shift(h1w, 1, 0, bc)

    wa = h2s + h2n
    wb = _np_shift(wa, -1, 0, bc)
    k1w = 2.0 * (wa - wb) / np.maximum(wa + wb, 1e-30) / h1w
    k1e = _np_shift(k1w, 1, 0, bc)

    wa = h1w + h1e
    wb = _np_shift(wa, 0, -1, bc)
    k2s = 2.0 * (wa - wb) / np.maximum(wa + wb, 1e-30) / h2s
    k2n = _np_shift(k2s, 0, 1, bc, loc="eface", kind="vector")

    amax_cfl = 0.125 / (cfg.time.dtu * (DXUR ** 2 + DYUR ** 2))
    dsmin = np.minimum(DXU, DYU) if cfg.lsmag_aniso else None

    f_para = f_perp = f_perp_smag = None
    if cfg.lvariable_hmix_aniso:
        km = cfg.km
        beta_f = 2.0 * const.OMEGA * np.cos(ULAT) / const.RADIUS
        lat_deg = np.abs(ULAT) * const.RADIAN
        bvl = (np.minimum(lat_deg, cfg.vconst_7) * 90.0
               / cfg.vconst_7) / const.RADIAN
        bu = cfg.vconst_1 * (1.0 + cfg.vconst_2 * (1.0 - np.cos(2.0 * bvl)))
        dxu3 = DXU ** 3
        f_para = np.zeros((km,) + ULAT.shape)
        f_perp = np.zeros((km,) + ULAT.shape)
        # the distance depends on the level only through its ocean mask:
        # levels with the same mask (every level of a flat bottom) share it
        dists = {}
        for k in range(1, km + 1):
            mask = (KMU >= k).tobytes()
            if mask not in dists:
                dists[mask] = _west_boundary_distance(KMU, HTN, k,
                                                      cfg.vconst_5)
            dist = dists[mask]
            bv = cfg.vconst_3 * beta_f * dxu3 \
                * np.exp(-(cfg.vconst_4 * dist) ** 2)
            f_perp[k - 1] = np.maximum(bu, bv)
            f_para[k - 1] = np.maximum(bv, cfg.vconst_6)
        # taper to 1/2 the viscous CFL limit (init_aniso :445-470)
        f_para = np.minimum(f_para, amax_cfl)
        f_perp = np.minimum(f_perp, amax_cfl)

    if cfg.lsmag_aniso and cfg.smag_lat_fact != 0.0:
        lat_deg = np.abs(ULAT) * const.RADIAN
        f_perp_smag = np.where(
            lat_deg >= cfg.smag_lat,
            1.0 - cfg.smag_lat_fact
            * np.exp(-(lat_deg - cfg.smag_lat) ** 2 / cfg.smag_lat_gauss),
            1.0 - cfg.smag_lat_fact)

    def f(a):
        return None if a is None else torch.as_tensor(np.array(a)).to(
            device=device, dtype=cfg.torch_dtype)

    return AnisoStatics(
        h1w=f(h1w), h1e=f(h1e), h2s=f(h2s), h2n=f(h2n),
        k1w=f(k1w), k1e=f(k1e), k2s=f(k2s), k2n=f(k2n),
        amax_cfl=f(amax_cfl), dsmin=f(dsmin),
        f_para=f(f_para), f_perp=f(f_perp), f_perp_smag=f(f_perp_smag))


def hdiffu_aniso(cfg: ModelConfig, grid, bc: BC, st: AnisoStatics,
                 umixk, vmixk):
    """Anisotropic friction HDU, HDV for the whole column (hdiffu_aniso
    :557-1062; quarter cells 0..3 on the leading axis = the reference's
    quarter cells 1..4 = SW, NW, NE, SE). Full cells: the depth ratios
    GE/GW/GN/GS are 1 (:700)."""
    u, v = umixk, vmixk
    uw, ue, us = bc.w(u), bc.e(u), bc.s(u)
    un = bc.n(u, "necorner", "vector")
    vw, ve, vs = bc.w(v), bc.e(v), bc.s(v)
    vn = bc.n(v, "necorner", "vector")
    h1w, h1e, h2s, h2n = st.h1w, st.h1e, st.h2s, st.h2n
    k1w, k1e, k2s, k2n = st.k1w, st.k1e, st.k2s, st.k2n

    # rate-of-strain tensor in each quarter cell (:719-765)
    w1 = (u - uw) / h1w
    w2 = (ue - u) / h1e
    w3 = 0.5 * k2s * (v + vs)
    w4 = 0.5 * k2n * (v + vn)
    e11 = torch.stack([w1 + w3, w1 + w4, w2 + w4, w2 + w3])

    w1 = (v - vs) / h2s
    w2 = (vn - v) / h2n
    w3 = 0.5 * k1w * (u + uw)
    w4 = 0.5 * k1e * (u + ue)
    e22 = torch.stack([w1 + w3, w2 + w3, w2 + w4, w1 + w4])

    w1 = (u - us) / h2s
    w2 = (un - u) / h2n
    w3 = (v - vw) / h1w
    w4 = (ve - v) / h1e
    w5 = k2s * (u + us)
    w6 = k2n * (u + un)
    w7 = k1w * (v + vw)
    w8 = k1e * (v + ve)
    e12 = torch.stack([w1 + w3 - 0.5 * (w5 + w7),
                       w2 + w3 - 0.5 * (w6 + w7),
                       w2 + w4 - 0.5 * (w6 + w8),
                       w1 + w4 - 0.5 * (w5 + w8)])

    # alignment normals (:774-799), elementwise for 'flow'
    if cfg.aniso_alignment == "east":
        n1 = torch.cos(grid.ANGLE)
        n2 = -torch.sin(grid.ANGLE)
    elif cfg.aniso_alignment == "flow":
        speed = torch.sqrt(u * u + v * v)
        ok = speed >= EPS
        safe = torch.where(ok, speed, torch.ones_like(speed))
        n1 = torch.where(ok, u / safe, 0.0)
        n2 = torch.where(ok, v / safe, 0.0)

    # viscosities per quarter cell (:805-870)
    if cfg.lsmag_aniso:
        dnorm = torch.sqrt(2.0 * (e11 ** 2 + e22 ** 2) + e12 ** 2)
        ds2 = st.dsmin * st.dsmin
        fps = st.f_perp_smag if st.f_perp_smag is not None else 1.0
        v1 = cfg.c_para * dnorm * ds2
        v2 = cfg.c_perp * fps * dnorm * ds2
        if st.f_para is not None:
            v1 = torch.maximum(v1, st.f_para)
            v2 = torch.maximum(v2, st.f_perp)
        v1 = torch.minimum(v1, st.amax_cfl)
        v2 = torch.minimum(v2, st.amax_cfl)
    elif st.f_para is not None:
        v1 = st.f_para
        v2 = st.f_perp
    else:
        # filled on the device: a copy from the host would synchronize
        v1 = torch.full((), cfg.visc_para, dtype=u.dtype, device=u.device)
        v2 = torch.full((), cfg.visc_perp, dtype=u.dtype, device=u.device)

    # stress = viscous tensor * strain (:879-928)
    if cfg.aniso_alignment == "grid":
        a = 0.5 * (v1 + v2)
        b = a
        c = torch.zeros_like(e11)
        d = v2 * torch.ones_like(e11)
    else:
        nn = n1 * n2
        dv = v1 - v2
        a = 0.5 * (v1 + v2) - 2.0 * dv * nn ** 2
        b = a
        c = dv * nn * (n1 ** 2 - n2 ** 2)
        d = v2 + 2.0 * dv * nn ** 2

    s11 = a * e11 - b * e22 + c * e12
    s22 = -b * e11 + a * e22 - c * e12
    s12 = c * (e11 - e22) + d * e12

    # stress divergence (:940-1040) from face pairs of quarter-cell
    # stresses; on a tripole grid a south pair's ghost row folds from its
    # north counterpart
    pair_w11 = h2s * s11[0] + h2n * s11[1]
    pair_e11 = h2s * s11[3] + h2n * s11[2]
    pair_s12 = h1w * s12[0] + h1e * s12[3]
    pair_n12 = h1w * s12[1] + h1e * s12[2]
    pair_w22 = h2s * s22[0] + h2n * s22[1]
    pair_e22 = h2s * s22[3] + h2n * s22[2]

    fx = 0.25 * (pair_e11 + bc.e(pair_w11) - pair_w11 - bc.w(pair_e11))
    fx = fx + 0.25 * ((pair_n12
                       + bc.n_partner(pair_s12, pair_n12, "necorner"))
                      * (1.0 + 0.5 * h2n * k2n)
                      - (pair_s12 + bc.s(pair_n12))
                      * (1.0 - 0.5 * h2s * k2s))
    fx = fx - 0.125 * ((pair_e22 + bc.e(pair_w22)) * h1e * k1e
                       + (pair_w22 + bc.w(pair_e22)) * h1w * k1w)

    pair_s22 = h1w * s22[0] + h1e * s22[3]
    pair_n22 = h1w * s22[1] + h1e * s22[2]
    pair_w12 = h2s * s12[0] + h2n * s12[1]
    pair_e12 = h2s * s12[3] + h2n * s12[2]
    pair_s11 = h1w * s11[0] + h1e * s11[3]
    pair_n11 = h1w * s11[1] + h1e * s11[2]

    fy = 0.25 * (pair_n22 + bc.n_partner(pair_s22, pair_n22, "necorner")
                 - pair_s22 - bc.s(pair_n22))
    fy = fy + 0.25 * ((pair_e12 + bc.e(pair_w12))
                      * (1.0 + 0.5 * h1e * k1e)
                      - (pair_w12 + bc.w(pair_e12))
                      * (1.0 - 0.5 * h1w * k1w))
    fy = fy - 0.125 * ((pair_n11
                        + bc.n_partner(pair_s11, pair_n11, "necorner"))
                       * h2n * k2n
                       + (pair_s11 + bc.s(pair_n11)) * h2s * k2s)

    hdu = torch.where(grid.kmask_u, fx * grid.UAREA_R, 0.0)
    hdv = torch.where(grid.kmask_u, fy * grid.UAREA_R, 0.0)
    return hdu, hdv
