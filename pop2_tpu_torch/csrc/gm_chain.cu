// The GM chain downstream of the slopes, fused with the flux assembly
// (hdifft_gm, source/hmix_gm.F90:1102-2219, with the transition layer on):
//   notanh slope tapers (:1405-1601)
//   const / bfre diffusivities with the deep floors (:1345-1399)
//   merged streamfunction through the diabatic, transition and interior
//     regions, with its boundary values taken at K_LEVEL (:3441-3738)
//   vertical transition profile of KAPPA_ISOP and HOR_DIFF (:3745-3840)
//   skew-flux weights, per-tracer flux divergence GTK, VDC_GM (:1720-2080)
//   optionally the diagnostic columns kappa_isop, kappa_thic, hor_diff.
//
// Replaces the TPU kernel gm_chain_pallas.py `_kernel` / `chain_tiles`
// (without its submesoscale fold-in, a later extension).
//
// Bound on this card: bytes: nt tracer fields, 8 slopes, 2 slope measures
// and the vertical profile in, nt + 1 (+ 3 diagnostic) fields out, against a
// few hundred flops per column and level. One thread per (j, i) column. The
// fluxes through a cell's faces need the weights of the neighbouring
// columns too (and the divergence the neighbours' fluxes), so each thread
// derives, besides the full weights of its own column, the effective
// diffusivity and the one face's skew weights of each of its four
// neighbours from the same inputs: redundant arithmetic on values the
// neighbouring threads read anyway (served by L1/L2), nothing exchanged and
// no weight field in device memory. The streamfunction's boundary values
// W1/W2 need slopes and tapers at K_LEVEL .. K_LEVEL+2: on this card they
// are plain indexed loads in a per-column set-up, done for the thread's own
// four faces and for the one facing face of each neighbour. The flux
// arithmetic itself is `gm_flux_column` (gm_flux.cuh).
#include "gm_flux.cuh"

namespace pop2 {

// rows of the per-level scalar table
enum { lDZ, lDZR, lDZWKP, lRDT, lRDB, lTRT, lTRB, lDZWR, kChainLevRows };

template <typename T>
struct ChainParams {
  T slm_r, slm_b, ah, ah_bolus, isop_deep, thic_deep, ah_srfbl, ah_bottom;
  int hd_const;
};

template <typename T>
struct ChainFields {
  const T* __restrict__ slp;  // (8, km, ny, nx): plane 2*face + half
  const T* __restrict__ sla;  // (2, km, ny, nx)
  const T* __restrict__ kv;   // (km, ny, nx)
  const T* __restrict__ lev;  // (kChainLevRows, km)
  int km;
  long ls, ps;  // level stride, plane stride
};

// Transition-layer geometry of one column and the streamfunction boundary
// values of the faces this thread needs from it.
template <typename T>
struct ChainCol {
  bool valid, thick_ok;
  long off;
  int kmt;
  T dd, thick, idp, safe_thick, w5, w6;
};

template <typename T>
__device__ __forceinline__ T notanh(T sla, T slm) {
  const T x = sla / slm;
  const T mid = T(0.5) * (T(1) - (T(2.5) * x - T(1)) *
                                     (T(4) - fabs(T(10) * x - T(4))));
  return x <= T(0.2) ? T(1) : (x >= T(0.6) ? T(0) : mid);
}

// Tapered diffusivities of both halves of level k before the vertical
// profile: kisop (top, bottom), kthic (top, bottom), and the untapered
// isopycnal diffusivity kis0.
template <typename T, bool BFRE, bool SAME_SLM>
__device__ __forceinline__ void tapers_kappa(
    const ChainFields<T>& f, const ChainParams<T>& p, const ChainCol<T>& c,
    int k, T* kis_t, T* kis_b, T* kth_t, T* kth_b, T* kis0) {
  const long o = k * f.ls + c.off;
  const T sla_t = f.sla[o], sla_b = f.sla[f.ps + o];
  const T t2_t = notanh(sla_t, p.slm_r), t2_b = notanh(sla_b, p.slm_r);
  const T t3_t = SAME_SLM ? t2_t : notanh(sla_t, p.slm_b);
  const T t3_b = SAME_SLM ? t2_b : notanh(sla_b, p.slm_b);
  // no slope tapering inside the diabatic region
  const bool ind_t = f.lev[lTRT * f.km + k] <= c.dd;
  const bool ind_b = f.lev[lTRB * f.km + k] <= c.dd;
  T kth0;
  if (BFRE) {
    const T kvv = f.kv[o];
    *kis0 = p.ah * max(kvv, p.isop_deep);
    kth0 = p.ah_bolus * max(kvv, p.thic_deep);
  } else {
    *kis0 = p.ah;
    kth0 = p.ah_bolus;
  }
  const bool at_bot = k + 1 == c.kmt;
  *kis_t = k == 0 ? T(0) : (ind_t ? T(1) : t2_t) * *kis0;
  *kth_t = k == 0 ? T(0) : (ind_t ? T(1) : t3_t) * kth0;
  *kis_b = at_bot ? T(0) : (ind_b ? T(1) : t2_b) * *kis0;
  *kth_b = at_bot ? T(0) : (ind_b ? T(1) : t3_b) * kth0;
}

// What the streamfunction's boundary values need of a column besides the
// face's slopes: thickness diffusivities and level scalars at K_LEVEL (k),
// k+1, k+2, and which of the two base positions applies.
template <typename T>
struct ChainBase {
  int i0, i1, i2;
  bool m1, m2, deeper;
  T th_b_k, th_t_k1, th_b_k1, th_t_k2;
  T dz_k, dz_k1, dz_k2, dzwr_k, dzwr_k1;
};

template <typename T, bool BFRE, bool SAME_SLM>
__device__ __forceinline__ ChainBase<T> chain_base(
    const ChainFields<T>& f, const ChainParams<T>& p, const ChainCol<T>& c,
    int klev, int ztw) {
  ChainBase<T> b;
  const int km = f.km;
  b.i0 = min(max(klev - 1, 0), km - 1);
  b.i1 = min(max(klev, 0), km - 1);
  b.i2 = min(max(klev + 1, 0), km - 1);
  const bool inside = klev < c.kmt && klev > 0;
  b.m1 = ztw == 1 && inside;  // base at zt(k)
  b.m2 = ztw == 2 && inside;  // base at zw(k)
  b.deeper = b.m2 && klev + 1 < c.kmt;
  T u0, u1, u2, u3, u4;
  tapers_kappa<T, BFRE, SAME_SLM>(f, p, c, b.i0, &u0, &u1, &u2, &b.th_b_k,
                                  &u3);
  tapers_kappa<T, BFRE, SAME_SLM>(f, p, c, b.i1, &u0, &u1, &b.th_t_k1,
                                  &b.th_b_k1, &u3);
  tapers_kappa<T, BFRE, SAME_SLM>(f, p, c, b.i2, &u0, &u1, &b.th_t_k2, &u4,
                                  &u3);
  b.dz_k = f.lev[lDZ * km + b.i0];
  b.dz_k1 = f.lev[lDZ * km + b.i1];
  b.dz_k2 = f.lev[lDZ * km + b.i2];
  b.dzwr_k = f.lev[lDZWR * km + b.i0];
  b.dzwr_k1 = f.lev[lDZWR * km + b.i1];
  return b;
}

// W1 (streamfunction) and W2 (its first derivative) at the interior depth
// for one face of a column.
template <typename T>
__device__ __forceinline__ void chain_w12(const ChainFields<T>& f,
                                          const ChainCol<T>& c,
                                          const ChainBase<T>& b, int face,
                                          T* w1, T* w2) {
  const T* top = f.slp + (2 * face) * f.ps + c.off;
  const T* bot = f.slp + (2 * face + 1) * f.ps + c.off;
  const T sl_b_k = bot[b.i0 * f.ls], sl_t_k1 = top[b.i1 * f.ls];
  const T sl_b_k1 = bot[b.i1 * f.ls], sl_t_k2 = top[b.i2 * f.ls];

  const T w1_a = b.th_b_k * sl_b_k * b.dz_k;
  T w2_a = T(2) * b.dzwr_k * (w1_a - b.th_t_k1 * sl_t_k1 * b.dz_k1);
  const T w2n_a = T(2) * (b.th_t_k1 * sl_t_k1 - b.th_b_k1 * sl_b_k1);
  if (fabs(w2n_a) < fabs(w2_a)) w2_a = w2n_a;

  const T w1_b0 = b.th_t_k1 * sl_t_k1;
  T w2_b = T(2) * (w1_b0 - b.th_b_k1 * sl_b_k1);
  const T w1_b = w1_b0 * b.dz_k1;
  const T w2n_b = T(2) * b.dzwr_k1 * (b.th_b_k1 * sl_b_k1 * b.dz_k1 -
                                       b.th_t_k2 * sl_t_k2 * b.dz_k2);
  if (b.deeper && fabs(w2n_b) < fabs(w2_b)) w2_b = w2n_b;

  *w1 = b.m1 ? w1_a : (b.m2 ? w1_b : T(0));
  *w2 = b.m1 ? w2_a : (b.m2 ? w2_b : T(0));
}

// One level of a column after the vertical profile: isopycnal and
// horizontal diffusivities and the thickness diffusivity of both halves.
template <typename T>
struct ChainLevel {
  T kis[2], hd[2], kth[2];
};

template <typename T, bool BFRE, bool SAME_SLM>
__device__ __forceinline__ ChainLevel<T> chain_level(
    const ChainFields<T>& f, const ChainParams<T>& p, const ChainCol<T>& c,
    int k) {
  ChainLevel<T> l;
  T kis0;
  tapers_kappa<T, BFRE, SAME_SLM>(f, p, c, k, &l.kis[0], &l.kis[1],
                                  &l.kth[0], &l.kth[1], &kis0);
  const T hd0 = p.hd_const ? p.ah_srfbl : kis0;
  const bool in_col = k + 1 <= c.kmt;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const T rd = f.lev[(h == 0 ? lRDT : lRDB) * f.km + k];
    const bool z_dia = rd <= c.dd && in_col;
    const bool z_tl = rd > c.dd && rd <= c.idp && in_col && c.thick_ok;
    const bool z_int = rd > c.idp && in_col;
    l.kis[h] = z_dia ? T(0)
                     : (z_tl ? (rd - c.dd) * l.kis[h] / c.safe_thick
                             : l.kis[h]);
    const T hd = z_tl ? (c.idp - rd) * hd0 / c.safe_thick : hd0;
    l.hd[h] = z_int ? T(0) : hd;
  }
  if (p.ah_bottom != T(0) && k + 1 == c.kmt) l.hd[1] = p.ah_bottom;
  return l;
}

// Merged streamfunction of one quarter cell: linear through the diabatic
// region, quadratic through the transition layer, kappa_thic*slope*dz below.
template <typename T>
__device__ __forceinline__ T chain_sf(const ChainFields<T>& f,
                                      const ChainCol<T>& c, int k, int half,
                                      T w1, T w2, T kth, T sl) {
  const T rd = f.lev[(half == 0 ? lRDT : lRDB) * f.km + k];
  const bool in_col = k + 1 <= c.kmt;
  if (!in_col) return T(0);
  const T lin = rd * c.w5 * (T(2) * w1 + c.thick * w2);
  if (rd <= c.dd) return lin;
  if (rd <= c.idp)
    return -(c.dd - rd) * (c.dd - rd) * c.w6 * (w1 + c.idp * w2) + lin;
  return kth * sl * f.lev[lDZ * f.km + k];
}

template <typename T, bool BFRE, bool DIAGS, bool SAME_SLM>
struct ChainWeights {
  ChainFields<T> f;
  ChainParams<T> p;
  GmMetrics<T> m;
  ChainCol<T> col[5];
  T w1_own[4], w2_own[4];  // own column, faces e, w, n, s
  T w1_nb[5], w2_nb[5];    // neighbour's face that looks back
  T* __restrict__ diags;   // (3, km, ny, nx) or null

  __device__ __forceinline__ void own(int k, GmWeights<T>* w) {
    const ChainCol<T>& c = col[kC];
    const ChainLevel<T> l = chain_level<T, BFRE, SAME_SLM>(f, p, c, k);
    const long o = k * f.ls + c.off;
    T sl_t[4], sl_b[4], sf_t[4], sf_b[4];
#pragma unroll
    for (int fc = 0; fc < 4; ++fc) {
      sl_t[fc] = f.slp[(2 * fc) * f.ps + o];
      sl_b[fc] = f.slp[(2 * fc + 1) * f.ps + o];
      sf_t[fc] = chain_sf(f, c, k, 0, w1_own[fc], w2_own[fc], l.kth[0],
                          sl_t[fc]);
      sf_b[fc] = chain_sf(f, c, k, 1, w1_own[fc], w2_own[fc], l.kth[1],
                          sl_b[fc]);
    }
    gm_make_weights<T, false>(f.lev[lDZ * f.km + k], l.kis[0], l.kis[1],
                              l.hd[0], l.hd[1], sl_t, sl_b, sf_t, sf_b, m, w);
    if (DIAGS) {
      diags[o] = T(0.5) * (l.kis[0] + l.kis[1]);
      diags[f.ps + o] = T(0.5) * (l.kth[0] + l.kth[1]);
      diags[2 * f.ps + o] = T(0.5) * (l.hd[0] + l.hd[1]);
    }
  }

  __device__ __forceinline__ void face(int nb, int k, T* weff, T* vt,
                                       T* vb) const {
    *weff = *vt = *vb = T(0);
    const ChainCol<T>& c = col[nb];
    if (!c.valid) return;
    const ChainLevel<T> l = chain_level<T, BFRE, SAME_SLM>(f, p, c, k);
    *weff = l.kis[0] + l.kis[1] + l.hd[0] + l.hd[1];
    const int fc = facing(nb);
    const long o = k * f.ls + c.off;
    const T dzk = f.lev[lDZ * f.km + k];
    const T sl_t = f.slp[(2 * fc) * f.ps + o];
    const T sl_b = f.slp[(2 * fc + 1) * f.ps + o];
    *vt = l.kis[0] * sl_t * dzk -
          chain_sf(f, c, k, 0, w1_nb[nb], w2_nb[nb], l.kth[0], sl_t);
    *vb = l.kis[1] * sl_b * dzk -
          chain_sf(f, c, k, 1, w1_nb[nb], w2_nb[nb], l.kth[1], sl_b);
  }
};

template <typename T, bool BFRE, bool DIAGS, bool SAME_SLM>
__global__ void __launch_bounds__(kThreads)
gm_chain_kernel(int nt, int km, int ny, int nx, int cyclic,
                ChainParams<T> p, const T* __restrict__ lev,
                const T* __restrict__ tmix, const T* __restrict__ slp,
                const T* __restrict__ sla, const T* __restrict__ kv,
                const T* __restrict__ hyx, const T* __restrict__ hxy,
                const T* __restrict__ tarea_r, const T* __restrict__ dd,
                const T* __restrict__ thk, const T* __restrict__ idp,
                const int* __restrict__ kmt, const int* __restrict__ klev,
                const int* __restrict__ ztw,
                T* __restrict__ gtk, T* __restrict__ vdc,
                T* __restrict__ diags) {
  Column c;
  if (!locate(ny, nx, cyclic, &c)) return;
  const long ls = (long)ny * nx, ps = (long)km * ls;
  const Stencil s = make_stencil(c, nx);
  const T eps = T(1.0e-10);

  ChainWeights<T, BFRE, DIAGS, SAME_SLM> wp;
  wp.f = ChainFields<T>{slp, sla, kv, lev, km, ls, ps};
  wp.p = p;
  wp.m = load_metrics(s, kmt, hyx, hxy, tarea_r);
  wp.diags = diags;

#pragma unroll
  for (int n = 0; n < 5; ++n) {
    ChainCol<T>& col = wp.col[n];
    col.valid = s.valid[n];
    col.off = s.off[n];
    col.kmt = wp.m.kmt[n];
    col.dd = dd[col.off];
    col.thick = thk[col.off];
    col.idp = idp[col.off];
    const bool ocean = col.kmt > 0;
    col.thick_ok = col.thick > eps;
    col.safe_thick = col.thick_ok ? col.thick : T(1);
    col.w5 = ocean ? T(1) / (T(2) * col.dd + col.thick) : T(0);
    col.w6 = (ocean && col.thick_ok) ? col.w5 / col.safe_thick : T(0);
    wp.w1_nb[n] = wp.w2_nb[n] = T(0);
    if (!col.valid) continue;
    const ChainBase<T> b = chain_base<T, BFRE, SAME_SLM>(
        wp.f, p, col, klev[col.off], ztw[col.off]);
    if (n == kC) {
#pragma unroll
      for (int fc = 0; fc < 4; ++fc)
        chain_w12(wp.f, col, b, fc, &wp.w1_own[fc], &wp.w2_own[fc]);
    } else {
      chain_w12(wp.f, col, b, facing(n), &wp.w1_nb[n], &wp.w2_nb[n]);
    }
  }

  TracerDiffs<T> dp;
  dp.t = tmix;
  dp.s = s;
#pragma unroll
  for (int n = 0; n < 5; ++n) dp.kmt[n] = wp.m.kmt[n];
  dp.ls = ls;
  dp.ts = ps;
  gm_flux_column<T, false>(wp, dp, wp.m, nt, km, ls, ps, s.off[kC], lev, gtk,
                           vdc);
}

}  // namespace pop2

extern "C" int pop2_gm_chain_lev_rows() { return pop2::kChainLevRows; }

// dtype: 0 = float32, 1 = float64; flags: bit 0 bfre kappa, bit 1 write the
// diagnostic columns, bit 2 slm_r == slm_b; params: slm_r, slm_b, ah,
// ah_bolus, isop_deep, thic_deep, ah_srfbl, ah_bottom. Returns
// cudaGetLastError() of the launch.
extern "C" int pop2_gm_chain(int dtype, int nt, int km, int ny, int nx,
                             int cyclic, int flags, int hd_const,
                             const double* params, const void* lev,
                             const void* tmix, const void* slp,
                             const void* sla, const void* kv,
                             const void* hyx, const void* hxy,
                             const void* tarea_r, const void* dd,
                             const void* thk, const void* idp,
                             const int* kmt, const int* klev,
                             const int* ztw, void* gtk, void* vdc,
                             void* diags, void* stream) {
  using namespace pop2;
  const dim3 grid(blocks_for((long)ny * nx)), block(kThreads);
  cudaStream_t s = (cudaStream_t)stream;
#define POP2_GM_CHAIN(T, BFRE, DIAGS, SAME)                                  \
  {                                                                          \
    ChainParams<T> p{(T)params[0], (T)params[1], (T)params[2],               \
                     (T)params[3], (T)params[4], (T)params[5],               \
                     (T)params[6], (T)params[7], hd_const};                  \
    gm_chain_kernel<T, BFRE, DIAGS, SAME><<<grid, block, 0, s>>>(            \
        nt, km, ny, nx, cyclic, p, (const T*)lev, (const T*)tmix,            \
        (const T*)slp, (const T*)sla, (const T*)kv, (const T*)hyx,           \
        (const T*)hxy, (const T*)tarea_r, (const T*)dd, (const T*)thk,       \
        (const T*)idp, kmt, klev, ztw, (T*)gtk, (T*)vdc, (T*)diags);         \
  }
#define POP2_GM_CHAIN_FLAGS(T)                                               \
  switch (flags & 7) {                                                       \
    case 0: POP2_GM_CHAIN(T, false, false, false) break;                     \
    case 1: POP2_GM_CHAIN(T, true, false, false) break;                      \
    case 2: POP2_GM_CHAIN(T, false, true, false) break;                      \
    case 3: POP2_GM_CHAIN(T, true, true, false) break;                       \
    case 4: POP2_GM_CHAIN(T, false, false, true) break;                      \
    case 5: POP2_GM_CHAIN(T, true, false, true) break;                       \
    case 6: POP2_GM_CHAIN(T, false, true, true) break;                       \
    default: POP2_GM_CHAIN(T, true, true, true) break;                       \
  }
  if (dtype == 0) {
    POP2_GM_CHAIN_FLAGS(float)
  } else {
    POP2_GM_CHAIN_FLAGS(double)
  }
#undef POP2_GM_CHAIN_FLAGS
#undef POP2_GM_CHAIN
  return (int)cudaGetLastError();
}
