// The GM chain downstream of the slopes, fused with the flux assembly
// (hdifft_gm, source/hmix_gm.F90:1102-2219, with the transition layer on):
//   notanh slope tapers (:1405-1601)
//   const / bfre diffusivities with the deep floors (:1345-1399)
//   merged streamfunction through the diabatic, transition and interior
//     regions, with its boundary values taken at K_LEVEL (:3441-3738)
//   vertical transition profile of KAPPA_ISOP and HOR_DIFF (:3745-3840)
//   skew-flux weights, per-tracer flux divergence GTK, VDC_GM (:1720-2080)
//   optionally the diagnostic columns kappa_isop, kappa_thic, hor_diff;
//   optionally (`SM`, the TPU kernel's `with_sm`) the submesoscale
//     streamfunction (mix_submeso.F90:341-772) folded into the merged one.
//
// Replaces the TPU kernel gm_chain_pallas.py `_kernel` / `chain_tiles`.
//
// Bound on this card: bytes: nt tracer fields, 8 slopes, 2 slope measures
// and the vertical profile in, nt + 1 (+ 3 diagnostic) fields out, against a
// few hundred flops per column and level. The fluxes through a cell's faces
// need the weights of the neighbouring columns, so the design follows the
// TPU kernel, which computes a row block's weights once in fast memory and
// shifts them: a block is a 2-D tile of kTileCols x rows columns, the outer
// ring of it a one-column halo (corners unused), one thread a column, a
// warp a row of the tile. The block walks down k:
//   - once, per tile column: the transition-layer geometry and the
//     streamfunction's boundary values W1/W2 of its four faces (indexed
//     loads at K_LEVEL .. K_LEVEL+2), with the metric ratios kept in the
//     thread's slots of shared memory (in registers they pushed the float64
//     instances into spilling);
//   - per level, staged by asynchronous copies one level ahead (level k+2
//     lands while level k+1's weights and level k's fluxes are computed):
//     the 8 slope planes, 2 slope measures and kv of the thread's own
//     column, and the nt tracers, into a ring of four levels that the
//     neighbours read (k-1, k, k+1 for the vertical differences);
//   - per level, every column of the tile, halo included, evaluates its
//     diffusivities, transition profile and skew weights once
//     (`gm_make_weights`) and publishes weff and the faces' vt/vb in shared
//     memory (two buffers: level k+1 is written while level k is read);
//   - after one barrier a level, each interior column forms its level-k
//     fluxes (`gm_flux_level`, shared with gm_flux.cu) from its own weights
//     and its neighbours' facing ones, read from shared memory where a
//     tracer's fluxes use them, the vertical-flux carry of each tracer in
//     shared memory.
// With `SM` a column also holds, once, the submesoscale streamfunction's
// amplitudes of its four faces and its mixed-layer depth (five 2-D planes,
// `submeso.amplitudes` of the plain version); each level adds amplitude x
// mu(z) (the Fox-Kemper vertical shape at the quarter cell's reference
// depth, inside the mixed layer) to the face's merged streamfunction. The
// skew flux is linear in the streamfunction, so this equals GM's tendency
// plus the submesoscale one (`submeso.gtk`).
// Closed edges read zero (copies of nothing, zero weights); a cyclic edge
// wraps inside the halo. On a tripole grid (`fold`) the threads of the
// ghost row gj = ny are the fold of the top row's columns (centre fields:
// row ny - 1, column nx - 1 - i, in another tile): they stage that column's
// slopes, tracers and geometry and form its weights, and publish as their
// south face the north face's skew weights with the sign flipped (the
// faces swap under the 180-degree fold: `BC.n_partner` of the plain
// version); the top row's north bottom level is the folded KMT. The
// submesoscale amplitudes fold the same way: the ghost thread reads the
// folded column's own (its north face's amplitude, whose buoyancy gradient
// is that column's, ends up sign-flipped on the top row's north face with
// the rest of the weight), as the plain version's `BC.n_partner` of the
// south-face streamfunction does. The block
// shape and the dynamic shared memory come from the wrapper's planner
// (`gm_chain_cuda.launch_plan`).
#include "gm_flux.cuh"

namespace pop2 {

// rows of the per-level scalar table
enum { lDZ, lDZR, lDZWKP, lRDT, lRDB, lTRT, lTRB, lDZWR, kChainLevRows };

// The tile: a row is one warp, kTileCols - 2 interior columns between the
// west and east halo columns; `rows` rows (blockDim.y), rows - 2 interior.
constexpr int kTileCols = 32;
constexpr int kTileInterior = kTileCols - 2;
template <typename T>
struct ChainTile;
template <>
struct ChainTile<float> {
  static constexpr int kMaxRows = 16;
};
template <>
struct ChainTile<double> {
  static constexpr int kMaxRows = 10;
};

// planes of a staged level of a column: 8 slopes (plane 2*face + half), the
// 2 slope measures, kv
enum { sSLA = 8, sKV = 10, kStagePlanes = 11 };
// what a column publishes each level: weff, then vt and vb of faces e,w,n,s
enum { wWEFF = 0, wVT = 1, wVB = 5, kPubWeights = 9 };
// a column's constants, kept in shared memory rather than registers (read
// again where a level uses them): transition-layer geometry, the
// streamfunction's boundary values of the four faces, the metric ratios
enum {
  cDD, cTHICK, cIDP, cSAFE, cW5, cW6, cW1, cW2 = cW1 + 4,
  cHYX = cW2 + 4, cHYXW, cHXY, cHXYS, cTAREA, kColConsts
};
// with `SM` also the submesoscale amplitudes of faces e, w, n, s and the
// mixed-layer depth (planes of the `sm` operand in this order)
enum { cSMA = kColConsts, cSMML = cSMA + 4, kColConstsSM, kSmPlanes = 5 };

__host__ __device__ constexpr int col_consts(bool sm) {
  return sm ? kColConstsSM : kColConsts;
}

// Values of dynamic shared memory a tile of `nthr` columns needs: the
// column constants, two staged levels, a ring of four tracer levels, two
// buffers of published weights, the vertical-flux carries.
inline long chain_smem_values(int nt, int nthr, bool sm) {
  return (long)(col_consts(sm) + 2 * kStagePlanes + 4 * nt +
                2 * kPubWeights + nt) * nthr;
}

template <typename T>
struct ChainParams {
  T slm_r, slm_b, ah, ah_bolus, isop_deep, thic_deep, ah_srfbl, ah_bottom;
  int hd_const;
};

// Device-memory fields the per-column set-up reads at K_LEVEL .. K_LEVEL+2.
template <typename T>
struct ChainFields {
  const T* __restrict__ slp;  // (8, km, ny, nx): plane 2*face + half
  const T* __restrict__ sla;  // (2, km, ny, nx)
  const T* __restrict__ kv;   // (km, ny, nx)
  const T* __restrict__ lev;  // (kChainLevRows, km)
  int km;
  long ls, ps;  // level stride, plane stride
};

// Transition-layer geometry of one column.
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
// isopycnal diffusivity kis0; from the level's slope measures and kv.
template <typename T, bool BFRE, bool SAME_SLM>
__device__ __forceinline__ void tapers_kappa(
    const ChainParams<T>& p, const ChainCol<T>& c,
    const T* __restrict__ lev, int km, int k, T sla_t, T sla_b, T kvv,
    T* kis_t, T* kis_b, T* kth_t, T* kth_b, T* kis0) {
  const T t2_t = notanh(sla_t, p.slm_r), t2_b = notanh(sla_b, p.slm_r);
  const T t3_t = SAME_SLM ? t2_t : notanh(sla_t, p.slm_b);
  const T t3_b = SAME_SLM ? t2_b : notanh(sla_b, p.slm_b);
  // no slope tapering inside the diabatic region
  const bool ind_t = lev[lTRT * km + k] <= c.dd;
  const bool ind_b = lev[lTRB * km + k] <= c.dd;
  T kth0;
  if (BFRE) {
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

// The same from device memory, for the set-up at K_LEVEL .. K_LEVEL+2.
template <typename T, bool BFRE, bool SAME_SLM>
__device__ __forceinline__ void tapers_kappa_at(
    const ChainFields<T>& f, const ChainParams<T>& p, const ChainCol<T>& c,
    int k, T* kis_t, T* kis_b, T* kth_t, T* kth_b, T* kis0) {
  const long o = k * f.ls + c.off;
  tapers_kappa<T, BFRE, SAME_SLM>(p, c, f.lev, f.km, k, f.sla[o],
                                  f.sla[f.ps + o], BFRE ? f.kv[o] : T(0),
                                  kis_t, kis_b, kth_t, kth_b, kis0);
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
  tapers_kappa_at<T, BFRE, SAME_SLM>(f, p, c, b.i0, &u0, &u1, &u2,
                                     &b.th_b_k, &u3);
  tapers_kappa_at<T, BFRE, SAME_SLM>(f, p, c, b.i1, &u0, &u1, &b.th_t_k1,
                                     &b.th_b_k1, &u3);
  tapers_kappa_at<T, BFRE, SAME_SLM>(f, p, c, b.i2, &u0, &u1, &b.th_t_k2,
                                     &u4, &u3);
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
    const ChainParams<T>& p, const ChainCol<T>& c, const T* __restrict__ lev,
    int km, int k, T sla_t, T sla_b, T kvv) {
  ChainLevel<T> l;
  T kis0;
  tapers_kappa<T, BFRE, SAME_SLM>(p, c, lev, km, k, sla_t, sla_b, kvv,
                                  &l.kis[0], &l.kis[1], &l.kth[0],
                                  &l.kth[1], &kis0);
  const T hd0 = p.hd_const ? p.ah_srfbl : kis0;
  const bool in_col = k + 1 <= c.kmt;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const T rd = lev[(h == 0 ? lRDT : lRDB) * km + k];
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
// (With `SM` the submesoscale streamfunction is added to the result.)
template <typename T>
__device__ __forceinline__ T chain_sf(const T* __restrict__ lev, int km,
                                      const ChainCol<T>& c, int k, int half,
                                      T w1, T w2, T kth, T sl) {
  const T rd = lev[(half == 0 ? lRDT : lRDB) * km + k];
  const bool in_col = k + 1 <= c.kmt;
  if (!in_col) return T(0);
  const T lin = rd * c.w5 * (T(2) * w1 + c.thick * w2);
  if (rd <= c.dd) return lin;
  if (rd <= c.idp)
    return -(c.dd - rd) * (c.dd - rd) * c.w6 * (w1 + c.idp * w2) + lin;
  return kth * sl * lev[lDZ * km + k];
}

// Tracer differences of an interior column from the tile's ring of tracer
// levels in shared memory: face differences masked where either side is
// below its bottom, tz(k) = T(k-1) - T(k) with tz(0) = 0. Columns outside a
// closed edge hold zeros.
template <typename T>
struct TileTracers {
  const T* ring;  // (4 levels, nt, nthr): level k in slot k & 3
  int nt, nthr;
  int idx[5];  // tile index of each column of the stencil
  int kmt[5];

  __device__ __forceinline__ T at(int n, int k, int col) const {
    return ring[((k & 3) * nt + n) * nthr + idx[col]];
  }
  __device__ __forceinline__ T face(int n, int k, int a, int b) const {
    return (k < kmt[a] && k < kmt[b]) ? at(n, k, b) - at(n, k, a) : T(0);
  }
  __device__ __forceinline__ T tx_c(int n, int k) const {
    return face(n, k, kC, kE);
  }
  __device__ __forceinline__ T tx_w(int n, int k) const {
    return face(n, k, kW, kC);
  }
  __device__ __forceinline__ T ty_c(int n, int k) const {
    return face(n, k, kC, kN);
  }
  __device__ __forceinline__ T ty_s(int n, int k) const {
    return face(n, k, kS, kC);
  }
  __device__ __forceinline__ T tz(int n, int k, int col) const {
    return k > 0 ? at(n, k - 1, col) - at(n, k, col) : T(0);
  }
};

// The weights the tile's columns published for one level, as
// `gm_flux_level` reads them, straight from shared memory.
template <typename T>
struct TileWeights {
  const T* pb;  // (kPubWeights, nthr)
  int nthr;
  const int* idx;  // tile index of each column of the stencil

  __device__ __forceinline__ T at(int q, int c) const {
    return pb[q * nthr + idx[c]];
  }
  __device__ __forceinline__ T own_weff() const { return at(wWEFF, kC); }
  // isotropic: one effective diffusivity for the x and the y faces
  __device__ __forceinline__ T own_weff_y() const { return own_weff(); }
  __device__ __forceinline__ T own_vt(int f) const { return at(wVT + f, kC); }
  __device__ __forceinline__ T own_vb(int f) const { return at(wVB + f, kC); }
  __device__ __forceinline__ T nb_weff(int c) const { return at(wWEFF, c); }
  __device__ __forceinline__ T nb_vt(int c) const {
    return at(wVT + facing(c), c);
  }
  __device__ __forceinline__ T nb_vb(int c) const {
    return at(wVB + facing(c), c);
  }
};

// The submesoscale vertical shape mu(z) of both halves of level k (zero
// where the half's reference depth lies below the mixed layer or the
// column).
template <typename T>
__device__ __forceinline__ void sm_shape(const T* __restrict__ lev, int km,
                                         int k, int kmt, T ml, T mu[2]) {
  const T ml_safe = ml > T(0) ? ml : T(1);
  const bool in_col = k + 1 <= kmt;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const T rd = lev[(h == 0 ? lRDT : lRDB) * km + k];
    T w3s = T(1) - T(2) * rd / ml_safe;
    w3s = w3s * w3s;
    mu[h] = (rd < ml && in_col)
                ? (T(1) - w3s) * (T(1) + T(5.0 / 21.0) * w3s)
                : T(0);
  }
}

template <typename T, bool BFRE, bool DIAGS, bool SAME_SLM, bool SM>
__global__ void __launch_bounds__(kTileCols * ChainTile<T>::kMaxRows)
gm_chain_kernel(int nt, int km, int ny, int nx, int cyclic, int fold,
                ChainParams<T> p, const T* __restrict__ lev,
                const T* __restrict__ tmix, const T* __restrict__ slp,
                const T* __restrict__ sla, const T* __restrict__ kv,
                const T* __restrict__ hyx, const T* __restrict__ hxy,
                const T* __restrict__ tarea_r, const T* __restrict__ dd,
                const T* __restrict__ thk, const T* __restrict__ idp,
                const int* __restrict__ kmt, const int* __restrict__ klev,
                const int* __restrict__ ztw, const T* __restrict__ sm,
                T* __restrict__ gtk, T* __restrict__ vdc,
                T* __restrict__ diags) {
  extern __shared__ __align__(16) unsigned char pop2_smem[];
  const int nthr = kTileCols * blockDim.y;
  const int tid = threadIdx.y * kTileCols + threadIdx.x;
  const long ls = (long)ny * nx, ps = (long)km * ls;
  T* cst = reinterpret_cast<T*>(pop2_smem);    // (col_consts(SM), nthr)
  T* stage = cst + col_consts(SM) * nthr;      // (2, kStagePlanes, nthr)
  T* ring = stage + 2 * kStagePlanes * nthr;   // (4, nt, nthr)
  T* pub = ring + 4 * nt * nthr;               // (2, kPubWeights, nthr)
  T* fzt = pub + 2 * kPubWeights * nthr;       // (nt, nthr)

  // This thread's tile column (gj, gi); a cyclic edge wraps gi = -1 and
  // gi = nx, a closed one leaves them invalid (as every gj outside 0..ny-1
  // but the tripole ghost row gj = ny, the fold of row ny - 1).
  const int gi = blockIdx.x * kTileInterior + (int)threadIdx.x - 1;
  const int gj = blockIdx.y * ((int)blockDim.y - 2) + (int)threadIdx.y - 1;
  const bool halo_x = threadIdx.x == 0 || threadIdx.x == kTileCols - 1;
  const bool halo_y = threadIdx.y == 0 || threadIdx.y == blockDim.y - 1;
  const int i = cyclic ? (gi < 0 ? gi + nx : (gi >= nx ? gi - nx : gi)) : gi;
  const bool ghost = fold && gj == ny;
  const bool valid = !(halo_x && halo_y) && gj >= first_row(fold, ny) &&
                     (gj < ny || ghost) &&
                     (cyclic ? gi >= -1 && gi <= nx : gi >= 0 && gi < nx);
  const bool interior = !halo_x && !halo_y && gi < nx && gj < ny;
  long off = 0;
  if (valid) {
    int fj = gj, fi = i;
    if (ghost) fold_point(kFoldCenter, 1, i, fold, nx, &fj, &fi);
    off = (long)fj * nx + fi;
  }
  const T eps = T(1.0e-10);

  // ---- once per column: geometry, the streamfunction's boundary values
  // and the metric ratios, into the column's shared-memory constants
  T* my = cst + tid;  // constant q at my[q * nthr]
  const int kmt_c = valid ? kmt[off] : 0;
  const bool thick_ok = valid && thk[off] > eps;
  {
    const ChainFields<T> f{slp, sla, kv, lev, km, ls, ps};
    ChainCol<T> col;
    col.valid = valid;
    col.off = off;
    col.kmt = kmt_c;
    col.dd = valid ? dd[off] : T(0);
    col.thick = valid ? thk[off] : T(0);
    col.idp = valid ? idp[off] : T(0);
    const bool ocean = col.kmt > 0;
    col.thick_ok = thick_ok;
    col.safe_thick = col.thick_ok ? col.thick : T(1);
    col.w5 = ocean ? T(1) / (T(2) * col.dd + col.thick) : T(0);
    col.w6 = (ocean && col.thick_ok) ? col.w5 / col.safe_thick : T(0);
    my[cDD * nthr] = col.dd;
    my[cTHICK * nthr] = col.thick;
    my[cIDP * nthr] = col.idp;
    my[cSAFE * nthr] = col.safe_thick;
    my[cW5 * nthr] = col.w5;
    my[cW6 * nthr] = col.w6;
    T w1[4] = {}, w2[4] = {};
    if (valid) {
      const ChainBase<T> b =
          chain_base<T, BFRE, SAME_SLM>(f, p, col, klev[off], ztw[off]);
#pragma unroll
      for (int fc = 0; fc < 4; ++fc)
        chain_w12(f, col, b, fc, &w1[fc], &w2[fc]);
    }
#pragma unroll
    for (int fc = 0; fc < 4; ++fc) {
      my[(cW1 + fc) * nthr] = w1[fc];
      my[(cW2 + fc) * nthr] = w2[fc];
    }
    if (SM) {
#pragma unroll
      for (int q = 0; q < kSmPlanes; ++q)
        my[(cSMA + q) * nthr] = valid ? sm[q * ls + off] : T(0);
    }
  }
  int kmt5[5] = {};  // bottom levels of the stencil (interior columns)
  {
    GmMetrics<T> m = {};
    if (interior) {
      Column c;
      locate_at(ny, nx, cyclic, gj, i, &c, fold);
      m = load_metrics(make_stencil(c, nx), kmt, hyx, hxy, tarea_r);
    }
#pragma unroll
    for (int c = 0; c < 5; ++c) kmt5[c] = m.kmt[c];
    my[cHYX * nthr] = m.hyx;
    my[cHYXW * nthr] = m.hyxw;
    my[cHXY * nthr] = m.hxy;
    my[cHXYS * nthr] = m.hxys;
    my[cTAREA * nthr] = m.tarea_r;
  }
  // the constants as the level arithmetic takes them
  auto column = [&]() {
    ChainCol<T> c;
    c.valid = valid;
    c.thick_ok = thick_ok;
    c.off = off;
    c.kmt = kmt_c;
    c.dd = my[cDD * nthr];
    c.thick = my[cTHICK * nthr];
    c.idp = my[cIDP * nthr];
    c.safe_thick = my[cSAFE * nthr];
    c.w5 = my[cW5 * nthr];
    c.w6 = my[cW6 * nthr];
    return c;
  };
  auto metrics = [&]() {
    GmMetrics<T> m;
#pragma unroll
    for (int c = 0; c < 5; ++c) m.kmt[c] = kmt5[c];
    m.hyx = my[cHYX * nthr];
    m.hyxw = my[cHYXW * nthr];
    m.hxy = my[cHXY * nthr];
    m.hxys = my[cHXYS * nthr];
    m.tarea_r = my[cTAREA * nthr];
    return m;
  };
  TileTracers<T> dp;
  dp.ring = ring;
  dp.nt = nt;
  dp.nthr = nthr;
  dp.idx[kC] = tid;
  dp.idx[kE] = tid + 1;
  dp.idx[kW] = tid - 1;
  dp.idx[kN] = tid + kTileCols;
  dp.idx[kS] = tid - kTileCols;
#pragma unroll
  for (int c = 0; c < 5; ++c) dp.kmt[c] = kmt5[c];

  // what a column outside the domain shows its neighbours: zeros, for good
  if (!valid) {
    for (int q = 0; q < 4 * nt; ++q) ring[q * nthr + tid] = T(0);
    for (int q = 0; q < 2 * kPubWeights; ++q) pub[q * nthr + tid] = T(0);
  }
  for (int n = 0; n < nt; ++n) fzt[n * nthr + tid] = T(0);

  // start the copies of level L: a group a level, empty past the bottom
  auto stage_level = [&](int L) {
    if (valid && L < km) {
      const long o = L * ls + off;
      T* st = stage + (L & 1) * kStagePlanes * nthr + tid;
#pragma unroll
      for (int q = 0; q < 8; ++q)
        cp_async(st + q * nthr, slp + q * ps + o, true);
      cp_async(st + sSLA * nthr, sla + o, true);
      cp_async(st + (sSLA + 1) * nthr, sla + ps + o, true);
      if (BFRE) cp_async(st + sKV * nthr, kv + o, true);
      T* rt = ring + (L & 3) * nt * nthr + tid;
      for (int n = 0; n < nt; ++n)
        cp_async(rt + n * nthr, tmix + n * ps + o, true);
    }
    cp_async_commit();
  };

  // the column's weights at level L from its staged level; weff, vt, vb go
  // to shared memory for the neighbours
  auto weights = [&](int L, GmWeights<T>* w) {
    const T* st = stage + (L & 1) * kStagePlanes * nthr + tid;
    const ChainCol<T> col = column();
    const ChainLevel<T> l = chain_level<T, BFRE, SAME_SLM>(
        p, col, lev, km, L, st[sSLA * nthr], st[(sSLA + 1) * nthr],
        BFRE ? st[sKV * nthr] : T(0));
    T sl_t[4], sl_b[4], sf_t[4], sf_b[4];
    T mu[2] = {T(0), T(0)};
    if (SM) sm_shape(lev, km, L, kmt_c, my[cSMML * nthr], mu);
#pragma unroll
    for (int fc = 0; fc < 4; ++fc) {
      sl_t[fc] = st[(2 * fc) * nthr];
      sl_b[fc] = st[(2 * fc + 1) * nthr];
      const T w1 = my[(cW1 + fc) * nthr], w2 = my[(cW2 + fc) * nthr];
      sf_t[fc] = chain_sf(lev, km, col, L, 0, w1, w2, l.kth[0], sl_t[fc]);
      sf_b[fc] = chain_sf(lev, km, col, L, 1, w1, w2, l.kth[1], sl_b[fc]);
      if (SM) {
        const T a = my[(cSMA + fc) * nthr];
        sf_t[fc] += mu[0] * a;
        sf_b[fc] += mu[1] * a;
      }
    }
    gm_make_weights<T, false>(lev[lDZ * km + L], l.kis[0], l.kis[1],
                              l.hd[0], l.hd[1], sl_t, sl_b, sf_t, sf_b,
                              metrics(), w);
    T* pb = pub + (L & 1) * kPubWeights * nthr + tid;
    pb[wWEFF * nthr] = w->weff;
#pragma unroll
    for (int fc = 0; fc < 4; ++fc) {
      pb[(wVT + fc) * nthr] = w->vt[fc];
      pb[(wVB + fc) * nthr] = w->vb[fc];
    }
    if (ghost) {  // the fold shows the top row its north face, sign flipped
      pb[(wVT + fS) * nthr] = -w->vt[fN];
      pb[(wVB + fS) * nthr] = -w->vb[fN];
    }
    if (DIAGS && interior) {
      const long o = L * ls + off;
      diags[o] = T(0.5) * (l.kis[0] + l.kis[1]);
      diags[ps + o] = T(0.5) * (l.kth[0] + l.kth[1]);
      diags[2 * ps + o] = T(0.5) * (l.hd[0] + l.hd[1]);
    }
  };

  // ---- down the column -----------------------------------------------------
  stage_level(0);
  stage_level(1);
  cp_async_wait<1>();  // level 0 has landed (the thread's own copies)
  GmWeights<T> cur, nxt;
  if (valid) weights(0, &cur);
  for (int k = 0; k < km; ++k) {
    // level k+1 has landed everywhere; level k's weights are published;
    // every thread is done with level k-1's buffers
    cp_async_wait<0>();
    __syncthreads();
    stage_level(k + 2);
    if (valid && k + 1 < km) weights(k + 1, &nxt);
    if (interior) {
      const TileWeights<T> tw{pub + (k & 1) * kPubWeights * nthr, nthr,
                              dp.idx};
      const GmMetrics<T> m = metrics();
      gm_flux_level<T, false, 0>(dp, m, nt, gm_level(m, km, k, lev), cur, nxt,
                              tw, fzt + tid, nthr, ls, ps, off, gtk, vdc);
    }
    cur = nxt;
  }
}

template <typename T, bool BFRE, bool DIAGS, bool SAME, bool SM>
struct ChainInstance {
  static cudaError_t prepare(long smem) {
    return allow_large_smem(gm_chain_kernel<T, BFRE, DIAGS, SAME, SM>, smem);
  }
  static int occupancy(int rows, long smem) {
    const cudaError_t e = prepare(smem);
    if (e != cudaSuccess) return -(int)e;
    return blocks_per_sm(gm_chain_kernel<T, BFRE, DIAGS, SAME, SM>,
                         kTileCols * rows, smem);
  }
};

// The launch configuration the wrapper chose: `rows` rows of kTileCols
// columns, `smem` bytes of dynamic shared memory.
template <typename T>
bool chain_config_ok(int nt, int km, int rows, long smem, bool sm) {
  return nt >= 1 && nt <= kMaxTracers && km >= 1 && rows >= 3 &&
         rows <= ChainTile<T>::kMaxRows &&
         smem >= chain_smem_values(nt, kTileCols * rows, sm) *
                     (long)sizeof(T);
}

}  // namespace pop2

extern "C" int pop2_gm_chain_lev_rows() { return pop2::kChainLevRows; }

// Values of dynamic shared memory a tile column takes with nt tracers, with
// the submesoscale fold-in or without (the planner's per-column count,
// gm_chain_cuda.smem_values).
extern "C" int pop2_gm_chain_smem_values(int nt, int sm) {
  return (int)pop2::chain_smem_values(nt, 1, sm != 0);
}

#define POP2_GM_CHAIN_SM(T, B, D, S, ACTION)                                 \
  if (flags & 8) ACTION(T, B, D, S, true) else ACTION(T, B, D, S, false)
#define POP2_GM_CHAIN_SAME(T, B, D, ACTION)                                  \
  if (flags & 4) {                                                           \
    POP2_GM_CHAIN_SM(T, B, D, true, ACTION)                                  \
  } else {                                                                   \
    POP2_GM_CHAIN_SM(T, B, D, false, ACTION)                                 \
  }
#define POP2_GM_CHAIN_FLAGS(T, ACTION)                                       \
  switch (flags & 3) {                                                       \
    case 0: POP2_GM_CHAIN_SAME(T, false, false, ACTION) break;               \
    case 1: POP2_GM_CHAIN_SAME(T, true, false, ACTION) break;                \
    case 2: POP2_GM_CHAIN_SAME(T, false, true, ACTION) break;                \
    default: POP2_GM_CHAIN_SAME(T, true, true, ACTION) break;                \
  }

// dtype: 0 = float32, 1 = float64; cyclic: the east-west edge wraps; fold:
// the north edge is a tripole fold; flags: bit 0 bfre kappa, bit 1 write the
// diagnostic columns, bit 2 slm_r == slm_b, bit 3 the submesoscale fold-in
// (`sm`: (5, ny, nx) amplitudes of faces e, w, n, s and the mixed-layer
// depth; unread without it); rows: rows of the tile (halo included); smem:
// dynamic shared memory a block, bytes; params: slm_r, slm_b, ah, ah_bolus,
// isop_deep, thic_deep, ah_srfbl, ah_bottom. Returns cudaGetLastError() of
// the launch, or cudaErrorInvalidValue for a configuration the kernel does
// not take or the card cannot hold.
extern "C" int pop2_gm_chain(int dtype, int nt, int km, int ny, int nx,
                             int cyclic, int fold, int flags, int hd_const,
                             int rows, long smem, const double* params,
                             const void* lev, const void* tmix,
                             const void* slp, const void* sla,
                             const void* kv, const void* hyx,
                             const void* hxy, const void* tarea_r,
                             const void* dd, const void* thk,
                             const void* idp, const int* kmt,
                             const int* klev, const int* ztw,
                             const void* sm, void* gtk, void* vdc,
                             void* diags, void* stream) {
  using namespace pop2;
  const bool with_sm = (flags & 8) != 0;
  if (!(dtype == 0 ? chain_config_ok<float>(nt, km, rows, smem, with_sm)
                   : chain_config_ok<double>(nt, km, rows, smem, with_sm)) ||
      (with_sm && sm == nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((nx + kTileInterior - 1) / kTileInterior),
                  (unsigned)((ny + rows - 3) / (rows - 2)));
  const dim3 block(kTileCols, rows);
  cudaStream_t s = (cudaStream_t)stream;
#define POP2_GM_CHAIN(T, BFRE, DIAGS, SAME, SMF)                             \
  {                                                                          \
    const cudaError_t e =                                                    \
        ChainInstance<T, BFRE, DIAGS, SAME, SMF>::prepare(smem);             \
    if (e != cudaSuccess) return (int)e;                                     \
    ChainParams<T> p{(T)params[0], (T)params[1], (T)params[2],               \
                     (T)params[3], (T)params[4], (T)params[5],               \
                     (T)params[6], (T)params[7], hd_const};                  \
    gm_chain_kernel<T, BFRE, DIAGS, SAME, SMF><<<grid, block, smem, s>>>(    \
        nt, km, ny, nx, cyclic, fold, p, (const T*)lev, (const T*)tmix,      \
        (const T*)slp, (const T*)sla, (const T*)kv, (const T*)hyx,           \
        (const T*)hxy, (const T*)tarea_r, (const T*)dd, (const T*)thk,       \
        (const T*)idp, kmt, klev, ztw, (const T*)sm, (T*)gtk, (T*)vdc,       \
        (T*)diags);                                                          \
  }
  if (dtype == 0) {
    POP2_GM_CHAIN_FLAGS(float, POP2_GM_CHAIN)
  } else {
    POP2_GM_CHAIN_FLAGS(double, POP2_GM_CHAIN)
  }
#undef POP2_GM_CHAIN
  return (int)cudaGetLastError();
}

// Blocks of a launch of this configuration that one SM holds at once.
extern "C" int pop2_gm_chain_blocks_per_sm(int dtype, int flags, int rows,
                                           long smem) {
  using namespace pop2;
#define POP2_GM_CHAIN_OCC(T, BFRE, DIAGS, SAME, SMF)                         \
  return ChainInstance<T, BFRE, DIAGS, SAME, SMF>::occupancy(rows, smem);
  if (dtype == 0) {
    POP2_GM_CHAIN_FLAGS(float, POP2_GM_CHAIN_OCC)
  } else {
    POP2_GM_CHAIN_FLAGS(double, POP2_GM_CHAIN_OCC)
  }
#undef POP2_GM_CHAIN_OCC
  return -(int)cudaErrorInvalidValue;  // not reached: every case returns
}
#undef POP2_GM_CHAIN_FLAGS
#undef POP2_GM_CHAIN_SAME
#undef POP2_GM_CHAIN_SM
