// Isopycnal slopes of the GM / submesoscale schemes in one pass over the T
// and S columns: the MWJF expansion coefficients drho/dT, drho/dS
// (source/state_mod.F90:418-498), the T/S face and vertical differences, the
// eight quarter-cell slopes (tracer_diffs_and_isopyc_slopes,
// source/hmix_gm_submeso_share.F90:149-434), the absolute-slope measure SLA
// (source/hmix_gm.F90:1236-1242) and the displaced-parcel N^2 of the bfre
// profile (source/hmix_gm.F90:3104-3111).
//
// Replaces the TPU kernel gm_slope_pallas.py `_kernel` / `slopes_tiles`.
//
// Bound on this card: bytes, 2 fields read and 11 written per point, against
// some 250 flops and about 15 division or square-root sequences (two
// evaluations of the rational EOS derivatives, eight slopes, two measures).
// The design keeps bytes in flight and reads each value once a level:
//   - a block is a tile of kFrameCols x kSlopeRows columns (a warp a row,
//     one thread a column) in a one-column frame (common.cuh `Frame`),
//     walking down k; the tile's shape is a compile-time constant, so a
//     shared-memory address is a register and an immediate;
//   - T and S of the tile and its N, S, E, W frame sides, with the level's
//     row of the coefficient table, are staged in shared memory by
//     `cp.async` kSlopeAhead levels ahead into a ring of kSlopeRing levels:
//     a column reads its neighbours' T and S at k and its own at k+1 there;
//     the clipped temperature max(T, -2) is formed where it is read;
//   - no neighbour needs a column's MWJF derivatives, so they stay in the
//     column's registers, as do the T and S differences across the level's
//     top (the level above's bottom ones).
// The pressure-dependent polynomial coefficients of the EOS collapse to
// per-level scalars computed on the host (`coef`, 19 rows of km): set A at
// the level's own pressure, set B at the pressure of the level below for
// the displaced parcel. Slopes divide by the vertical density difference
// clamped at -eps2, in the operation order of the plain version. Closed
// edges read zero (copies of nothing); a cyclic edge wraps inside the frame;
// the ragged last tiles are masked. On a tripole grid (`fold`) the frame's
// north ghost row holds the fold of the top row (T and S are centre
// scalars: the copy reads the mapped column, in another tile) and the top
// row's north bottom level is the folded KMT (common.cuh `fold_point`).
// The block shape and the dynamic shared memory come from the wrapper's
// planner (`gm_slope_cuda.launch_plan`).
#include "common.cuh"

namespace pop2 {

// rows of the per-level coefficient table
enum {
  cN00A, cN02A, cN10A, cD00A, cD01A, cD03A,
  cN00B, cN02B, cN10B, cD00B, cD01B, cD03B,
  cTMIN, cTMAX, cSMIN, cSMAX, cDZWT, cDZWB, cDZWR, kSlopeCoefRows
};

// the tile's rows, a compile-time constant, and the ring of staged levels:
// level k is read with level k+1 while levels k+2 and k+3 land
constexpr int kSlopeRows = 8;
constexpr int kSlopeThreads = kFrameCols * kSlopeRows;
constexpr int kSlopeAhead = 3;
constexpr int kSlopeRing = kSlopeAhead + 1;  // the four rotating indices below
using SlopeFrame = Frame<1>;
static_assert(SlopeFrame::covered(kSlopeRows), "a frame slot, no copier");
static_assert(kSlopeCoefRows <= kSlopeThreads, "a coefficient, no copier");

// A staged level: the T and S frame planes, then the level's coefficients.
struct SlopeLayout {
  static constexpr int kP = SlopeFrame::plane(kSlopeRows);
  static constexpr int kLevel = 2 * kP + kSlopeCoefRows;
  static constexpr int kValues = kSlopeRing * kLevel;
};

// Blocks an SM that the register budget is set for: 32 warps in float32.
template <typename T>
struct SlopeOcc {
  static constexpr int kMinBlocks = sizeof(T) == 4 ? 4 : 2;
};

// (drho/dT, drho/dS) of the MWJF rational fit; the pressure-independent
// terms are constants (g/cm^3 units folded into the numerator).
template <typename T>
__device__ __forceinline__ void mwjf_derivs(T TQ, T SQ, T SQR, T n00, T n02,
                                            T n10, T d00, T d01, T d03,
                                            T* drdt, T* drds) {
  const T n01 = T(7.35212840e+0 * 0.001), n03 = T(3.98476704e-4 * 0.001);
  const T n11 = T(-7.23268813e-3 * 0.001), n20 = T(2.12382341e-3 * 0.001);
  const T d02 = T(-4.60835542e-5), d04 = T(1.80809186e-10);
  const T d10 = T(2.14691708e-3), d11 = T(-9.27062484e-6);
  const T d13 = T(-1.78343643e-10), dq0 = T(4.76534122e-6);
  const T dq2 = T(1.63410736e-9);

  const T work1 = n00 + TQ * (n01 + TQ * (n02 + n03 * TQ)) +
                  SQ * (n10 + n11 * TQ + n20 * SQ);
  const T work2 = d00 + TQ * (d01 + TQ * (d02 + TQ * (d03 + d04 * TQ))) +
                  SQ * (d10 + TQ * (d11 + TQ * TQ * d13) +
                        SQR * (dq0 + TQ * TQ * dq2));
  const T denomk = T(1) / work2;
  const T w3t = n01 + TQ * (T(2) * n02 + T(3) * n03 * TQ) + n11 * SQ;
  const T w4t = d01 + SQ * d11 +
                TQ * (T(2) * (d02 + SQ * SQR * dq2) +
                      TQ * (T(3) * (d03 + SQ * d13) + TQ * T(4) * d04));
  *drdt = (w3t - work1 * denomk * w4t) * denomk;
  const T w3s = n10 + n11 * TQ + T(2) * n20 * SQ;
  const T w4s = d10 + TQ * (d11 + TQ * TQ * d13) +
                T(1.5) * SQR * (dq0 + TQ * TQ * dq2);
  *drds = (w3s - work1 * denomk * w4s) * denomk * T(1000);
}

template <typename T>
__device__ __forceinline__ T clampv(T x, T lo, T hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

template <typename T>
__global__ void __launch_bounds__(kSlopeThreads, SlopeOcc<T>::kMinBlocks)
gm_slope_kernel(int km, int ny, int nx, int cyclic, int fold, T grav,
                const T* __restrict__ coef, const T* __restrict__ tmix,
                const int* __restrict__ kmt, const T* __restrict__ dxt,
                const T* __restrict__ dyt, T* __restrict__ slp,
                T* __restrict__ sla, T* __restrict__ n2) {
  using Lay = SlopeLayout;
  constexpr int W = SlopeFrame::kPitch, P = Lay::kP, R = kSlopeRows;
  extern __shared__ __align__(16) unsigned char pop2_smem[];
  T* ring = reinterpret_cast<T*>(pop2_smem);  // (kSlopeRing, Lay::kLevel)
  const int tid = threadIdx.y * kFrameCols + threadIdx.x;
  // level and plane strides: the C entry keeps every offset of an output
  // below 2^31
  const int ls = ny * nx, ps = km * ls;
  const T* tt = tmix;             // temperature
  const T* ss = tmix + ps;        // salinity

  const int x0 = blockIdx.x * kFrameCols, y0 = blockIdx.y * R;
  const int s = (threadIdx.y + 1) * W + threadIdx.x + 1;  // own slot
  const int gi = x0 + threadIdx.x, gj = y0 + threadIdx.y;
  const bool live = gi < nx && gj < ny;  // the column writes output
  const int oc = live ? gj * nx + gi : 0;

  // the frame slots this thread copies: the tile and its N, S, E, W sides
  // (no corners); bit 0: inside the domain, bit 1: copied
  int soff[kFrameSlots];
  unsigned sflag[kFrameSlots];
#pragma unroll
  for (int j = 0; j < kFrameSlots; ++j) {
    const int q = tid + j * kSlopeThreads;
    int r = 0, c = 0, off = 0;
    const bool in =
        q < P && frame_slot<1>(q, y0, x0, ny, nx, cyclic, &r, &c, &off,
                               fold, kFoldCenter);
    const bool corner = (r == 0 || r == R + 1) && (c == 0 || c == W - 1);
    soff[j] = off;
    sflag[j] = q < P && !corner ? (unsigned)in | 2u : 0u;
  }

  // start the copies of level L into ring slot b: a group a level, empty
  // past the bottom
  auto stage = [&](int L, int b) {
    if (L < km) {
      T* lt = ring + b * Lay::kLevel;
      const int lo = L * ls;
#pragma unroll
      for (int j = 0; j < kFrameSlots; ++j) {
        const int q = tid + j * kSlopeThreads;
        if (sflag[j] & 2u) {
          const bool in = sflag[j] & 1u;
          cp_async(lt + q, tt + (lo + soff[j]), in);
          cp_async(lt + P + q, ss + (lo + soff[j]), in);
        }
      }
      if (tid < kSlopeCoefRows)
        cp_async(lt + 2 * P + tid, coef + (tid * km + L), true);
    }
    cp_async_commit();
  };

  // 2-D operands of the column; the slope measure's 1/dx^2 and 1/dy^2 once
  // a column (four divisions a level fewer)
  int kmt_c = 0, kmt_e = 0, kmt_w = 0, kmt_n = 0, kmt_s = 0;
  T rdx2 = T(1), rdy2 = T(1);
  if (live) {
    Column c;
    locate_at(ny, nx, cyclic, gj, gi, &c, fold);
    kmt_c = kmt[oc];
    kmt_e = c.ve ? kmt[c.j * nx + c.ie] : 0;
    kmt_w = c.vw ? kmt[c.j * nx + c.iw] : 0;
    kmt_n = c.vn ? kmt[c.jn * nx + c.in] : 0;
    kmt_s = c.vs ? kmt[c.js * nx + c.i] : 0;
    const T dx = dxt[oc], dy = dyt[oc];
    rdx2 = T(1) / (dx * dx);
    rdy2 = T(1) / (dy * dy);
  }
  const T eps = T(1.0e-10), neg_eps2 = T(-1.0e-20), tfloor = T(-2);

  // ---- down the column -----------------------------------------------------
  // level L in ring slot L % kSlopeRing, kept as rotating indices
  int b0 = 0, b1 = 1, b2 = 2, b3 = 3;
  stage(0, b0);
  stage(1, b1);
  stage(2, b2);
  // clipped T and S differences across the level's top interface (zero
  // above the first level): the level above's bottom ones
  T tzp_c = T(0), tzs_c = T(0);
  for (int k = 0; k < km; ++k) {
    // levels k and k+1 have landed everywhere; every thread is done with
    // level k-1's slot
    cp_async_wait<kSlopeAhead - 2>();
    __syncthreads();
    stage(k + kSlopeAhead, b3);
    if (live) {
      const int kk = k + 1;
      const bool last = k == km - 1;
      const T* tk = ring + b0 * Lay::kLevel;
      const T* sk = tk + P;
      const T* ck = tk + 2 * P;
      const T t_raw = tk[s], s_c = sk[s];
      const T tc_c = max(t_raw, tfloor);
      T tc_p = T(0), s_p = T(0);
      if (!last) {
        const T* tp = ring + b1 * Lay::kLevel;
        tc_p = max(tp[s], tfloor);
        s_p = tp[P + s];
      }
      const T TQ = clampv(t_raw, ck[cTMIN], ck[cTMAX]);
      const T SQ = T(1000) * clampv(s_c, ck[cSMIN], ck[cSMAX]);
      const T SQR = sqrt(SQ);
      T drdt, drds, drdt_d, drds_d;
      mwjf_derivs(TQ, SQ, SQR, ck[cN00A], ck[cN02A], ck[cN10A], ck[cD00A],
                  ck[cD01A], ck[cD03A], &drdt, &drds);
      mwjf_derivs(TQ, SQ, SQR, ck[cN00B], ck[cN02B], ck[cN10B], ck[cD00B],
                  ck[cD01B], ck[cD03B], &drdt_d, &drds_d);

      // masked face differences of clipped T and of S, looking out of the
      // cell through its east, west, north and south faces
      const bool in_c = kk <= kmt_c, below = kk < kmt_c;
      T dtf[4], dsf[4];
      {
        const bool me = in_c && kk <= kmt_e, mw = in_c && kk <= kmt_w;
        const bool mn = in_c && kk <= kmt_n, ms = in_c && kk <= kmt_s;
        dtf[0] = me ? max(tk[s + 1], tfloor) - tc_c : T(0);
        dsf[0] = me ? sk[s + 1] - s_c : T(0);
        dtf[1] = mw ? tc_c - max(tk[s - 1], tfloor) : T(0);
        dsf[1] = mw ? s_c - sk[s - 1] : T(0);
        dtf[2] = mn ? max(tk[s + W], tfloor) - tc_c : T(0);
        dsf[2] = mn ? sk[s + W] - s_c : T(0);
        dtf[3] = ms ? tc_c - max(tk[s - W], tfloor) : T(0);
        dsf[3] = ms ? s_c - sk[s - W] : T(0);
      }

      // vertical differences across the interface below the level
      const T tzp_p = last ? T(0) : tc_c - tc_p;
      const T tzs_p = last ? T(0) : s_c - s_p;
      const T rz_ktp = min(drdt * tzp_c + drds * tzs_c, neg_eps2);
      const T rz_kbt = min(drdt * tzp_p + drds * tzs_p, neg_eps2);

      const int ok = k * ls + oc;
      T q_t[2] = {T(0), T(0)}, q_b[2] = {T(0), T(0)};  // sums of squares
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const T r = drdt * dtf[f] + drds * dsf[f];
        // the top half of level 1 has no interface above
        const T s_top = (in_c && k > 0) ? r / rz_ktp : T(0);
        const T s_bot = below ? r / rz_kbt : T(0);
        slp[(2 * f) * ps + ok] = s_top;
        slp[(2 * f + 1) * ps + ok] = s_bot;
        q_t[f >> 1] += s_top * s_top;
        q_b[f >> 1] += s_bot * s_bot;
      }
      sla[ok] =
          ck[cDZWT] * sqrt(T(0.5) * (q_t[0] * rdx2 + q_t[1] * rdy2)) + eps;
      sla[ps + ok] =
          ck[cDZWB] * sqrt(T(0.5) * (q_b[0] * rdx2 + q_b[1] * rdy2)) + eps;

      const T w3 = drdt_d * tzp_p + drds_d * tzs_p;
      n2[ok] = below ? max(T(0), -grav * w3 * ck[cDZWR]) : T(0);

      tzp_c = tzp_p;
      tzs_c = tzs_p;
    }
    const int b = b0;
    b0 = b1;
    b1 = b2;
    b2 = b3;
    b3 = b;
  }
}

template <typename T>
struct SlopeInstance {
  static cudaError_t prepare(long smem) {
    return allow_large_smem(gm_slope_kernel<T>, smem);
  }
  static int occupancy(long smem) {
    const cudaError_t e = prepare(smem);
    if (e != cudaSuccess) return -(int)e;
    return blocks_per_sm(gm_slope_kernel<T>, kSlopeThreads, smem);
  }
};

// The launch configuration the wrapper chose: `rows` rows of kFrameCols
// columns, `smem` bytes of dynamic shared memory; offsets in int (the
// eight slope planes).
template <typename T>
bool slope_config_ok(int km, int ny, int nx, int rows, long smem) {
  return km >= 1 && 8L * km * ny * nx < (1L << 31) && rows == kSlopeRows &&
         smem >= (long)SlopeLayout::kValues * (long)sizeof(T);
}

}  // namespace pop2

extern "C" int pop2_gm_slope_coef_rows() { return pop2::kSlopeCoefRows; }

// Values of dynamic shared memory the tile takes (the planner's count,
// gm_slope_cuda.smem_values).
extern "C" int pop2_gm_slope_smem_values() {
  return pop2::SlopeLayout::kValues;
}

extern "C" int pop2_gm_slope_tile_rows() { return pop2::kSlopeRows; }

// dtype: 0 = float32, 1 = float64; cyclic: the east-west edge wraps; fold:
// the north edge is a tripole fold; rows: rows of the tile; smem: dynamic
// shared memory a block, bytes. Returns cudaGetLastError() of the launch,
// or cudaErrorInvalidValue for a configuration the kernel does not take.
extern "C" int pop2_gm_slopes(int dtype, int km, int ny, int nx, int cyclic,
                              int fold, int rows, long smem, double grav,
                              const void* coef, const void* tmix,
                              const int* kmt, const void* dxt,
                              const void* dyt, void* slp, void* sla,
                              void* n2, void* stream) {
  using namespace pop2;
  if (!(dtype == 0 ? slope_config_ok<float>(km, ny, nx, rows, smem)
                   : slope_config_ok<double>(km, ny, nx, rows, smem)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((nx + kFrameCols - 1) / kFrameCols),
                  (unsigned)((ny + kSlopeRows - 1) / kSlopeRows));
  const dim3 block(kFrameCols, kSlopeRows);
  cudaStream_t s = (cudaStream_t)stream;
#define POP2_GM_SLOPES(T)                                                    \
  {                                                                          \
    const cudaError_t e = SlopeInstance<T>::prepare(smem);                   \
    if (e != cudaSuccess) return (int)e;                                     \
    gm_slope_kernel<T><<<grid, block, smem, s>>>(                            \
        km, ny, nx, cyclic, fold, (T)grav, (const T*)coef, (const T*)tmix,   \
        kmt, (const T*)dxt, (const T*)dyt, (T*)slp, (T*)sla, (T*)n2);        \
  }
  if (dtype == 0)
    POP2_GM_SLOPES(float)
  else
    POP2_GM_SLOPES(double)
#undef POP2_GM_SLOPES
  return (int)cudaGetLastError();
}

// Blocks of a launch with `smem` bytes a block that one SM holds at once.
extern "C" int pop2_gm_slope_blocks_per_sm(int dtype, long smem) {
  using namespace pop2;
  return dtype == 0 ? SlopeInstance<float>::occupancy(smem)
                    : SlopeInstance<double>::occupancy(smem);
}
