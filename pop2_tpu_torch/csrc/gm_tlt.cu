// The transition-layer search of GM (transition_layer,
// source/hmix_gm.F90:3183-3434): for each column, from the diabatic depth
// (the smoothed KPP boundary-layer depth) down, the first interface or
// centre below it (pass 1), then level by level while the Rossby-scale
// vertical displacement R |S| of the slope measure still reaches above the
// diabatic depth (passes 2 and 3). Outputs the transition layer's
// thickness, the depth where the adiabatic interior starts, its base level
// K_LEVEL and whether the base is a centre (1) or an interface (2).
//
// Replaces no TPU kernel: the JAX package runs this search as jnp scans
// between its two GM kernels (gm_chain_pallas.py:831-832), and the port's
// plain version (`gm.transition_layer`) as loops of whole-field operations
// that end at the deepest level any column still searches: one launch per
// operation and level, host-bound once the boundary layer is deep.
//
// Bound on this card: bytes, and few of them: each column reads its 2-D
// fields and the slope measures of the levels it searches, and writes four
// 2-D fields. The search is sequential down a column and stops at the
// column's own depth, so a thread takes a column and walks it with the
// state of the three passes in registers; neighbouring threads take
// neighbouring columns, so a warp's reads of one level are coalesced.
// The products R |S| are rounded before the comparison, as the plain
// version rounds them (no fused multiply-add), so the integer outputs equal
// the plain version's.
#include "common.cuh"

namespace pop2 {

constexpr int kTltThreads = 128;

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

template <typename T>
__global__ void __launch_bounds__(kTltThreads)
gm_tlt_kernel(int km, long ncol, const T* __restrict__ zlev,
              const T* __restrict__ dd, const T* __restrict__ sla,
              const T* __restrict__ rb, const int* __restrict__ kmt,
              T* __restrict__ thick_out, T* __restrict__ idp_out,
              int* __restrict__ klev_out, int* __restrict__ ztw_out) {
  const long c = (long)blockIdx.x * kTltThreads + threadIdx.x;
  if (c >= ncol) return;
  const T* zt = zlev;
  const T* zw = zlev + km;
  const T* s_t = sla + c;               // top half, level q at s_t[q * ncol]
  const T* s_b = sla + km * ncol + c;   // bottom half
  const int kmt_c = kmt[c];
  const T d = dd[c], r = rb[c];

  // pass 1 (:3248-3276): the minimum layer reaches the first interface
  // (zw) or centre (zt) below the diabatic depth
  int k_level = 0, k_sub = 0, ztw = 0, k_start = 0;
  T thick = T(0);
  int k1 = 0;
  while (k1 < km && !(d < zw[k1])) ++k1;
  if (k1 < km && kmt_c != 0) {
    const bool at_zt = k1 != 0 && d < zt[k1];
    k_level = k1 + 1;
    k_sub = at_zt ? 1 : 0;
    thick = at_zt ? zt[k1] - d : zw[k1] - d;
    ztw = at_zt ? 1 : 2;
    k_start = at_zt ? k1 + 1 : k1 + 2;
  }
  bool compute = !(kmt_c == 0 || k_start > kmt_c ||
                   (k_start == kmt_c && k_sub == 1));

  // pass 2 (:3297-3331): a layer that ended at a centre extends to the
  // interface below where R |S| there reaches above the diabatic depth
  if (compute && k_sub == 1 && k_start < kmt_c && k_start <= km - 1) {
    const int q = k_start - 1;
    const T work = mul_rn(fmax(s_b[q * ncol], s_t[(q + 1) * ncol]), r);
    if (work != T(0)) {
      if (d >= zw[q] - work) {
        thick = zw[q] - d;
        k_level = k_start;
        ztw = 2;
        ++k_start;
      } else {
        compute = false;
      }
    }
  }

  // pass 3 (:3339-3388): deeper levels, the top (zt) and the bottom (zw)
  // half of each, until R |S| no longer reaches or the column ends
  if (compute && k_start >= 2) {
    for (int k = k_start; k <= km && k <= kmt_c; ++k) {
      const int q = k - 1;
      T work = mul_rn(fmax(s_t[q * ncol], s_b[q * ncol]), r);
      if (work != T(0)) {
        if (!(d >= zt[q] - work)) break;
        thick = zt[q] - d;
        k_level = k;
        ztw = 1;
      }
      work = T(0);
      if (k < kmt_c)
        work = mul_rn(fmax(s_b[q * ncol], s_t[(q + 1) * ncol]), r);
      else  // k == kmt_c
        work = mul_rn(s_b[q * ncol], r);
      if (work != T(0)) {
        if (!(d >= zw[q] - work)) break;
        thick = zw[q] - d;
        k_level = k;
        ztw = 2;
      }
    }
  }

  // the interior starts at the base (:3404-3413)
  const int kl0 = min(max(k_level - 1, 0), km - 1);
  const T idp = ztw == 1 ? zt[kl0] : (ztw == 2 ? zw[kl0] : T(0));
  const bool ocean = kmt_c > 0;
  thick_out[c] = ocean ? thick : T(0);
  idp_out[c] = ocean ? idp : T(0);
  klev_out[c] = k_level;
  ztw_out[c] = ztw;
}

}  // namespace pop2

extern "C" int pop2_gm_tlt_threads() { return pop2::kTltThreads; }

// Blocks of a launch that one SM holds at once.
extern "C" int pop2_gm_tlt_blocks_per_sm(int dtype) {
  using namespace pop2;
  return dtype == 0
             ? blocks_per_sm(gm_tlt_kernel<float>, kTltThreads, 0)
             : blocks_per_sm(gm_tlt_kernel<double>, kTltThreads, 0);
}

// dtype: 0 = float32, 1 = float64; zlev: (2, km) zt then zw; dd, rb: (ny,
// nx) diabatic depth and Rossby radius; sla: (2, km, ny, nx) slope
// measures (top, bottom half); kmt: (ny, nx). Outputs (ny, nx): thickness,
// interior depth, K_LEVEL, ZTW. Returns cudaGetLastError() of the launch,
// or cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int pop2_gm_tlt(int dtype, int km, int ny, int nx,
                           const void* zlev, const void* dd, const void* sla,
                           const void* rb, const int* kmt, void* thick,
                           void* idp, int* klev, int* ztw, void* stream) {
  using namespace pop2;
  if (km < 1 || ny < 1 || nx < 1) return (int)cudaErrorInvalidValue;
  const long ncol = (long)ny * nx;
  const dim3 grid((unsigned)((ncol + kTltThreads - 1) / kTltThreads));
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    gm_tlt_kernel<float><<<grid, kTltThreads, 0, s>>>(
        km, ncol, (const float*)zlev, (const float*)dd, (const float*)sla,
        (const float*)rb, kmt, (float*)thick, (float*)idp, klev, ztw);
  } else {
    gm_tlt_kernel<double><<<grid, kTltThreads, 0, s>>>(
        km, ncol, (const double*)zlev, (const double*)dd,
        (const double*)sla, (const double*)rb, kmt, (double*)thick,
        (double*)idp, klev, ztw);
  }
  return (int)cudaGetLastError();
}
