// Masked batched Thomas sweep: the implicit vertical-mixing solve of every
// water column (impvmixt / impvmixu, source/vertical_mix.F90:1164, :1679).
//
// Replaces the TPU kernel tridiag_pallas.py `_thomas_kernel` / `thomas_tiles`.
//
// Per column p and right-hand side n it solves, for the increment F,
//   (hfac_k + A_k + C_k) F_k - A_k F_{k+1} - C_k F_{k-1} = hfac_k * rhs_k
// with C_k = A_{k-1}, the surface diagonal h1 in place of hfac_1, the
// deepest level kmax (1-based, 0 = land) closing the column, and all nr
// right-hand sides sharing one factorisation. The kernel forms
// hfac_k * rhs_k itself; the caller zeroes A at the last level.
//
// Bound on this card: bytes. The minimum traffic is A once, every rhs once
// and every solution once ((1 + 2 nr) fields); there are about ten flops per
// value. The design: one thread per column, so each level's loads and
// stores of a warp are 32 consecutive values; B, C and the nr partial
// solutions of the forward sweep ride in registers. The elimination
// coefficients E_k must survive from the forward to the backward sweep:
// they live in a per-thread local array bounded by kMaxLevels (km <= 64
// covers every grid of the model, the deepest has 62 levels). Local memory
// is interleaved by thread, so its traffic is as coalesced as a
// caller-allocated (km, ny, nx) scratch would be, without an allocation
// per call; it stays in L1/L2 when the working set allows. The forward
// solutions are parked in `out` and corrected in place going up, so `out`
// is written twice and read once: about 3 nr + 1 field passes plus E.
#include "common.cuh"

namespace pop2 {

constexpr int kMaxLevels = 64;

template <typename T, int NR>
__global__ void __launch_bounds__(kThreads)
thomas_kernel(int km, long ncol, const T* __restrict__ hfac,
              const T* __restrict__ h1, const int* __restrict__ kmax,
              const T* __restrict__ a, const T* __restrict__ rhs,
              T* __restrict__ out) {
  const long p = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= ncol) return;
  const long rs = (long)km * ncol;  // stride between right-hand sides
  const int kmx = kmax[p];
  T e[kMaxLevels];
  T f[NR];

  // level-1 set-up (source/vertical_mix.F90:1263-1274)
  const T h1p = h1[p];
  T c = a[p];
  T dinv = T(1) / (h1p + c);
  T ek = c * dinv;
  T b = h1p * ek;
  e[0] = ek;
  T hf = hfac[0];
#pragma unroll
  for (int n = 0; n < NR; ++n) {
    f[n] = hf * rhs[n * rs + p] * dinv;
    out[n * rs + p] = f[n];
  }

  // forward elimination
  for (int k = 1; k < km; ++k) {
    const int kk = k + 1;  // 1-based level
    const bool at_bot = kmx == kk;
    const bool below = kmx < kk;
    const long o = (long)k * ncol + p;
    const T ak = a[o];
    hf = hfac[k];
    const T d = below ? T(1) : hf + b + (at_bot ? T(0) : ak);
    dinv = T(1) / d;
    ek = below ? T(0) : ak * dinv;
    b = (hf + b) * ek;
    e[k] = ek;
#pragma unroll
    for (int n = 0; n < NR; ++n) {
      f[n] = below ? T(0) : (hf * rhs[n * rs + o] + c * f[n]) * dinv;
      out[n * rs + o] = f[n];
    }
    c = ak;
  }

  // back substitution (source/vertical_mix.F90:1338-1349): F_k += E_k F_{k+1}
  // for k < kmax, sweeping up; f[] holds F_{k+1}
  for (int k = km - 2; k >= 0; --k) {
    const bool interior = (k + 1) < kmx;
    const long o = (long)k * ncol + p;
    ek = e[k];
#pragma unroll
    for (int n = 0; n < NR; ++n) {
      T fk = out[n * rs + o];
      if (interior) {
        fk = fk + ek * f[n];
        out[n * rs + o] = fk;
      }
      f[n] = fk;
    }
  }
}

template <typename T>
int thomas_launch(int nr, int km, long ncol, const void* hfac, const void* h1,
                  const int* kmax, const void* a, const void* rhs, void* out,
                  cudaStream_t stream) {
  if (km < 1 || km > kMaxLevels || nr < 1 || nr > 3)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(blocks_for(ncol)), block(kThreads);
#define POP2_THOMAS(NR)                                                      \
  thomas_kernel<T, NR><<<grid, block, 0, stream>>>(                          \
      km, ncol, (const T*)hfac, (const T*)h1, kmax, (const T*)a,             \
      (const T*)rhs, (T*)out)
  switch (nr) {
    case 1: POP2_THOMAS(1); break;
    case 2: POP2_THOMAS(2); break;
    default: POP2_THOMAS(3); break;
  }
#undef POP2_THOMAS
  return (int)cudaGetLastError();
}

}  // namespace pop2

// dtype: 0 = float32, 1 = float64. Returns cudaGetLastError() of the launch.
extern "C" int pop2_thomas(int dtype, int nr, int km, long ncol,
                           const void* hfac, const void* h1, const int* kmax,
                           const void* a, const void* rhs, void* out,
                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return pop2::thomas_launch<float>(nr, km, ncol, hfac, h1, kmax, a, rhs,
                                      out, s);
  return pop2::thomas_launch<double>(nr, km, ncol, hfac, h1, kmax, a, rhs,
                                     out, s);
}

extern "C" int pop2_thomas_max_levels() { return pop2::kMaxLevels; }
