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
// value. The design: one thread per column (the recurrence is sequential in
// k; the columns fill the card), a block of C columns, and the block's slab
// of A and the nr right-hand sides, km levels deep, staged in shared memory
// by asynchronous copies that the thread starts ahead of the sweep, in groups
// of kChunk levels, kAhead groups in flight (so the sweep starts when the
// first group has landed and many levels' loads are in flight at once).
// Each thread reads and writes only its own column of the slab, so no block
// barrier is needed, and the layout (level, column) keeps a warp's accesses
// on 32 consecutive words. The forward sweep overwrites A_k by the
// elimination coefficient E_k and rhs_k by the forward solution in place;
// the back substitution reads them there and writes `out` once, level by
// level. Device-memory traffic is the bound's. The slab, (1 + nr) km C
// values, is the dynamic shared memory: C comes from the wrapper's planner
// (`tridiag_cuda.launch_plan`) so that several blocks fit an SM. On an H100
// 64 or 128 columns a block were no faster than 32, one group of copies in
// flight slower than two and more than two no faster.
//
// Right-hand sides: the kernel is instantiated for 1 to kMaxRhs (4, the
// production menu's most: salinity and three passive tracers on the Euler
// step); the wrapper launches more in groups of at most kMaxRhs that share
// A, h1 and kmax (`tridiag_cuda.rhs_groups`), each group reading A again.
// At 4 right-hand sides in float64 a block's slab of 60 levels is 76.8 KB,
// so an SM holds three blocks (four at 2 right-hand sides, five at 4 in
// float32); each block keeps (1 + nr) values a level in flight, so the
// bytes in flight an SM stay near those of the 2-right-hand-side instance.
//
// Partial bottom cells (PBC instances): the bottom level's thickness differs
// from the level table's, so its diagonal term hfac_kmax is read from one
// more (ny, nx) plane, hbot, once a column, and used at k = kmax (and in the
// level-1 set-up of a one-level column); every other level reads the table.
// The coupling A, already 3-D, is formed by the wrapper from the column's
// thicknesses. One plane more than the full-cell instance's traffic.
#include "common.cuh"

namespace pop2 {

constexpr int kMaxLevels = 64;
constexpr int kMaxRhs = 4;             // right-hand sides a launch
constexpr int kChunk = 8;              // levels a group of copies
constexpr int kAhead = 2;              // groups of copies in flight
constexpr int kMaxColsPerBlock = 256;  // threads a block at most

template <typename T, int NR, bool PBC>
__global__ void __launch_bounds__(kMaxColsPerBlock)
thomas_kernel(int km, long ncol, const T* __restrict__ hfac,
              const T* __restrict__ h1, const int* __restrict__ kmax,
              const T* __restrict__ a, const T* __restrict__ rhs,
              T* __restrict__ out, const T* __restrict__ hbot) {
  extern __shared__ __align__(16) unsigned char pop2_smem[];
  const int C = blockDim.x, t = threadIdx.x;
  const long p = (long)blockIdx.x * C + t;
  if (p >= ncol) return;  // no barrier below: the ragged block just stops
  T* se = reinterpret_cast<T*>(pop2_smem);  // (km, C): A_k, then E_k
  T* sf = se + km * C;                      // (NR, km, C): rhs, then F
  const long rs = (long)km * ncol;          // stride between right-hand sides

  // copies of this column's levels, a group per kChunk levels, kAhead
  // groups in flight: chunk g is waited for before its levels are swept and
  // chunk g + kAhead is started after them
  const int nchunk = (km + kChunk - 1) / kChunk;
  auto start_chunk = [&](int g) {
    const int k1 = min(km, (g + 1) * kChunk);
    for (int k = g * kChunk; k < k1; ++k) {
      const long o = (long)k * ncol + p;
      cp_async(se + k * C + t, a + o, true);
#pragma unroll
      for (int n = 0; n < NR; ++n)
        cp_async(sf + (n * km + k) * C + t, rhs + n * rs + o, true);
    }
    cp_async_commit();
  };
  int started = 0;
  while (started < min(kAhead, nchunk)) start_chunk(started++);

  const int kmx = kmax[p];
  // the bottom level's diagonal term (PBC), 0-based level kmx - 1
  const T hb = PBC ? hbot[p] : T(0);
  T f[NR], c, b;
  for (int g = 0; g < nchunk; ++g) {
    // chunk g has landed once at most the chunks started after it are
    // pending (none after the last one)
    static_assert(kAhead == 2, "one chunk at most is pending behind g");
    if (started - g - 1 > 0)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    const int k1 = min(km, (g + 1) * kChunk);
    for (int k = g * kChunk; k < k1; ++k) {
      T* ak_p = se + k * C + t;
      const T ak = *ak_p;
      if (k == 0) {
        // level-1 set-up (source/vertical_mix.F90:1263-1274)
        const T h1p = h1[p];
        const T dinv = T(1) / (h1p + ak);
        const T ek = ak * dinv;
        b = h1p * ek;
        *ak_p = ek;
        const T hf = (PBC && kmx == 1) ? hb : hfac[0];
#pragma unroll
        for (int n = 0; n < NR; ++n) {
          T* fp = sf + n * km * C + t;
          f[n] = hf * *fp * dinv;
          *fp = f[n];
        }
      } else {
        // forward elimination
        const int kk = k + 1;  // 1-based level
        const bool at_bot = kmx == kk;
        const bool below = kmx < kk;
        const T hf = (PBC && at_bot) ? hb : hfac[k];
        const T d = below ? T(1) : hf + b + (at_bot ? T(0) : ak);
        const T dinv = T(1) / d;
        const T ek = below ? T(0) : ak * dinv;
        b = (hf + b) * ek;
        *ak_p = ek;
#pragma unroll
        for (int n = 0; n < NR; ++n) {
          T* fp = sf + (n * km + k) * C + t;
          f[n] = below ? T(0) : (hf * *fp + c * f[n]) * dinv;
          *fp = f[n];
        }
      }
      c = ak;
    }
    if (started < nchunk) start_chunk(started++);
  }

  // back substitution (source/vertical_mix.F90:1338-1349): F_k += E_k F_{k+1}
  // for k < kmax, sweeping up; f[] holds F_{k+1}. Every level of `out` is
  // written once.
  const long ob = (long)(km - 1) * ncol + p;
#pragma unroll
  for (int n = 0; n < NR; ++n) out[n * rs + ob] = f[n];
  for (int k = km - 2; k >= 0; --k) {
    const bool interior = (k + 1) < kmx;
    const long o = (long)k * ncol + p;
    const T ek = se[k * C + t];
#pragma unroll
    for (int n = 0; n < NR; ++n) {
      T fk = sf[(n * km + k) * C + t];
      if (interior) fk = fk + ek * f[n];
      out[n * rs + o] = fk;
      f[n] = fk;
    }
  }
}

// The launch configuration the wrapper chose: C columns a block (a multiple
// of 32), `smem` bytes holding the (1 + nr) km C slab.
inline bool thomas_config_ok(int nr, int km, int cols, long smem,
                             int value_bytes) {
  return km >= 1 && km <= kMaxLevels && nr >= 1 && nr <= kMaxRhs &&
         cols >= 32 &&
         cols <= kMaxColsPerBlock && cols % 32 == 0 &&
         smem >= (long)(1 + nr) * km * cols * value_bytes;
}

template <typename T, int NR, bool PBC>
int thomas_run(int km, long ncol, int cols, long smem, const void* hfac,
               const void* h1, const int* kmax, const void* a,
               const void* rhs, void* out, const void* hbot,
               cudaStream_t stream) {
  const cudaError_t e = allow_large_smem(thomas_kernel<T, NR, PBC>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((ncol + cols - 1) / cols)), block(cols);
  thomas_kernel<T, NR, PBC><<<grid, block, smem, stream>>>(
      km, ncol, (const T*)hfac, (const T*)h1, kmax, (const T*)a,
      (const T*)rhs, (T*)out, (const T*)hbot);
  return (int)cudaGetLastError();
}

template <typename T, int NR>
int thomas_run_pbc(int km, long ncol, int cols, long smem, const void* hfac,
                   const void* h1, const int* kmax, const void* a,
                   const void* rhs, void* out, const void* hbot,
                   cudaStream_t stream) {
  if (hbot != nullptr)
    return thomas_run<T, NR, true>(km, ncol, cols, smem, hfac, h1, kmax, a,
                                   rhs, out, hbot, stream);
  return thomas_run<T, NR, false>(km, ncol, cols, smem, hfac, h1, kmax, a,
                                  rhs, out, hbot, stream);
}

template <typename T>
int thomas_launch(int nr, int km, long ncol, int cols, long smem,
                  const void* hfac, const void* h1, const int* kmax,
                  const void* a, const void* rhs, void* out,
                  const void* hbot, cudaStream_t stream) {
  if (!thomas_config_ok(nr, km, cols, smem, sizeof(T)))
    return (int)cudaErrorInvalidValue;
  switch (nr) {
    case 1: return thomas_run_pbc<T, 1>(km, ncol, cols, smem, hfac, h1, kmax,
                                        a, rhs, out, hbot, stream);
    case 2: return thomas_run_pbc<T, 2>(km, ncol, cols, smem, hfac, h1, kmax,
                                        a, rhs, out, hbot, stream);
    case 3: return thomas_run_pbc<T, 3>(km, ncol, cols, smem, hfac, h1, kmax,
                                        a, rhs, out, hbot, stream);
    default: return thomas_run_pbc<T, 4>(km, ncol, cols, smem, hfac, h1,
                                         kmax, a, rhs, out, hbot, stream);
  }
}

template <typename T, int NR, bool PBC>
int thomas_occupancy(int cols, long smem) {
  const cudaError_t e = allow_large_smem(thomas_kernel<T, NR, PBC>, smem);
  if (e != cudaSuccess) return -(int)e;
  return blocks_per_sm(thomas_kernel<T, NR, PBC>, cols, smem);
}

template <typename T, bool PBC>
int thomas_occupancy_nr(int nr, int cols, long smem) {
  switch (nr) {
    case 1: return thomas_occupancy<T, 1, PBC>(cols, smem);
    case 2: return thomas_occupancy<T, 2, PBC>(cols, smem);
    case 3: return thomas_occupancy<T, 3, PBC>(cols, smem);
    default: return thomas_occupancy<T, 4, PBC>(cols, smem);
  }
}

}  // namespace pop2

// dtype: 0 = float32, 1 = float64; nr: right-hand sides, 1 to 4; cols:
// columns (threads) a block; smem: dynamic shared memory a block, bytes;
// hbot: the bottom level's diagonal term, (ncol), under partial bottom cells
// (the PBC instance), or null. Returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for a configuration the kernel does not take or the
// card cannot hold.
extern "C" int pop2_thomas(int dtype, int nr, int km, long ncol, int cols,
                           long smem, const void* hfac, const void* h1,
                           const int* kmax, const void* a, const void* rhs,
                           void* out, const void* hbot, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return pop2::thomas_launch<float>(nr, km, ncol, cols, smem, hfac, h1,
                                      kmax, a, rhs, out, hbot, s);
  return pop2::thomas_launch<double>(nr, km, ncol, cols, smem, hfac, h1,
                                     kmax, a, rhs, out, hbot, s);
}

// Blocks a launch of this configuration (pbc: the PBC instance) keeps on
// one SM at once.
extern "C" int pop2_thomas_blocks_per_sm(int dtype, int nr, int cols,
                                         long smem, int pbc) {
  using namespace pop2;
  if (nr < 1 || nr > kMaxRhs) return -(int)cudaErrorInvalidValue;
  if (pbc)
    return dtype == 0 ? thomas_occupancy_nr<float, true>(nr, cols, smem)
                      : thomas_occupancy_nr<double, true>(nr, cols, smem);
  return dtype == 0 ? thomas_occupancy_nr<float, false>(nr, cols, smem)
                    : thomas_occupancy_nr<double, false>(nr, cols, smem);
}

// Right-hand sides a launch takes at most (the planner's tridiag_cuda
// MAX_RHS).
extern "C" int pop2_thomas_max_rhs() { return pop2::kMaxRhs; }

// Dynamic shared memory a block may take on the current device, bytes
// (the launch planners' limit).
extern "C" int pop2_max_dynamic_smem() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return n;
}
