// Shared helpers for the hand-written Hopper kernels of the ocean core.
//
// All three kernels use the same layout: one thread per (j, i) water column,
// i fastest so a warp reads 32 neighbouring addresses, a loop over k with
// the column's carries in registers, neighbours read straight from global
// memory (L1/L2 serve the re-reads). Fields are dense row-major
// (..., km, ny, nx) arrays; closed boundaries read zero, a cyclic east-west
// boundary wraps the index.
#pragma once

#include <cuda_runtime.h>

namespace pop2 {

constexpr int kThreads = 128;  // threads per block: 4 warps, 1 column each

// Horizontal position of a thread's column and of its four neighbours.
// An index that would leave the domain through a closed edge is clamped to
// the column itself and flagged invalid; readers return zero for it.
struct Column {
  int j, i;
  int jn, js, ie, iw;
  bool vn, vs, ve, vw;
};

__device__ __forceinline__ bool locate(int ny, int nx, int cyclic,
                                       Column* c) {
  const long p = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= (long)ny * nx) return false;
  c->j = (int)(p / nx);
  c->i = (int)(p - (long)c->j * nx);
  c->vs = c->j > 0;
  c->vn = c->j < ny - 1;
  c->js = c->vs ? c->j - 1 : c->j;
  c->jn = c->vn ? c->j + 1 : c->j;
  if (cyclic) {
    c->ve = c->vw = true;
    c->ie = (c->i + 1 == nx) ? 0 : c->i + 1;
    c->iw = (c->i == 0) ? nx - 1 : c->i - 1;
  } else {
    c->ve = c->i < nx - 1;
    c->vw = c->i > 0;
    c->ie = c->ve ? c->i + 1 : c->i;
    c->iw = c->vw ? c->i - 1 : c->i;
  }
  return true;
}

// f[off] where the neighbour exists, zero where a closed edge cuts it off.
template <typename T>
__device__ __forceinline__ T ldz(const T* __restrict__ f, long off,
                                 bool valid) {
  return valid ? __ldg(f + off) : T(0);
}

inline int blocks_for(long n) { return (int)((n + kThreads - 1) / kThreads); }

}  // namespace pop2
