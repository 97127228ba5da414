// Shared helpers for the hand-written Hopper kernels of the ocean core.
//
// Fields are dense row-major (..., km, ny, nx) arrays, i fastest, so a warp
// of neighbouring columns reads 32 neighbouring addresses; closed boundaries
// read zero, a cyclic east-west boundary wraps the index. Every kernel
// stages in shared memory with asynchronous copies (`cp.async`) issued
// ahead of the arithmetic: thomas stages whole columns; gm_chain, gm_slope,
// gm_flux, tracer and clinic a 2-D tile of columns with a one-column halo,
// level by level, and the stencil kernels among them hand what a column
// computes once a level (the GM weights, the face velocities of tracer and
// clinic) to its neighbours through shared memory. Their block shape and
// dynamic shared memory come from the caller (the wrappers' launch
// planners); the C entries check them against the layout, and the card
// refuses a block over what it gives one (`allow_large_smem`). gm_slope,
// gm_flux, tracer and clinic share the tile geometry below (`Frame`,
// `frame_slot`): a tile of threads inside a frame of halo slots that the
// threads copy; the chain keeps its own tile, whose halo columns are
// threads.
#pragma once

#include <cuda_runtime.h>

namespace pop2 {

// Horizontal position of a thread's column and of its four neighbours.
// An index that would leave the domain through a closed edge is clamped to
// the column itself and flagged invalid; readers return zero for it.
struct Column {
  int j, i;
  int jn, js, ie, iw;
  bool vn, vs, ve, vw;
};

// The column at (j, i), which must lie inside the domain.
__device__ __forceinline__ void locate_at(int ny, int nx, int cyclic, int j,
                                          int i, Column* c) {
  c->j = j;
  c->i = i;
  c->vs = j > 0;
  c->vn = j < ny - 1;
  c->js = c->vs ? j - 1 : j;
  c->jn = c->vn ? j + 1 : j;
  if (cyclic) {
    c->ve = c->vw = true;
    c->ie = (i + 1 == nx) ? 0 : i + 1;
    c->iw = (i == 0) ? nx - 1 : i - 1;
  } else {
    c->ve = i < nx - 1;
    c->vw = i > 0;
    c->ie = c->ve ? i + 1 : i;
    c->iw = c->vw ? i - 1 : i;
  }
}

// f[off] where the neighbour exists, zero where a closed edge cuts it off.
template <typename T>
__device__ __forceinline__ T ldz(const T* __restrict__ f, long off,
                                 bool valid) {
  return valid ? __ldg(f + off) : T(0);
}

// ---- asynchronous copies into shared memory (sm_80 and later) ------------

// Start copying one value from device memory into shared memory; with
// valid == false nothing is read and the value becomes zero.
template <typename T>
__device__ __forceinline__ void cp_async(T* smem, const T* gmem, bool valid) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "4- or 8-byte values");
  constexpr int kBytes = sizeof(T);
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
               "l"(gmem), "n"(kBytes), "r"(valid ? kBytes : 0)
               : "memory");
}

// Close the group of copies this thread started since the last commit.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- 2-D tiles staged level by level (gm_slope, gm_flux, tracer, clinic) --
//
// A block is a tile of kFrameCols x rows interior columns, a warp a row and
// one thread a column, inside a frame of HALO columns on every side. A
// staged plane covers the whole frame, slot (r, c) at r * kPitch + c, the
// tile's interior column (ty, tx) at slot (ty + HALO, tx + HALO); thread
// tid copies the frame slots tid + j * nthreads, j < kFrameSlots.
constexpr int kFrameCols = 32;
constexpr int kFrameSlots = 2;

template <int HALO>
struct Frame {
  static constexpr int kHalo = HALO;
  static constexpr int kPitch = kFrameCols + 2 * HALO;
  // slots of a plane of a tile of `rows` rows
  static constexpr __host__ __device__ int plane(int rows) {
    return kPitch * (rows + 2 * HALO);
  }
  // whether the block's threads cover every slot of a plane
  static constexpr __host__ __device__ bool covered(int rows) {
    return rows >= 1 && plane(rows) <= kFrameSlots * kFrameCols * rows;
  }
};

// Where frame slot q (< plane(rows)) of the tile whose first interior
// column is (y0, x0) lies: its frame row r and column c, and the offset of
// its column in a level plane. False outside the domain: beyond a closed
// edge, and beyond the north and south edges (a tripole grid's fold will
// map the north frame rows, gj >= ny, here). A cyclic east-west edge wraps
// the HALO columns past it.
template <int HALO>
__device__ __forceinline__ bool frame_slot(int q, int y0, int x0, int ny,
                                           int nx, int cyclic, int* r,
                                           int* c, int* off) {
  *r = q / Frame<HALO>::kPitch;
  *c = q - *r * Frame<HALO>::kPitch;
  const int gj = y0 + *r - HALO;
  int gi = x0 + *c - HALO;
  bool in = gj >= 0 && gj < ny;
  if (cyclic) {
    in = in && gi >= -HALO && gi < nx + HALO;
    gi = gi < 0 ? gi + nx : (gi >= nx ? gi - nx : gi);
  } else {
    in = in && gi >= 0 && gi < nx;
  }
  *off = in ? gj * nx + gi : 0;
  return in;
}

// Let a kernel take `smem` bytes of dynamic shared memory a block and
// prefer shared memory over L1 in the SM's split. The attributes belong to
// the current device, so this is called before every launch (it is cheap);
// it fails where the card gives a block less than `smem`.
template <typename K>
inline cudaError_t allow_large_smem(K* kernel, long smem) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

// Blocks of `threads` threads and `smem` bytes of dynamic shared memory that
// fit on one SM at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or
// minus the CUDA error.
template <typename K>
inline int blocks_per_sm(K* kernel, int threads, long smem) {
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, kernel, threads, (size_t)smem);
  return e == cudaSuccess ? n : -(int)e;
}

}  // namespace pop2
