// Shared helpers for the hand-written Hopper kernels of the ocean core.
//
// Fields are dense row-major (..., km, ny, nx) arrays, i fastest, so a warp
// of neighbouring columns reads 32 neighbouring addresses; closed boundaries
// read zero, a cyclic east-west boundary wraps the index, and a tripole
// north boundary (`fold`) maps the ghost rows past ny - 1 onto the top
// physical rows, index-reversed (`fold_point`; vector fields also flip
// their sign, which the kernels apply where they read such a value).
// The `fold` argument is 0 on a closed north edge and otherwise the count of
// rows through the fold's top row: ny on the whole domain, where the ghost
// rows fold onto the plane's own top rows; on a top-row block of an x
// decomposition (parallel/mesh.py `halo_call`) the plane's first `fold` rows
// are a strip of the mirror block's top rows, in natural order, whose last
// column is the mirror of the plane's first, and the ghost rows fold onto
// them: the same index map with its rows counted from the strip's top.
// The strip lies south of the domain then (`first_row`): a read past the
// domain's south edge gets zero, as on the whole domain.
// Every kernel but the transition-layer search (gm_tlt, a thread a column
// that reads each value once) stages in shared memory with asynchronous
// copies (`cp.async`) issued ahead of the arithmetic: thomas stages whole
// columns; gm_chain, gm_slope, gm_flux, tracer and clinic a 2-D tile of
// columns with a one-column halo (two for tracer's upwind3), level by
// level, and the stencil kernels among them hand what a column computes
// once a level (the GM weights, the face velocities of tracer and clinic,
// tracer's QUICKEST face values) to its neighbours through shared memory.
// Their block shape and dynamic shared memory come from the caller (the
// wrappers' launch planners); the C entries check them against the layout,
// and the card refuses a block over what it gives one
// (`allow_large_smem`). gm_slope, gm_flux, tracer and clinic share the tile
// geometry below (`Frame`, `frame_slot`): a tile of threads inside a frame
// of halo slots that the threads copy; the chain keeps its own tile, whose
// halo columns are threads.
#pragma once

#include <cuda_runtime.h>

namespace pop2 {

// Where a field lives on the B-grid cell, for the tripole fold
// (tripole.py): T points, NE corners (U points), east and north faces.
enum FoldLoc { kFoldCenter = 0, kFoldCorner, kFoldEface, kFoldNface };

// The first row of the domain in a plane of ny rows: past the mirror strip
// of a top-row block of an x decomposition (`fold` < ny), else 0.
__device__ __forceinline__ int first_row(int fold, int ny) {
  return fold > 0 && fold < ny ? fold : 0;
}

// The physical point (j, i) whose value the tripole ghost row n (n >= 1)
// past the top row holds at column gi (0 <= gi < nx) for a field at `loc`
// (mpi/POP_HaloMod.F90:1961-2050): centre and N-face fields reverse
// i -> nx-1-i, corner and E-face fields i -> nx-2-i with nx-1 -> nx-1;
// centre and E-face fields take row fny-n, corner and N-face row fny-1-n,
// where fny is the `fold` argument (the rows through the fold's top row).
__device__ __forceinline__ void fold_point(int loc, int n, int gi, int fny,
                                           int nx, int* j, int* i) {
  const bool row_below = loc == kFoldCorner || loc == kFoldNface;
  const bool shifted = loc == kFoldCorner || loc == kFoldEface;
  *j = row_below ? fny - 1 - n : fny - n;
  *i = shifted ? (gi == nx - 1 ? nx - 1 : nx - 2 - gi) : nx - 1 - gi;
}

// Horizontal position of a thread's column and of its four neighbours.
// An index that would leave the domain through a closed edge is clamped to
// the column itself and flagged invalid; readers return zero for it. The
// north neighbour is (jn, in): on a tripole grid the top row's north
// neighbour is the fold of a centre field (row fold - 1, column nx - 1 - i).
struct Column {
  int j, i;
  int jn, js, ie, iw, in;
  bool vn, vs, ve, vw;
};

// The column at (j, i), which must lie inside the domain; `fold`: the
// north edge is a tripole fold (nonzero: the rows through its top row).
__device__ __forceinline__ void locate_at(int ny, int nx, int cyclic, int j,
                                          int i, Column* c, int fold = 0) {
  c->j = j;
  c->i = i;
  c->vs = j > first_row(fold, ny);
  c->vn = j < ny - 1 || fold;
  c->js = c->vs ? j - 1 : j;
  c->jn = j < ny - 1 ? j + 1 : (fold ? fold - 1 : j);
  c->in = (j < ny - 1 || !fold) ? i : nx - 1 - i;
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
// edge, and beyond the north and south edges (the south edge at `lo` or at
// the fold's `first_row`) unless the north edge is a tripole fold (`fold`,
// the rows through its top row): then the ghost rows
// gj = ny .. ny + HALO - 1 are in, at the offset of the physical point the
// fold maps them to for a field at `loc` (east-west wrap first, then the
// fold, as the ghost cells are indexed), and `*folded` says so. A cyclic east-west edge wraps the
// HALO columns past it.
template <int HALO>
__device__ __forceinline__ bool frame_slot(int q, int y0, int x0, int ny,
                                           int nx, int cyclic, int* r,
                                           int* c, int* off, int fold = 0,
                                           int loc = kFoldCenter,
                                           bool* folded = nullptr,
                                           int lo = 0) {
  *r = q / Frame<HALO>::kPitch;
  *c = q - *r * Frame<HALO>::kPitch;
  int gj = y0 + *r - HALO;
  int gi = x0 + *c - HALO;
  const bool ghost = fold && gj >= ny && gj < ny + HALO;
  const int row0 = lo > first_row(fold, ny) ? lo : first_row(fold, ny);
  bool in = gj >= row0 && (gj < ny || ghost);
  if (cyclic) {
    in = in && gi >= -HALO && gi < nx + HALO;
    gi = gi < 0 ? gi + nx : (gi >= nx ? gi - nx : gi);
  } else {
    in = in && gi >= 0 && gi < nx;
  }
  if (in && ghost) fold_point(loc, gj - ny + 1, gi, fold, nx, &gj, &gi);
  if (folded) *folded = in && ghost;
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
