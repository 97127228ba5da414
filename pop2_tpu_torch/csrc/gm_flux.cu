// GM/Redi flux assembly from precomputed fields: GTK for every tracer and
// VDC_GM from the tracer differences tx, ty, tz, the quarter-cell slopes,
// the merged streamfunction, and the isopycnal / horizontal diffusivities
// (source/hmix_gm.F90:1720-2080; gm.flux_assembly in the Python package).
//
// Replaces the TPU kernel gm_pallas.py `_kernel` / `flux_assembly_tiles`
// together with the weight packing (`_packs`) and the VDC_GM block that its
// wrapper left to plain array code.
//
// Bound on this card: bytes. The function must read 3 nt difference fields
// and 20 weight-source fields (8 slopes, 8 streamfunction, 2 + 2
// diffusivities) and write nt + 1 fields, against a few hundred flops per
// column and level; with `cancellation` the skew weights vanish, and tz and
// the streamfunction are not read. The TPU version first packs 17 weight
// planes in device memory so its tiles fit fast memory; here no pack is
// written, and each value is read once a level:
//   - a block is a tile of kFrameCols x rows columns (a warp a row, one
//     thread a column) in a one-column frame (common.cuh `Frame`), walking
//     down k; the model's two tracers have an instance with the count and
//     the rows (kFluxRows) compile-time constants, any other count the
//     narrow tile (kFluxRowsNarrow), whose staged levels of up to
//     kMaxTracers tracers fit a block;
//   - every frame column forms its tracer-independent weights once a level
//     from the unpacked fields, which only its own thread reads (plain
//     loads, no shared stage): a tile column the full `GmWeights` (the next
//     level's, a level ahead), a frame column on the tile's sides only its
//     effective diffusivity and the facing face's skew weights, formed by
//     the first threads besides their own. Each publishes weff, vt, vb in
//     shared memory (two buffers, one barrier a level), and a column's
//     face fluxes read its neighbours' there;
//   - tx (tile and W side), ty (tile and S side) and, for the skew terms,
//     tz (tile and its four sides) of every tracer are staged by `cp.async`
//     two levels ahead into three buffers: the level's fluxes read level k
//     and level k+1;
//   - the vertical-flux carry of each tracer lies in shared memory, so all
//     tracers (up to kMaxTracers) are one launch and the weights are formed
//     once for them;
//   - integer work is what held the first build back (a run-time tracer
//     count and 64-bit offsets made most of an 870-instruction level in
//     float32, and spilled at 32 warps an SM): offsets are int (the C entry
//     checks that they fit), and the model's instance unrolls its loops
//     over the tracers.
// The arithmetic of a level is `gm_flux_level` of gm_flux.cuh, shared with
// the fused chain kernel, driven here by the providers `FrameWeights` and
// `FrameDiffs`. Both `cancellation` branches are instances. Closed edges
// read zero (copies of nothing, zero weights); a cyclic edge wraps inside
// the frame; the ragged last tiles are masked. A tripole north edge (FOLD,
// an instance of its own, so that the closed-edge instances keep their
// code) is the chain kernel's fold (common.cuh `fold_point`): the frame's
// ghost row is copied from the folded columns (tz and the diffusivities are
// centre scalars), the north neighbour's bottom level is the folded
// column's, and the ghost row's south-face skew weights are the folded
// column's north-face ones with the sign flipped (the faces swap under the
// 180-degree fold, `BC.n_partner` of the plain version); no top row is
// patched after the kernel. Anisotropic GM (ANISO, instances of their own)
// reads a second isopycnal diffusivity, the y faces' (kisy; kisop is then
// the x faces'): every column forms the x faces' skew and vertical-flux
// weights from kisop and the y faces' from kisy, and publishes two
// effective diffusivities, one a direction; a side column forms the one of
// the face it turns to the tile, the tripole ghost row its folded column's
// y-face weights. Two fields more to read, one plane more to publish. The
// block shape and the dynamic shared memory come from the wrapper's
// planner (`gm_cuda.launch_plan`).
#include "gm_flux.cuh"

namespace pop2 {

// the model's tracers, T and S: an instance with this count a compile-time
// constant (template NT) on the wide tile; any other count is a run-time
// value (NT = 0) on the narrow tile
constexpr int kFluxTracersFixed = 2;
constexpr int kFluxRows = 8;
constexpr int kFluxRowsNarrow = 2;
__host__ __device__ constexpr int flux_rows(int nt) {
  return nt == kFluxTracersFixed ? kFluxRows : kFluxRowsNarrow;
}
using FluxFrame = Frame<1>;

// what a frame column publishes each level: weff (with ANISO the x faces'
// and then the y faces'), then vt and vb of faces e, w, n, s (the
// effective diffusivities alone under `cancellation`)
template <bool CANCEL, bool ANISO>
struct FluxPub {
  static constexpr int kWeff = 0;
  static constexpr int kWeffY = ANISO ? 1 : 0;
  static constexpr int kVT = ANISO ? 2 : 1;
  static constexpr int kVB = kVT + 4;
  static constexpr int kCount = CANCEL ? kVT : kVB + 4;
};
// staged difference planes of a tracer
enum { dTX = 0, dTY = 1, dTZ = 2 };

// The tile's shared memory, in values: three staged levels of nt tracers'
// difference frame planes, two buffers of the published weights (frame
// planes), the nt vertical-flux carries (tile planes).
template <bool CANCEL, int ROWS, bool ANISO>
struct FluxLayout {
  static constexpr int kW = FluxFrame::kPitch;
  static constexpr int kP = FluxFrame::plane(ROWS);  // a frame plane
  static constexpr int kC = kFrameCols * ROWS;       // a tile plane
  static constexpr int kDiff = CANCEL ? 2 : 3;       // planes a tracer
  static constexpr int kPub = FluxPub<CANCEL, ANISO>::kCount;
  static constexpr int kTracer = kDiff * kP;  // a tracer's staged level
  static constexpr int kSlots = (kP + kC - 1) / kC;  // frame slots a thread
  // frame columns on the tile's sides whose weights a tile thread forms:
  // the W and E columns and the S and N rows, no corners
  static constexpr int kSides = 2 * ROWS + 2 * kFrameCols;
  static constexpr int kSideIters = (kSides + kC - 1) / kC;
  static constexpr __host__ __device__ long values(int nt) {
    return 3L * nt * kTracer + 2L * kPub * kP + (long)nt * kC;
  }
};

template <int ROWS, bool ANISO>
long flux_smem_values_of(int nt, bool cancel) {
  return cancel ? FluxLayout<true, ROWS, ANISO>::values(nt)
                : FluxLayout<false, ROWS, ANISO>::values(nt);
}

inline long flux_smem_values(int nt, bool cancel, bool aniso) {
  if (flux_rows(nt) == kFluxRows)
    return aniso ? flux_smem_values_of<kFluxRows, true>(nt, cancel)
                 : flux_smem_values_of<kFluxRows, false>(nt, cancel);
  return aniso ? flux_smem_values_of<kFluxRowsNarrow, true>(nt, cancel)
               : flux_smem_values_of<kFluxRowsNarrow, false>(nt, cancel);
}

// Blocks an SM that the register budget is set for. The model's two
// tracers: 32 warps in float32 with `cancellation` (the gm_flux path's
// instance), 16 in its skew instance, in float64 and anisotropic. A
// run-time tracer count takes the registers it needs.
template <typename T, bool CANCEL, int NT, bool ANISO>
struct FluxOcc {
  static constexpr int kMinBlocks =
      NT != kFluxTracersFixed ? 1
                              : (sizeof(T) == 4 && CANCEL && !ANISO ? 4 : 2);
};

// Slot offset of stencil column `col` from the centre in a frame plane.
template <int W>
__device__ __forceinline__ int frame_shift(int col) {
  return col == kE ? 1 : col == kW ? -1 : col == kN ? W : col == kS ? -W : 0;
}

// The weights the tile's frame columns published for one level, as
// `gm_flux_level` reads them, from shared memory: pb is the buffer of the
// level, s the centre column's slot.
template <typename T, bool CANCEL, bool ANISO, int P, int W>
struct FrameWeights {
  using Pub = FluxPub<CANCEL, ANISO>;
  const T* pb;
  int s;

  __device__ __forceinline__ T at(int q, int col) const {
    return pb[q * P + s + frame_shift<W>(col)];
  }
  __device__ __forceinline__ T own_weff() const { return at(Pub::kWeff, kC); }
  __device__ __forceinline__ T own_weff_y() const {
    return at(Pub::kWeffY, kC);
  }
  __device__ __forceinline__ T own_vt(int f) const {
    return CANCEL ? T(0) : at(Pub::kVT + f, kC);
  }
  __device__ __forceinline__ T own_vb(int f) const {
    return CANCEL ? T(0) : at(Pub::kVB + f, kC);
  }
  __device__ __forceinline__ T nb_weff(int c) const {
    return at(c == kN || c == kS ? Pub::kWeffY : Pub::kWeff, c);
  }
  __device__ __forceinline__ T nb_vt(int c) const {
    return CANCEL ? T(0) : at(Pub::kVT + facing(c), c);
  }
  __device__ __forceinline__ T nb_vb(int c) const {
    return CANCEL ? T(0) : at(Pub::kVB + facing(c), c);
  }
};

// The tracer differences of the centre column's stencil, as
// `gm_flux_level` reads them, from the staged levels: lk holds level k,
// lkp the level below it (level k again at the bottom); a tracer's planes
// are NS values apart.
template <typename T, int P, int W, int NS>
struct FrameDiffs {
  const T* lk;
  const T* lkp;
  int k, s;

  __device__ __forceinline__ const T* lvl(int n, int L) const {
    return (L == k ? lk : lkp) + n * NS + s;
  }
  __device__ __forceinline__ T tx_c(int n, int L) const {
    return lvl(n, L)[dTX * P];
  }
  __device__ __forceinline__ T tx_w(int n, int L) const {
    return lvl(n, L)[dTX * P - 1];
  }
  __device__ __forceinline__ T ty_c(int n, int L) const {
    return lvl(n, L)[dTY * P];
  }
  __device__ __forceinline__ T ty_s(int n, int L) const {
    return lvl(n, L)[dTY * P - W];
  }
  __device__ __forceinline__ T tz(int n, int L, int col) const {
    return lvl(n, L)[dTZ * P + frame_shift<W>(col)];
  }
};

// The field of a slope-like pair that holds face `face` (`f` the x faces,
// `g` the y faces, each (2 faces, 2 halves, km, ny, nx)), and the offset of
// the face's top-half plane in it (the bottom half is ps further).
template <typename T>
__device__ __forceinline__ const T* quarter(const T* f, const T* g,
                                            int face) {
  return face < fN ? f : g;
}
__device__ __forceinline__ int quarter_off(int face, int ps) {
  return 2 * (face & 1) * ps;
}

template <typename T, bool CANCEL, int NT, bool FOLD, bool ANISO>
__global__ void __launch_bounds__(kFrameCols * flux_rows(NT),
                                  FluxOcc<T, CANCEL, NT, ANISO>::kMinBlocks)
gm_flux_kernel(int nt, int km, int ny, int nx, int cyclic, int fold,
               const T* __restrict__ tx, const T* __restrict__ ty,
               const T* __restrict__ tz, const T* __restrict__ slx,
               const T* __restrict__ sly, const T* __restrict__ sfx,
               const T* __restrict__ sfy, const T* __restrict__ kisop,
               const T* __restrict__ kisy, const T* __restrict__ hd,
               const int* __restrict__ kmt,
               const T* __restrict__ hyx, const T* __restrict__ hxy,
               const T* __restrict__ tarea_r, const T* __restrict__ lev,
               T* __restrict__ gtk, T* __restrict__ vdc) {
  constexpr int ROWS = flux_rows(NT);
  using Lay = FluxLayout<CANCEL, ROWS, ANISO>;
  using Pub = FluxPub<CANCEL, ANISO>;
  constexpr int W = Lay::kW, P = Lay::kP, C = Lay::kC;
  if (NT > 0) nt = NT;
  extern __shared__ __align__(16) unsigned char pop2_smem[];
  T* stg = reinterpret_cast<T*>(pop2_smem);  // (3, nt, Lay::kTracer)
  T* pub = stg + 3 * nt * Lay::kTracer;      // (2, Lay::kPub, P)
  T* fzt = pub + 2 * Lay::kPub * P;          // (nt, C)
  const int tid = threadIdx.y * kFrameCols + threadIdx.x;
  // level and plane strides: the C entry keeps every offset of a field
  // below 2^31
  const int ls = ny * nx, ps = km * ls;
  const int stage_size = nt * Lay::kTracer;

  const int x0 = blockIdx.x * kFrameCols, y0 = blockIdx.y * ROWS;
  const int s = (threadIdx.y + 1) * W + threadIdx.x + 1;  // own slot
  const int gi = x0 + threadIdx.x, gj = y0 + threadIdx.y;
  const bool live = gi < nx && gj < ny;  // the column writes output
  const int oc = live ? gj * nx + gi : 0;

  // The column of the own slot, whose weights this thread forms: the
  // live column, or past a cyclic edge the column it wraps to, or past a
  // tripole edge the folded column (a live neighbour reads its weights), or
  // none.
  int own_off = 0;
  bool own_in, own_fold = false;
  {
    int r, c;
    own_in = frame_slot<1>(s, y0, x0, ny, nx, cyclic, &r, &c, &own_off,
                           FOLD ? fold : 0, kFoldCenter, &own_fold);
  }
  // The frame slots this thread copies; bit 0: inside the domain, bit 1:
  // tx (tile, W side), bit 2: ty (tile, S side), bit 3: tz (tile, N, S, E,
  // W sides).
  int soff[Lay::kSlots];
  unsigned sflag[Lay::kSlots];
#pragma unroll
  for (int j = 0; j < Lay::kSlots; ++j) {
    const int q = tid + j * C;
    int r = 0, c = 0, off = 0;
    const bool in = q < P && frame_slot<1>(q, y0, x0, ny, nx, cyclic, &r,
                                           &c, &off, FOLD ? fold : 0);
    const bool row_in = r >= 1 && r <= ROWS;
    const bool col_in = c >= 1 && c <= kFrameCols;
    const bool fx = row_in && c <= kFrameCols;
    const bool fy = col_in && r <= ROWS;
    const bool fz = !CANCEL && ((row_in && c <= kFrameCols + 1) ||
                                (col_in && r <= ROWS + 1));
    soff[j] = off;
    sflag[j] = q < P ? (unsigned)in | (unsigned)fx << 1 |
                           (unsigned)fy << 2 | (unsigned)fz << 3
                     : 0u;
  }
  // The frame columns on the tile's sides whose weights this thread forms
  // besides its own (the first threads): slot, column offset, whether it
  // lies inside the domain (and on the tripole ghost row), and the face it
  // turns to the tile.
  int hq[Lay::kSideIters], hoff[Lay::kSideIters], hface[Lay::kSideIters];
  bool hin[Lay::kSideIters], hfold[Lay::kSideIters];
#pragma unroll
  for (int j = 0; j < Lay::kSideIters; ++j) {
    const int h = tid + j * C;
    int q = -1, face = fE;
    if (h < ROWS) {  // W column: its east face
      q = (h + 1) * W;
      face = fE;
    } else if (h < 2 * ROWS) {  // E column: its west face
      q = (h - ROWS + 1) * W + W - 1;
      face = fW;
    } else if (h < 2 * ROWS + kFrameCols) {  // S row: its north face
      q = h - 2 * ROWS + 1;
      face = fN;
    } else if (h < Lay::kSides) {  // N row: its south face
      q = (ROWS + 1) * W + h - 2 * ROWS - kFrameCols + 1;
      face = fS;
    }
    int r, c, off = 0;
    bool folded = false;
    hin[j] = q >= 0 && frame_slot<1>(q, y0, x0, ny, nx, cyclic, &r, &c,
                                     &off, FOLD ? fold : 0, kFoldCenter,
                                     &folded);
    hfold[j] = folded;
    hq[j] = q;
    hoff[j] = off;
    hface[j] = face;
  }

  // start the copies of level L into buffer b: a group a level, empty past
  // the bottom
  auto stage = [&](int L, int b) {
    if (L < km) {
      T* st = stg + b * stage_size;
      const int lo = L * ls;
      for (int n = 0; n < nt; ++n) {
        const int to = n * ps + lo;
        T* sn = st + n * Lay::kTracer;
#pragma unroll
        for (int j = 0; j < Lay::kSlots; ++j) {
          const int q = tid + j * C;
          const bool in = sflag[j] & 1u;
          const int o = to + soff[j];
          if (sflag[j] & 2u) cp_async(sn + dTX * P + q, tx + o, in);
          if (sflag[j] & 4u) cp_async(sn + dTY * P + q, ty + o, in);
          if (!CANCEL && (sflag[j] & 8u))
            cp_async(sn + dTZ * P + q, tz + o, in);
        }
      }
    }
    cp_async_commit();
  };

  // the column's 2-D operands (zero where it writes no output)
  GmMetrics<T> m = {};
  if (live) {
    Column c;
    locate_at(ny, nx, cyclic, gj, gi, &c, FOLD ? fold : 0);
    m = load_metrics(make_stencil(c, nx), kmt, hyx, hxy, tarea_r);
  }

  // the own slot's weights at level L, published into its buffer
  auto own_weights = [&](int L, GmWeights<T>* w) {
    const int o = L * ls + own_off;
    T sl_t[4], sl_b[4], sf_t[4], sf_b[4];
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int q = quarter_off(f, ps) + o;
      const T* sl = quarter(slx, sly, f);
      sl_t[f] = own_in ? sl[q] : T(0);
      sl_b[f] = own_in ? sl[q + ps] : T(0);
      if (CANCEL) {
        sf_t[f] = sf_b[f] = T(0);
      } else {
        const T* sf = quarter(sfx, sfy, f);
        sf_t[f] = own_in ? sf[q] : T(0);
        sf_b[f] = own_in ? sf[q + ps] : T(0);
      }
    }
    const T kis_t = own_in ? kisop[o] : T(0);
    const T kis_b = own_in ? kisop[ps + o] : T(0);
    const T hd_t = own_in ? hd[o] : T(0);
    const T hd_b = own_in ? hd[ps + o] : T(0);
    T* pb = pub + (L & 1) * Lay::kPub * P + s;
    if (ANISO) {
      const T ky_t = own_in ? kisy[o] : T(0);
      const T ky_b = own_in ? kisy[ps + o] : T(0);
      T weff_y;
      gm_make_weights_aniso<T, CANCEL>(lev[L], kis_t, kis_b, ky_t, ky_b,
                                       hd_t, hd_b, sl_t, sl_b, sf_t, sf_b, m,
                                       w, &weff_y);
      pb[Pub::kWeffY * P] = weff_y;
    } else {
      gm_make_weights<T, CANCEL>(lev[L], kis_t, kis_b, hd_t, hd_b, sl_t,
                                 sl_b, sf_t, sf_b, m, w);
    }
    pb[Pub::kWeff * P] = w->weff;
    if (!CANCEL) {
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        pb[(Pub::kVT + f) * P] = w->vt[f];
        pb[(Pub::kVB + f) * P] = w->vb[f];
      }
      // on the tripole ghost row the south face is the folded column's
      // north face, sign flipped
      if (FOLD && own_fold) {
        pb[(Pub::kVT + fS) * P] = -w->vt[fN];
        pb[(Pub::kVB + fS) * P] = -w->vb[fN];
      }
    }
  };

  // the side columns' weff and facing skew weights at level L, published
  // (zeros outside the domain)
  auto side_weights = [&](int L) {
    T* pb = pub + (L & 1) * Lay::kPub * P;
#pragma unroll
    for (int j = 0; j < Lay::kSideIters; ++j) {
      if (hq[j] < 0) continue;
      const bool in = hin[j];
      const int o = L * ls + hoff[j];
      const int f = hface[j];
      // the diffusivity of the face turned to the tile: with ANISO the y
      // faces' for the S and N rows
      const bool yface = ANISO && f >= fN;
      const T* kis = yface ? kisy : kisop;
      const T kis_t = in ? kis[o] : T(0);
      const T kis_b = in ? kis[ps + o] : T(0);
      const T hd_t = in ? hd[o] : T(0);
      const T hd_b = in ? hd[ps + o] : T(0);
      if (ANISO)
        pb[(yface ? Pub::kWeffY : Pub::kWeff) * P + hq[j]] =
            (kis_t + hd_t) + (kis_b + hd_b);
      else
        pb[Pub::kWeff * P + hq[j]] = kis_t + kis_b + hd_t + hd_b;
      if (!CANCEL) {
        // the face turned to the tile; on the tripole ghost row the folded
        // column's north face, read and sign flipped for its south face
        const bool flip = FOLD && hfold[j];
        const int fr = flip ? fN : f;
        const int q = quarter_off(fr, ps) + o;
        const T* sl = quarter(slx, sly, fr);
        const T* sf = quarter(sfx, sfy, fr);
        const T dzk = lev[L];
        const T sl_t = in ? sl[q] : T(0), sl_b = in ? sl[q + ps] : T(0);
        const T sf_t = in ? sf[q] : T(0), sf_b = in ? sf[q + ps] : T(0);
        const T vt = kis_t * sl_t * dzk - sf_t;
        const T vb = kis_b * sl_b * dzk - sf_b;
        pb[(Pub::kVT + f) * P + hq[j]] = flip ? -vt : vt;
        pb[(Pub::kVB + f) * P + hq[j]] = flip ? -vb : vb;
      }
    }
  };

  for (int n = 0; n < nt; ++n) fzt[n * C + tid] = T(0);

  // ---- down the column -----------------------------------------------------
  // level L in buffer L % 3, kept as three rotating indices
  int b0 = 0, b1 = 1, b2 = 2;
  stage(0, b0);
  stage(1, b1);
  GmWeights<T> cur, nxt;
  own_weights(0, &cur);
  side_weights(0);
  for (int k = 0; k < km; ++k) {
    // level k+1 has landed everywhere; level k's weights are published;
    // every thread is done with level k-1's buffers
    cp_async_wait<0>();
    __syncthreads();
    stage(k + 2, b2);
    if (k + 1 < km) {
      own_weights(k + 1, &nxt);
      side_weights(k + 1);
    }
    if (live) {
      const GmLevel<T> g = gm_level(m, km, k, lev);
      const T* lk = stg + b0 * stage_size;
      const FrameDiffs<T, P, W, Lay::kTracer> dp{
          lk, g.kp == k ? lk : stg + b1 * stage_size, k, s};
      const FrameWeights<T, CANCEL, ANISO, P, W> fw{
          pub + (k & 1) * Lay::kPub * P, s};
      gm_flux_level<T, CANCEL, NT>(dp, m, nt, g, cur, nxt, fw, fzt + tid, C, ls,
                               ps, oc, gtk, vdc);
    }
    cur = nxt;
    const int b = b0;
    b0 = b1;
    b1 = b2;
    b2 = b;
  }
}

template <typename T, bool CANCEL, int NT, bool FOLD, bool ANISO>
struct FluxInstance {
  static cudaError_t prepare(long smem) {
    return allow_large_smem(gm_flux_kernel<T, CANCEL, NT, FOLD, ANISO>,
                            smem);
  }
  static int occupancy(long smem) {
    const cudaError_t e = prepare(smem);
    if (e != cudaSuccess) return -(int)e;
    return blocks_per_sm(gm_flux_kernel<T, CANCEL, NT, FOLD, ANISO>,
                         kFrameCols * flux_rows(NT), smem);
  }
};

// The launch configuration the wrapper chose: `rows` rows of kFrameCols
// columns, `smem` bytes of dynamic shared memory.
template <typename T>
bool flux_config_ok(int nt, int km, int ny, int nx, bool cancel, bool aniso,
                    int rows, long smem) {
  // offsets in int: the four quarter planes of a slope field, the nt of a
  // difference field
  return nt >= 1 && nt <= kMaxTracers && km >= 1 &&
         (long)(nt > 4 ? nt : 4) * km * ny * nx < (1L << 31) &&
         rows == flux_rows(nt) &&
         smem >= flux_smem_values(nt, cancel, aniso) * (long)sizeof(T);
}

}  // namespace pop2

#define POP2_GM_FLUX_BRANCHES(T, FOLD, ANISO, ACTION)                        \
  if (nt == kFluxTracersFixed && cancellation)                               \
    ACTION(T, true, kFluxTracersFixed, FOLD, ANISO)                          \
  else if (nt == kFluxTracersFixed)                                          \
    ACTION(T, false, kFluxTracersFixed, FOLD, ANISO)                         \
  else if (cancellation)                                                     \
    ACTION(T, true, 0, FOLD, ANISO)                                          \
  else                                                                       \
    ACTION(T, false, 0, FOLD, ANISO)
#define POP2_GM_FLUX_INSTANCES(T, ACTION)                                    \
  if (fold && aniso) {                                                       \
    POP2_GM_FLUX_BRANCHES(T, true, true, ACTION)                             \
  } else if (fold) {                                                         \
    POP2_GM_FLUX_BRANCHES(T, true, false, ACTION)                            \
  } else if (aniso) {                                                        \
    POP2_GM_FLUX_BRANCHES(T, false, true, ACTION)                            \
  } else {                                                                   \
    POP2_GM_FLUX_BRANCHES(T, false, false, ACTION)                           \
  }

extern "C" int pop2_gm_flux_max_tracers() { return pop2::kMaxTracers; }

// Values of dynamic shared memory the tile takes for nt tracers in a branch,
// isotropic or anisotropic (the planner's count, gm_cuda.smem_values).
extern "C" int pop2_gm_flux_smem_values(int nt, int cancellation,
                                        int aniso) {
  return (int)pop2::flux_smem_values(nt, cancellation != 0, aniso != 0);
}

// The rows of the tile for nt tracers (the planner's gm_cuda.tile_rows).
extern "C" int pop2_gm_flux_tile_rows(int nt) { return pop2::flux_rows(nt); }

// dtype: 0 = float32, 1 = float64; fold: the north edge is a tripole fold
// (nonzero: the rows through its top row, common.cuh); aniso: anisotropic diffusivities, kisop the x faces', kisy the y faces'
// (not read otherwise); rows: rows of the tile; smem: dynamic shared memory
// a block, bytes.
// Returns cudaGetLastError() of the launch, or cudaErrorInvalidValue for a
// configuration the kernel does not take.
extern "C" int pop2_gm_flux(int dtype, int nt, int km, int ny, int nx,
                            int cyclic, int fold, int cancellation, int aniso,
                            int rows, long smem, const void* tx,
                            const void* ty, const void* tz, const void* slx,
                            const void* sly, const void* sfx,
                            const void* sfy, const void* kisop,
                            const void* kisy, const void* hd, const int* kmt,
                            const void* hyx, const void* hxy,
                            const void* tarea_r, const void* lev, void* gtk,
                            void* vdc, void* stream) {
  using namespace pop2;
  const bool cancel = cancellation != 0;
  if (!(dtype == 0 ? flux_config_ok<float>(nt, km, ny, nx, cancel,
                                           aniso != 0, rows, smem)
                   : flux_config_ok<double>(nt, km, ny, nx, cancel,
                                            aniso != 0, rows, smem)) ||
      (aniso && kisy == nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((nx + kFrameCols - 1) / kFrameCols),
                  (unsigned)((ny + rows - 1) / rows));
  const dim3 block(kFrameCols, rows);
  cudaStream_t s = (cudaStream_t)stream;
#define POP2_GM_FLUX(T, CANCEL, NT, FOLD, ANISO)                             \
  {                                                                          \
    const cudaError_t e =                                                    \
        FluxInstance<T, CANCEL, NT, FOLD, ANISO>::prepare(smem);             \
    if (e != cudaSuccess) return (int)e;                                     \
    gm_flux_kernel<T, CANCEL, NT, FOLD, ANISO><<<grid, block, smem, s>>>(    \
        nt, km, ny, nx, cyclic, fold, (const T*)tx, (const T*)ty,            \
        (const T*)tz,                                                        \
        (const T*)slx, (const T*)sly, (const T*)sfx, (const T*)sfy,          \
        (const T*)kisop, (const T*)kisy, (const T*)hd, kmt, (const T*)hyx,   \
        (const T*)hxy, (const T*)tarea_r, (const T*)lev, (T*)gtk, (T*)vdc);  \
  }
  if (dtype == 0) {
    POP2_GM_FLUX_INSTANCES(float, POP2_GM_FLUX)
  } else {
    POP2_GM_FLUX_INSTANCES(double, POP2_GM_FLUX)
  }
#undef POP2_GM_FLUX
  return (int)cudaGetLastError();
}

// Blocks of a launch of this configuration (nt tracers, a branch, the north
// edge, isotropic or not, `smem` bytes a block) that one SM holds at once.
extern "C" int pop2_gm_flux_blocks_per_sm(int dtype, int nt, int cancellation,
                                          int fold, int aniso, long smem) {
  using namespace pop2;
#define POP2_GM_FLUX_OCC(T, CANCEL, NT, FOLD, ANISO)                         \
  return FluxInstance<T, CANCEL, NT, FOLD, ANISO>::occupancy(smem);
  if (dtype == 0) {
    POP2_GM_FLUX_INSTANCES(float, POP2_GM_FLUX_OCC)
  } else {
    POP2_GM_FLUX_INSTANCES(double, POP2_GM_FLUX_OCC)
  }
#undef POP2_GM_FLUX_OCC
  return -(int)cudaErrorInvalidValue;  // not reached: every case returns
}
#undef POP2_GM_FLUX_INSTANCES
#undef POP2_GM_FLUX_BRANCHES
