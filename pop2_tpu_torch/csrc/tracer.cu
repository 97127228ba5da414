// Fused tracer tendency of one baroclinic step:
//   ft = ah * Del2(tmix) - L_adv(trcr; u, v, dh) + D_v(told; vdc, stf)
// i.e. comp_flux_vel + advt_centered or advt_upwind3 (source/advection.F90
// :1970, :2139, :2313), hdifft_del2 (source/hmix_del2.F90:1034) and vdifft
// (source/vertical_mix.F90:691) in one pass.
//
// Replaces the TPU kernel tracer_pallas.py `_kernel` /
// `tracer_tendency_tiles` in all its modes: centered or upwind3 (QUICKEST)
// advection, a closed or tripole north edge, a cyclic or closed east-west
// edge, with the Laplacian mixing fused (DEL2, the dynamical-core path) and
// without it (advection + vertical diffusion only, the mode the GM paths
// run: the horizontal mixing is then the GM kernels' and tmix is not read).
//
// Bound on this card: bytes. Minimum traffic is u, v, vdc (2 classes) and
// trcr, told, out per tracer (the model passes told or trcr again as tmix):
// (4 + 3 nt) distinct 3-D fields plus a dozen 2-D ones, against some 60
// flops per output value (upwind3 some 120, and its 12 coefficient planes);
// without DEL2 (4 + 2 nt) fields. Both kernels below keep the bytes in
// flight and read each value once a level:
//   - a block is a tile of kFrameCols x kRows columns (32 x 8, a warp a
//     row, one thread a column) in a frame of HALO columns (common.cuh
//     `Frame`), walking down k; the tile's shape is a compile-time
//     constant, so a shared-memory address is a register and an immediate
//     (with a run-time row count every address was multiplied out);
//   - each level is staged in shared memory by `cp.async` two levels ahead;
//   - every column forms the fluxes through its east and north faces once a
//     level, one level ahead, and publishes them (two buffers, one barrier
//     a level); a column takes those of its west and south faces from its
//     west and south neighbours. The frame's W column and S row are formed
//     by the first warps' threads besides their own;
//   - down k, per tracer, in registers: the advection flux through the
//     level's top (the level above's bottom flux) and the vertical
//     diffusive flux through it (the level above's vtfb), besides the
//     continuity sum for w. A frame value is read again only by the
//     neighbouring tile, from L2.
// The tracer count of a launch is a template parameter up to kMaxGroup, so
// the carries stay in registers; the wrapper launches groups above it.
// Closed edges read zero (copies of nothing, zero metrics); a cyclic edge
// wraps inside the frame; on a tripole grid the frame's rows past ny - 1
// are copied from the folded columns (`frame_slot`: trcr, tmix and KMT, the
// only fields read past the north edge, are centre fields, so no sign
// flips); the ragged last tiles are masked. The block shape and the dynamic
// shared memory come from the wrapper's planner (`tracer_cuda.launch_plan`).
//
// Centered advection (`tracer_kernel`) reaches one column out: a frame of
// HALO 1, three staged buffers of u, v, trcr and tmix on the frame and told
// and the diffusivities on the tile; the face velocities ute, vtn are what
// a column publishes. Upwind3 (`tracer_upw_kernel`) reaches two columns and
// two rows out and its vertical term reads levels k+1 and k+2: a frame of
// HALO 2 for trcr, and besides ute, vtn each column publishes its east and
// north QUICKEST face values of each tracer, formed once. The 12 coefficient
// planes of the tile and of its W column's and S row's faces are staged
// once a tile. The trcr frame is read only by the face values, one level
// ahead; what a level reads at its own column (told below it, the
// diffusivities, trcr two levels down, tmix) is staged one level ahead
// beside it, while trcr at k-1, k, k+1 and told at k are carried in
// registers; so every ring has two buffers, the k loop takes two levels a
// turn with the buffers fixed, and every shared-memory address is a
// register and an immediate. On this card the upwind3 tile is bound by the
// instructions it issues a level (`kernel_sass.py`; a third of them loads
// from shared memory), not by its bytes (PERF.md).
//
// Partial bottom cells (the PBC instances of both kernels): a column's
// thickness is dz but at its bottom level, where it is the plane DZBT at T
// points (k = KMT - 1) and DZBU at U points (k = KMU - 1). The flux
// velocities u DYU dzu, v DXU dzu take each U point's own thickness, so the
// U points' KMU and DZBU are staged once a tile beside DYU and DXU; a
// column reads its DZBT once and forms, once, what its bottom level takes
// in place of the level table's row: 1/DZBT and 1/(2 DZBT) (dzr, dz2r) and
// the spacing 1/((dz + DZBT)/2) of the level above it (the interface
// spacing 1/((dzt_k + dzt_k+1)/2) that the JAX package's jnp chain forms at
// every level is the table's dzwr2, the same expression of dz, at every
// other level). The Laplacian and upwind3's vertical coefficients stay on
// dz, as in the JAX package. The full-cell instances' arithmetic is
// untouched by the mode, bitwise.
#include <type_traits>

#include "common.cuh"

namespace pop2 {

constexpr int kMaxGroup = 2;  // tracers a launch (template NT)
// the frame's width of centered advection: it and the Laplacian reach one
// column (upwind3's frame, kUpwHalo, below)
constexpr int kHalo = 1;
// the tile's rows, a compile-time constant, so that every shared-memory
// address is a register plus an immediate offset
constexpr int kRows = 8;
constexpr int kThreadsTile = kFrameCols * kRows;
using TracerFrame = Frame<kHalo>;
static_assert(TracerFrame::covered(kRows), "a frame slot without a copier");

// Blocks an SM that the register budget is set for: 32 warps in float32.
template <typename T>
struct TracerOcc {
  static constexpr int kMinBlocks = sizeof(T) == 4 ? 4 : 2;
};

// The tile's shared memory, in values: the DYU and DXU frame planes; three
// staged levels, each of u, v, NT trcr (and NT tmix) frame planes and NT
// told and NT diffusivity tile planes; two buffers of the published ute
// and vtn.
// PBC: two more metric planes, the U points' KMU (as values) and DZBU.
template <int NT, bool DEL2, bool PBC = false>
struct TracerLayout {
  static constexpr int kP = TracerFrame::plane(kRows);  // a frame plane
  static constexpr int kC = kThreadsTile;               // a tile plane
  static constexpr int kMet = PBC ? 4 : 2;              // metric planes
  static constexpr int kRing = 2 + NT * (DEL2 ? 2 : 1);  // frame planes
  static constexpr int kStage = kRing * kP + 2 * NT * kC;
  static constexpr int kValues = kMet * kP + 3 * kStage + 2 * 2 * kP;
};

template <bool PBC>
inline int tracer_smem_values_of(int ng, bool del2) {
  if (ng == 1)
    return del2 ? TracerLayout<1, true, PBC>::kValues
                : TracerLayout<1, false, PBC>::kValues;
  return del2 ? TracerLayout<2, true, PBC>::kValues
              : TracerLayout<2, false, PBC>::kValues;
}

// Centered advection; FOLD: the north edge is a tripole fold (`fold` the
// rows through its top row, common.cuh); PBC: partial bottom cells (kmu,
// dzbt, dzbu read, else not).
template <typename T, int NT, bool DEL2, bool FOLD, bool PBC>
__global__ void __launch_bounds__(kThreadsTile, TracerOcc<T>::kMinBlocks)
tracer_kernel(int n0, int km, int ny, int nx, int cyclic, int fold,
              int varthick,
              const T* __restrict__ u, const T* __restrict__ v,
              const T* __restrict__ trcr, const T* __restrict__ tmix,
              const T* __restrict__ told, const T* __restrict__ vdc,
              const T* __restrict__ stf, const T* __restrict__ dh,
              const int* __restrict__ kmt, const T* __restrict__ dyu,
              const T* __restrict__ dxu, const T* __restrict__ tarea_r,
              const T* __restrict__ dtn, const T* __restrict__ dts,
              const T* __restrict__ dte, const T* __restrict__ dtw,
              const T* __restrict__ dz, const T* __restrict__ dzr,
              const T* __restrict__ dz2r, const T* __restrict__ dzwr2, T ah,
              T* __restrict__ out, const int* __restrict__ kmu,
              const T* __restrict__ dzbt, const T* __restrict__ dzbu) {
  using Lay = TracerLayout<NT, DEL2, PBC>;
  constexpr int W = TracerFrame::kPitch, P = Lay::kP, C = Lay::kC;
  extern __shared__ __align__(16) unsigned char pop2_smem[];
  const int tid = threadIdx.y * kFrameCols + threadIdx.x;
  const int ls = ny * nx;       // level stride (the C entry keeps
  const long ts = (long)km * ls;  // km * ny * nx below 2^31)
  // DYU, DXU and with PBC the U points' KMU and DZBU: (Lay::kMet, P)
  T* met = reinterpret_cast<T*>(pop2_smem);
  T* stg = met + Lay::kMet * P;              // (3 buffers, Lay::kStage)
  T* pub = stg + 3 * Lay::kStage;            // (2 buffers, ute / vtn, P)
  // plane p of the staged level in buffer b: u, v, trcr[NT], tmix[NT]
  // (frame planes, slot index), then told[NT], vdc[NT] (tile planes, tid)
  auto ring = [&](int b, int p) { return stg + b * Lay::kStage + p * P; };
  auto tile = [&](int b, int p) {
    return stg + b * Lay::kStage + Lay::kRing * P + p * C;
  };

  const int x0 = blockIdx.x * kFrameCols, y0 = blockIdx.y * kRows;
  const int s = (threadIdx.y + kHalo) * W + threadIdx.x + kHalo;  // own slot
  const int gi = x0 + threadIdx.x, gj = y0 + threadIdx.y;
  const bool live = gi < nx && gj < ny;  // the column writes output
  const int oc = live ? gj * nx + gi : 0;

  // the frame slots this thread copies; bit 0: inside the domain, bit 1:
  // u and v (tile, S row, W column), bit 2: trcr and tmix (tile, N, S, E,
  // W sides, no corners)
  int soff[kFrameSlots];
  unsigned sflag[kFrameSlots];
#pragma unroll
  for (int j = 0; j < kFrameSlots; ++j) {
    const int q = tid + j * kThreadsTile;
    int r = 0, c = 0, off = 0;
    const bool in = q < P && frame_slot<kHalo>(q, y0, x0, ny, nx, cyclic,
                                               &r, &c, &off,
                                               FOLD ? fold : 0);
    const bool row_in = r >= kHalo && r < kRows + kHalo;
    const bool col_in = c >= kHalo && c < kFrameCols + kHalo;
    const bool uv = r >= kHalo - 1 && r < kRows + kHalo && c >= kHalo - 1 &&
                    c < kFrameCols + kHalo;
    const bool tr = (row_in && c >= kHalo - 1 && c <= kFrameCols + kHalo) ||
                    (col_in && r >= kHalo - 1 && r <= kRows + kHalo);
    soff[j] = off;
    sflag[j] = q < P ? (unsigned)in | (unsigned)uv << 1 | (unsigned)tr << 2
                     : 0u;
    if (q < P && uv) {  // the face metrics, zero outside the domain
      met[q] = in ? dyu[off] : T(0);
      met[P + q] = in ? dxu[off] : T(0);
      if (PBC) {
        met[2 * P + q] = in ? T(kmu[off]) : T(0);
        met[3 * P + q] = in ? dzbu[off] : T(0);
      }
    }
  }
  // the frame's S row (vtn) and W column (ute): one extra slot each for the
  // first kFrameCols + kRows threads
  const bool h_south = tid < kFrameCols;
  const int hq = h_south ? (kHalo - 1) * W + tid + kHalo
                         : (tid < kFrameCols + kRows
                                ? (tid - kFrameCols + kHalo) * W + kHalo - 1
                                : -1);
  // the group's fields, tracer by tracer (tracer 0 uses diffusivity class
  // 0, all others class 1)
  const T* trn[NT];
  const T* tmn[NT];
  const T* ton[NT];
  const T* vdn[NT];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    trn[n] = trcr + (n0 + n) * ts;
    tmn[n] = tmix + (n0 + n) * ts;
    ton[n] = told + (n0 + n) * ts;
    vdn[n] = vdc + (n0 + n < 1 ? 0 : ts);
  }

  // start the copies of level L into buffer b: a group a level, empty past
  // the bottom
  auto stage = [&](int L, int b) {
    if (L < km) {
      const int lo = L * ls;
#pragma unroll
      for (int j = 0; j < kFrameSlots; ++j) {
        const int q = tid + j * kThreadsTile;
        const bool in = sflag[j] & 1u;
        const int o = lo + soff[j];
        if (sflag[j] & 2u) {
          cp_async(ring(b, 0) + q, u + o, in);
          cp_async(ring(b, 1) + q, v + o, in);
        }
        if (sflag[j] & 4u) {
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            cp_async(ring(b, 2 + n) + q, trn[n] + o, in);
            if (DEL2) cp_async(ring(b, 2 + NT + n) + q, tmn[n] + o, in);
          }
        }
      }
      if (live) {
        const int o = lo + oc;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          cp_async(tile(b, n) + tid, ton[n] + o, true);
          cp_async(tile(b, NT + n) + tid, vdn[n] + o, true);
        }
      }
    }
    cp_async_commit();
  };

  const T half = T(0.5);
  // publish the face velocities of level L from buffer b (comp_flux_vel):
  // ute of the thread's own slot and of its W-column slot, vtn of its own
  // and its S-row slot
  auto faces = [&](int L, int b) {
    const T* su = ring(b, 0);
    const T* sv = ring(b, 1);
    T* pu = pub + (L & 1) * 2 * P;
    T* pv = pu + P;
    const T dzl = dz[L];
    // the thickness of U point q at level L
    auto dzu = [&](int q) {
      return (PBC && met[2 * P + q] == T(L + 1)) ? met[3 * P + q] : dzl;
    };
    pu[s] = half * (su[s] * met[s] * dzu(s) +
                    su[s - W] * met[s - W] * dzu(s - W));
    pv[s] = half * (sv[s] * met[P + s] * dzu(s) +
                    sv[s - 1] * met[P + s - 1] * dzu(s - 1));
    if (h_south)
      pv[hq] = half * (sv[hq] * met[P + hq] * dzu(hq) +
                       sv[hq - 1] * met[P + hq - 1] * dzu(hq - 1));
    else if (hq >= 0)
      pu[hq] = half * (su[hq] * met[hq] * dzu(hq) +
                       su[hq - W] * met[hq - W] * dzu(hq - W));
  };

  // 2-D operands of the column
  int kmt_c = 0, kmt_n = 0, kmt_s = 0, kmt_e = 0, kmt_w = 0;
  T tarea = T(0), dtn_c = T(0), dts_c = T(0), dte_c = T(0), dtw_c = T(0);
  T wtk = T(0);  // w at the top of the level
  // PBC: the bottom level's 1/dz, 1/(2 dz) and the spacing above it
  T dzbr = T(1), dzb2r = T(1), dzwr_b = T(1);
  if (live) {
    Column c;
    locate_at(ny, nx, cyclic, gj, gi, &c, FOLD ? fold : 0);
    kmt_c = kmt[oc];
    if (PBC) {
      const T dzb = dzbt[oc];
      dzbr = T(1) / dzb;
      dzb2r = T(0.5) / dzb;
      if (kmt_c >= 2) dzwr_b = T(1) / (T(0.5) * (dz[kmt_c - 2] + dzb));
    }
    kmt_n = c.vn ? kmt[c.jn * nx + c.in] : 0;
    kmt_s = c.vs ? kmt[c.js * nx + c.i] : 0;
    kmt_e = c.ve ? kmt[c.j * nx + c.ie] : 0;
    kmt_w = c.vw ? kmt[c.j * nx + c.iw] : 0;
    tarea = tarea_r[oc];
    if (DEL2) {
      dtn_c = dtn[oc];
      dts_c = dts[oc];
      dte_c = dte[oc];
      dtw_c = dtw[oc];
    }
    wtk = dh[oc];
  }
  T wsum = wtk;  // dh + running sum of the horizontal divergence

  // ---- down the column -----------------------------------------------------
  // level L in buffer L % 3, kept as three rotating indices
  int b0 = 0, b1 = 1, b2 = 2;
  stage(0, b0);
  stage(1, b1);
  cp_async_wait<1>();  // level 0 has landed (the thread's own copies)
  __syncthreads();     // ... and everyone's, with the metric planes
  faces(0, b0);
  // per tracer: the advection and vertical diffusive fluxes through the
  // level's top
  T top_k[NT], vtf_k[NT];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    top_k[n] = T(0);
    vtf_k[n] = T(0);
  }
  for (int k = 0; k < km; ++k) {
    // level k+1 has landed everywhere; level k's face velocities are
    // published; every thread is done with level k-1's buffers
    cp_async_wait<0>();
    __syncthreads();
    stage(k + 2, b2);
    if (k + 1 < km) faces(k + 1, b1);
    if (live) {
      const int kk = k + 1;  // 1-based level
      const bool last = k == km - 1;
      const bool bot_k = PBC && kk == kmt_c;  // the partial bottom level
      const T dzrk = bot_k ? dzbr : dzr[k];
      const T dz2rk = bot_k ? dzb2r : dz2r[k];
      const T* pu = pub + (k & 1) * 2 * P;
      const T* pv = pu + P;
      const T ute = pu[s], utw = pu[s - 1];
      const T vtn = pv[s], vts = pv[s - W];

      const T cc = vtn - vts + ute - utw;
      wsum = wsum + cc * tarea;
      const bool below = kmt_c > kk;  // the level below is ocean
      const T wtkb = below ? wsum : T(0);

      // masked Laplacian coefficients: a face is open only if the
      // neighbour is ocean at this level
      const bool mask = kmt_c >= kk;
      const T cn = (mask && kmt_n >= kk) ? dtn_c : T(0);
      const T cs = (mask && kmt_s >= kk) ? dts_c : T(0);
      const T ce = (mask && kmt_e >= kk) ? dte_c : T(0);
      const T cw = (mask && kmt_w >= kk) ? dtw_c : T(0);
      const T ccd = -(cn + cs + ce + cw);
      // the spacing below the level: the bottom level's thickness enters
      // the one above it
      const T dzwr_k = (PBC && kk + 1 == kmt_c) ? dzwr_b : dzwr2[k];

#pragma unroll
      for (int n = 0; n < NT; ++n) {
        // centered advection (advt_centered)
        const T* tk = ring(b0, 2 + n);
        const T tc = tk[s];
        const T t_n = tk[s + W], t_s = tk[s - W];
        const T t_e = tk[s + 1], t_w = tk[s - 1];
        T ltk = half * (cc * tc + vtn * t_n - vts * t_s + ute * t_e
                        - utw * t_w) * tarea * dzrk;
        const T top =
            k == 0 ? (varthick ? T(0) : T(2) * wtk * tc) : top_k[n];
        const T tc_b = last ? T(0) : ring(b1, 2 + n)[s];
        const T bot = last ? T(0) : wtkb * (tc + tc_b);
        ltk = ltk + dz2rk * (top - bot);

        // Laplacian diffusion of the mixing-time tracer (hdifft_del2)
        T hdtk = T(0);
        if (DEL2) {
          const T* tmk = ring(b0, 2 + NT + n);
          hdtk = ah * (ccd * tmk[s] + cn * tmk[s + W] + cs * tmk[s - W]
                       + ce * tmk[s + 1] + cw * tmk[s - 1]);
        }

        // explicit vertical diffusion of the old-time tracer (vdifft); the
        // flux through the top is the level above's bottom flux
        const T to_c = tile(b0, n)[tid];
        const T to_b = last ? T(0) : tile(b1, n)[tid];
        const T vtfb =
            below ? tile(b0, NT + n)[tid] * (to_c - to_b) * dzwr_k : T(0);
        const T vtf = k == 0 ? (mask ? stf[(n0 + n) * ls + oc] : T(0))
                             : vtf_k[n];
        const T vdf = mask ? (vtf - vtfb) * dzrk : T(0);

        out[(n0 + n) * ts + (k * ls + oc)] = hdtk - ltk + vdf;
        top_k[n] = bot;
        vtf_k[n] = vtfb;
      }
      wtk = wtkb;
    }
    const int b = b0;
    b0 = b1;
    b1 = b2;
    b2 = b;
  }
}

// ---- upwind3 (QUICKEST): the tile in a frame of two columns --------------

constexpr int kUpwHalo = 2;  // QUICKEST reaches i +- 2, j +- 2
using UpwFrame = Frame<kUpwHalo>;
static_assert(UpwFrame::covered(kRows), "a frame slot without a copier");
// The face region: the tile with its S row and W column, whose faces'
// fluxes the tile's columns read; slot (r, c) is the column (y0 - 1 + r,
// x0 - 1 + c), at r * kFacePitch + c: the slots of a Frame<1> plane but its
// N row and E column.
constexpr int kFacePitch = kFrameCols + 1;
constexpr int kFaceSlots = (kRows + 1) * kFacePitch;
static_assert(kFaceSlots <= kFrameSlots * kThreadsTile,
              "a face slot without a copier");
// the faces a tile's threads form besides their own: the S row's north
// faces (threads 0 .. kFrameCols - 1), the W column's east faces (the next
// kRows threads)
constexpr int kHaloFaces = kFrameCols + kRows;
constexpr int kUpwCoef = 6;  // a face's QUICKEST values: alfp .. delm
constexpr int kLev = 11;     // values a level of the upwind3 level table

// Blocks an SM that the upwind3 kernel's register and shared-memory budgets
// are set for: 32 / 16 warps. In float32 four blocks (64 registers) ran
// faster than three (80) on the H100, spill and all: 320x384 is 480 tiles,
// one wave of four blocks on 132 SMs and two of three (PERF.md).
template <typename T>
struct TracerUpwOcc {
  static constexpr int kMinBlocks = sizeof(T) == 4 ? 4 : 2;
};

// The upwind3 tile's shared memory, in values (KMT is held as values):
//   once a tile: DYU, DXU (face region), KMT (frame), the S row's
//     north-face and the W column's east-face QUICKEST values and TAREA_R
//     (kHaloFaces each), the tile's own east- and north-face QUICKEST
//     values (12 tile planes);
//   two frame buffers (level L in buffer L % 2, staged two levels ahead):
//     u, v (face region), NT trcr (frame);
//   two centre buffers (level L in buffer L % 2, staged one level ahead):
//     what level L reads besides the carries: NT told of level L + 1, NT
//     diffusivities of level L, NT trcr of level L + 2 (tile planes) and
//     with DEL2 NT tmix of level L (frame);
//   two buffers of what a column publishes: ute, vtn, NT east-face and NT
//     north-face values (face region);
//   with PBC, once a tile: DZBU on the face region and KMU there as bytes
//     (a plane of values more would drop the float32 tile of two tracers
//     from four blocks an SM to three).
// Every ring has two buffers, so the k loop runs two levels a turn and
// every shared-memory address is a thread's register and an immediate.
template <int NT, bool DEL2, bool PBC = false>
struct TracerUpwLayout {
  static constexpr int kP = UpwFrame::plane(kRows);  // a frame plane
  static constexpr int kF = kFaceSlots;              // a face-region plane
  static constexpr int kC = kThreadsTile;            // a tile plane
  static constexpr int kStatic = 2 * kF + kP +
                                 (kUpwCoef + 1) * kHaloFaces +
                                 2 * kUpwCoef * kC;
  static constexpr int kFrameLevel = 2 * kF + NT * kP;
  static constexpr int kCentreLevel = 3 * NT * kC + (DEL2 ? NT * kP : 0);
  static constexpr int kPub = (2 + 2 * NT) * kF;
  // DZBU, then KMU as bytes, counted in 4-byte values
  static constexpr int kPbc = PBC ? kF + (kF + 3) / 4 : 0;
  static constexpr int kValues =
      kStatic + 2 * (kFrameLevel + kCentreLevel + kPub) + kPbc;
};

template <bool PBC>
inline int tracer_smem_values_of(int ng, bool del2, bool upwind3) {
  if (upwind3) {
    if (ng == 1)
      return del2 ? TracerUpwLayout<1, true, PBC>::kValues
                  : TracerUpwLayout<1, false, PBC>::kValues;
    return del2 ? TracerUpwLayout<2, true, PBC>::kValues
                : TracerUpwLayout<2, false, PBC>::kValues;
  }
  return tracer_smem_values_of<PBC>(ng, del2);
}

inline int tracer_smem_values(int ng, bool del2, bool upwind3, bool pbc) {
  return pbc ? tracer_smem_values_of<true>(ng, del2, upwind3)
             : tracer_smem_values_of<false>(ng, del2, upwind3);
}

// QUICKEST face value (advect.advt_upwind3 `faceval`): x1 = X one step
// downstream, x0 = X, xm = X one step upstream, x2 = X two steps
// downstream; c: the face's six coefficient values alfp .. delm, STRIDE
// apart; m1, mm, m2: the stencil's points are ocean at the level.
template <int STRIDE, typename T>
__device__ __forceinline__ T quickest(bool c_pos, bool m1, bool mm, bool m2,
                                      const T* c, T x1, T x0, T xm, T x2) {
  const T alfp = c[0], betp = c[STRIDE], gamp = c[2 * STRIDE];
  const T alfm = c[3 * STRIDE], betm = c[4 * STRIDE], delm = c[5 * STRIDE];
  const T ap = m1 ? alfp : T(0);
  const T work = m1 ? betp : betp + alfp;
  const T bp = mm ? work : work + gamp;
  const T gp = mm ? gamp : T(0);
  const T am = m2 ? alfm : alfm + delm;
  const T dm = m2 ? delm : T(0);
  const T plus = ap * x1 + bp * x0 + gp * xm;
  const T minus = am * x1 + betm * x0 + dm * x2;
  return c_pos ? plus : minus;
}

// x / d as the division rounds it, from r = 1/d rounded once: q = x r is
// within an ulp of the quotient, x - d q is exact in an fma, and q + (x -
// d q) r rounds to the quotient (Markstein); three operations in place of
// the division's sequence and its branch to a slow path.
template <typename T>
__device__ __forceinline__ T quotient(T x, T d, T r) {
  const T q = x * r;
  return fma(fma(-d, q, x), r, q);
}

// The fields of a launch's group of NT tracers, tracer by tracer, offset on
// the host: in the kernel's parameters every copy's address is one
// instruction (tracer 0 uses diffusivity class 0, all others class 1).
template <typename T, int NT>
struct TracerGroup {
  const T* tr[NT];  // trcr
  const T* tm[NT];  // tmix
  const T* to[NT];  // told
  const T* vd[NT];  // vdc
  const T* sf[NT];  // stf
  T* out[NT];
};

// Upwind3 advection; fold: the north edge is a tripole fold (only the
// frame's slots depend on it). upw: the 12 horizontal coefficient planes
// (east-face alfxp .. delxm, north-face alfyp .. delym; (12, ny, nx)); lev:
// the level table, (km, kLev): dz, dzr, dz2r, dzwr2, the 6 vertical
// coefficients talfzp .. tdelzm and 1/dz rounded once in T, a row a level.
// PBC: partial bottom cells (kmu, dzbt, dzbu read, else not).
template <typename T, int NT, bool DEL2, bool PBC>
__global__ void __launch_bounds__(kThreadsTile, TracerUpwOcc<T>::kMinBlocks)
tracer_upw_kernel(int km, int ny, int nx, int cyclic, int fold, int varthick,
                  const TracerGroup<T, NT> g, const T* __restrict__ u,
                  const T* __restrict__ v, const T* __restrict__ dh,
                  const int* __restrict__ kmt,
                  const T* __restrict__ dyu, const T* __restrict__ dxu,
                  const T* __restrict__ tarea_r, const T* __restrict__ dtn,
                  const T* __restrict__ dts, const T* __restrict__ dte,
                  const T* __restrict__ dtw, const T* __restrict__ upw,
                  const T* __restrict__ lev, T ah,
                  const int* __restrict__ kmu, const T* __restrict__ dzbt,
                  const T* __restrict__ dzbu) {
  using Lay = TracerUpwLayout<NT, DEL2, PBC>;
  constexpr int H = kUpwHalo, W = UpwFrame::kPitch, FW = kFacePitch;
  constexpr int P = Lay::kP, F = Lay::kF, C = Lay::kC;
  constexpr int FL = Lay::kFrameLevel, CL = Lay::kCentreLevel;
  constexpr int PL = Lay::kPub;
  extern __shared__ __align__(16) unsigned char pop2_smem[];
  const int tid = threadIdx.y * kFrameCols + threadIdx.x;
  const int ls = ny * nx;  // level stride (the C entry keeps km * ny * nx
                           // below 2^31)
  T* met = reinterpret_cast<T*>(pop2_smem);  // DYU, DXU: (2, F)
  T* kms = met + 2 * F;                      // KMT: (P)
  T* hal = kms + P;  // (kUpwCoef + 1, kHaloFaces): coefficients, TAREA_R
  T* cof = hal + (kUpwCoef + 1) * kHaloFaces;  // (2 kUpwCoef, C)
  // frame buffer b: u, v (face region), then trcr[NT] (frame)
  T* frm = cof + 2 * kUpwCoef * C;  // (2, FL)
  // centre buffer b: tile planes told[NT], diffusivity[NT], trcr[NT]; with
  // DEL2 tmix[NT] (frame)
  T* cen = frm + 2 * FL;  // (2, CL)
  // published buffer b: ute, vtn, east-face values [NT], north-face [NT]
  T* pub = cen + 2 * CL;  // (2, PL)
  // PBC: the face region's DZBU (F) and KMU (F bytes)
  T* dzf = pub + 2 * PL;
  unsigned char* kmf = reinterpret_cast<unsigned char*>(dzf + F);

  const int x0 = blockIdx.x * kFrameCols, y0 = blockIdx.y * kRows;
  const int s = (threadIdx.y + H) * W + threadIdx.x + H;      // frame slot
  const int fs = (threadIdx.y + 1) * FW + threadIdx.x + 1;    // face slot
  const int gi = x0 + threadIdx.x, gj = y0 + threadIdx.y;
  const bool live = gi < nx && gj < ny;  // the column writes output
  const int oc = live ? gj * nx + gi : 0;

  // the frame slots this thread copies: the offset of the column, -1 past
  // an edge (the copy writes zero); bit 0: trcr and KMT (the tile's rows
  // and columns across the whole frame), bit 1: tmix (one column out)
  int foff[kFrameSlots];
  unsigned fflag[kFrameSlots];
#pragma unroll
  for (int j = 0; j < kFrameSlots; ++j) {
    const int q = tid + j * kThreadsTile;
    int r = 0, c = 0, off = 0;
    const bool in = q < P && frame_slot<H>(q, y0, x0, ny, nx, cyclic, &r, &c,
                                           &off, fold, kFoldCenter);
    const bool row_in = r >= H && r < kRows + H;
    const bool col_in = c >= H && c < kFrameCols + H;
    const bool one = (row_in && c >= H - 1 && c <= kFrameCols + H) ||
                     (col_in && r >= H - 1 && r <= kRows + H);
    foff[j] = in ? off : -1;
    fflag[j] = q < P ? (unsigned)(row_in || col_in) | (unsigned)one << 1
                     : 0u;
    if (fflag[j] & 1u) kms[q] = in ? T(kmt[off]) : T(0);
  }
  // the face-region slots this thread copies (the slots of a Frame<1>
  // plane): the offset, -1 past an edge, -2 past the region
  int uoff[kFrameSlots];
#pragma unroll
  for (int j = 0; j < kFrameSlots; ++j) {
    const int q = tid + j * kThreadsTile;
    uoff[j] = -2;
    if (q < F) {
      const int rr = q / FW, cc = q - rr * FW;
      int r = 0, c = 0, off = 0;
      const bool in = frame_slot<1>(rr * Frame<1>::kPitch + cc, y0, x0, ny,
                                    nx, cyclic, &r, &c, &off, 0, kFoldCenter,
                                    nullptr, first_row(fold, ny));
      uoff[j] = in ? off : -1;
      met[q] = in ? dyu[off] : T(0);
      met[F + q] = in ? dxu[off] : T(0);
      if (PBC) {
        dzf[q] = in ? dzbu[off] : T(0);
        kmf[q] = in ? (unsigned char)kmu[off] : (unsigned char)0;
      }
    }
  }
  // the face this thread forms besides its own: the S row's north face
  // (the first kFrameCols threads) or the W column's east face (the next
  // kRows); its QUICKEST values and TAREA_R, zero past an edge
  const bool h_south = tid < kFrameCols;
  if (tid < kHaloFaces) {
    int r = 0, c = 0, off = 0;
    const int q1 = h_south ? tid + 1
                           : (tid - kFrameCols + 1) * Frame<1>::kPitch;
    const bool in =
        frame_slot<1>(q1, y0, x0, ny, nx, cyclic, &r, &c, &off, 0,
                      kFoldCenter, nullptr, first_row(fold, ny));
    const int p0 = h_south ? kUpwCoef : 0;  // north- or east-face planes
#pragma unroll
    for (int q = 0; q < kUpwCoef; ++q)
      hal[q * kHaloFaces + tid] = in ? upw[(p0 + q) * ls + off] : T(0);
    hal[kUpwCoef * kHaloFaces + tid] = in ? tarea_r[off] : T(0);
  }
  // the column's own east- and north-face QUICKEST values
#pragma unroll
  for (int q = 0; q < 2 * kUpwCoef; ++q)
    cof[q * C + tid] = live ? upw[q * ls + oc] : T(0);

  // start the copies of level L's frame into frame buffer fb (u, v, trcr)
  auto stage_frame = [&](int L, T* fb) {
    if (L >= km) return;
    const int lo = L * ls;
#pragma unroll
    for (int j = 0; j < kFrameSlots; ++j) {
      const int q = tid + j * kThreadsTile;
      if (uoff[j] != -2) {
        const bool in = uoff[j] >= 0;
        const int o = lo + (in ? uoff[j] : 0);
        cp_async(fb + q, u + o, in);
        cp_async(fb + F + q, v + o, in);
      }
      if (fflag[j] & 1u) {
        const bool in = foff[j] >= 0;
        const int o = lo + (in ? foff[j] : 0);
#pragma unroll
        for (int n = 0; n < NT; ++n) cp_async(fb + 2 * F + n * P + q,
                                              g.tr[n] + o, in);
      }
    }
  };
  // start the copies of what level L reads besides the carries into centre
  // buffer cb: told of level L + 1, the diffusivities of level L, trcr of
  // level L + 2, tmix of level L
  auto stage_centre = [&](int L, T* cb) {
    if (L >= km) return;
    const int lo = L * ls;
    if (DEL2) {
#pragma unroll
      for (int j = 0; j < kFrameSlots; ++j) {
        if (!(fflag[j] & 2u)) continue;
        const int q = tid + j * kThreadsTile;
        const bool in = foff[j] >= 0;
        const int o = lo + (in ? foff[j] : 0);
#pragma unroll
        for (int n = 0; n < NT; ++n) cp_async(cb + 3 * NT * C + n * P + q,
                                              g.tm[n] + o, in);
      }
    }
    if (live) {
      const int o = lo + oc;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (L + 1 < km) cp_async(cb + n * C + tid, g.to[n] + o + ls, true);
        cp_async(cb + (NT + n) * C + tid, g.vd[n] + o, true);
        if (L + 2 < km)
          cp_async(cb + (2 * NT + n) * C + tid, g.tr[n] + o + 2 * ls, true);
      }
    }
  };

  const T half = T(0.5);
  T tarea = T(0);
  if (live) tarea = tarea_r[oc];
  // publish the fluxes of level L's faces from frame buffer fb into
  // published buffer pb (comp_flux_vel, advt_upwind3's face values): ute
  // and the east-face values of the thread's own slot, vtn and the
  // north-face values, and those of its S-row or W-column face. The own
  // slot's values are all read before its first store, so that no store to
  // shared memory makes the compiler read a value again.
  auto faces = [&](int L, const T* fb, T* pb) {
    const T* su = fb;
    const T* sv = fb + F;
    const T dzl = lev[L * kLev];
    const T kk = T(L + 1);  // 1-based level, against KMT held as values
    // the thickness of face-region U point q at level L
    auto dzu = [&](int q) {
      return (PBC && kmf[q] == L + 1) ? dzf[q] : dzl;
    };
    const T ute = half * (su[fs] * met[fs] * dzu(fs) +
                          su[fs - FW] * met[fs - FW] * dzu(fs - FW));
    const T vtn = half * (sv[fs] * met[F + fs] * dzu(fs) +
                          sv[fs - 1] * met[F + fs - 1] * dzu(fs - 1));
    const bool e_pos = ute * tarea > T(0), n_pos = vtn * tarea > T(0);
    const bool me = kk <= kms[s + 1], mw = kk <= kms[s - 1];
    const bool mee = kk <= kms[s + 2];
    const bool mn = kk <= kms[s + W], ms = kk <= kms[s - W];
    const bool mnn = kk <= kms[s + 2 * W];
    T e_val[NT], n_val[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const T* X = fb + 2 * F + n * P;
      e_val[n] = quickest<C>(e_pos, me, mw, mee, cof + tid, X[s + 1], X[s],
                           X[s - 1], X[s + 2]);
      n_val[n] = quickest<C>(n_pos, mn, ms, mnn, cof + kUpwCoef * C + tid,
                            X[s + W], X[s], X[s - W], X[s + 2 * W]);
    }
    pb[fs] = ute;
    pb[F + fs] = vtn;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      pb[(2 + n) * F + fs] = e_val[n];
      pb[(2 + NT + n) * F + fs] = n_val[n];
    }
    // the S row's north face (SOUTH) or the W column's east face, at face
    // slot hq and frame slot hs, stepping across it by d (a row or a
    // column); b: the face flux's other U point (west or south), mo: its
    // metric plane, po: its published plane, pe: that of its face values
    auto halo = [&](auto south) {
      constexpr bool SOUTH = decltype(south)::value;
      constexpr int d = SOUTH ? W : 1, b = SOUTH ? 1 : FW;
      constexpr int mo = SOUTH ? F : 0, po = SOUTH ? F : 0;
      constexpr int pe = SOUTH ? 2 + NT : 2;
      const int hr = tid - kFrameCols;  // the W column's row
      const int hq = SOUTH ? tid + 1 : (hr + 1) * FW;
      const int hs = SOUTH ? (H - 1) * W + tid + H : (hr + H) * W + H - 1;
      const T* sx = fb + po;  // u or v
      const T ta = hal[kUpwCoef * kHaloFaces + tid];
      const T flux = half * (sx[hq] * met[mo + hq] * dzu(hq) +
                             sx[hq - b] * met[mo + hq - b] * dzu(hq - b));
      const bool pos = flux * ta > T(0);
      const bool m1 = kk <= kms[hs + d], mm = kk <= kms[hs - d];
      const bool m2 = kk <= kms[hs + 2 * d];
      T trh[NT];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const T* X = fb + 2 * F + n * P;
        trh[n] = quickest<kHaloFaces>(pos, m1, mm, m2, hal + tid, X[hs + d],
                                      X[hs], X[hs - d], X[hs + 2 * d]);
      }
      pb[po + hq] = flux;
#pragma unroll
      for (int n = 0; n < NT; ++n) pb[(pe + n) * F + hq] = trh[n];
    };
    if (tid < kFrameCols)
      halo(std::true_type());
    else if (tid < kHaloFaces)
      halo(std::false_type());
  };

  // 2-D operands of the column
  int kmt_c = 0;
  T dtn_c = T(0), dts_c = T(0), dte_c = T(0), dtw_c = T(0);
  T wtk = T(0);  // w at the top of the level
  // PBC: the bottom level's dz, 1/dz, 1/(2 dz) and the spacing above it
  T dzb = T(1), dzbr = T(1), dzb2r = T(1), dzwr_b = T(1);
  if (live) {
    kmt_c = kmt[oc];
    if (PBC) {
      dzb = dzbt[oc];
      dzbr = T(1) / dzb;
      dzb2r = T(0.5) / dzb;
      if (kmt_c >= 2)
        dzwr_b = T(1) / (T(0.5) * (lev[(kmt_c - 2) * kLev] + dzb));
    }
    if (DEL2) {
      dtn_c = dtn[oc];
      dts_c = dts[oc];
      dte_c = dte[oc];
      dtw_c = dtw[oc];
    }
    wtk = dh[oc];
  }
  T wsum = wtk;  // dh + running sum of the horizontal divergence
  // per tracer, carried down k: trcr at the level, the level above and the
  // level below; told at the level; the advection and vertical diffusive
  // fluxes through the level's top
  T t_k[NT], t_km1[NT], t_kp1[NT], to_k[NT], top_k[NT], vtf_k[NT];

  // the tendency of level k from published buffer pb and centre buffer cb
  auto tendency = [&](int k, const T* pb, const T* cb) {
    const int kk = k + 1;  // 1-based level
    const bool last = k == km - 1;
    const T* lk = lev + k * kLev;  // the level's row of the table
    const bool bot_k = PBC && kk == kmt_c;  // the partial bottom level
    const T dzk = bot_k ? dzb : lk[0], dzrk = bot_k ? dzbr : lk[1];
    const T dz2rk = bot_k ? dzb2r : lk[2];
    const T ute = pb[fs], utw = pb[fs - 1];
    const T vtn = pb[F + fs], vts = pb[F + fs - FW];

    const T cc = vtn - vts + ute - utw;
    wsum = wsum + cc * tarea;
    const bool below = kmt_c > kk;  // the level below is ocean
    const T wtkb = below ? wsum : T(0);
    const bool mask = kmt_c >= kk;

    // masked Laplacian coefficients: a face is open only if the neighbour
    // is ocean at this level
    T cn = T(0), cs = T(0), ce = T(0), cw = T(0);
    if (DEL2) {
      const T kkv = T(kk);
      cn = (mask && kms[s + W] >= kkv) ? dtn_c : T(0);
      cs = (mask && kms[s - W] >= kkv) ? dts_c : T(0);
      ce = (mask && kms[s + 1] >= kkv) ? dte_c : T(0);
      cw = (mask && kms[s - 1] >= kkv) ? dtw_c : T(0);
    }
    const T ccd = -(cn + cs + ce + cw);
    // the spacing below the level: the bottom level's thickness enters the
    // one above it
    const T dzwr_k = (PBC && kk + 1 == kmt_c) ? dzwr_b : lk[3];

    // upwind3 vertical coefficients of the level
    T tz[6];
#pragma unroll
    for (int q = 0; q < 6; ++q) tz[q] = lk[4 + q];
    const bool interior2 = kk < kmt_c - 1;
    const T azminus = interior2 ? tz[3] : tz[3] + tz[5];
    const T dzminus = interior2 ? tz[5] : T(0);
    const T ce_ = ute * tarea, cw_ = -utw * tarea;
    const T cn_ = vtn * tarea, cs_ = -vts * tarea;

#pragma unroll
    for (int n = 0; n < NT; ++n) {
      // horizontal: the published upwind-biased face values
      const T tr_e = pb[(2 + n) * F + fs], tr_w = pb[(2 + n) * F + fs - 1];
      const T tr_n = pb[(2 + NT + n) * F + fs];
      const T tr_s = pb[(2 + NT + n) * F + fs - FW];
      const T lh = quotient(ce_ * tr_e + cw_ * tr_w + cn_ * tr_n + cs_ * tr_s,
                            dzk, bot_k ? dzbr : lk[10]);
      // vertical (QUICKEST through the level's bottom)
      const T tc = t_k[n];
      const T tp1 = last ? tc : t_kp1[n];
      const T tp2 = k + 2 < km ? cb[(2 * NT + n) * C + tid] : tp1;
      const T tplus = tz[0] * tp1 + tz[1] * tc + tz[2] * t_km1[n];
      const T tminus = azminus * tp1 + tz[4] * tc + dzminus * tp2;
      const T auxb = last ? T(0)
                          : (wtkb - fabs(wtkb)) * tplus +
                                (wtkb + fabs(wtkb)) * tminus;
      const T aux = top_k[n];
      T vert = dz2rk * (aux - auxb);
      if (k == 0 && !varthick) vert = wtk * tc / dzk - half * auxb / dzk;
      const T ltk = mask ? lh + vert : T(0);

      // Laplacian diffusion of the mixing-time tracer (hdifft_del2)
      T hdtk = T(0);
      if (DEL2) {
        const T* tmk = cb + 3 * NT * C + n * P;
        hdtk = ah * (ccd * tmk[s] + cn * tmk[s + W] + cs * tmk[s - W]
                     + ce * tmk[s + 1] + cw * tmk[s - 1]);
      }

      // explicit vertical diffusion of the old-time tracer (vdifft); the
      // flux through the top is the level above's bottom flux
      const T to_c = to_k[n];
      const T to_b = last ? T(0) : cb[n * C + tid];
      const T vtfb =
          below ? cb[(NT + n) * C + tid] * (to_c - to_b) * dzwr_k : T(0);
      const T vtf = k == 0 ? (mask ? g.sf[n][oc] : T(0)) : vtf_k[n];
      const T vdf = mask ? (vtf - vtfb) * dzrk : T(0);

      g.out[n][k * ls + oc] = hdtk - ltk + vdf;
      top_k[n] = auxb;
      vtf_k[n] = vtfb;
      t_km1[n] = tc;
      t_k[n] = tp1;
      t_kp1[n] = tp2;
      to_k[n] = to_b;
    }
    wtk = wtkb;
  };

  // ---- down the column -----------------------------------------------------
  // level L's frame in frame buffer L % 2 (staged two levels ahead), what
  // it reads in centre buffer L % 2 (one level ahead), its published
  // fluxes in buffer L % 2
  stage_frame(0, frm);
  stage_centre(0, cen);
  cp_async_commit();
  stage_frame(1, frm + FL);
  cp_async_commit();
  cp_async_wait<1>();  // level 0 has landed (the thread's own copies)
  __syncthreads();     // ... and everyone's, with the tile's 2-D planes
  faces(0, frm, pub);
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    t_k[n] = frm[2 * F + n * P + s];
    t_km1[n] = t_k[n];  // the surface level's is its own
    t_kp1[n] = live && km > 1 ? g.tr[n][ls + oc] : t_k[n];
    to_k[n] = live ? g.to[n][oc] : T(0);
    top_k[n] = T(0);
    vtf_k[n] = T(0);
  }
  // a turn of level k in buffers B = k % 2: level k+1's frame has landed
  // everywhere and so has what level k reads; level k's fluxes are
  // published; every thread is done with level k-1's buffers and level k's
  // frame
  auto turn = [&](auto parity, int k) {
    constexpr int B = decltype(parity)::value, B1 = 1 - B;
    cp_async_wait<0>();
    __syncthreads();
    stage_frame(k + 2, frm + B * FL);
    stage_centre(k + 1, cen + B1 * CL);
    cp_async_commit();
    if (k + 1 < km) faces(k + 1, frm + B1 * FL, pub + B1 * PL);
    if (live) tendency(k, pub + B * PL, cen + B * CL);
  };
  for (int k = 0; k < km; k += 2) {
    turn(std::integral_constant<int, 0>(), k);
    if (k + 1 < km) turn(std::integral_constant<int, 1>(), k + 1);
  }
}

template <typename T, int NT, bool DEL2, bool FOLD, bool PBC>
struct TracerInstance {
  static cudaError_t prepare(long smem) {
    return allow_large_smem(tracer_kernel<T, NT, DEL2, FOLD, PBC>, smem);
  }
  static int occupancy(long smem) {
    const cudaError_t e = prepare(smem);
    if (e != cudaSuccess) return -(int)e;
    return blocks_per_sm(tracer_kernel<T, NT, DEL2, FOLD, PBC>,
                         kThreadsTile, smem);
  }
};

template <typename T, int NT, bool DEL2, bool PBC>
struct TracerUpwInstance {
  static cudaError_t prepare(long smem) {
    return allow_large_smem(tracer_upw_kernel<T, NT, DEL2, PBC>, smem);
  }
  static int occupancy(long smem) {
    const cudaError_t e = prepare(smem);
    if (e != cudaSuccess) return -(int)e;
    return blocks_per_sm(tracer_upw_kernel<T, NT, DEL2, PBC>, kThreadsTile,
                         smem);
  }
};

// The fields of the group of NT tracers from n0, offset on the host.
template <typename T, int NT>
TracerGroup<T, NT> tracer_group(int n0, int km, int ny, int nx,
                                const void* trcr, const void* tmix,
                                const void* told, const void* vdc,
                                const void* stf, void* out) {
  const long ls = (long)ny * nx, ts = km * ls;
  TracerGroup<T, NT> g;
  for (int n = 0; n < NT; ++n) {
    g.tr[n] = (const T*)trcr + (n0 + n) * ts;
    g.tm[n] = (const T*)tmix + (n0 + n) * ts;
    g.to[n] = (const T*)told + (n0 + n) * ts;
    g.vd[n] = (const T*)vdc + (n0 + n < 1 ? 0 : ts);
    g.sf[n] = (const T*)stf + (n0 + n) * ls;
    g.out[n] = (T*)out + (n0 + n) * ts;
  }
  return g;
}

// The launch configuration the wrapper chose: a group of ng tracers from
// n0 of nt, `rows` rows of kFrameCols columns, `smem` bytes of dynamic
// shared memory (the layout of centered or upwind3 advection); level
// offsets in int.
template <typename T>
bool tracer_config_ok(int ng, int n0, int nt, int km, int ny, int nx,
                      bool del2, bool upwind3, bool pbc, int rows,
                      long smem) {
  return ng >= 1 && ng <= kMaxGroup && n0 >= 0 && n0 + ng <= nt && km >= 1 &&
         (!pbc || km < 256) && (long)km * ny * nx < (1L << 31) &&
         rows == kRows &&
         smem >= (long)tracer_smem_values(ng, del2, upwind3, pbc) *
                     (long)sizeof(T);
}

}  // namespace pop2

#define POP2_TRACER_INSTANCES(T, ACTION)                                     \
  if (ng == 1 && del2)                                                       \
    ACTION(T, 1, true)                                                       \
  else if (ng == 1)                                                          \
    ACTION(T, 1, false)                                                      \
  else if (del2)                                                             \
    ACTION(T, 2, true)                                                       \
  else                                                                       \
    ACTION(T, 2, false)

// Values of dynamic shared memory the tile takes for a group of ng tracers
// with centered or upwind3 advection, full or partial bottom cells (the
// planner's count, tracer_cuda.smem_values).
extern "C" int pop2_tracer_smem_values(int ng, int with_del2, int upwind3,
                                       int pbc) {
  return pop2::tracer_smem_values(ng, with_del2 != 0, upwind3 != 0,
                                  pbc != 0);
}

extern "C" int pop2_tracer_tile_rows() { return pop2::kRows; }

extern "C" int pop2_tracer_max_group() { return pop2::kMaxGroup; }

// dtype: 0 = float32, 1 = float64; with_del2 = 0 selects the advection +
// vertical-diffusion instance (tmix and ah are then not read). One launch
// computes the ng tracers n0 .. n0+ng-1 of nt (the pointers are those of
// all nt); cyclic: the east-west edge wraps; fold: the north edge is a
// tripole fold (nonzero: the rows through its top row, common.cuh); upwind3: QUICKEST advection (upw: its 12 horizontal
// coefficient planes; lev: its level table (km, 11) of dz, dzr, dz2r,
// dzwr2, the 6 vertical coefficients and 1/dz rounded once, read in place
// of dz .. dzwr2;
// neither read for centered advection); rows: rows of the tile; smem:
// dynamic shared memory a block, bytes; kmu, dzbt, dzbu: KMU and the bottom
// level's thickness at T and U points under partial bottom cells (the PBC
// instances), or null. Returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for a configuration the kernel does not take.
extern "C" int pop2_tracer(int dtype, int with_del2, int nt, int n0, int ng,
                           int km, int ny, int nx, int cyclic, int fold,
                           int upwind3, int varthick, int rows, long smem,
                           const void* u, const void* v, const void* trcr,
                           const void* tmix, const void* told,
                           const void* vdc, const void* stf, const void* dh,
                           const int* kmt, const void* dyu, const void* dxu,
                           const void* tarea_r, const void* dtn,
                           const void* dts, const void* dte, const void* dtw,
                           const void* dz, const void* dzr, const void* dz2r,
                           const void* dzwr2, const void* upw,
                           const void* lev, double ah, void* out,
                           const int* kmu, const void* dzbt,
                           const void* dzbu, void* stream) {
  using namespace pop2;
  const bool del2 = with_del2 != 0, quick = upwind3 != 0;
  const bool pbc = dzbt != nullptr;
  if (!(dtype == 0 ? tracer_config_ok<float>(ng, n0, nt, km, ny, nx, del2,
                                              quick, pbc, rows, smem)
                   : tracer_config_ok<double>(ng, n0, nt, km, ny, nx, del2,
                                               quick, pbc, rows, smem)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((nx + kFrameCols - 1) / kFrameCols),
                  (unsigned)((ny + rows - 1) / rows));
  const dim3 block(kFrameCols, rows);
  cudaStream_t s = (cudaStream_t)stream;
#define POP2_TRACER_CENTERED(T, NT, DEL2, FOLD, PBC)                         \
  {                                                                          \
    const cudaError_t e =                                                    \
        TracerInstance<T, NT, DEL2, FOLD, PBC>::prepare(smem);               \
    if (e != cudaSuccess) return (int)e;                                     \
    tracer_kernel<T, NT, DEL2, FOLD, PBC><<<grid, block, smem, s>>>(         \
        n0, km, ny, nx, cyclic, fold, varthick, (const T*)u, (const T*)v,    \
        (const T*)trcr, (const T*)tmix, (const T*)told, (const T*)vdc,       \
        (const T*)stf, (const T*)dh, kmt, (const T*)dyu, (const T*)dxu,      \
        (const T*)tarea_r, (const T*)dtn, (const T*)dts, (const T*)dte,      \
        (const T*)dtw, (const T*)dz, (const T*)dzr, (const T*)dz2r,          \
        (const T*)dzwr2, (T)ah, (T*)out, kmu, (const T*)dzbt,                \
        (const T*)dzbu);                                                     \
  }
#define POP2_TRACER_UPW(T, NT, DEL2, PBC)                                    \
  {                                                                          \
    const cudaError_t e = TracerUpwInstance<T, NT, DEL2, PBC>::prepare(smem);\
    if (e != cudaSuccess) return (int)e;                                     \
    tracer_upw_kernel<T, NT, DEL2, PBC><<<grid, block, smem, s>>>(           \
        km, ny, nx, cyclic, fold, varthick,                                  \
        tracer_group<T, NT>(n0, km, ny, nx, trcr, tmix, told, vdc, stf,      \
                            out),                                            \
        (const T*)u, (const T*)v, (const T*)dh, kmt, (const T*)dyu,          \
        (const T*)dxu, (const T*)tarea_r, (const T*)dtn, (const T*)dts,      \
        (const T*)dte, (const T*)dtw, (const T*)upw, (const T*)lev, (T)ah,   \
        kmu, (const T*)dzbt, (const T*)dzbu);                                \
  }
#define POP2_TRACER(T, NT, DEL2)                                             \
  {                                                                          \
    if (quick && pbc) {                                                      \
      POP2_TRACER_UPW(T, NT, DEL2, true)                                     \
    } else if (quick) {                                                      \
      POP2_TRACER_UPW(T, NT, DEL2, false)                                    \
    } else if (fold && pbc) {                                                \
      POP2_TRACER_CENTERED(T, NT, DEL2, true, true)                          \
    } else if (fold) {                                                       \
      POP2_TRACER_CENTERED(T, NT, DEL2, true, false)                         \
    } else if (pbc) {                                                        \
      POP2_TRACER_CENTERED(T, NT, DEL2, false, true)                         \
    } else {                                                                 \
      POP2_TRACER_CENTERED(T, NT, DEL2, false, false)                        \
    }                                                                        \
  }
  if (dtype == 0) {
    POP2_TRACER_INSTANCES(float, POP2_TRACER)
  } else {
    POP2_TRACER_INSTANCES(double, POP2_TRACER)
  }
#undef POP2_TRACER
#undef POP2_TRACER_UPW
#undef POP2_TRACER_CENTERED
  return (int)cudaGetLastError();
}

// Blocks of a launch of this configuration (a group of ng tracers, with the
// Laplacian or without, centered or upwind3, closed or tripole north edge,
// full or partial bottom cells, `smem` bytes a block) that one SM holds at
// once.
extern "C" int pop2_tracer_blocks_per_sm(int dtype, int with_del2, int ng,
                                         int upwind3, int fold, long smem,
                                         int pbc) {
  using namespace pop2;
  const bool del2 = with_del2 != 0, quick = upwind3 != 0;
  if (ng < 1 || ng > kMaxGroup) return -(int)cudaErrorInvalidValue;
#define POP2_TRACER_OCC(T, NT, DEL2)                                         \
  {                                                                          \
    if (quick && pbc)                                                        \
      return TracerUpwInstance<T, NT, DEL2, true>::occupancy(smem);          \
    if (quick) return TracerUpwInstance<T, NT, DEL2, false>::occupancy(smem);\
    if (fold && pbc)                                                         \
      return TracerInstance<T, NT, DEL2, true, true>::occupancy(smem);       \
    if (fold)                                                                \
      return TracerInstance<T, NT, DEL2, true, false>::occupancy(smem);      \
    if (pbc)                                                                 \
      return TracerInstance<T, NT, DEL2, false, true>::occupancy(smem);      \
    return TracerInstance<T, NT, DEL2, false, false>::occupancy(smem);       \
  }
  if (dtype == 0) {
    POP2_TRACER_INSTANCES(float, POP2_TRACER_OCC)
  } else {
    POP2_TRACER_INSTANCES(double, POP2_TRACER_OCC)
  }
#undef POP2_TRACER_OCC
  return -(int)cudaErrorInvalidValue;  // not reached: every case returns
}
#undef POP2_TRACER_INSTANCES
