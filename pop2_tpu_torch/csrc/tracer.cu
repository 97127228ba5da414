// Fused tracer tendency of one baroclinic step:
//   ft = ah * Del2(tmix) - L_adv(trcr; u, v, dh) + D_v(told; vdc, stf)
// i.e. comp_flux_vel + advt_centered (source/advection.F90:1970, :2139),
// hdifft_del2 (source/hmix_del2.F90:1034) and vdifft
// (source/vertical_mix.F90:691) in one pass.
//
// Replaces the TPU kernel tracer_pallas.py `_kernel` /
// `tracer_tendency_tiles` in its centered-advection, closed north-south
// modes: with the Laplacian mixing fused (DEL2, the dynamical-core path) and
// without it (advection + vertical diffusion only, the mode the GM path
// runs: the horizontal mixing is then the GM kernels' and tmix is not read).
//
// Bound on this card: bytes. Minimum traffic is u, v, vdc (2 classes) and
// trcr, told, out per tracer (the model passes told or trcr again as tmix):
// (4 + 3 nt) distinct 3-D fields plus a dozen 2-D ones, against some 60
// flops per output value; without DEL2 (4 + 2 nt) fields. The design keeps
// the bytes in flight and reads each value once a level:
//   - a block is a tile of kFrameCols x kRows columns (32 x 8, a warp a
//     row, one thread a column) in a frame of kHalo columns (common.cuh
//     `Frame`), walking down k; the tile's shape is a compile-time
//     constant, so a shared-memory address is a register and an immediate
//     (with a run-time row count every address was multiplied out);
//   - each level is staged in shared memory by `cp.async` two levels ahead
//     (three buffers: level k is read with the centre of level k+1 while
//     level k+2 lands): u, v on the tile and its S, W, SW frame (the face
//     velocities), trcr and tmix on the tile and its N, S, E, W frame (the
//     stencils), told and the diffusivities on the tile only;
//   - every column forms its face velocities ute = (a_c + a_s)/2 and
//     vtn = (b_c + b_w)/2 (a = u DYU dz, b = v DXU dz) once a level, one
//     level ahead, and publishes them (two buffers, one barrier a level);
//     a column takes utw and vts from its west and south neighbours. The
//     frame's W column and S row are formed by the first warps' threads
//     besides their own (ute there, vtn there);
//   - down k, per tracer, in registers: the advection flux through the
//     level's top (the level above's bottom flux) and the vertical
//     diffusive flux through it (the level above's vtfb), besides the
//     continuity sum for w; trcr and told at k and k+1 come from the
//     staged levels (carried in registers as well, they pushed the float32
//     instance with the Laplacian into spilling). A frame value is read
//     again only by the neighbouring tile, from L2.
// The tracer count of a launch is a template parameter up to kMaxGroup, so
// the carries stay in registers; the wrapper launches groups above it.
// Closed edges read zero (copies of nothing, zero metrics); a cyclic edge
// wraps inside the frame; the ragged last tiles are masked. The block shape
// and the dynamic shared memory come from the wrapper's planner
// (`tracer_cuda.launch_plan`).
//
// The upwind3 (QUICKEST) mode and the tripole north edge run a second,
// simpler kernel (`tracer_col_kernel`, below): one thread a column walking
// down k that reads its stencil from device memory (through the read-only
// cache) rather than from a staged frame. upwind3 reaches two columns and
// two rows out (i +- 2, j +- 2) and its vertical term reads level k+2; on a
// tripole grid the rows past ny - 1 are the fold of the top rows (tracers,
// KMT: centre fields), so a column of the top rows reads columns of another
// tile. Its 12 horizontal coefficient planes (east- and north-face
// QUICKEST weights, advect.upwind3_planes) and 6 vertical coefficient rows
// come from the wrapper.
#include "common.cuh"

namespace pop2 {

constexpr int kMaxGroup = 2;  // tracers a launch (template NT)
// the frame's width: centered advection and the Laplacian reach one column;
// upwind3 (QUICKEST) reaches i +- 2, j +- 2 and will need 2, with its
// coefficient planes staged beside u and v (tracer_pallas.py:114, :295-301)
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
template <int NT, bool DEL2>
struct TracerLayout {
  static constexpr int kP = TracerFrame::plane(kRows);  // a frame plane
  static constexpr int kC = kThreadsTile;               // a tile plane
  static constexpr int kRing = 2 + NT * (DEL2 ? 2 : 1);  // frame planes
  static constexpr int kStage = kRing * kP + 2 * NT * kC;
  static constexpr int kValues = 2 * kP + 3 * kStage + 2 * 2 * kP;
};

inline int tracer_smem_values(int ng, bool del2) {
  if (ng == 1)
    return del2 ? TracerLayout<1, true>::kValues
                : TracerLayout<1, false>::kValues;
  return del2 ? TracerLayout<2, true>::kValues
              : TracerLayout<2, false>::kValues;
}

template <typename T, int NT, bool DEL2>
__global__ void __launch_bounds__(kThreadsTile, TracerOcc<T>::kMinBlocks)
tracer_kernel(int n0, int km, int ny, int nx, int cyclic, int varthick,
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
              T* __restrict__ out) {
  using Lay = TracerLayout<NT, DEL2>;
  constexpr int W = TracerFrame::kPitch, P = Lay::kP, C = Lay::kC;
  extern __shared__ __align__(16) unsigned char pop2_smem[];
  const int tid = threadIdx.y * kFrameCols + threadIdx.x;
  const int ls = ny * nx;       // level stride (the C entry keeps
  const long ts = (long)km * ls;  // km * ny * nx below 2^31)
  T* met = reinterpret_cast<T*>(pop2_smem);  // DYU, DXU: (2, P)
  T* stg = met + 2 * P;                      // (3 buffers, Lay::kStage)
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
                                               &r, &c, &off);
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
    pu[s] = half * (su[s] * met[s] * dzl + su[s - W] * met[s - W] * dzl);
    pv[s] = half * (sv[s] * met[P + s] * dzl +
                    sv[s - 1] * met[P + s - 1] * dzl);
    if (h_south)
      pv[hq] = half * (sv[hq] * met[P + hq] * dzl +
                       sv[hq - 1] * met[P + hq - 1] * dzl);
    else if (hq >= 0)
      pu[hq] = half * (su[hq] * met[hq] * dzl +
                       su[hq - W] * met[hq - W] * dzl);
  };

  // 2-D operands of the column
  int kmt_c = 0, kmt_n = 0, kmt_s = 0, kmt_e = 0, kmt_w = 0;
  T tarea = T(0), dtn_c = T(0), dts_c = T(0), dte_c = T(0), dtw_c = T(0);
  T wtk = T(0);  // w at the top of the level
  if (live) {
    Column c;
    locate_at(ny, nx, cyclic, gj, gi, &c);
    kmt_c = kmt[oc];
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
      const T dzrk = dzr[k], dz2rk = dz2r[k];
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
      const T dzwr_k = dzwr2[k];

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

// ---- the column kernel: upwind3 and the tripole north edge ---------------

constexpr int kColRows = 8;  // a block: kFrameCols x kColRows columns
constexpr int kUpwPlanes = 12;  // alfxp..delxm (east), alfyp..delym (north)
constexpr int kUpwVert = 6;     // talfzp, tbetzp, tgamzp, talfzm, tbetzm,
                                // tdelzm (km each)

// Index of a horizontal neighbour (j, i) in a (ny, nx) plane, or -1 beyond
// a closed edge: a cyclic east-west edge wraps, the south edge is closed,
// and with `fold` the rows ny and ny + 1 are the fold of rows ny - 1 and
// ny - 2 (centre fields).
__device__ __forceinline__ int col_index(int j, int i, int ny, int nx,
                                         int cyclic, int fold) {
  if (i < 0 || i >= nx) {
    if (!cyclic) return -1;
    i = i < 0 ? i + nx : i - nx;
  }
  if (j < 0) return -1;
  if (j >= ny) {
    if (!fold || j > ny + 1) return -1;
    fold_point(kFoldCenter, j - ny + 1, i, ny, nx, &j, &i);
  }
  return j * nx + i;
}

template <typename T>
__device__ __forceinline__ T ld_at(const T* __restrict__ f, int idx) {
  return idx >= 0 ? __ldg(f + idx) : T(0);
}

// QUICKEST face value (advect.advt_upwind3 `faceval`): x1 = X one step
// downstream, x0 = X, xm = X one step upstream, x2 = X two steps
// downstream; c: the coefficient planes' six values of the face; m1, mm,
// m2: the stencil's points are ocean at the level.
template <typename T>
__device__ __forceinline__ T quickest(bool c_pos, bool m1, bool mm, bool m2,
                                      const T (&c)[6], T x1, T x0, T xm,
                                      T x2) {
  const T alfp = c[0], betp = c[1], gamp = c[2];
  const T alfm = c[3], betm = c[4], delm = c[5];
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

// Blocks an SM that the column kernel's register budget is set for.
template <typename T>
struct TracerColOcc {
  static constexpr int kMinBlocks = sizeof(T) == 4 ? 3 : 2;
};

template <typename T, int NT, bool DEL2, bool UPW>
__global__ void __launch_bounds__(kFrameCols * kColRows,
                                  TracerColOcc<T>::kMinBlocks)
tracer_col_kernel(int n0, int km, int ny, int nx, int cyclic, int fold,
                  int varthick, const T* __restrict__ u,
                  const T* __restrict__ v, const T* __restrict__ trcr,
                  const T* __restrict__ tmix, const T* __restrict__ told,
                  const T* __restrict__ vdc, const T* __restrict__ stf,
                  const T* __restrict__ dh, const int* __restrict__ kmt,
                  const T* __restrict__ dyu, const T* __restrict__ dxu,
                  const T* __restrict__ tarea_r, const T* __restrict__ dtn,
                  const T* __restrict__ dts, const T* __restrict__ dte,
                  const T* __restrict__ dtw, const T* __restrict__ dz,
                  const T* __restrict__ dzr, const T* __restrict__ dz2r,
                  const T* __restrict__ dzwr2, const T* __restrict__ upw,
                  const T* __restrict__ vco, T ah, T* __restrict__ out) {
  const int gi = blockIdx.x * kFrameCols + threadIdx.x;
  const int gj = blockIdx.y * kColRows + threadIdx.y;
  if (gi >= nx || gj >= ny) return;
  const int ls = ny * nx;
  const long ts = (long)km * ls;
  const int oc = gj * nx + gi;
  auto at = [&](int dj, int di) {
    return col_index(gj + dj, gi + di, ny, nx, cyclic, fold);
  };
  // the stencil's points: centre, e, w, ee, ww, n, s, nn, ss, and the sw
  // corner of the face velocities
  const int ie = at(0, 1), iw = at(0, -1), iee = at(0, 2), iww = at(0, -2);
  const int in = at(1, 0), is = at(-1, 0), inn = at(2, 0), iss = at(-2, 0);
  const int isw = at(-1, -1);
  const int k_c = kmt[oc], k_e = ld_at(kmt, ie), k_w = ld_at(kmt, iw);
  const int k_ee = ld_at(kmt, iee), k_ww = ld_at(kmt, iww);
  const int k_n = ld_at(kmt, in), k_s = ld_at(kmt, is);
  const int k_nn = ld_at(kmt, inn), k_ss = ld_at(kmt, iss);
  const T tarea = tarea_r[oc];
  const T tarea_w = ld_at(tarea_r, iw), tarea_s = ld_at(tarea_r, is);
  // face metrics of the four U corners around the T cell
  const T dyu_c = dyu[oc], dyu_s = ld_at(dyu, is), dyu_w = ld_at(dyu, iw);
  const T dyu_sw = ld_at(dyu, isw);
  const T dxu_c = dxu[oc], dxu_s = ld_at(dxu, is), dxu_w = ld_at(dxu, iw);
  const T dxu_sw = ld_at(dxu, isw);
  T dtn_c = T(0), dts_c = T(0), dte_c = T(0), dtw_c = T(0);
  if (DEL2) {
    dtn_c = dtn[oc];
    dts_c = dts[oc];
    dte_c = dte[oc];
    dtw_c = dtw[oc];
  }
  const T half = T(0.5);
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
  T wtk = dh[oc];   // w at the top of the level
  T wsum = wtk;     // dh + running sum of the horizontal divergence
  T top_k[NT], vtf_k[NT];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    top_k[n] = T(0);
    vtf_k[n] = T(0);
  }
  for (int k = 0; k < km; ++k) {
    const int kk = k + 1;
    const bool last = k == km - 1;
    const int lo = k * ls;
    const T dzk = dz[k], dzrk = dzr[k], dz2rk = dz2r[k];
    // face velocities (comp_flux_vel): a = u DYU dz, b = v DXU dz at the
    // four U corners
    auto lu = [&](int idx) { return ld_at(u + lo, idx); };
    auto lv = [&](int idx) { return ld_at(v + lo, idx); };
    const T a_c = u[lo + oc] * dyu_c * dzk, a_s = lu(is) * dyu_s * dzk;
    const T a_w = lu(iw) * dyu_w * dzk, a_sw = lu(isw) * dyu_sw * dzk;
    const T b_c = v[lo + oc] * dxu_c * dzk, b_w = lv(iw) * dxu_w * dzk;
    const T b_s = lv(is) * dxu_s * dzk, b_sw = lv(isw) * dxu_sw * dzk;
    const T ute = half * (a_c + a_s);
    const T utw = iw >= 0 ? half * (a_w + a_sw) : T(0);
    const T vtn = half * (b_c + b_w);
    const T vts = is >= 0 ? half * (b_s + b_sw) : T(0);
    const T cc = vtn - vts + ute - utw;
    wsum = wsum + cc * tarea;
    const bool below = k_c > kk;  // the level below is ocean
    const T wtkb = below ? wsum : T(0);
    const bool mask = k_c >= kk;

    // masked Laplacian coefficients
    const T cn = (mask && k_n >= kk) ? dtn_c : T(0);
    const T cs = (mask && k_s >= kk) ? dts_c : T(0);
    const T ce = (mask && k_e >= kk) ? dte_c : T(0);
    const T cw = (mask && k_w >= kk) ? dtw_c : T(0);
    const T ccd = -(cn + cs + ce + cw);
    const T dzwr_k = dzwr2[k];

    // upwind3 vertical coefficients of the level
    T tz[6] = {};
    if (UPW) {
#pragma unroll
      for (int q = 0; q < 6; ++q) tz[q] = vco[q * km + k];
    }
    // QUICKEST coefficients of the east and north faces of the column and
    // of its west and south neighbours (their east / north faces are the
    // column's west / south ones), read again each level (through the
    // read-only cache) rather than held in 24 registers
    T cx[6] = {}, cxw[6] = {}, cy[6] = {}, cys[6] = {};
    if (UPW) {
#pragma unroll
      for (int q = 0; q < 6; ++q) {
        cx[q] = __ldg(upw + q * ls + oc);
        cxw[q] = ld_at(upw + q * ls, iw);
        cy[q] = __ldg(upw + (6 + q) * ls + oc);
        cys[q] = ld_at(upw + (6 + q) * ls, is);
      }
    }
    const bool interior2 = kk < k_c - 1;
    const T azminus = interior2 ? tz[3] : tz[3] + tz[5];
    const T dzminus = interior2 ? tz[5] : T(0);

#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const T* tk = trn[n] + lo;
      auto X = [&](int idx) { return ld_at(tk, idx); };
      const T tc = tk[oc];
      const T t_e = X(ie), t_w = X(iw), t_n = X(in), t_s = X(is);
      const T tc_b = last ? T(0) : trn[n][lo + ls + oc];
      T ltk, bot;
      if (UPW) {
        // horizontal: upwind-biased face values
        const T t_ee = X(iee), t_ww = X(iww), t_nn = X(inn), t_ss = X(iss);
        const T ce_ = ute * tarea, cw_ = -utw * tarea;
        const T cn_ = vtn * tarea, cs_ = -vts * tarea;
        const T tr_e = quickest(ce_ > T(0), kk <= k_e, kk <= k_w,
                                kk <= k_ee, cx, t_e, tc, t_w, t_ee);
        const T tr_w = iw >= 0 ? quickest(utw * tarea_w > T(0), kk <= k_c,
                                          kk <= k_ww, kk <= k_e, cxw, tc,
                                          t_w, t_ww, t_e)
                               : T(0);
        const T tr_n = quickest(cn_ > T(0), kk <= k_n, kk <= k_s,
                                kk <= k_nn, cy, t_n, tc, t_s, t_nn);
        const T tr_s = is >= 0 ? quickest(vts * tarea_s > T(0), kk <= k_c,
                                          kk <= k_ss, kk <= k_n, cys, tc,
                                          t_s, t_ss, t_n)
                               : T(0);
        const T lh = (ce_ * tr_e + cw_ * tr_w + cn_ * tr_n + cs_ * tr_s) /
                     dzk;
        // vertical (QUICKEST through the level's bottom)
        const T t_km1 = k == 0 ? tc : trn[n][lo - ls + oc];
        const T t_kp1 = last ? tc : tc_b;
        const T t_kp2 = k + 2 < km ? trn[n][lo + 2 * ls + oc] : t_kp1;
        const T tplus = tz[0] * t_kp1 + tz[1] * tc + tz[2] * t_km1;
        const T tminus = azminus * t_kp1 + tz[4] * tc + dzminus * t_kp2;
        const T auxb = last ? T(0)
                            : (wtkb - fabs(wtkb)) * tplus +
                                  (wtkb + fabs(wtkb)) * tminus;
        const T aux = top_k[n];
        T vert = dz2rk * (aux - auxb);
        if (k == 0 && !varthick)
          vert = wtk * tc / dzk - half * auxb / dzk;
        ltk = mask ? lh + vert : T(0);
        bot = auxb;
      } else {
        // centered (advt_centered)
        ltk = half * (cc * tc + vtn * t_n - vts * t_s + ute * t_e
                      - utw * t_w) * tarea * dzrk;
        const T top =
            k == 0 ? (varthick ? T(0) : T(2) * wtk * tc) : top_k[n];
        bot = last ? T(0) : wtkb * (tc + tc_b);
        ltk = ltk + dz2rk * (top - bot);
      }

      // Laplacian diffusion of the mixing-time tracer (hdifft_del2)
      T hdtk = T(0);
      if (DEL2) {
        const T* tmk = tmn[n] + lo;
        hdtk = ah * (ccd * tmk[oc] + cn * ld_at(tmk, in) +
                     cs * ld_at(tmk, is) + ce * ld_at(tmk, ie) +
                     cw * ld_at(tmk, iw));
      }

      // explicit vertical diffusion of the old-time tracer (vdifft)
      const T to_c = ton[n][lo + oc];
      const T to_b = last ? T(0) : ton[n][lo + ls + oc];
      const T vtfb = below ? vdn[n][lo + oc] * (to_c - to_b) * dzwr_k : T(0);
      const T vtf = k == 0 ? (mask ? stf[(n0 + n) * ls + oc] : T(0))
                           : vtf_k[n];
      const T vdf = mask ? (vtf - vtfb) * dzrk : T(0);

      out[(n0 + n) * ts + (lo + oc)] = hdtk - ltk + vdf;
      top_k[n] = bot;
      vtf_k[n] = vtfb;
    }
    wtk = wtkb;
  }
}

template <typename T, int NT, bool DEL2, bool UPW>
struct TracerColInstance {
  static int occupancy() {
    return blocks_per_sm(tracer_col_kernel<T, NT, DEL2, UPW>,
                         kFrameCols * kColRows, 0);
  }
};

template <typename T, int NT, bool DEL2>
struct TracerInstance {
  static cudaError_t prepare(long smem) {
    return allow_large_smem(tracer_kernel<T, NT, DEL2>, smem);
  }
  static int occupancy(long smem) {
    const cudaError_t e = prepare(smem);
    if (e != cudaSuccess) return -(int)e;
    return blocks_per_sm(tracer_kernel<T, NT, DEL2>, kThreadsTile, smem);
  }
};

// The launch configuration the wrapper chose: a group of ng tracers from
// n0 of nt, `rows` rows of kFrameCols columns, `smem` bytes of dynamic
// shared memory; level offsets in int.
template <typename T>
bool tracer_config_ok(int ng, int n0, int nt, int km, int ny, int nx,
                      bool del2, int rows, long smem) {
  return ng >= 1 && ng <= kMaxGroup && n0 >= 0 && n0 + ng <= nt && km >= 1 &&
         (long)km * ny * nx < (1L << 31) && rows == kRows &&
         smem >= (long)tracer_smem_values(ng, del2) * (long)sizeof(T);
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
// (the planner's count, tracer_cuda.smem_values).
extern "C" int pop2_tracer_smem_values(int ng, int with_del2) {
  return pop2::tracer_smem_values(ng, with_del2 != 0);
}

extern "C" int pop2_tracer_tile_rows() { return pop2::kRows; }

extern "C" int pop2_tracer_max_group() { return pop2::kMaxGroup; }

#define POP2_TRACER_COL_INSTANCES(T, ACTION)                                 \
  if (ng == 1 && del2 && quick)                                              \
    ACTION(T, 1, true, true)                                                 \
  else if (ng == 1 && del2)                                                  \
    ACTION(T, 1, true, false)                                                \
  else if (ng == 1 && quick)                                                 \
    ACTION(T, 1, false, true)                                                \
  else if (ng == 1)                                                          \
    ACTION(T, 1, false, false)                                               \
  else if (del2 && quick)                                                    \
    ACTION(T, 2, true, true)                                                 \
  else if (del2)                                                             \
    ACTION(T, 2, true, false)                                                \
  else if (quick)                                                            \
    ACTION(T, 2, false, true)                                                \
  else                                                                       \
    ACTION(T, 2, false, false)

// dtype: 0 = float32, 1 = float64; with_del2 = 0 selects the advection +
// vertical-diffusion instance (tmix and ah are then not read). One launch
// computes the ng tracers n0 .. n0+ng-1 of nt (the pointers are those of
// all nt); cyclic: the east-west edge wraps; fold: the north edge is a
// tripole fold; upwind3: QUICKEST advection (upw: its 12 horizontal
// coefficient planes, vco: its 6 vertical coefficient rows of km; not read
// for centered advection). With fold or upwind3 the column kernel runs
// (rows = its block's rows, smem = 0), else the staged-tile kernel (rows:
// rows of the tile; smem: dynamic shared memory a block, bytes). Returns
// cudaGetLastError() of the launch, or cudaErrorInvalidValue for a
// configuration the kernel does not take.
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
                           const void* vco, double ah, void* out,
                           void* stream) {
  using namespace pop2;
  const bool del2 = with_del2 != 0, column = fold || upwind3;
  if (column) {
    if (!(ng >= 1 && ng <= kMaxGroup && n0 >= 0 && n0 + ng <= nt &&
          km >= 1 && (long)km * ny * nx < (1L << 31) && rows == kColRows &&
          smem == 0))
      return (int)cudaErrorInvalidValue;
  } else if (!(dtype == 0 ? tracer_config_ok<float>(ng, n0, nt, km, ny, nx,
                                                    del2, rows, smem)
                          : tracer_config_ok<double>(ng, n0, nt, km, ny, nx,
                                                     del2, rows, smem))) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((unsigned)((nx + kFrameCols - 1) / kFrameCols),
                  (unsigned)((ny + rows - 1) / rows));
  const dim3 block(kFrameCols, rows);
  cudaStream_t s = (cudaStream_t)stream;
#define POP2_TRACER(T, NT, DEL2)                                             \
  {                                                                          \
    const cudaError_t e = TracerInstance<T, NT, DEL2>::prepare(smem);        \
    if (e != cudaSuccess) return (int)e;                                     \
    tracer_kernel<T, NT, DEL2><<<grid, block, smem, s>>>(                    \
        n0, km, ny, nx, cyclic, varthick, (const T*)u, (const T*)v,          \
        (const T*)trcr, (const T*)tmix, (const T*)told, (const T*)vdc,       \
        (const T*)stf, (const T*)dh, kmt, (const T*)dyu, (const T*)dxu,      \
        (const T*)tarea_r, (const T*)dtn, (const T*)dts, (const T*)dte,      \
        (const T*)dtw, (const T*)dz, (const T*)dzr, (const T*)dz2r,          \
        (const T*)dzwr2, (T)ah, (T*)out);                                    \
  }
#define POP2_TRACER_COL(T, NT, DEL2, UPW)                                    \
  tracer_col_kernel<T, NT, DEL2, UPW><<<grid, block, 0, s>>>(                \
      n0, km, ny, nx, cyclic, fold, varthick, (const T*)u, (const T*)v,      \
      (const T*)trcr, (const T*)tmix, (const T*)told, (const T*)vdc,         \
      (const T*)stf, (const T*)dh, kmt, (const T*)dyu, (const T*)dxu,        \
      (const T*)tarea_r, (const T*)dtn, (const T*)dts, (const T*)dte,        \
      (const T*)dtw, (const T*)dz, (const T*)dzr, (const T*)dz2r,            \
      (const T*)dzwr2, (const T*)upw, (const T*)vco, (T)ah, (T*)out);
  const bool quick = upwind3 != 0;
  if (column) {
    if (dtype == 0) {
      POP2_TRACER_COL_INSTANCES(float, POP2_TRACER_COL)
    } else {
      POP2_TRACER_COL_INSTANCES(double, POP2_TRACER_COL)
    }
  } else if (dtype == 0) {
    POP2_TRACER_INSTANCES(float, POP2_TRACER)
  } else {
    POP2_TRACER_INSTANCES(double, POP2_TRACER)
  }
#undef POP2_TRACER
#undef POP2_TRACER_COL
  return (int)cudaGetLastError();
}

extern "C" int pop2_tracer_col_rows() { return pop2::kColRows; }

// Blocks of the column kernel's launch for a group of ng tracers that one
// SM holds at once.
extern "C" int pop2_tracer_col_blocks_per_sm(int dtype, int with_del2,
                                             int ng, int upwind3) {
  using namespace pop2;
  const bool del2 = with_del2 != 0, quick = upwind3 != 0;
  if (ng < 1 || ng > kMaxGroup) return -(int)cudaErrorInvalidValue;
#define POP2_TRACER_COL_OCC(T, NT, DEL2, UPW)                                \
  return TracerColInstance<T, NT, DEL2, UPW>::occupancy();
  if (dtype == 0) {
    POP2_TRACER_COL_INSTANCES(float, POP2_TRACER_COL_OCC)
  } else {
    POP2_TRACER_COL_INSTANCES(double, POP2_TRACER_COL_OCC)
  }
#undef POP2_TRACER_COL_OCC
  return -(int)cudaErrorInvalidValue;  // not reached: every case returns
}
#undef POP2_TRACER_COL_INSTANCES

// Blocks of a launch of this configuration (a group of ng tracers, with the
// Laplacian or without, `smem` bytes a block) that one SM holds at once.
extern "C" int pop2_tracer_blocks_per_sm(int dtype, int with_del2, int ng,
                                         long smem) {
  using namespace pop2;
  const bool del2 = with_del2 != 0;
  if (ng < 1 || ng > kMaxGroup) return -(int)cudaErrorInvalidValue;
#define POP2_TRACER_OCC(T, NT, DEL2)                                         \
  return TracerInstance<T, NT, DEL2>::occupancy(smem);
  if (dtype == 0) {
    POP2_TRACER_INSTANCES(float, POP2_TRACER_OCC)
  } else {
    POP2_TRACER_INSTANCES(double, POP2_TRACER_OCC)
  }
#undef POP2_TRACER_OCC
  return -(int)cudaErrorInvalidValue;  // not reached: every case returns
}
#undef POP2_TRACER_INSTANCES
