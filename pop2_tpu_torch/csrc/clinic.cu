// Fused momentum forcing of one baroclinic step (clinic,
// source/baroclinic.F90:1635-1895):
//   fx = -L(u) + f (wc v_cur + wo v_old) - PKX + am Lap(u, v) + D_v(u_old)
//   fy = -L(v) - f (wc u_cur + wo u_old) - PKY + am Lap(v,-u) + D_v(v_old)
// masked to ocean U points, plus the thickness-weighted vertical means
// ZX, ZY = HUR * sum_k f dz_k (source/baroclinic.F90:1035-1057). It fuses
// advu (source/advection.F90:1127), gradp (source/pressure_grad.F90:185),
// hdiffu_del2 (source/hmix_del2.F90:892) and vdiffu
// (source/vertical_mix.F90:853).
//
// Replaces the TPU kernel clinic_pallas.py `_kernel` / `clinic_rhs_tiles`:
// with the Laplacian friction (HDIFFU, the dynamical-core path) or without
// it (with_hdiffu=False: the anisotropic friction is added outside, so um,
// vm and the ten weights are not read), with a closed or a tripole north
// edge.
//
// Bound on this card: bytes. Minimum traffic is six distinct 3-D inputs (u, v
// at two times, the averaged density, the viscosity; the model passes one of
// the two velocity pairs again as the mixing-time pair) and two 3-D outputs,
// plus 24 2-D fields; about 150 flops per output pair. The design keeps the
// bytes in flight and reads each value once a level:
//   - a block is a tile of kFrameCols x kRows columns (a warp a row, one
//     thread a column) in a one-column frame (common.cuh `Frame`), walking
//     down k;
//   - each level is staged in shared memory by `cp.async`: u, v on the
//     whole frame three levels ahead (four buffers), um, vm on the tile and
//     its N, S, E, W sides, the averaged density on the tile and its N, E,
//     NE frame, uo, vo and the viscosity on the tile two levels ahead (three
//     buffers); the copies of one level are in flight while a level is
//     computed (a second level in flight was measured no faster); a tile stops
//     staging past its deepest column's bottom, so like the one-column
//     design it reads little below the sea floor;
//   - the U-face velocities take two exchanges: every frame column forms
//     a = u DYU dz and b = v DXU dz once, two levels ahead, and publishes
//     them; every column then forms its west face uuw and south face vus
//     from its neighbours' a and b, one level ahead, and publishes them; a
//     column takes uue and vun from its east and north neighbours (zero
//     at a closed edge). Both exchanges are double-buffered, so one barrier
//     a level orders them; the frame's E column and N row are formed by the
//     first warps' threads besides their own;
//   - down k in registers: u, v at k-1 and k, uo, vo at k (each read as the
//     level below of the level before), the continuity sum for w at U
//     points, the running vertical integral of the density gradient with
//     the half-level factors, the vertical-friction flux through the
//     level's top, and the ZX/ZY sums. A thread owns its whole column, so
//     ZX/ZY need no reduction across threads and are deterministic. The ten
//     Laplacian weights of a column sit in its slots of shared memory.
// The tile's rows are a compile-time constant (8 in float32; 6 in float64,
// measured faster than 8 there), so that every shared-memory address is a
// register plus an immediate offset.
// Levels below the column's bottom write zero and skip the arithmetic.
// Closed edges read zero (copies of nothing, zero metrics); a cyclic edge
// wraps inside the frame; the ragged last tiles are masked. On a tripole
// grid (`fold`) the frame's north ghost row is copied from the folded
// points (common.cuh `fold_point`, `fold` the rows through the fold's top
// row), in other tiles: u, v, um, vm and DYU,
// DXU as NE-corner fields, the density as a centre one; u and v are
// vectors, so their ghost values flip sign where they are read (the a, b
// fluxes of the ghost slots, the top row's north neighbour). The ghost
// row's south-face flux vus is not formed from the frame: it is the fold
// of an E-face vector, -vus of row ny - 1 at column nx - 2 - i, formed from
// v and DXU read at that column (advect.advu's `bc.n(vus, "eface",
// "vector")`). The block shape and the dynamic shared memory come from the
// wrapper's planner (`clinic_cuda.launch_plan`).
//
// Partial bottom cells (the PBC instances): a U column's thickness is dz but
// at its bottom level k = KMU - 1, where it is the plane DZBU. The fluxes
// a = u DYU dzu, b = v DXU dzu take each frame point's own thickness, so
// KMU and DZBU are staged on the frame once a tile beside DYU and DXU
// (where the fold's ghost row reads its folded points, so do they). At the
// column's bottom level the quotients by the thickness (advu's, vdiffu's)
// take 1/DZBU and 1/(2 DZBU) in place of the level table's dzr and dz2r,
// the spacing above it is 1/((dz + DZBU)/2), all formed once a column, and
// ZX/ZY weight the level by DZBU. The full-cell instances' arithmetic is
// untouched by the mode, bitwise.
#include "common.cuh"

namespace pop2 {

// order of the stacked 2-D metric operand (clinic_cuda.G2D)
enum G2D {
  G_DYU, G_DXU, G_UAREA_R, G_FCOR, G_KXU, G_KYU, G_DXUR, G_DYUR, G_DUCM,
  G_DUN, G_DUS, G_DUE, G_DUW, G_DMC, G_DMN, G_DMS, G_DME, G_DMW, G_HUR,
  G_COUNT
};
// the Laplacian weights DUCM .. DMW, a column's constants in shared memory
constexpr int kWeights = G_DMW - G_DUCM + 1;

using ClinicFrame = Frame<1>;

// The tile and its shared memory, in values: the DYU, DXU frame planes;
// four staged levels of u, v (frame planes); three of um, vm, the density
// (frame planes) and uo, vo, the viscosity (tile planes); two buffers of
// a, b and two of uuw, vus (frame planes); the Laplacian weights. The
// register budget is set for 3 blocks an SM in float32 (4 blocks, at 64
// registers, were measured slower) and 2 in float64.
// PBC: two more metric planes, KMU (as values) and DZBU.
template <typename T, bool PBC = false>
struct ClinicTile {
  static constexpr int kRows = sizeof(T) == 4 ? 8 : 6;
  static constexpr int kThreads = kFrameCols * kRows;
  static constexpr int kMinBlocks = sizeof(T) == 4 ? 3 : 2;
  static constexpr int kP = ClinicFrame::plane(kRows);  // a frame plane
  static constexpr int kC = kThreads;                   // a tile plane
  static constexpr int kMet = PBC ? 4 : 2;              // metric planes
  static constexpr int kRest = 3 * kP + 3 * kC;         // a level of the rest
  static constexpr int kValues =
      kMet * kP + 4 * 2 * kP + 3 * kRest + 2 * 2 * kP + 2 * 2 * kP +
      kWeights * kC;
  static_assert(ClinicFrame::covered(kRows), "a frame slot without a copier");
};

template <typename T, bool HDIFFU, bool PBC>
__global__ void __launch_bounds__(ClinicTile<T>::kThreads,
                                  ClinicTile<T>::kMinBlocks)
clinic_kernel(int km, int ny, int nx, int cyclic, int fold,
              const T* __restrict__ uc, const T* __restrict__ vc,
              const T* __restrict__ uo, const T* __restrict__ vo,
              const T* __restrict__ um, const T* __restrict__ vm,
              const T* __restrict__ ra, const T* __restrict__ vvc,
              const T* __restrict__ g2d, const int* __restrict__ kmu,
              const T* __restrict__ dhu, const T* __restrict__ smf,
              const T* __restrict__ dz, const T* __restrict__ dzr,
              const T* __restrict__ dz2r, const T* __restrict__ dzwr2,
              const T* __restrict__ facs, T am, T bdrag, T wcor_c, T wcor_o,
              T* __restrict__ fx, T* __restrict__ fy, T* __restrict__ zx,
              T* __restrict__ zy, const T* __restrict__ dzbu) {
  using Tile = ClinicTile<T, PBC>;
  constexpr int W = ClinicFrame::kPitch, P = Tile::kP, C = Tile::kC;
  constexpr int kRows = Tile::kRows;
  extern __shared__ __align__(16) unsigned char pop2_smem[];
  const int tid = threadIdx.y * kFrameCols + threadIdx.x;
  const int ls = ny * nx;  // level stride (km * ny * nx < 2^31: C entry)
  // DYU, DXU and with PBC KMU and DZBU: (Tile::kMet, P)
  T* met = reinterpret_cast<T*>(pop2_smem);
  T* uvb = met + Tile::kMet * P;             // (4 buffers, u / v, P)
  T* rst = uvb + 4 * 2 * P;                  // (3 buffers, Tile::kRest)
  T* pab = rst + 3 * Tile::kRest;            // (2 buffers, a / b, P)
  T* pfc = pab + 2 * 2 * P;                  // (2 buffers, uuw / vus, P)
  T* wts = pfc + 2 * 2 * P;                  // (kWeights, C)
  // u (p = 0), v (1) of the level in u, v buffer b
  auto uv = [&](int b, int p) { return uvb + (b * 2 + p) * P; };
  // um, vm, density (frame planes p = 0-2) of the level in rest buffer b
  auto rs = [&](int b, int p) { return rst + b * Tile::kRest + p * P; };
  // uo, vo, viscosity (tile planes p = 0-2) of the level in rest buffer b
  auto rc = [&](int b, int p) {
    return rst + b * Tile::kRest + 3 * P + p * C;
  };

  const int x0 = blockIdx.x * kFrameCols, y0 = blockIdx.y * kRows;
  const int s = (threadIdx.y + 1) * W + threadIdx.x + 1;  // own slot
  const int gi = x0 + threadIdx.x, gj = y0 + threadIdx.y;
  const bool live = gi < nx && gj < ny;  // the column writes output
  const int oc = live ? gj * nx + gi : 0;

  // the frame slots this thread copies (u, v: all of them), at the offset
  // of a U-point field (soff) and of the density (doff; they differ on the
  // tripole ghost row); bit 0: inside the domain, bit 1: um, vm (tile, N,
  // S, E, W sides), bit 2: the density (tile, N row, E column), bit 3: a
  // folded ghost slot (u, v flip sign)
  int soff[kFrameSlots], doff[kFrameSlots];
  unsigned sflag[kFrameSlots];
#pragma unroll
  for (int j = 0; j < kFrameSlots; ++j) {
    const int q = tid + j * Tile::kThreads;
    int r = 0, c = 0, off = 0, offc = 0;
    bool folded = false;
    const bool in = q < P && frame_slot<1>(q, y0, x0, ny, nx, cyclic, &r,
                                           &c, &off, fold, kFoldCorner,
                                           &folded);
    if (q < P)
      frame_slot<1>(q, y0, x0, ny, nx, cyclic, &r, &c, &offc, fold,
                    kFoldCenter);
    const bool row_in = r >= 1 && r <= kRows;
    const bool col_in = c >= 1 && c <= kFrameCols;
    const bool plus = HDIFFU && (row_in || col_in);
    const bool dens = r >= 1 && c >= 1;
    soff[j] = off;
    doff[j] = offc;
    sflag[j] = (unsigned)in | (unsigned)plus << 1 | (unsigned)dens << 2 |
               (unsigned)folded << 3;
    if (q < P) {  // the face metrics, zero outside the domain
      met[q] = in ? g2d[G_DYU * ls + off] : T(0);
      met[P + q] = in ? g2d[G_DXU * ls + off] : T(0);
      if (PBC) {
        met[2 * P + q] = in ? T(kmu[off]) : T(0);
        met[3 * P + q] = in ? dzbu[off] : T(0);
      }
    }
  }
  // the frame's N row (vus) and E column (uuw): one extra slot each for the
  // first kFrameCols + kRows threads
  const bool h_north = tid < kFrameCols;
  const int hq = h_north ? (kRows + 1) * W + tid + 1
                         : (tid < kFrameCols + kRows
                                ? (tid - kFrameCols + 1) * W + kFrameCols + 1
                                : -1);
  // slots on the tripole ghost row, whose vus is the fold's (vus_fold):
  // the thread's own (a ragged tile's row past the domain) and its N-row one
  const bool own_ghost = fold && gj == ny && gi < nx;
  const bool hq_ghost = h_north && fold && y0 + kRows == ny && x0 + tid < nx;

  // start the copies of u, v at level L (the whole frame) into buffer b
  auto stage_uv = [&](int L, int b) {
    if (L >= km) return;
    const int lo = L * ls;
#pragma unroll
    for (int j = 0; j < kFrameSlots; ++j) {
      const int q = tid + j * Tile::kThreads;
      if (q >= P) continue;
      const bool in = sflag[j] & 1u;
      cp_async(uv(b, 0) + q, uc + (lo + soff[j]), in);
      cp_async(uv(b, 1) + q, vc + (lo + soff[j]), in);
    }
  };
  // start the copies of the rest of level L into buffer b
  auto stage_rest = [&](int L, int b) {
    if (L >= km) return;
    const int lo = L * ls;
#pragma unroll
    for (int j = 0; j < kFrameSlots; ++j) {
      const int q = tid + j * Tile::kThreads;
      if (q >= P) continue;
      const bool in = sflag[j] & 1u;
      const int o = lo + soff[j];
      if (sflag[j] & 2u) {
        cp_async(rs(b, 0) + q, um + o, in);
        cp_async(rs(b, 1) + q, vm + o, in);
      }
      if (sflag[j] & 4u) cp_async(rs(b, 2) + q, ra + (lo + doff[j]), in);
    }
    if (live) {
      const int o = lo + oc;
      cp_async(rc(b, 0) + tid, uo + o, true);
      cp_async(rc(b, 1) + tid, vo + o, true);
      cp_async(rc(b, 2) + tid, vvc + o, true);
    }
  };

  const T half = T(0.5), quarter = T(0.25), eighth = T(0.125);
  // publish a = u DYU dz, b = v DXU dz of level L from u, v buffer b on the
  // thread's slots
  auto fluxes = [&](int L, int b) {
    const T* su = uv(b, 0);
    const T* sv = uv(b, 1);
    T* pa = pab + (L & 1) * 2 * P;
    T* pb = pa + P;
    const T dzl = dz[L];
#pragma unroll
    for (int j = 0; j < kFrameSlots; ++j) {
      const int q = tid + j * Tile::kThreads;
      if (q >= P) continue;
      // the thickness of the frame point at level L
      const T dzq =
          (PBC && met[2 * P + q] == T(L + 1)) ? met[3 * P + q] : dzl;
      const T fa = su[q] * met[q] * dzq, fb = sv[q] * met[P + q] * dzq;
      const bool neg = sflag[j] & 8u;  // the fold of a vector
      pa[q] = neg ? -fa : fa;
      pb[q] = neg ? -fb : fb;
    }
  };
  // the tripole ghost row's south-face flux at column gi: the fold of vus
  // as an E-face vector, -vus(fold - 1, nx - 2 - gi) (the fold's top row),
  // from v and DXU of level L read where they lie
  auto vus_fold = [&](int L, int col) {
    const int j = fold - 1, fi = col == nx - 1 ? nx - 1 : nx - 2 - col;
    const T dzl = dz[L];
    auto bat = [&](int jj, int ii) {
      if (ii < 0 || ii >= nx) {
        if (!cyclic) return T(0);
        ii = ii < 0 ? ii + nx : ii - nx;
      }
      if (jj < 0) return T(0);
      const int o = jj * nx + ii;
      const T dzo = (PBC && kmu[o] == L + 1) ? dzbu[o] : dzl;
      return vc[L * ls + o] * g2d[G_DXU * ls + o] * dzo;
    };
    return -(quarter * (bat(j, fi) + bat(j - 1, fi))
             + eighth * (bat(j, fi - 1) + bat(j - 1, fi - 1)
                         + bat(j, fi + 1) + bat(j - 1, fi + 1)));
  };
  // 4-point averages of T-face fluxes onto the U-cell faces
  // (source/advection.F90:1245-1339): publish the west face uuw and the
  // south face vus of level L, of the thread's own slot and of its E-column
  // (uuw) or N-row (vus) slot
  auto faces = [&](int L) {
    const T* a = pab + (L & 1) * 2 * P;
    const T* b = a + P;
    T* pw = pfc + (L & 1) * 2 * P;
    T* ps = pw + P;
    auto uuw = [&](int q) {
      return quarter * (a[q] + a[q - 1])
          + eighth * (a[q - W] + a[q - W - 1] + a[q + W] + a[q + W - 1]);
    };
    auto vus = [&](int q) {
      return quarter * (b[q] + b[q - W])
          + eighth * (b[q - 1] + b[q - W - 1] + b[q + 1] + b[q - W + 1]);
    };
    pw[s] = uuw(s);
    ps[s] = own_ghost ? vus_fold(L, gi) : vus(s);
    if (h_north)
      ps[hq] = hq_ghost ? vus_fold(L, x0 + tid) : vus(hq);
    else if (hq >= 0)
      pw[hq] = uuw(hq);
  };

  // 2-D operands of the column; on a tripole grid the top row's north
  // neighbour is the fold of a vector (sgn_n)
  const T sgn_n = (fold && gj == ny - 1) ? T(-1) : T(1);
  bool ve = false, vn = false;
  int kmu_c = 0;
  T uarear = T(0), fcor = T(0), kxu = T(0), kyu = T(0), dxur = T(0),
    dyur = T(0), dhu_c = T(0), vuf = T(0), vvf = T(0);
  // PBC: the bottom level's thickness, its quotients (1/dzb and 1/(2 dzb),
  // the level table's dzr and dz2r of the bottom level) and the spacing
  // 1/((dz + dzb)/2) above it, formed once a column
  T dzb = T(1), dzbr = T(1), dzb2r = T(1), dzwr_b = T(1);
  if (live) {
    if (PBC) {
      dzb = dzbu[oc];
      dzbr = T(1) / dzb;
      dzb2r = T(0.5) / dzb;
      const int kmu_o = kmu[oc];
      if (kmu_o >= 2) dzwr_b = T(1) / (T(0.5) * (dz[kmu_o - 2] + dzb));
    }
    Column c;
    locate_at(ny, nx, cyclic, gj, gi, &c, fold);
    ve = c.ve;
    vn = c.vn;
    kmu_c = kmu[oc];
    uarear = g2d[G_UAREA_R * ls + oc];
    fcor = g2d[G_FCOR * ls + oc];
    kxu = g2d[G_KXU * ls + oc];
    kyu = g2d[G_KYU * ls + oc];
    dxur = g2d[G_DXUR * ls + oc];
    dyur = g2d[G_DYUR * ls + oc];
    dhu_c = dhu[oc];
    // friction flux through the top: the wind stress at the surface
    vuf = (kmu_c >= 1) ? smf[oc] : T(0);
    vvf = (kmu_c >= 1) ? smf[ls + oc] : T(0);
    if (HDIFFU) {
#pragma unroll
      for (int q = 0; q < kWeights; ++q)
        wts[q * C + tid] = g2d[(G_DUCM + q) * ls + oc];
    }
  }
  auto weight = [&](int g) { return wts[(g - G_DUCM) * C + tid]; };

  // carries down the column
  T wuk = dhu_c;   // w at the top of the U box
  T wsum = dhu_c;  // dhu + running sum of the horizontal divergence
  T rkx_p = T(0), rky_p = T(0);  // density gradient of the level above
  T pkx = T(0), pky = T(0);      // running pressure-gradient integral
  T zxa = T(0), zya = T(0);

  // ---- down the column -----------------------------------------------------
  // level L of u, v in buffer L % 4 and of the rest in L % 3, kept as
  // rotating indices: u0 .. u3 the buffers of levels k .. k+3, r0 .. r2
  // those of k .. k+2
  int u0 = 0, u1 = 1, u2 = 2, u3 = 3, r0 = 0, r1 = 1, r2 = 2;
  stage_uv(0, u0);
  stage_uv(1, u1);
  stage_rest(0, r0);
  cp_async_commit();
  stage_uv(2, u2);
  stage_rest(1, r1);
  cp_async_commit();
  cp_async_wait<1>();  // levels 0 and 1 of u, v and 0 of the rest: own
  // ... and everyone's, with the metric planes; whether a column of the
  // tile reaches level 2 (levels at or past the tile's deepest bottom are
  // neither staged nor formed: they would only feed zeros)
  bool reach2 = __syncthreads_or(kmu_c >= 2);
  fluxes(0, u0);
  if (km > 1) fluxes(1, u1);
  __syncthreads();
  faces(0);
  T u_p = T(0), v_p = T(0);  // u, v at k-1
  T u_k = live ? uv(u0, 0)[s] : T(0), v_k = live ? uv(u0, 1)[s] : T(0);
  T uo_k = live ? rc(r0, 0)[tid] : T(0), vo_k = live ? rc(r0, 1)[tid] : T(0);
  for (int k = 0; k < km; ++k) {
    // u, v of level k+2 and the rest of level k+1 have landed everywhere;
    // a, b of level k+1 and the faces of level k are published; every
    // thread is done with level k-1's buffers (reach2: a column of the tile
    // reaches level k+2, KMU >= k+2, and reads its u, v and uo, vo as the
    // level below its bottom level)
    cp_async_wait<0>();
    const bool reach3 = __syncthreads_or(kmu_c >= k + 3);
    if (reach3) stage_uv(k + 3, u3);
    if (reach2) stage_rest(k + 2, r2);
    cp_async_commit();
    if (reach3 && k + 2 < km) fluxes(k + 2, u2);
    if (reach2 && k + 1 < km) faces(k + 1);
    reach2 = reach3;
    const int ub = u0, rb = r0;
    u0 = u1;
    u1 = u2;
    u2 = u3;
    u3 = ub;
    r0 = r1;
    r1 = r2;
    r2 = rb;
    if (!live) continue;
    // level k is in buffers ub, rb now, level k+1 in u0, r0

    const int ko = k * ls + oc;
    if (kmu_c < k + 1) {  // below the bottom: masked, nothing carries on
      fx[ko] = T(0);
      fy[ko] = T(0);
      continue;
    }
    const bool last = k == km - 1;
    const bool bot_k = PBC && k + 1 == kmu_c;  // the partial bottom level
    const T dzk = bot_k ? dzb : dz[k], dzrk = bot_k ? dzbr : dzr[k];
    const T dz2rk = bot_k ? dzb2r : dz2r[k];
    const T* uk = uv(ub, 0);
    const T* vk = uv(ub, 1);
    const T u_b = last ? T(0) : uv(u0, 0)[s];
    const T v_b = last ? T(0) : uv(u0, 1)[s];
    const T uo_b = last ? T(0) : rc(r0, 0)[tid];
    const T vo_b = last ? T(0) : rc(r0, 1)[tid];

    // U-face volume fluxes; the east face is the west face of the column
    // at i+1, the north face the south face of the one at j+1
    const T* pw = pfc + (k & 1) * 2 * P;
    const T* ps = pw + P;
    const T uuw = pw[s];
    const T uue = ve ? pw[s + 1] : T(0);
    const T vus = ps[s];
    const T vun = vn ? ps[s + W] : T(0);

    const T cc = vun - vus + uue - uuw;
    wsum = wsum + cc * uarear;
    const T wukb = wsum;  // w at the bottom of the U box, by continuity

    // momentum advection with metric terms (advu)
    const T u = u_k, v = v_k;
    T luk = half * (cc * u + vun * (sgn_n * uk[s + W]) - vus * uk[s - W]
                    + uue * uk[s + 1] - uuw * uk[s - 1]) * uarear * dzrk;
    T lvk = half * (cc * v + vun * (sgn_n * vk[s + W]) - vus * vk[s - W]
                    + uue * vk[s + 1] - uuw * vk[s - 1]) * uarear * dzrk;
    T top_u, top_v, bot_u, bot_v;
    if (k == 0) {
      top_u = dzrk * wuk * u;
      top_v = dzrk * wuk * v;
    } else {
      top_u = dz2rk * wuk * (u_p + u);
      top_v = dz2rk * wuk * (v_p + v);
    }
    if (last) {
      bot_u = T(0);
      bot_v = T(0);
    } else {
      bot_u = dz2rk * wukb * (u + u_b);
      bot_v = dz2rk * wukb * (v + v_b);
    }
    luk = luk + top_u - bot_u + u * v * kyu - v * v * kxu;
    lvk = lvk + top_v - bot_v + u * v * kxu - u * u * kyu;

    // Coriolis with the time-centring weights (baroclinic.F90:971-995)
    const T uo_c = uo_k, vo_c = vo_k;
    const T cor_x = fcor * (wcor_c * v + wcor_o * vo_c);
    const T cor_y = -fcor * (wcor_c * u + wcor_o * uo_c);

    // pressure gradient: running vertical integral of the gradient of the
    // averaged density at the N, E, NE T points around the U point
    // (pressure_grad.F90:262-296)
    const T* rk = rs(rb, 2);
    const T f = rk[s];
    const T f_n = rk[s + W], f_e = rk[s + 1], f_ne = rk[s + W + 1];
    const T rkx = dxur * half * (f_ne - f - f_n + f_e);
    const T rky = dyur * half * (f_ne - f + f_n - f_e);
    if (k == 0) {
      rkx_p = rkx;
      rky_p = rky;
    }
    const T fac = facs[k];
    pkx = pkx + fac * (rkx + rkx_p);
    pky = pky + fac * (rky + rky_p);
    rkx_p = rkx;
    rky_p = rky;

    // Laplacian friction with the U/V metric mixing (hdiffu_del2)
    T hduk = T(0), hdvk = T(0);
    if (HDIFFU) {
      const T* umk = rs(rb, 0);
      const T* vmk = rs(rb, 1);
      const T um_c = umk[s], vm_c = vmk[s];
      const T nu = sgn_n * umk[s + W], nv = sgn_n * vmk[s + W];
      const T su = umk[s - W], sv = vmk[s - W];
      const T eu = umk[s + 1], ev = vmk[s + 1];
      const T wu = umk[s - 1], wv = vmk[s - 1];
      const T ducm = weight(G_DUCM), dun = weight(G_DUN);
      const T dus = weight(G_DUS), due = weight(G_DUE), duw = weight(G_DUW);
      const T lap_u = ducm * um_c + dun * nu + dus * su + due * eu + duw * wu;
      const T lap_v = ducm * vm_c + dun * nv + dus * sv + due * ev + duw * wv;
      const T dmc = weight(G_DMC), dmn = weight(G_DMN);
      const T dms = weight(G_DMS), dme = weight(G_DME), dmw = weight(G_DMW);
      const T mix_u = dmc * um_c + dmn * nu + dms * su + dme * eu + dmw * wu;
      const T mix_v = dmc * vm_c + dmn * nv + dms * sv + dme * ev + dmw * wv;
      hduk = am * (lap_u + mix_v);
      hdvk = am * (lap_v - mix_u);
    }

    // explicit vertical friction: quadratic drag at the bottom level
    // (vertical_mix.F90:853-1026)
    T vufb, vvfb;
    if (k + 1 == kmu_c) {
      const T vmag = bdrag * sqrt(uo_c * uo_c + vo_c * vo_c);
      vufb = vmag * uo_c;
      vvfb = vmag * vo_c;
    } else {
      // the spacing below the level: the bottom level's thickness enters
      // the one above it
      const T w = rc(rb, 2)[tid] * ((PBC && k + 2 == kmu_c) ? dzwr_b
                                                             : dzwr2[k]);
      vufb = w * (uo_c - uo_b);
      vvfb = w * (vo_c - vo_b);
    }
    const T du = (vuf - vufb) * dzrk;
    const T dv = (vvf - vvfb) * dzrk;
    vuf = vufb;
    vvf = vvfb;

    const T fxk = HDIFFU ? (((-luk + cor_x) - pkx) + hduk) + du
                         : ((-luk + cor_x) - pkx) + du;
    const T fyk = HDIFFU ? (((-lvk + cor_y) - pky) + hdvk) + dv
                         : ((-lvk + cor_y) - pky) + dv;
    fx[ko] = fxk;
    fy[ko] = fyk;
    zxa = zxa + fxk * dzk;
    zya = zya + fyk * dzk;
    wuk = wukb;
    u_p = u_k;
    v_p = v_k;
    u_k = u_b;
    v_k = v_b;
    uo_k = uo_b;
    vo_k = vo_b;
  }
  if (live) {
    const T hur = g2d[G_HUR * ls + oc];
    zx[oc] = hur * zxa;
    zy[oc] = hur * zya;
  }
}

template <typename T>
bool clinic_config_ok(int km, int ny, int nx, int rows, long smem, bool pbc) {
  const long values = pbc ? ClinicTile<T, true>::kValues
                          : ClinicTile<T, false>::kValues;
  return km >= 1 && (long)km * ny * nx < (1L << 31) &&
         rows == ClinicTile<T>::kRows && smem >= values * (long)sizeof(T);
}

}  // namespace pop2

extern "C" int pop2_clinic_g2d_count() { return pop2::G_COUNT; }

// The tile's rows and the values of dynamic shared memory it takes, by
// dtype and bottom cells (the planner's, clinic_cuda.TILE_ROWS and
// smem_values).
extern "C" int pop2_clinic_tile_rows(int dtype) {
  return dtype == 0 ? pop2::ClinicTile<float>::kRows
                    : pop2::ClinicTile<double>::kRows;
}
extern "C" int pop2_clinic_smem_values(int dtype, int pbc) {
  using namespace pop2;
  if (pbc)
    return dtype == 0 ? ClinicTile<float, true>::kValues
                      : ClinicTile<double, true>::kValues;
  return dtype == 0 ? ClinicTile<float, false>::kValues
                    : ClinicTile<double, false>::kValues;
}

// dtype: 0 = float32, 1 = float64; rows: rows of the tile; smem: dynamic
// shared memory a block, bytes. Returns cudaGetLastError() of the launch,
// or cudaErrorInvalidValue for a configuration the kernel does not take.
#define POP2_CLINIC_INSTANCES(T, ACTION) \
  if (hdiffu && pbc)                      \
    ACTION(T, true, true)                 \
  else if (hdiffu)                        \
    ACTION(T, true, false)                \
  else if (pbc)                           \
    ACTION(T, false, true)                \
  else                                    \
    ACTION(T, false, false)

// dtype: 0 = float32, 1 = float64; hdiffu: fuse the Laplacian friction;
// cyclic: the east-west edge wraps; fold: the north edge is a tripole fold;
// rows: rows of the tile; smem: dynamic shared memory a block, bytes; dzbu:
// the bottom level's thickness at U points under partial bottom cells (the
// PBC instances), or null. Returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for a configuration the kernel does not take.
extern "C" int pop2_clinic(int dtype, int hdiffu, int km, int ny, int nx,
                           int cyclic, int fold, int rows, long smem,
                           const void* uc, const void* vc, const void* uo,
                           const void* vo, const void* um, const void* vm,
                           const void* ra, const void* vvc, const void* g2d,
                           const int* kmu, const void* dhu, const void* smf,
                           const void* dz, const void* dzr, const void* dz2r,
                           const void* dzwr2, const void* facs, double am,
                           double bdrag, double wcor_c, double wcor_o,
                           void* fx, void* fy, void* zx, void* zy,
                           const void* dzbu, void* stream) {
  using namespace pop2;
  const bool pbc = dzbu != nullptr;
  if (!(dtype == 0 ? clinic_config_ok<float>(km, ny, nx, rows, smem, pbc)
                   : clinic_config_ok<double>(km, ny, nx, rows, smem, pbc)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((nx + kFrameCols - 1) / kFrameCols),
                  (unsigned)((ny + rows - 1) / rows));
  const dim3 block(kFrameCols, rows);
  cudaStream_t s = (cudaStream_t)stream;
#define POP2_CLINIC(T, HD, PBC)                                              \
  {                                                                          \
    const cudaError_t e = allow_large_smem(clinic_kernel<T, HD, PBC>, smem); \
    if (e != cudaSuccess) return (int)e;                                     \
    clinic_kernel<T, HD, PBC><<<grid, block, smem, s>>>(                     \
        km, ny, nx, cyclic, fold, (const T*)uc, (const T*)vc, (const T*)uo,  \
        (const T*)vo, (const T*)um, (const T*)vm, (const T*)ra,              \
        (const T*)vvc, (const T*)g2d, kmu, (const T*)dhu, (const T*)smf,     \
        (const T*)dz, (const T*)dzr, (const T*)dz2r, (const T*)dzwr2,        \
        (const T*)facs, (T)am, (T)bdrag, (T)wcor_c, (T)wcor_o, (T*)fx,       \
        (T*)fy, (T*)zx, (T*)zy, (const T*)dzbu);                             \
  }
  if (dtype == 0) {
    POP2_CLINIC_INSTANCES(float, POP2_CLINIC)
  } else {
    POP2_CLINIC_INSTANCES(double, POP2_CLINIC)
  }
#undef POP2_CLINIC
  return (int)cudaGetLastError();
}

// Blocks of a launch with `smem` bytes a block that one SM holds at once,
// with the Laplacian fused (hdiffu) or without, full or partial bottom
// cells (pbc).
extern "C" int pop2_clinic_blocks_per_sm(int dtype, int hdiffu, long smem,
                                         int pbc) {
  using namespace pop2;
#define POP2_CLINIC_OCC(T, HD, PBC)                                          \
  {                                                                          \
    const cudaError_t e = allow_large_smem(clinic_kernel<T, HD, PBC>, smem); \
    if (e != cudaSuccess) return -(int)e;                                    \
    return blocks_per_sm(clinic_kernel<T, HD, PBC>, ClinicTile<T>::kThreads, \
                         smem);                                              \
  }
  if (dtype == 0) {
    POP2_CLINIC_INSTANCES(float, POP2_CLINIC_OCC)
  } else {
    POP2_CLINIC_INSTANCES(double, POP2_CLINIC_OCC)
  }
#undef POP2_CLINIC_OCC
}
#undef POP2_CLINIC_INSTANCES
