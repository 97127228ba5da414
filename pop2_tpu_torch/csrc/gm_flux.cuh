// GM/Redi flux assembly of one water column (source/hmix_gm.F90:1720-2080):
// the per-face diffusive + skew fluxes, the vertical flux with its carry down
// the column, their divergence GTK for every tracer, and VDC_GM, the |S|^2
// vertical diffusivity handed to the implicit solve.
//
// Written once and used by two kernels; the arithmetic of a level is
// `gm_flux_level`, fed with
//   the level's scalars and face masks (GmLevel, from `gm_level`),
//   the column's own weights at the level (GmWeights `cur`, from
//     `gm_make_weights`) and the next level's (`nxt`: the vertical flux
//     through the level's bottom needs the top-half weights of the level
//     below),
//   each neighbour's effective diffusivity and the skew weights of the face
//     it shares with the column, through a weights provider W,
//   a difference provider D: tx_c/tx_w/ty_c/ty_s(n, k), tz(n, k, col).
// Both kernels are 2-D tiles of columns walking down k that form every
// column's weights once a level and publish them in shared memory: in
// `gm_chain.cu` (a tile with a one-column halo of threads) the providers
// are `TileWeights` and `TileTracers`, the differences formed from the
// staged tracers; in `gm_flux.cu` (a tile in a one-column frame)
// `FrameWeights` and `FrameDiffs`, the differences given and staged.
#pragma once

#include "common.cuh"

namespace pop2 {

// tracers a launch (vertical-flux carries); the wrappers split more into
// groups of at most this many, one launch a group
constexpr int kMaxTracers = 16;
enum { kC = 0, kE = 1, kW = 2, kN = 3, kS = 4 };  // column of the stencil
enum { fE = 0, fW = 1, fN = 2, fS = 3 };          // face of a cell

// The face of neighbour `col` that touches the centre column.
__device__ __forceinline__ int facing(int col) {
  return col == kE ? fW : col == kW ? fE : col == kN ? fS : fN;
}

// Offsets of the five columns of the stencil in a (ny, nx) plane, and which
// exist (a closed edge cuts a neighbour off: everything read there is zero).
struct Stencil {
  long off[5];
  bool valid[5];
};

__device__ __forceinline__ Stencil make_stencil(const Column& c, int nx) {
  Stencil s;
  s.off[kC] = (long)c.j * nx + c.i;
  s.off[kE] = (long)c.j * nx + c.ie;
  s.off[kW] = (long)c.j * nx + c.iw;
  s.off[kN] = (long)c.jn * nx + c.in;
  s.off[kS] = (long)c.js * nx + c.i;
  s.valid[kC] = true;
  s.valid[kE] = c.ve;
  s.valid[kW] = c.vw;
  s.valid[kN] = c.vn;
  s.valid[kS] = c.vs;
  return s;
}

// 2-D operands of a column: bottom levels of the stencil and the metric
// ratios hyx = HTE/HUS (own and west), hxy = HTN/HUW (own and south).
template <typename T>
struct GmMetrics {
  int kmt[5];
  T hyx, hyxw, hxy, hxys, tarea_r;
};

template <typename T>
__device__ __forceinline__ GmMetrics<T> load_metrics(
    const Stencil& s, const int* __restrict__ kmt, const T* __restrict__ hyx,
    const T* __restrict__ hxy, const T* __restrict__ tarea_r) {
  GmMetrics<T> m;
#pragma unroll
  for (int c = 0; c < 5; ++c) m.kmt[c] = s.valid[c] ? kmt[s.off[c]] : 0;
  m.hyx = hyx[s.off[kC]];
  m.hyxw = ldz(hyx, s.off[kW], s.valid[kW]);
  m.hxy = hxy[s.off[kC]];
  m.hxys = ldz(hxy, s.off[kS], s.valid[kS]);
  m.tarea_r = tarea_r[s.off[kC]];
  return m;
}

// Tracer-independent weights of one column at one level; faces e, w, n, s.
template <typename T>
struct GmWeights {
  T weff;          // kappa_isop + hor_diff, top half + bottom half
  T vt[4], vb[4];  // kappa_isop*slope*dz - streamfunction, top / bottom half
  T a[4];          // dz*kappa_isop*slope + streamfunction, bottom half
  T b[4];          // the same of the top half (used by the level above)
  T part_a;        // dz/4 * kappa_isop * sum(h * slope^2), bottom half
  T part_b;        // the same of the top half
};

// With CANCEL (equal isopycnal and thickness diffusivities, one slope
// taper) the skew weights vanish and the streamfunction is not read.
template <typename T, bool CANCEL>
__device__ __forceinline__ void gm_make_weights(
    T dzk, T kis_t, T kis_b, T hd_t, T hd_b, const T (&sl_t)[4],
    const T (&sl_b)[4], const T (&sf_t)[4], const T (&sf_b)[4],
    const GmMetrics<T>& m, GmWeights<T>* w) {
  w->weff = kis_t + kis_b + hd_t + hd_b;
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    if (CANCEL) {
      w->vt[f] = T(0);
      w->vb[f] = T(0);
      w->a[f] = dzk * kis_b * sl_b[f];
      w->b[f] = dzk * kis_t * sl_t[f];
    } else {
      w->vt[f] = kis_t * sl_t[f] * dzk - sf_t[f];
      w->vb[f] = kis_b * sl_b[f] * dzk - sf_b[f];
      w->a[f] = dzk * kis_b * sl_b[f] + sf_b[f];
      w->b[f] = dzk * kis_t * sl_t[f] + sf_t[f];
    }
  }
  const T qx_b = m.hyx * sl_b[fE] * sl_b[fE] + m.hyxw * sl_b[fW] * sl_b[fW];
  const T qy_b = m.hxy * sl_b[fN] * sl_b[fN] + m.hxys * sl_b[fS] * sl_b[fS];
  const T qx_t = m.hyx * sl_t[fE] * sl_t[fE] + m.hyxw * sl_t[fW] * sl_t[fW];
  const T qy_t = m.hxy * sl_t[fN] * sl_t[fN] + m.hxys * sl_t[fS] * sl_t[fS];
  w->part_a = dzk * T(0.25) * kis_b * (qx_b + qy_b);
  w->part_b = dzk * T(0.25) * kis_t * (qx_t + qy_t);
}

// The weights of anisotropic GM (gm_aniso): the x faces e, w take the
// isopycnal diffusivity kx, the y faces n, s ky; `weff` is the x faces'
// effective diffusivity, *weff_y the y faces'.
template <typename T, bool CANCEL>
__device__ __forceinline__ void gm_make_weights_aniso(
    T dzk, T kx_t, T kx_b, T ky_t, T ky_b, T hd_t, T hd_b,
    const T (&sl_t)[4], const T (&sl_b)[4], const T (&sf_t)[4],
    const T (&sf_b)[4], const GmMetrics<T>& m, GmWeights<T>* w, T* weff_y) {
  w->weff = (kx_t + hd_t) + (kx_b + hd_b);
  *weff_y = (ky_t + hd_t) + (ky_b + hd_b);
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    const T kt = f < fN ? kx_t : ky_t;
    const T kb = f < fN ? kx_b : ky_b;
    if (CANCEL) {
      w->vt[f] = T(0);
      w->vb[f] = T(0);
      w->a[f] = dzk * kb * sl_b[f];
      w->b[f] = dzk * kt * sl_t[f];
    } else {
      w->vt[f] = kt * sl_t[f] * dzk - sf_t[f];
      w->vb[f] = kb * sl_b[f] * dzk - sf_b[f];
      w->a[f] = dzk * kb * sl_b[f] + sf_b[f];
      w->b[f] = dzk * kt * sl_t[f] + sf_t[f];
    }
  }
  const T qx_b = m.hyx * sl_b[fE] * sl_b[fE] + m.hyxw * sl_b[fW] * sl_b[fW];
  const T qy_b = m.hxy * sl_b[fN] * sl_b[fN] + m.hxys * sl_b[fS] * sl_b[fS];
  const T qx_t = m.hyx * sl_t[fE] * sl_t[fE] + m.hyxw * sl_t[fW] * sl_t[fW];
  const T qy_t = m.hxy * sl_t[fN] * sl_t[fN] + m.hxys * sl_t[fS] * sl_t[fS];
  w->part_a = dzk * T(0.25) * (kx_b * qx_b + ky_b * qy_b);
  w->part_b = dzk * T(0.25) * (kx_t * qx_t + ky_t * qy_t);
}

// Diffusive + skew flux through the face between column A and the column B
// east (or north) of it, scaled as the reference scales it: `coef` is the
// masked quarter metric of A, `diff` the tracer difference across the face,
// `wsum` the two columns' effective diffusivities, (vt_a, vb_a) the skew
// weights of A's face and (vt_b, vb_b) of B's face looking back.
template <typename T, bool CANCEL>
__device__ __forceinline__ T gm_face_flux(T dzk, T coef, T diff, T wsum,
                                          T vt_a, T vb_a, T vt_b, T vb_b,
                                          T tz_a, T tzp_a, T tz_b, T tzp_b) {
  T f = dzk * coef * diff * wsum;
  if (!CANCEL)
    f = f - coef * (vt_a * tz_a + vb_a * tzp_a + vt_b * tz_b + vb_b * tzp_b);
  return f;
}

// Level k of a column apart from its weights: the level scalars (`lev`
// holds three rows of km: dz, 1/dz, and dzw between the level and the one
// below), whether the level and the one below are ocean, and the masked
// quarter metrics of its four faces.
template <typename T>
struct GmLevel {
  int k, kp;  // the level, and the one below it (k itself at the bottom)
  bool in_c, below;
  T dzk, dzrk, dzwk;
  T cx_c, cx_w, cy_c, cy_s;
};

template <typename T>
__device__ __forceinline__ GmLevel<T> gm_level(const GmMetrics<T>& m, int km,
                                               int k,
                                               const T* __restrict__ lev) {
  GmLevel<T> g;
  const int kk = k + 1;  // 1-based level
  const bool last = k == km - 1;
  g.k = k;
  g.kp = last ? k : k + 1;
  g.dzk = lev[k];
  g.dzrk = lev[km + k];
  g.dzwk = lev[2 * km + k];
  g.in_c = kk <= m.kmt[kC];
  g.below = kk < m.kmt[kC] && !last;
  g.cx_c = (g.in_c && kk <= m.kmt[kE]) ? T(0.25) * m.hyx : T(0);
  g.cx_w = (g.in_c && kk <= m.kmt[kW]) ? T(0.25) * m.hyxw : T(0);
  g.cy_c = (g.in_c && kk <= m.kmt[kN]) ? T(0.25) * m.hxy : T(0);
  g.cy_s = (g.in_c && kk <= m.kmt[kS]) ? T(0.25) * m.hxys : T(0);
  return g;
}

// GTK of every tracer and VDC_GM at level g.k of the column at offset oc.
// The face weights come from a provider `w`: own_weff() (the x faces'),
// own_weff_y() (the y faces'), own_vt(f), own_vb(f) of the column itself,
// nb_weff(c) (of the direction of c), nb_vt(c), nb_vb(c) of neighbour
// column c (the skew weights of its face that looks back); the
// vertical-flux weights from the column's own at the level (`cur`: a,
// part_a) and the level below (`nxt`: b, part_b); the differences from a
// provider `dp`: tx_c, tx_w, ty_c, ty_s (n, level) and tz(n, level, col), at
// the levels g.k and g.kp. fztop[n * fzs] carries the vertical flux through
// the level's top down the column (zero above the first level). A null
// `vdc` leaves VDC_GM unwritten: the wrappers launch more tracers than a
// launch carries in groups, and only the first group writes it.
// NT > 0: the count is a compile-time constant and the loop over the
// tracers unrolls. NT = 0: a run-time count `nt`, and the loop is kept
// rolled, so that every tracer runs the same instructions whatever the
// count (an unrolled body with a remainder loop rounded a tracer's fluxes
// differently by its place in the count): a tracer's result is then the
// same in any group of a grouped launch.
template <typename T, bool CANCEL, int NT, class D, class W>
__device__ __forceinline__ void gm_flux_level(
    const D& dp, const GmMetrics<T>& m, int nt, const GmLevel<T>& g,
    const GmWeights<T>& cur, const GmWeights<T>& nxt, const W& w,
    T* fztop, int fzs, long ls, long ts, long oc, T* __restrict__ gtk,
    T* __restrict__ vdc) {
  const T fac = CANCEL ? T(0.5) : T(0.25);
  const int k = g.k, kp = g.kp;
  const T dzk = g.dzk;
  const T cx_c = g.cx_c, cx_w = g.cx_w, cy_c = g.cy_c, cy_s = g.cy_s;

  auto tracer = [&](int n) {
    const T tx_c = dp.tx_c(n, k), tx_w = dp.tx_w(n, k);
    const T ty_c = dp.ty_c(n, k), ty_s = dp.ty_s(n, k);
    T tz[5], tzp[5];  // the skew terms alone read them
#pragma unroll
    for (int col = 0; col < 5; ++col) {
      tz[col] = CANCEL ? T(0) : dp.tz(n, k, col);
      tzp[col] = CANCEL ? T(0) : dp.tz(n, kp, col);
    }
    const T fx_c = gm_face_flux<T, CANCEL>(
        dzk, cx_c, tx_c, w.own_weff() + w.nb_weff(kE), w.own_vt(fE),
        w.own_vb(fE), w.nb_vt(kE), w.nb_vb(kE), tz[kC], tzp[kC], tz[kE],
        tzp[kE]);
    const T fx_w = gm_face_flux<T, CANCEL>(
        dzk, cx_w, tx_w, w.nb_weff(kW) + w.own_weff(), w.nb_vt(kW),
        w.nb_vb(kW), w.own_vt(fW), w.own_vb(fW), tz[kW], tzp[kW], tz[kC],
        tzp[kC]);
    const T fy_c = gm_face_flux<T, CANCEL>(
        dzk, cy_c, ty_c, w.own_weff_y() + w.nb_weff(kN), w.own_vt(fN),
        w.own_vb(fN), w.nb_vt(kN), w.nb_vb(kN), tz[kC], tzp[kC], tz[kN],
        tzp[kN]);
    const T fy_s = gm_face_flux<T, CANCEL>(
        dzk, cy_s, ty_s, w.nb_weff(kS) + w.own_weff_y(), w.nb_vt(kS),
        w.nb_vb(kS), w.own_vt(fS), w.own_vb(fS), tz[kS], tzp[kS], tz[kC],
        tzp[kC]);

    // vertical flux through the level's bottom: this level's bottom half
    // and the top half of the level below
    T fz = T(0);
    if (g.below) {
      const T work =
          cur.a[fE] * m.hyx * tx_c + cur.a[fW] * m.hyxw * tx_w +
          cur.a[fN] * m.hxy * ty_c + cur.a[fS] * m.hxys * ty_s +
          nxt.b[fE] * m.hyx * dp.tx_c(n, kp) +
          nxt.b[fW] * m.hyxw * dp.tx_w(n, kp) +
          nxt.b[fN] * m.hxy * dp.ty_c(n, kp) +
          nxt.b[fS] * m.hxys * dp.ty_s(n, kp);
      fz = -fac * work;
    }
    const T div = (fx_c - fx_w + fy_c - fy_s + fztop[n * fzs] - fz) *
                  g.dzrk * m.tarea_r;
    gtk[n * ts + k * ls + oc] = g.in_c ? div : T(0);
    fztop[n * fzs] = fz;
  };
  if (NT > 0) {
#pragma unroll
    for (int n = 0; n < NT; ++n) tracer(n);
  } else {
#pragma unroll 1
    for (int n = 0; n < nt; ++n) tracer(n);
  }
  if (vdc != nullptr)  // a launch of a later tracer group leaves VDC_GM
    vdc[k * ls + oc] =
        g.below ? g.dzwk * m.tarea_r * (cur.part_a + nxt.part_b) : T(0);
}

}  // namespace pop2
