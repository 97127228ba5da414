// Isopycnal slopes of the GM / submesoscale schemes in one pass over the T
// and S columns: the MWJF expansion coefficients drho/dT, drho/dS
// (source/state_mod.F90:418-498), the T/S face and vertical differences, the
// eight quarter-cell slopes (tracer_diffs_and_isopyc_slopes,
// source/hmix_gm_submeso_share.F90:149-434), the absolute-slope measure SLA
// (source/hmix_gm.F90:1236-1242) and the displaced-parcel N^2 of the bfre
// profile (source/hmix_gm.F90:3104-3111).
//
// Replaces the TPU kernel gm_slope_pallas.py `_kernel` / `slopes_tiles`.
//
// Bound on this card: bytes, 2 fields read and 11 written per point, against
// some 250 flops (two evaluations of the rational EOS derivatives). One
// thread per (j, i) column, i fastest; the column's T and S at k-1, k, k+1
// ride in registers down the level loop, the four neighbours' T and S are
// read once a level. The pressure-dependent polynomial coefficients of the
// EOS collapse to per-level scalars computed on the host (`coef`, 19 rows of
// km): set A at the level's own pressure, set B at the pressure of the level
// below for the displaced parcel. Slopes divide by the vertical density
// difference clamped at -eps2, in the operation order of the plain version.
#include "common.cuh"

namespace pop2 {

// rows of the per-level coefficient table
enum {
  cN00A, cN02A, cN10A, cD00A, cD01A, cD03A,
  cN00B, cN02B, cN10B, cD00B, cD01B, cD03B,
  cTMIN, cTMAX, cSMIN, cSMAX, cDZWT, cDZWB, cDZWR, kSlopeCoefRows
};

// (drho/dT, drho/dS) of the MWJF rational fit; the pressure-independent
// terms are constants (g/cm^3 units folded into the numerator).
template <typename T>
__device__ __forceinline__ void mwjf_derivs(T TQ, T SQ, T SQR, T n00, T n02,
                                            T n10, T d00, T d01, T d03,
                                            T* drdt, T* drds) {
  const T n01 = T(7.35212840e+0 * 0.001), n03 = T(3.98476704e-4 * 0.001);
  const T n11 = T(-7.23268813e-3 * 0.001), n20 = T(2.12382341e-3 * 0.001);
  const T d02 = T(-4.60835542e-5), d04 = T(1.80809186e-10);
  const T d10 = T(2.14691708e-3), d11 = T(-9.27062484e-6);
  const T d13 = T(-1.78343643e-10), dq0 = T(4.76534122e-6);
  const T dq2 = T(1.63410736e-9);

  const T work1 = n00 + TQ * (n01 + TQ * (n02 + n03 * TQ)) +
                  SQ * (n10 + n11 * TQ + n20 * SQ);
  const T work2 = d00 + TQ * (d01 + TQ * (d02 + TQ * (d03 + d04 * TQ))) +
                  SQ * (d10 + TQ * (d11 + TQ * TQ * d13) +
                        SQR * (dq0 + TQ * TQ * dq2));
  const T denomk = T(1) / work2;
  const T w3t = n01 + TQ * (T(2) * n02 + T(3) * n03 * TQ) + n11 * SQ;
  const T w4t = d01 + SQ * d11 +
                TQ * (T(2) * (d02 + SQ * SQR * dq2) +
                      TQ * (T(3) * (d03 + SQ * d13) + TQ * T(4) * d04));
  *drdt = (w3t - work1 * denomk * w4t) * denomk;
  const T w3s = n10 + n11 * TQ + T(2) * n20 * SQ;
  const T w4s = d10 + TQ * (d11 + TQ * TQ * d13) +
                T(1.5) * SQR * (dq0 + TQ * TQ * dq2);
  *drds = (w3s - work1 * denomk * w4s) * denomk * T(1000);
}

template <typename T>
__device__ __forceinline__ T clampv(T x, T lo, T hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gm_slope_kernel(int km, int ny, int nx, int cyclic, T grav,
                const T* __restrict__ coef, const T* __restrict__ tmix,
                const int* __restrict__ kmt, const T* __restrict__ dxt,
                const T* __restrict__ dyt, T* __restrict__ slp,
                T* __restrict__ sla, T* __restrict__ n2) {
  Column c;
  if (!locate(ny, nx, cyclic, &c)) return;
  const long ls = (long)ny * nx;  // level stride
  const long ps = (long)km * ls;  // plane (tracer, output channel) stride
  const long oc = (long)c.j * nx + c.i;
  const long oe = (long)c.j * nx + c.ie, ow = (long)c.j * nx + c.iw;
  const long on = (long)c.jn * nx + c.i, os = (long)c.js * nx + c.i;
  const T* tt = tmix;       // temperature
  const T* ss = tmix + ps;  // salinity

  const int kmt_c = kmt[oc];
  const int kmt_e = c.ve ? kmt[oe] : 0, kmt_w = c.vw ? kmt[ow] : 0;
  const int kmt_n = c.vn ? kmt[on] : 0, kmt_s = c.vs ? kmt[os] : 0;
  const T dx = dxt[oc], dy = dyt[oc];
  const T dx2 = dx * dx, dy2 = dy * dy;
  const T eps = T(1.0e-10), neg_eps2 = T(-1.0e-20), tfloor = T(-2);

  // column carries: clipped temperature and salinity at k-1, k, k+1
  T tc_m = T(0), s_m = T(0);
  T t_raw = tt[oc], s_c = ss[oc];
  T tc_c = max(t_raw, tfloor);

  for (int k = 0; k < km; ++k) {
    const int kk = k + 1;
    const bool last = k == km - 1;
    T t_raw_p = T(0), s_p = T(0), tc_p = T(0);
    if (!last) {
      t_raw_p = tt[(k + 1) * ls + oc];
      s_p = ss[(k + 1) * ls + oc];
      tc_p = max(t_raw_p, tfloor);
    }
    const T* ck = coef + k;
#define C_(row) ck[(row) * km]
    const T TQ = clampv(t_raw, C_(cTMIN), C_(cTMAX));
    const T SQ = T(1000) * clampv(s_c, C_(cSMIN), C_(cSMAX));
    const T SQR = sqrt(SQ);
    T drdt, drds, drdt_d, drds_d;
    mwjf_derivs(TQ, SQ, SQR, C_(cN00A), C_(cN02A), C_(cN10A), C_(cD00A),
                C_(cD01A), C_(cD03A), &drdt, &drds);
    mwjf_derivs(TQ, SQ, SQR, C_(cN00B), C_(cN02B), C_(cN10B), C_(cD00B),
                C_(cD01B), C_(cD03B), &drdt_d, &drds_d);

    // masked face differences of clipped T and of S, looking out of the
    // cell through its east, west, north and south faces
    const bool in_c = kk <= kmt_c, below = kk < kmt_c;
    const long ok = k * ls;
    T dtf[4], dsf[4];
    {
      const bool me = in_c && kk <= kmt_e, mw = in_c && kk <= kmt_w;
      const bool mn = in_c && kk <= kmt_n, ms = in_c && kk <= kmt_s;
      dtf[0] = me ? max(tt[ok + oe], tfloor) - tc_c : T(0);
      dsf[0] = me ? ss[ok + oe] - s_c : T(0);
      dtf[1] = mw ? tc_c - max(tt[ok + ow], tfloor) : T(0);
      dsf[1] = mw ? s_c - ss[ok + ow] : T(0);
      dtf[2] = mn ? max(tt[ok + on], tfloor) - tc_c : T(0);
      dsf[2] = mn ? ss[ok + on] - s_c : T(0);
      dtf[3] = ms ? tc_c - max(tt[ok + os], tfloor) : T(0);
      dsf[3] = ms ? s_c - ss[ok + os] : T(0);
    }

    // vertical differences across the interface above and below the level
    const T tzp_c = k > 0 ? tc_m - tc_c : T(0);
    const T tzs_c = k > 0 ? s_m - s_c : T(0);
    const T tzp_p = last ? T(0) : tc_c - tc_p;
    const T tzs_p = last ? T(0) : s_c - s_p;
    const T rz_ktp = min(drdt * tzp_c + drds * tzs_c, neg_eps2);
    const T rz_kbt = min(drdt * tzp_p + drds * tzs_p, neg_eps2);

    T q_t[2] = {T(0), T(0)}, q_b[2] = {T(0), T(0)};  // sums of squares x, y
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const T r = drdt * dtf[f] + drds * dsf[f];
      // the top half of level 1 has no interface above
      const T s_top = (in_c && k > 0) ? r / rz_ktp : T(0);
      const T s_bot = below ? r / rz_kbt : T(0);
      slp[(2 * f) * ps + ok + oc] = s_top;
      slp[(2 * f + 1) * ps + ok + oc] = s_bot;
      q_t[f >> 1] += s_top * s_top;
      q_b[f >> 1] += s_bot * s_bot;
    }
    sla[ok + oc] =
        C_(cDZWT) * sqrt(T(0.5) * (q_t[0] / dx2 + q_t[1] / dy2)) + eps;
    sla[ps + ok + oc] =
        C_(cDZWB) * sqrt(T(0.5) * (q_b[0] / dx2 + q_b[1] / dy2)) + eps;

    const T w3 = drdt_d * tzp_p + drds_d * tzs_p;
    n2[ok + oc] = below ? max(T(0), -grav * w3 * C_(cDZWR)) : T(0);
#undef C_

    tc_m = tc_c;
    s_m = s_c;
    t_raw = t_raw_p;
    s_c = s_p;
    tc_c = tc_p;
  }
}

}  // namespace pop2

extern "C" int pop2_gm_slope_coef_rows() { return pop2::kSlopeCoefRows; }

// dtype: 0 = float32, 1 = float64. Returns cudaGetLastError() of the launch.
extern "C" int pop2_gm_slopes(int dtype, int km, int ny, int nx, int cyclic,
                              double grav, const void* coef,
                              const void* tmix, const int* kmt,
                              const void* dxt, const void* dyt, void* slp,
                              void* sla, void* n2, void* stream) {
  using namespace pop2;
  const dim3 grid(blocks_for((long)ny * nx)), block(kThreads);
  cudaStream_t s = (cudaStream_t)stream;
#define POP2_GM_SLOPES(T)                                                    \
  gm_slope_kernel<T><<<grid, block, 0, s>>>(                                 \
      km, ny, nx, cyclic, (T)grav, (const T*)coef, (const T*)tmix, kmt,      \
      (const T*)dxt, (const T*)dyt, (T*)slp, (T*)sla, (T*)n2)
  if (dtype == 0)
    POP2_GM_SLOPES(float);
  else
    POP2_GM_SLOPES(double);
#undef POP2_GM_SLOPES
  return (int)cudaGetLastError();
}

// Blocks of the one-column launch that one SM holds at once (variant unused).
extern "C" int pop2_gm_slope_blocks_per_sm(int dtype, int variant) {
  using namespace pop2;
  (void)variant;
  return dtype == 0 ? blocks_per_sm(gm_slope_kernel<float>, kThreads, 0)
                    : blocks_per_sm(gm_slope_kernel<double>, kThreads, 0);
}
