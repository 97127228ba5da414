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
// (4 + 3 nt) distinct 3-D fields plus a dozen 2-D ones, against some 60 flops
// per output value. The design: one thread per (j, i) column, i fastest, k
// looped with the continuity cumsum (w at the level's top and bottom)
// carried in registers. Each thread needs the volume fluxes through all four
// lateral faces of its cell; it computes the west and south ones from the
// neighbours' u, v and metrics itself (redundant arithmetic, no exchange
// between threads), so the flux velocities never touch device memory.
// Without DEL2 the mixing-time tracer drops out of the traffic: (4 + 2 nt)
// fields. The loop over tracers sits inside the level loop, so the flux
// velocities are formed once per column and level. Neighbour and k+-1
// re-reads are left to L1/L2; shared-memory tiling and register carries of
// the k+-1 values are later work.
#include "common.cuh"

namespace pop2 {

template <typename T, bool DEL2>
__global__ void __launch_bounds__(kThreads)
tracer_kernel(int nt, int km, int ny, int nx, int cyclic, int varthick,
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
  Column c;
  if (!locate(ny, nx, cyclic, &c)) return;
  const long ls = (long)ny * nx;  // level stride
  const long ts = (long)km * ls;  // tracer stride
  const long oc = (long)c.j * nx + c.i;
  const long on = (long)c.jn * nx + c.i;
  const long os = (long)c.js * nx + c.i;
  const long oe = (long)c.j * nx + c.ie;
  const long ow = (long)c.j * nx + c.iw;
  const long osw = (long)c.js * nx + c.iw;
  const bool vsw = c.vs && c.vw;

  // 2-D operands of the column; a metric of a cut-off neighbour is zero, so
  // the flux it scales vanishes as the shifted-in zero of the plain version
  const int kmt_c = kmt[oc];
  const int kmt_n = c.vn ? kmt[on] : 0;
  const int kmt_s = c.vs ? kmt[os] : 0;
  const int kmt_e = c.ve ? kmt[oe] : 0;
  const int kmt_w = c.vw ? kmt[ow] : 0;
  const T dyu_c = dyu[oc], dyu_s = ldz(dyu, os, c.vs);
  const T dyu_w = ldz(dyu, ow, c.vw), dyu_sw = ldz(dyu, osw, vsw);
  const T dxu_c = dxu[oc], dxu_s = ldz(dxu, os, c.vs);
  const T dxu_w = ldz(dxu, ow, c.vw), dxu_sw = ldz(dxu, osw, vsw);
  const T tarea = tarea_r[oc];
  const T dtn_c = dtn[oc], dts_c = dts[oc], dte_c = dte[oc], dtw_c = dtw[oc];
  const T dhp = dh[oc];
  const T half = T(0.5);

  T wtk = dhp;   // w at the top of the level
  T wsum = dhp;  // dh + running sum of the horizontal divergence

  for (int k = 0; k < km; ++k) {
    const int kk = k + 1;  // 1-based level
    const T dzk = dz[k], dzrk = dzr[k], dz2rk = dz2r[k];
    const T* uk = u + k * ls;
    const T* vk = v + k * ls;

    // volume fluxes through the four faces (comp_flux_vel)
    const T a_c = uk[oc] * dyu_c * dzk;
    const T a_s = uk[os] * dyu_s * dzk;
    const T a_w = uk[ow] * dyu_w * dzk;
    const T a_sw = uk[osw] * dyu_sw * dzk;
    const T b_c = vk[oc] * dxu_c * dzk;
    const T b_s = vk[os] * dxu_s * dzk;
    const T b_w = vk[ow] * dxu_w * dzk;
    const T b_sw = vk[osw] * dxu_sw * dzk;
    const T ute = half * (a_c + a_s);
    const T utw = half * (a_w + a_sw);
    const T vtn = half * (b_c + b_w);
    const T vts = half * (b_s + b_sw);

    const T cc = vtn - vts + ute - utw;
    wsum = wsum + cc * tarea;
    const bool below = kmt_c > kk;  // the level below is ocean
    const T wtkb = below ? wsum : T(0);

    // masked Laplacian coefficients: a face is open only if the neighbour
    // is ocean at this level
    const bool mask = kmt_c >= kk;
    const T cn = (mask && kmt_n >= kk) ? dtn_c : T(0);
    const T cs = (mask && kmt_s >= kk) ? dts_c : T(0);
    const T ce = (mask && kmt_e >= kk) ? dte_c : T(0);
    const T cw = (mask && kmt_w >= kk) ? dtw_c : T(0);
    const T ccd = -(cn + cs + ce + cw);
    const T dzwr_k = dzwr2[k];
    const T dzwr_km1 = dzwr2[k > 0 ? k - 1 : 0];

    for (int n = 0; n < nt; ++n) {
      const long base = n * ts + k * ls;

      // centered advection (advt_centered)
      const T* tk = trcr + base;
      const T tc = tk[oc];
      const T t_n = ldz(tk, on, c.vn), t_s = ldz(tk, os, c.vs);
      const T t_e = ldz(tk, oe, c.ve), t_w = ldz(tk, ow, c.vw);
      T ltk = half * (cc * tc + vtn * t_n - vts * t_s + ute * t_e
                      - utw * t_w) * tarea * dzrk;
      T top, bot;
      if (k == 0)
        top = varthick ? T(0) : T(2) * wtk * tc;
      else
        top = wtk * (tk[oc - ls] + tc);
      bot = (k == km - 1) ? T(0) : wtkb * (tc + tk[oc + ls]);
      ltk = ltk + dz2rk * (top - bot);

      // Laplacian diffusion of the mixing-time tracer (hdifft_del2)
      T hdtk = T(0);
      if (DEL2) {
        const T* tmk = tmix + base;
        hdtk = ah * (ccd * tmk[oc] + cn * ldz(tmk, on, c.vn)
                     + cs * ldz(tmk, os, c.vs)
                     + ce * ldz(tmk, oe, c.ve)
                     + cw * ldz(tmk, ow, c.vw));
      }

      // explicit vertical diffusion of the old-time tracer (vdifft):
      // tracer 0 uses diffusivity class 0, all others class 1
      const T* tok = told + base;
      const T* vdk = vdc + (n < 1 ? 0 : 1) * ts + k * ls;
      const T to_c = tok[oc];
      const T vtfb = below ? vdk[oc] * (to_c - tok[oc + ls]) * dzwr_k : T(0);
      T vtf;
      if (k == 0)
        vtf = mask ? stf[n * ls + oc] : T(0);
      else  // the bottom flux of level k-1; open iff level k is ocean
        vtf = mask ? vdk[oc - ls] * (tok[oc - ls] - to_c) * dzwr_km1 : T(0);
      const T vdf = mask ? (vtf - vtfb) * dzrk : T(0);

      out[base + oc] = hdtk - ltk + vdf;
    }
    wtk = wtkb;
  }
}

}  // namespace pop2

// dtype: 0 = float32, 1 = float64. Returns cudaGetLastError() of the launch.
// with_del2 = 0 selects the advection + vertical-diffusion instance (tmix
// and ah are then not read).
extern "C" int pop2_tracer(int dtype, int with_del2, int nt, int km, int ny,
                           int nx, int cyclic, int varthick, const void* u,
                           const void* v, const void* trcr, const void* tmix,
                           const void* told, const void* vdc, const void* stf,
                           const void* dh, const int* kmt, const void* dyu,
                           const void* dxu, const void* tarea_r,
                           const void* dtn, const void* dts, const void* dte,
                           const void* dtw, const void* dz, const void* dzr,
                           const void* dz2r, const void* dzwr2, double ah,
                           void* out, void* stream) {
  using namespace pop2;
  const dim3 grid(blocks_for((long)ny * nx)), block(kThreads);
  cudaStream_t s = (cudaStream_t)stream;
#define POP2_TRACER(T, DEL2)                                                 \
  tracer_kernel<T, DEL2><<<grid, block, 0, s>>>(                             \
      nt, km, ny, nx, cyclic, varthick, (const T*)u, (const T*)v,            \
      (const T*)trcr, (const T*)tmix, (const T*)told, (const T*)vdc,         \
      (const T*)stf, (const T*)dh, kmt, (const T*)dyu, (const T*)dxu,        \
      (const T*)tarea_r, (const T*)dtn, (const T*)dts, (const T*)dte,        \
      (const T*)dtw, (const T*)dz, (const T*)dzr, (const T*)dz2r,            \
      (const T*)dzwr2, (T)ah, (T*)out)
  if (dtype == 0 && with_del2)
    POP2_TRACER(float, true);
  else if (dtype == 0)
    POP2_TRACER(float, false);
  else if (with_del2)
    POP2_TRACER(double, true);
  else
    POP2_TRACER(double, false);
#undef POP2_TRACER
  return (int)cudaGetLastError();
}

// Blocks of the one-column launch that one SM holds at once; variant: with
// the Laplacian (1) or without (0).
extern "C" int pop2_tracer_blocks_per_sm(int dtype, int variant) {
  using namespace pop2;
  if (dtype == 0)
    return variant ? blocks_per_sm(tracer_kernel<float, true>, kThreads, 0)
                   : blocks_per_sm(tracer_kernel<float, false>, kThreads, 0);
  return variant ? blocks_per_sm(tracer_kernel<double, true>, kThreads, 0)
                 : blocks_per_sm(tracer_kernel<double, false>, kThreads, 0);
}
