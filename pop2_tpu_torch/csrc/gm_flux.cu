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
// column and level. The TPU version first packs 17 weight planes in device
// memory so its tiles fit fast memory; here each thread forms the weights it
// needs from the unpacked fields in registers, for its own column and (the
// one face that touches it) for each of its four neighbours, so no pack is
// ever written. The arithmetic is `gm_flux_level` in gm_flux.cuh, driven
// here by `gm_flux_column` and shared with the fused chain kernel. Both
// `cancellation` branches are instances.
#include "gm_flux.cuh"

namespace pop2 {

// Weights from the slope (slx, sly), streamfunction (sfx, sfy), isopycnal
// diffusivity and horizontal diffusivity fields. slx/sly/sfx/sfy are
// (2 faces, 2 halves, km, ny, nx): plane 2*face + half; kisop/hd are
// (2 halves, km, ny, nx).
template <typename T, bool CANCEL>
struct FieldWeights {
  const T* __restrict__ slx;
  const T* __restrict__ sly;
  const T* __restrict__ sfx;
  const T* __restrict__ sfy;
  const T* __restrict__ kisop;
  const T* __restrict__ hd;
  const T* __restrict__ lev;
  Stencil s;
  GmMetrics<T> m;
  long ls, ps;  // level stride, plane stride (km levels)

  // slope-like field `f` (x faces) / `g` (y faces) of cell face `face`
  __device__ __forceinline__ T quarter(const T* f, const T* g, int face,
                                       int half, long o) const {
    const T* src = face < fN ? f : g;
    return src[(2 * (face & 1) + half) * ps + o];
  }

  __device__ __forceinline__ void own(int k, GmWeights<T>* w) {
    const long o = k * ls + s.off[kC];
    T sl_t[4], sl_b[4], sf_t[4], sf_b[4];
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      sl_t[f] = quarter(slx, sly, f, 0, o);
      sl_b[f] = quarter(slx, sly, f, 1, o);
      sf_t[f] = CANCEL ? T(0) : quarter(sfx, sfy, f, 0, o);
      sf_b[f] = CANCEL ? T(0) : quarter(sfx, sfy, f, 1, o);
    }
    gm_make_weights<T, CANCEL>(lev[k], kisop[o], kisop[ps + o], hd[o],
                               hd[ps + o], sl_t, sl_b, sf_t, sf_b, m, w);
  }

  __device__ __forceinline__ void face(int col, int k, T* weff, T* vt,
                                       T* vb) const {
    *weff = *vt = *vb = T(0);
    if (!s.valid[col]) return;
    const long o = k * ls + s.off[col];
    const T kis_t = kisop[o], kis_b = kisop[ps + o];
    *weff = kis_t + kis_b + hd[o] + hd[ps + o];
    if (CANCEL) return;
    const int f = facing(col);
    const T dzk = lev[k];
    *vt = kis_t * quarter(slx, sly, f, 0, o) * dzk - quarter(sfx, sfy, f, 0, o);
    *vb = kis_b * quarter(slx, sly, f, 1, o) * dzk - quarter(sfx, sfy, f, 1, o);
  }
};

template <typename T, bool CANCEL>
__global__ void __launch_bounds__(kThreads)
gm_flux_kernel(int nt, int km, int ny, int nx, int cyclic,
               const T* __restrict__ tx, const T* __restrict__ ty,
               const T* __restrict__ tz, const T* __restrict__ slx,
               const T* __restrict__ sly, const T* __restrict__ sfx,
               const T* __restrict__ sfy, const T* __restrict__ kisop,
               const T* __restrict__ hd, const int* __restrict__ kmt,
               const T* __restrict__ hyx, const T* __restrict__ hxy,
               const T* __restrict__ tarea_r, const T* __restrict__ lev,
               T* __restrict__ gtk, T* __restrict__ vdc) {
  Column c;
  if (!locate(ny, nx, cyclic, &c)) return;
  const long ls = (long)ny * nx, ts = (long)km * ls;
  const Stencil s = make_stencil(c, nx);
  const GmMetrics<T> m = load_metrics(s, kmt, hyx, hxy, tarea_r);
  FieldWeights<T, CANCEL> wp{slx, sly, sfx, sfy, kisop, hd, lev, s, m, ls, ts};
  const GivenDiffs<T> dp{tx, ty, tz, s, ls, ts};
  gm_flux_column<T, CANCEL>(wp, dp, m, nt, km, ls, ts, s.off[kC], lev, gtk,
                            vdc);
}

}  // namespace pop2

extern "C" int pop2_gm_flux_max_tracers() { return pop2::kMaxTracers; }

// dtype: 0 = float32, 1 = float64. Returns cudaGetLastError() of the launch.
extern "C" int pop2_gm_flux(int dtype, int nt, int km, int ny, int nx,
                            int cyclic, int cancellation, const void* tx,
                            const void* ty, const void* tz, const void* slx,
                            const void* sly, const void* sfx, const void* sfy,
                            const void* kisop, const void* hd, const int* kmt,
                            const void* hyx, const void* hxy,
                            const void* tarea_r, const void* lev, void* gtk,
                            void* vdc, void* stream) {
  using namespace pop2;
  const dim3 grid(blocks_for((long)ny * nx)), block(kThreads);
  cudaStream_t s = (cudaStream_t)stream;
#define POP2_GM_FLUX(T, CANCEL)                                              \
  gm_flux_kernel<T, CANCEL><<<grid, block, 0, s>>>(                          \
      nt, km, ny, nx, cyclic, (const T*)tx, (const T*)ty, (const T*)tz,      \
      (const T*)slx, (const T*)sly, (const T*)sfx, (const T*)sfy,            \
      (const T*)kisop, (const T*)hd, kmt, (const T*)hyx, (const T*)hxy,      \
      (const T*)tarea_r, (const T*)lev, (T*)gtk, (T*)vdc)
  if (dtype == 0 && cancellation)
    POP2_GM_FLUX(float, true);
  else if (dtype == 0)
    POP2_GM_FLUX(float, false);
  else if (cancellation)
    POP2_GM_FLUX(double, true);
  else
    POP2_GM_FLUX(double, false);
#undef POP2_GM_FLUX
  return (int)cudaGetLastError();
}

// Blocks of the one-column launch that one SM holds at once; variant: the
// cancellation instance (1) or the skew one (0).
extern "C" int pop2_gm_flux_blocks_per_sm(int dtype, int variant) {
  using namespace pop2;
  if (dtype == 0)
    return variant ? blocks_per_sm(gm_flux_kernel<float, true>, kThreads, 0)
                   : blocks_per_sm(gm_flux_kernel<float, false>, kThreads, 0);
  return variant ? blocks_per_sm(gm_flux_kernel<double, true>, kThreads, 0)
                 : blocks_per_sm(gm_flux_kernel<double, false>, kThreads, 0);
}
