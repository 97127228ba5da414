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
// Replaces the TPU kernel clinic_pallas.py `_kernel` / `clinic_rhs_tiles` in
// its with_hdiffu=True, closed north-south mode (the mode the
// dynamical-core slice runs).
//
// Bound on this card: bytes. Minimum traffic is six distinct 3-D inputs (u, v
// at two times, the averaged density, the viscosity; the model passes one of
// the two velocity pairs again as the mixing-time pair) and two 3-D outputs,
// plus 24 2-D fields; about 150 flops per output pair. The
// design: one thread per (j, i) column, i fastest, k looped with the
// carries in registers: the continuity cumsum for w at U points, the
// running vertical integral of the density gradient with the half-level
// factors, the vertical-friction flux through the level's top, and the
// ZX/ZY sums. A thread owns its whole column, so ZX/ZY need no reduction
// across threads and the result is deterministic. The U-face volume fluxes
// need u, v on the 3 x 3 neighbourhood; each thread forms them itself from
// the neighbours' values and metrics (redundant arithmetic, no exchange),
// with the 18 neighbour metrics held in registers across the level loop.
// Levels below the column's bottom write zero and skip the arithmetic.
#include "common.cuh"

namespace pop2 {

// order of the stacked 2-D metric operand (clinic_cuda.G2D)
enum G2D {
  G_DYU, G_DXU, G_UAREA_R, G_FCOR, G_KXU, G_KYU, G_DXUR, G_DYUR, G_DUCM,
  G_DUN, G_DUS, G_DUE, G_DUW, G_DMC, G_DMN, G_DMS, G_DME, G_DMW, G_HUR,
  G_COUNT
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
clinic_kernel(int km, int ny, int nx, int cyclic,
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
              T* __restrict__ zy) {
  Column c;
  if (!locate(ny, nx, cyclic, &c)) return;
  const long ls = (long)ny * nx;  // level stride

  // 3 x 3 neighbourhood, index [dj + 1][di + 1]
  const int jj[3] = {c.js, c.j, c.jn};
  const int ii[3] = {c.iw, c.i, c.ie};
  const bool vj[3] = {c.vs, true, c.vn};
  const bool vi[3] = {c.vw, true, c.ve};
  long off[3][3];
  bool val[3][3];
  T dyu3[3][3], dxu3[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      off[r][q] = (long)jj[r] * nx + ii[q];
      val[r][q] = vj[r] && vi[q];
      dyu3[r][q] = ldz(g2d + G_DYU * ls, off[r][q], val[r][q]);
      dxu3[r][q] = ldz(g2d + G_DXU * ls, off[r][q], val[r][q]);
    }
  const long oc = off[1][1];
  const long on = off[2][1], os = off[0][1], oe = off[1][2], ow = off[1][0];
  const long one = off[2][2];
  const bool vne = val[2][2];

  const T uarear = g2d[G_UAREA_R * ls + oc];
  const T fcor = g2d[G_FCOR * ls + oc];
  const T kxu = g2d[G_KXU * ls + oc], kyu = g2d[G_KYU * ls + oc];
  const T dxur = g2d[G_DXUR * ls + oc], dyur = g2d[G_DYUR * ls + oc];
  const T ducm = g2d[G_DUCM * ls + oc];
  const T dun = g2d[G_DUN * ls + oc], dus = g2d[G_DUS * ls + oc];
  const T due = g2d[G_DUE * ls + oc], duw = g2d[G_DUW * ls + oc];
  const T dmc = g2d[G_DMC * ls + oc];
  const T dmn = g2d[G_DMN * ls + oc], dms = g2d[G_DMS * ls + oc];
  const T dme = g2d[G_DME * ls + oc], dmw = g2d[G_DMW * ls + oc];
  const T hur = g2d[G_HUR * ls + oc];
  const int kmu_c = kmu[oc];
  const T dhu_c = dhu[oc];
  const T half = T(0.5), quarter = T(0.25), eighth = T(0.125);

  // carries down the column
  T wuk = dhu_c;   // w at the top of the U box
  T wsum = dhu_c;  // dhu + running sum of the horizontal divergence
  T rkx_p = T(0), rky_p = T(0);  // density gradient of the level above
  T pkx = T(0), pky = T(0);      // running pressure-gradient integral
  T vuf = (kmu_c >= 1) ? smf[oc] : T(0);  // friction flux through the top:
  T vvf = (kmu_c >= 1) ? smf[ls + oc] : T(0);  // wind stress at the surface
  T zxa = T(0), zya = T(0);

  for (int k = 0; k < km; ++k) {
    const long ko = k * ls + oc;
    if (kmu_c < k + 1) {  // below the bottom: masked, nothing carries on
      fx[ko] = T(0);
      fy[ko] = T(0);
      continue;
    }
    const T dzk = dz[k], dzrk = dzr[k], dz2rk = dz2r[k];
    const T* uk = uc + k * ls;
    const T* vk = vc + k * ls;

    // current velocities and U-face volume fluxes on the neighbourhood
    T u3[3][3], v3[3][3], a[3][3], b[3][3];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        u3[r][q] = ldz(uk, off[r][q], val[r][q]);
        v3[r][q] = ldz(vk, off[r][q], val[r][q]);
        a[r][q] = u3[r][q] * dyu3[r][q] * dzk;
        b[r][q] = v3[r][q] * dxu3[r][q] * dzk;
      }
    // 4-point averages of T-face fluxes onto the U-cell faces
    // (source/advection.F90:1245-1339); the east face is the west face of
    // the column at i+1, the north face the south face of the one at j+1
    const T uuw = quarter * (a[1][1] + a[1][0])
        + eighth * (a[0][1] + a[0][0] + a[2][1] + a[2][0]);
    const T uue = c.ve ? quarter * (a[1][2] + a[1][1])
        + eighth * (a[0][2] + a[0][1] + a[2][2] + a[2][1]) : T(0);
    const T vus = quarter * (b[1][1] + b[0][1])
        + eighth * (b[1][0] + b[0][0] + b[1][2] + b[0][2]);
    const T vun = c.vn ? quarter * (b[2][1] + b[1][1])
        + eighth * (b[2][0] + b[1][0] + b[2][2] + b[1][2]) : T(0);

    const T cc = vun - vus + uue - uuw;
    wsum = wsum + cc * uarear;
    const T wukb = wsum;  // w at the bottom of the U box, by continuity

    // momentum advection with metric terms (advu)
    const T u = u3[1][1], v = v3[1][1];
    T luk = half * (cc * u + vun * u3[2][1] - vus * u3[0][1]
                    + uue * u3[1][2] - uuw * u3[1][0]) * uarear * dzrk;
    T lvk = half * (cc * v + vun * v3[2][1] - vus * v3[0][1]
                    + uue * v3[1][2] - uuw * v3[1][0]) * uarear * dzrk;
    T top_u, top_v, bot_u, bot_v;
    if (k == 0) {
      top_u = dzrk * wuk * u;
      top_v = dzrk * wuk * v;
    } else {
      top_u = dz2rk * wuk * (uk[oc - ls] + u);
      top_v = dz2rk * wuk * (vk[oc - ls] + v);
    }
    if (k == km - 1) {
      bot_u = T(0);
      bot_v = T(0);
    } else {
      bot_u = dz2rk * wukb * (u + uk[oc + ls]);
      bot_v = dz2rk * wukb * (v + vk[oc + ls]);
    }
    luk = luk + top_u - bot_u + u * v * kyu - v * v * kxu;
    lvk = lvk + top_v - bot_v + u * v * kxu - u * u * kyu;

    // Coriolis with the time-centring weights (baroclinic.F90:971-995)
    const T uo_c = uo[ko], vo_c = vo[ko];
    const T cor_x = fcor * (wcor_c * v + wcor_o * vo_c);
    const T cor_y = -fcor * (wcor_c * u + wcor_o * uo_c);

    // pressure gradient: running vertical integral of the gradient of the
    // averaged density at the N, E, NE T points around the U point
    // (pressure_grad.F90:262-296)
    const T* rk = ra + k * ls;
    const T f = rk[oc];
    const T f_n = ldz(rk, on, c.vn), f_e = ldz(rk, oe, c.ve);
    const T f_ne = ldz(rk, one, vne);
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
    const T* umk = um + k * ls;
    const T* vmk = vm + k * ls;
    const T um_c = umk[oc], vm_c = vmk[oc];
    const T nu = ldz(umk, on, c.vn), nv = ldz(vmk, on, c.vn);
    const T su = ldz(umk, os, c.vs), sv = ldz(vmk, os, c.vs);
    const T eu = ldz(umk, oe, c.ve), ev = ldz(vmk, oe, c.ve);
    const T wu = ldz(umk, ow, c.vw), wv = ldz(vmk, ow, c.vw);
    const T lap_u = ducm * um_c + dun * nu + dus * su + due * eu + duw * wu;
    const T lap_v = ducm * vm_c + dun * nv + dus * sv + due * ev + duw * wv;
    const T mix_u = dmc * um_c + dmn * nu + dms * su + dme * eu + dmw * wu;
    const T mix_v = dmc * vm_c + dmn * nv + dms * sv + dme * ev + dmw * wv;
    const T hduk = am * (lap_u + mix_v);
    const T hdvk = am * (lap_v - mix_u);

    // explicit vertical friction: quadratic drag at the bottom level
    // (vertical_mix.F90:853-1026)
    T vufb, vvfb;
    if (k + 1 == kmu_c) {
      const T vmag = bdrag * sqrt(uo_c * uo_c + vo_c * vo_c);
      vufb = vmag * uo_c;
      vvfb = vmag * vo_c;
    } else {
      const T w = vvc[ko] * dzwr2[k];
      vufb = w * (uo_c - uo[ko + ls]);
      vvfb = w * (vo_c - vo[ko + ls]);
    }
    const T du = (vuf - vufb) * dzrk;
    const T dv = (vvf - vvfb) * dzrk;
    vuf = vufb;
    vvf = vvfb;

    const T fxk = (((-luk + cor_x) - pkx) + hduk) + du;
    const T fyk = (((-lvk + cor_y) - pky) + hdvk) + dv;
    fx[ko] = fxk;
    fy[ko] = fyk;
    zxa = zxa + fxk * dzk;
    zya = zya + fyk * dzk;
    wuk = wukb;
  }
  zx[oc] = hur * zxa;
  zy[oc] = hur * zya;
}

}  // namespace pop2

// dtype: 0 = float32, 1 = float64. Returns cudaGetLastError() of the launch.
extern "C" int pop2_clinic(int dtype, int km, int ny, int nx, int cyclic,
                           const void* uc, const void* vc, const void* uo,
                           const void* vo, const void* um, const void* vm,
                           const void* ra, const void* vvc, const void* g2d,
                           const int* kmu, const void* dhu, const void* smf,
                           const void* dz, const void* dzr, const void* dz2r,
                           const void* dzwr2, const void* facs, double am,
                           double bdrag, double wcor_c, double wcor_o,
                           void* fx, void* fy, void* zx, void* zy,
                           void* stream) {
  using namespace pop2;
  const dim3 grid(blocks_for((long)ny * nx)), block(kThreads);
  cudaStream_t s = (cudaStream_t)stream;
#define POP2_CLINIC(T)                                                       \
  clinic_kernel<T><<<grid, block, 0, s>>>(                                   \
      km, ny, nx, cyclic, (const T*)uc, (const T*)vc, (const T*)uo,          \
      (const T*)vo, (const T*)um, (const T*)vm, (const T*)ra,                \
      (const T*)vvc, (const T*)g2d, kmu, (const T*)dhu, (const T*)smf,       \
      (const T*)dz, (const T*)dzr, (const T*)dz2r, (const T*)dzwr2,          \
      (const T*)facs, (T)am, (T)bdrag, (T)wcor_c, (T)wcor_o, (T*)fx,         \
      (T*)fy, (T*)zx, (T*)zy)
  if (dtype == 0)
    POP2_CLINIC(float);
  else
    POP2_CLINIC(double);
#undef POP2_CLINIC
  return (int)cudaGetLastError();
}

extern "C" int pop2_clinic_g2d_count() { return pop2::G_COUNT; }

// Blocks of the one-column launch that one SM holds at once (variant unused).
extern "C" int pop2_clinic_blocks_per_sm(int dtype, int variant) {
  using namespace pop2;
  (void)variant;
  return dtype == 0 ? blocks_per_sm(clinic_kernel<float>, kThreads, 0)
                    : blocks_per_sm(clinic_kernel<double>, kThreads, 0);
}
