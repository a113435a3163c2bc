// Shared device code of the DG(P1) compressible-Euler kernels.
//
// Every expression is written in the operation order of the plain torch
// versions (quinoa_tpu_torch/pde/eos.py, ops/riemann.py,
// pde/dg_compflow.py), and the library is built with --fmad=false and
// without fast math, so on the card kernel and plain version differ only
// where torch itself orders a sum differently.
#pragma once

#include <cuda_runtime.h>

namespace qtk {

// DG(P1) compressible Euler: C components, K modes, G face and GV volume
// quadrature points.  The wrappers check the shapes against these.
constexpr int C = 5;
constexpr int K = 4;
constexpr int CK = C * K;
constexpr int G = 3;
constexpr int GV = 5;

// Layout of the packed constant table (kernels/__init__.py pack_tables).
constexpr int TAB_BSELF = 0;     // B_selfface (4, G, K)
constexpr int TAB_BVOL = 48;     // B_vol (GV, K)
constexpr int TAB_WDB = 68;      // w_vol * dBdxi_vol (GV, K, 3)
constexpr int TAB_WFACE = 128;   // w_face (G,)
constexpr int TAB_SIZE = 131;

constexpr int BC_INTERIOR = 0;
constexpr int BC_SYMMETRY = 2;

template <typename T>
struct Eos {
  T gamma, gm1, pstiff;
};

// torch.minimum / torch.maximum (and jnp's): a NaN operand gives NaN.
// The propagation matters: a face point with negative pressure has a NaN
// sound speed, and HLLC's wave selection must then fall through to the
// same branch as the plain version (fmin/fmax would drop the NaN).
template <typename T>
__device__ __forceinline__ T vmin(T a, T b) {
  return (a != a || b != b) ? a + b : (b < a ? b : a);
}
template <typename T>
__device__ __forceinline__ T vmax(T a, T b) {
  return (a != a || b != b) ? a + b : (b > a ? b : a);
}

template <typename T>
__device__ __forceinline__ T pressure(const Eos<T>& eos, T rho, T u, T v,
                                      T w, T rhoE) {
  return (rhoE - T(0.5) * rho * (u * u + v * v + w * w) - eos.pstiff) *
             eos.gm1 - eos.pstiff;
}

// pressure from conservative variables s[0..4]
template <typename T>
__device__ __forceinline__ T pressure_cons(const Eos<T>& eos, const T* s) {
  const T rho = s[0];
  return pressure(eos, rho, s[1] / rho, s[2] / rho, s[3] / rho, s[4]);
}

template <typename T>
__device__ __forceinline__ T soundspeed(const Eos<T>& eos, T rho, T p) {
  return sqrt(eos.gamma * (p + eos.pstiff) / rho);
}

// P1 Dubiner basis at reference point (x, e, z)
template <typename T>
__device__ __forceinline__ void basis_p1(T x, T e, T z, T* B) {
  B[0] = T(1);
  B[1] = T(2) * x + e + z - T(1);
  B[2] = T(3) * e + z - T(1);
  B[3] = T(4) * z - T(1);
}

// sum_k B[k] * u[c*K + k] for one component, summed in k order
template <typename T>
__device__ __forceinline__ T eval_mode_sum(const T* B, const T* u, int c) {
  T s = B[0] * u[c * K];
#pragma unroll
  for (int k = 1; k < K; ++k) s = s + B[k] * u[c * K + k];
  return s;
}

template <typename T>
__device__ __forceinline__ T dot3(T a0, T a1, T a2, const T* n) {
  return a0 * n[0] + a1 * n[1] + a2 * n[2];
}

// ghost state of a boundary face (DGCompFlow.bc_state): reflected
// velocity on symmetry faces, a copy of the left state otherwise
template <typename T>
__device__ __forceinline__ void bc_state(int bt, const T* sL, const T* n,
                                         T* sR) {
  if (bt == BC_SYMMETRY) {
    const T rho = sL[0];
    const T v0 = sL[1] / rho, v1 = sL[2] / rho, v2 = sL[3] / rho;
    const T vn = dot3(v0, v1, v2, n);
    sR[0] = sL[0];
    sR[1] = rho * (v0 - T(2) * vn * n[0]);
    sR[2] = rho * (v1 - T(2) * vn * n[1]);
    sR[3] = rho * (v2 - T(2) * vn * n[2]);
    sR[4] = sL[4];
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) sR[c] = sL[c];
  }
}

// |v.n| + a with the pressure floored at 0 (DGCompFlow.charvel)
template <typename T>
__device__ __forceinline__ T charvel(const Eos<T>& eos, const T* s,
                                     const T* n) {
  const T rho = s[0];
  const T v0 = s[1] / rho, v1 = s[2] / rho, v2 = s[3] / rho;
  const T p = vmax(pressure_cons(eos, s), T(0));
  const T a = soundspeed(eos, rho, p);
  return fabs(dot3(v0, v1, v2, n)) + a;
}

template <typename T>
__device__ __forceinline__ void normal_flux(const T* u, T p, T vn,
                                            const T* n, T* f) {
  f[0] = u[0] * vn;
  f[1] = u[1] * vn + p * n[0];
  f[2] = u[2] * vn + p * n[1];
  f[3] = u[3] * vn + p * n[2];
  f[4] = (u[4] + p) * vn;
}

// HLLC flux with Roe-averaged signal velocities (ops/riemann.py hllc)
template <typename T>
__device__ void hllc(const Eos<T>& eos, const T* n, const T* uL,
                     const T* uR, T* fl) {
  const T rhoL = uL[0];
  const T vL0 = uL[1] / rhoL, vL1 = uL[2] / rhoL, vL2 = uL[3] / rhoL;
  const T pL = pressure(eos, rhoL, vL0, vL1, vL2, uL[4]);
  const T aL = soundspeed(eos, rhoL, pL);
  const T rhoR = uR[0];
  const T vR0 = uR[1] / rhoR, vR1 = uR[2] / rhoR, vR2 = uR[3] / rhoR;
  const T pR = pressure(eos, rhoR, vR0, vR1, vR2, uR[4]);
  const T aR = soundspeed(eos, rhoR, pR);
  const T vnL = dot3(vL0, vL1, vL2, n);
  const T vnR = dot3(vR0, vR1, vR2, n);

  const T rlr = sqrt(rhoR / rhoL);
  const T rlr1 = T(1) + rlr;
  const T vnroe = (vnR * rlr + vnL) / rlr1;
  const T aroe = (aR * rlr + aL) / rlr1;

  const T Sl = vmin(vnL - aL, vnroe - aroe);
  const T Sr = vmax(vnR + aR, vnroe + aroe);
  const T Sm = (rhoR * vnR * (Sr - vnR) - rhoL * vnL * (Sl - vnL) + pL - pR) /
               (rhoR * (Sr - vnR) - rhoL * (Sl - vnL));
  const T pStar = rhoL * (vnL - Sl) * (vnL - Sm) + pL;

  if (Sl > T(0)) {
    normal_flux(uL, pL, vnL, n, fl);
    return;
  }
  if (!(Sm > T(0)) && !(Sr >= T(0))) {
    normal_flux(uR, pR, vnR, n, fl);
    return;
  }
  // star state of the side the contact leaves behind
  const bool left = Sm > T(0);
  const T* u = left ? uL : uR;
  const T rho = left ? rhoL : rhoR;
  const T vn = left ? vnL : vnR;
  const T p = left ? pL : pR;
  const T S = left ? Sl : Sr;
  const T w = S - vn;
  const T den = S - Sm;
  T us[C];
  us[0] = w * rho / den;
  us[1] = (w * u[1] + (pStar - p) * n[0]) / den;
  us[2] = (w * u[2] + (pStar - p) * n[1]) / den;
  us[3] = (w * u[3] + (pStar - p) * n[2]) / den;
  us[4] = (w * u[4] - p * vn + pStar * Sm) / den;
  normal_flux(us, pStar, Sm, n, fl);
}

// Euler flux column j of state s with pressure p (euler_flux_dir)
template <typename T>
__device__ __forceinline__ void euler_flux_dir(const T* s, T p, int j,
                                               T* f) {
  const T rho = s[0];
  const T vj = s[1 + j] / rho;
  f[0] = s[1 + j];
  f[1] = s[1] * vj + (j == 0 ? p : T(0));
  f[2] = s[2] * vj + (j == 1 ? p : T(0));
  f[3] = s[3] * vj + (j == 2 ? p : T(0));
  f[4] = (s[4] + p) * vj;
}

}  // namespace qtk
