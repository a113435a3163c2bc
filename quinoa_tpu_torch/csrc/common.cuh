// Shared device code of the DG(P1) compressible-Euler kernels, and the
// multimat kernels' material constants (K14-K16).
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
// quadrature points.  The wrappers check the shapes against these.  The
// face kernels of every order (K12-K14) take K and G as template
// parameters of those names, which hide the P1 values below; K13 and K14
// take their row counts as template parameters too, never C.
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

// the entries of w_vol * dBdxi_vol (mode k, direction m) that are not
// zero for the P1 Dubiner basis: dB0 = 0, dB2/dxi = 0, dB3/dxi = dB3/deta
// = 0 (kernels/__init__.py WDB_NONZERO).  The plain versions skip w == 0,
// so K1's and K16's volume rows add exactly these terms; pack_tables
// refuses a table with other zeros.
__host__ __device__ constexpr bool wdb_nonzero(int k, int m) {
  return k == 1 || (k == 2 && m > 0) || (k == 3 && m == 2);
}

constexpr int BC_INTERIOR = 0;
constexpr int BC_SYMMETRY = 2;

// Riemann fluxes of the single-stream face kernel K12 (the int argument of
// its C entry points; kernels/__init__.py FLUXES)
constexpr int FLUX_HLLC = 0;
constexpr int FLUX_LF = 1;

template <typename T>
struct Eos {
  T gamma, gm1, pstiff;
};

// the multimat kernels' (K14, K16) per-material stiffened-gas constants,
// passed by value
template <typename T>
struct MMEos {
  T gamma[3], gm1[3], pstiff[3];
};

// MMEos of the wrappers' three (gamma, pstiff) pairs, gm1 = gamma - 1
// rounded once, as pde/eos.py's (self.gamma - 1.0)
template <typename T>
MMEos<T> mm_eos(const double* gamma, const double* pstiff) {
  MMEos<T> eos;
  for (int k = 0; k < 3; ++k) {
    eos.gamma[k] = T(gamma[k]);
    eos.gm1[k] = T(gamma[k] - 1.0);
    eos.pstiff[k] = T(pstiff[k]);
  }
  return eos;
}

// the floor of MultiMatSystem._prim's alpha and material density: 50 *
// the type's machine epsilon (torch.finfo(dtype).eps)
template <typename T>
__device__ __forceinline__ T mm_floor() {
  return T(50.0 * (sizeof(T) == 4 ? 1.1920928955078125e-07
                                  : 2.220446049250313e-16));
}

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

// num / den.  IEEE division sends a zero numerator to its slow path, a
// called subroutine (FCHK in the SASS); over a divisor that is neither
// zero nor NaN the quotient is the zero of the sign the division gives,
// formed here without it.  A branch, not a select: the division must not
// run on that side.  K1, K15 and K16 divide through it.
template <typename T>
__device__ __forceinline__ T quot(T num, T den) {
  if (num == T(0) && den == den && den != T(0))
    return signbit(num) != signbit(den) ? T(-0.0) : T(0);
  return num / den;
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

// P2 Dubiner basis at reference point (x, e, z): the P1 modes, then the
// six quadratic modes of ops/basis.py _basis_list, each written as the
// torch expression is evaluated (left to right, no fused multiply-adds)
template <typename T>
__device__ __forceinline__ void basis_p2(T x, T e, T z, T* B) {
  basis_p1(x, e, z, B);
  B[4] = T(6) * x * x + e * e + z * z + T(6) * x * e + T(6) * x * z +
         T(2) * e * z - T(6) * x - T(2) * e - T(2) * z + T(1);
  B[5] = T(5) * e * e + z * z + T(10) * x * e + T(2) * x * z +
         T(6) * e * z - T(2) * x - T(6) * e - T(2) * z + T(1);
  B[6] = T(6) * z * z + T(12) * x * z + T(6) * e * z - T(2) * x - e -
         T(7) * z + T(1);
  B[7] = T(10) * e * e + z * z + T(8) * e * z - T(8) * e - T(2) * z + T(1);
  B[8] = T(6) * z * z + T(18) * e * z - T(3) * e - T(7) * z + T(1);
  B[9] = T(15) * z * z - T(10) * z + T(1);
}

// the NB-mode basis (NB = 1: P0, 4: P1, 10: P2) of the face kernels
// K12-K14; at P0 the single mode is 1 and the point is not read
template <typename T, int NB>
__device__ __forceinline__ void basis_at(T x, T e, T z, T* B) {
  static_assert(NB == 1 || NB == 4 || NB == 10,
                "the face kernels take P0, P1 or P2");
  if constexpr (NB == 1) {
    B[0] = T(1);
  } else if constexpr (NB == 4) {
    basis_p1(x, e, z, B);
  } else {
    basis_p2(x, e, z, B);
  }
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

// Rusanov / Lax-Friedrichs flux (ops/riemann.py lax_friedrichs).  The
// pressure is not clamped: a negative one gives a NaN sound speed, which
// vmax carries into lam and the flux, as torch.maximum does.
template <typename T>
__device__ void lax_friedrichs(const Eos<T>& eos, const T* n, const T* uL,
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
  T fL[C], fR[C];
  normal_flux(uL, pL, vnL, n, fL);
  normal_flux(uR, pR, vnR, n, fR);
  const T lam = vmax(aL, aR) + vmax(fabs(vnL), fabs(vnR));
#pragma unroll
  for (int c = 0; c < C; ++c)
    fl[c] = T(0.5) * (fL[c] + fR[c] - lam * (uR[c] - uL[c]));
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

// K9 and K11: a node's slots in a (D, N) slot table, read along the node
// axis.  A slot is s = a*M + e, corner a of entity e of M, and A*M is a
// pad.  The corner comes from compares, not a division (the wrappers
// check that A*M fits an int).
template <int A>
__device__ __forceinline__ int slot_corner(int s, int M) {
  int a = 0;
#pragma unroll
  for (int k = 1; k <= A; ++k) a += s >= k * M;
  return a;
}

// Levels d0 .. d0 + GL - 1 of node n's slots, all loads issued before any
// is used; a level at or past D reads as the pad A*M.  Each id is read
// once, so it streams past L1 (__ldcs), which keeps L1 for the value
// gathers that neighbouring nodes share.
template <int A, int GL>
__device__ __forceinline__ void load_slots(const int* __restrict__ sup,
                                           int d0, int D, int N, int n,
                                           int M, int (&s)[GL]) {
#pragma unroll
  for (int g = 0; g < GL; ++g)
    s[g] = d0 + g < D ? __ldcs(sup + (size_t)(d0 + g) * N + n) : A * M;
}

}  // namespace qtk
