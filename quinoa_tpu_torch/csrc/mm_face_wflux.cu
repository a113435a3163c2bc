// K14 mm_face_wflux: the multimat flavour of K12 (face_wflux.cu).  One
// thread per face point writes, at each of the face's G Gauss points, the
// weighted AUSM+up flux of the velocity-equilibrium multi-material system
// and its riemannDeriv rows, for NMAT = 2 or 3 materials at DG(P0) (K = 1,
// G = 1) and DG(P1) (K = 4, G = 3); at DG(P1) also with THINC interface
// sharpening (template parameter THINC).
//
// Replaces the multimat instance of the TPU near/far face pass:
// quinoa_tpu/ops/face_fused.py _make_nearfar_kernel, _make_far_rstate_kernel
// and _make_far_raccum_kernel (B2-B5) tracing quinoa_tpu/pde/multimat.py
// _FusedMMFacade (riemann, bc_state, charvel).  The accumulation is K13's
// (basis_accum.cu) at R rows.  Plain version: ops/face_fused.py
// mm_face_wflux_plain, i.e. pde/multimat.py MultiMatSystem._prim, ausm,
// bc_state, charvel and _split_mach (and _FusedMMFacade._thinc_faces),
// evaluated in the same order.
//
// Per face: gather the C = 3*NMAT + 3 modal rows of el and er (the TPU
// state's 3*NMAT + 1 zero carrier rows are not read: they exist only for
// its generic kernel), evaluate the basis and the states at the G points,
// substitute a finite unit state on pad faces (their weights are zero),
// apply the symmetry/extrapolate ghost (the momentum rebuilt as
// rho * (v - 2 (v.n) n) from the rho-divided velocity), then the
// primitives, AUSM+up and the charvel, and write, with wt = w_g * area *
// fmask and R = C + 3*NMAT + 1,
//   wfl (R*G, F): row r*G + g = [flux (C) | -ap_k*n_i (3*NMAT) | -vriem]*wt,
//   mx (F,) = sum_g wt * (interior ? max(vl, vr) : vl).
// The signs make K13's (-left, +right) sums give +dap at the left element
// and -dap at the right, as _FusedMMFacade.riemann does.
//
// THINC (quinoa_tpu/pde/multimat.py _FusedMMFacade(thinc=True), whose
// carriers the JAX package's kernels gather as 5*NMAT more state rows of
// K modes): here the carriers X (8*NMAT, E) are compact, per material the
// 4 modes of the interface coordinate q, then the cell constants q0, the
// flag, rho_k and rhoE_k, read as one word each (their higher modes are
// zero, so B*x sums to the constant exactly).  A side's carriers are its
// element's, all 1.0 on pad faces (the unit state), and the ghost keeps
// the left side's.  After the ghost, the charvel takes the raw states;
// then both states get the tanh profile alpha = (1 + tanh(beta (q -
// q0)))/2 where flag > 0.5, the fractions are renormalised by max(sum,
// 50 eps), flagged materials re-derive alpha rho and alpha rhoE from the
// cell means, and the momentum is rescaled by rho_new / rho_lin; AUSM+up
// takes the sharpened states.  tanh is libm's (no fast math), the
// function torch's CUDA tanh calls.
//
// Floors and guards, as _prim: alpha and the material density at 50
// epsilons of the type (float32: 5.96e-6, above ALPHAMIN = 1e-12, so trace
// materials are floored on every face), the pressure at 1e-30 in the sound
// speed, mach == 0 guarded in the supersonic pressure split, 1e-16 in the
// upwind weights of ap.  min/max propagate NaN as torch does (vmin/vmax).
//
// Bound on the card: device-memory bytes (a P1 face reads 2 x 4C state
// words, with THINC 2 x 8*NMAT carrier words, 18 Gauss coordinates and 8
// words of face data, and writes 3R + 1 words; AUSM+up is ~300 flops a
// point, THINC adds two primitive evaluations and ~40 flops a material
// and side; at P0 10 state and 8 face words against ~300 flops).
//
// Design at DG(P1): gather apart from compute.  A block takes a tile of
// TILE faces (mm_tile) and G*TILE threads.  First the threads copy the
// tile's el and er state rows (and the THINC carriers) into shared memory,
// one row at a time across the tile: a warp's reads of a row are the el
// (or er) of 32 consecutive faces, which the el-sorted faces and the
// Hilbert element order keep near each other, and every state word is
// read once a face (one thread per face, looping over the points, read
// the carriers again at every point).  Then thread (g, j) evaluates both
// sides at point g of face j from shared memory (the basis sum in mode
// order), applies the pad substitution, the ghost, the charvel, THINC, the
// primitives and AUSM+up, and writes its R weighted rows; threads are
// point-major, so a warp writes 32 consecutive faces of one wfl row.  The
// face's mx is summed in point order by its point-0 thread through shared
// memory.  That is three times the threads of one thread per face, and no
// 2 x 4C-word state arrays in registers (one thread per face needs 211
// float32 registers at THINC nmat 3).  ptxas, float32: THINC nmat 3 / 2
// 80 / 56 registers, plain AUSM+up nmat 3 / 2 72 / 56, the nmat 2 tiles
// with 8 / 12 bytes of spill; float64 at most 148, no spill.  Shared
// memory: (2 x 4C + 2 x 8*NMAT + G) x TILE words, at most 37.6 KB.  At
// DG(P0) a thread per face reads its states directly
// (mm_face_wflux_p0_kernel, 59 / 69 float32 registers): there the gather
// does not pay.  The template parameters K and G hide common.cuh's DG(P1)
// constants of those names; C is never used here.

#include "common.cuh"

namespace qtk {

// MultiMatSystem._prim of one face-point state
template <typename T, int NMAT>
struct MMPrim {
  T rho, vel[3], al[NMAT], pm[NMAT], hm[NMAT], am[NMAT];
};

template <typename T, int NMAT>
__device__ __forceinline__ void mm_prim(const MMEos<T>& eos, const T* u,
                                        MMPrim<T, NMAT>& q) {
  constexpr int D = NMAT, M = 2 * NMAT, EN = 2 * NMAT + 3;
  const T floor = mm_floor<T>();
  T rho = u[D];
#pragma unroll
  for (int k = 1; k < NMAT; ++k) rho = rho + u[D + k];
  q.rho = rho;
#pragma unroll
  for (int i = 0; i < 3; ++i) q.vel[i] = u[M + i] / rho;
#pragma unroll
  for (int k = 0; k < NMAT; ++k) {
    const Eos<T> ek{eos.gamma[k], eos.gm1[k], eos.pstiff[k]};
    const T a = vmax(u[k], floor);
    const T rk = vmax(u[D + k] / a, floor);
    const T e = u[EN + k] / a;
    const T p = pressure(ek, rk, q.vel[0], q.vel[1], q.vel[2], e);
    q.al[k] = a;
    q.pm[k] = p;
    q.hm[k] = u[EN + k] + a * p;
    q.am[k] = soundspeed(ek, rk, vmax(p, T(1e-30)));
  }
}

// AUSM+ split Mach/pressure polynomials (_split_mach), f_a = 1
template <typename T>
__device__ __forceinline__ void split_mach(T mach, T& msp, T& msm, T& psp,
                                           T& psm) {
  const T am = fabs(mach);
  const T m1p = T(0.5) * (mach + am);
  const T m1m = T(0.5) * (mach - am);
  const T mp1 = mach + T(1), mm1 = mach - T(1);
  const T m2p = T(0.25) * (mp1 * mp1);
  const T m2m = T(-0.25) * (mm1 * mm1);
  const T c = T(16.0 * (3.0 / 16.0));  // 16 alpha
  const bool sup = am >= T(1);
  const T msafe = mach == T(0) ? T(1) : mach;
  msp = sup ? m1p : m2p * (T(1) - T(2) * m2m);
  msm = sup ? m1m : m2m * (T(1) + T(2) * m2p);
  psp = sup ? m1p / msafe : m2p * ((T(2) - mach) - c * mach * m2m);
  psm = sup ? m1m / msafe : m2m * ((T(-2) - mach) + c * mach * m2p);
}

// AUSM+up flux (C rows) and the riemannDeriv rows -ap_k*n_i, -vriem
template <typename T, int NMAT>
__device__ void mm_ausm(const T* n, const T* uL, const T* uR,
                        const MMPrim<T, NMAT>& L, const MMPrim<T, NMAT>& R,
                        T* fl) {
  constexpr int NC = 3 * NMAT + 3;
  constexpr int D = NMAT, M = 2 * NMAT, EN = 2 * NMAT + 3;
  T pl = L.al[0] * L.pm[0], pr = R.al[0] * R.pm[0];
#pragma unroll
  for (int k = 1; k < NMAT; ++k) {
    pl = pl + L.al[k] * L.pm[k];
    pr = pr + R.al[k] * R.pm[k];
  }
  // mixture speed of sound from averaged material states
  const T rho12 = T(0.5) * (L.rho + R.rho);
  T ac2 = T(0);
#pragma unroll
  for (int k = 0; k < NMAT; ++k) {
    const T al12 = T(0.5) * (L.al[k] + R.al[k]);
    const T rm12 = T(0.5) * (uL[D + k] / L.al[k] + uR[D + k] / R.al[k]);
    const T am12 = T(0.5) * (L.am[k] + R.am[k]);
    const T term = al12 * rm12 * am12 * am12;
    ac2 = k == 0 ? term : ac2 + term;
  }
  const T ac12 = sqrt(ac2 / rho12);
  const T vnl = dot3(L.vel[0], L.vel[1], L.vel[2], n);
  const T vnr = dot3(R.vel[0], R.vel[1], R.vel[2], n);
  T mspl, msml, pspl, psml, mspr, msmr, pspr, psmr;
  split_mach(vnl / ac12, mspl, msml, pspl, psml);
  split_mach(vnr / ac12, mspr, msmr, pspr, psmr);

  const T m12 = mspl + msmr;  // k_p = 0
  const T vriem = ac12 * m12;
  const T p12 = pspl * pl + psmr * pr;  // k_u = 0
  const T lp = T(0.5) * (vriem + fabs(vriem));
  const T lm = T(0.5) * (vriem - fabs(vriem));
#pragma unroll
  for (int k = 0; k < NMAT; ++k) {
    fl[k] = lp * L.al[k] + lm * R.al[k];
    fl[D + k] = lp * uL[D + k] + lm * uR[D + k];
    fl[EN + k] = lp * L.hm[k] + lm * R.hm[k];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
    fl[M + i] = lp * uL[M + i] + lm * uR[M + i] + p12 * n[i];

  // Riemann-advected partial pressures, upwinded by the sign of vriem
  const T lpn = lp / (fabs(vriem) + T(1e-16));
  const T lmn = lm / (fabs(vriem) + T(1e-16));
#pragma unroll
  for (int k = 0; k < NMAT; ++k) {
    const T apl = L.al[k] * L.pm[k];
    const T apr = R.al[k] * R.pm[k];
    const T ap = fabs(lpn) > T(1e-10)
                     ? apl
                     : (fabs(lmn) > T(1e-10) ? apr : T(0.5) * (apl + apr));
#pragma unroll
    for (int i = 0; i < 3; ++i) fl[NC + 3 * k + i] = -(ap * n[i]);
  }
  fl[NC + 3 * NMAT] = -vriem;
}

// THINC carriers of one side at one face point: q from its 4 P1 modes with
// the side's basis (in mode order), the cell constants as stored
template <typename T, int NMAT>
struct ThincCarriers {
  T q[NMAT], q0[NMAT], flag[NMAT], rho[NMAT], rhoE[NMAT];
};

// the 8*NMAT carrier rows of one side, stride words apart (shared memory)
template <typename T, int NMAT>
__device__ __forceinline__ void thinc_at(const T* x0, int stride, const T* B,
                                         ThincCarriers<T, NMAT>& c) {
#pragma unroll
  for (int k = 0; k < NMAT; ++k) {
    const T* x = x0 + 8 * k * stride;
    T q = B[0] * x[0];
#pragma unroll
    for (int m = 1; m < 4; ++m) q = q + B[m] * x[m * stride];
    c.q[k] = q;
    c.q0[k] = x[4 * stride];
    c.flag[k] = x[5 * stride];
    c.rho[k] = x[6 * stride];
    c.rhoE[k] = x[7 * stride];
  }
}

template <typename T, int NMAT>
__device__ __forceinline__ void thinc_unit(ThincCarriers<T, NMAT>& c) {
#pragma unroll
  for (int k = 0; k < NMAT; ++k)
    c.q[k] = c.q0[k] = c.flag[k] = c.rho[k] = c.rhoE[k] = T(1);
}

// _FusedMMFacade._thinc_faces on one face-point state s (NC rows), in place
template <typename T, int NMAT>
__device__ __forceinline__ void thinc_faces(const ThincCarriers<T, NMAT>& c,
                                            T beta, T* s) {
  constexpr int D = NMAT, M = 2 * NMAT, EN = 2 * NMAT + 3;
  T an[NMAT];
  bool fl[NMAT];
#pragma unroll
  for (int k = 0; k < NMAT; ++k) {
    const T ath = T(0.5) * (T(1) + tanh(beta * (c.q[k] - c.q0[k])));
    fl[k] = c.flag[k] > T(0.5);
    an[k] = fl[k] ? ath : s[k];
  }
  T ssum = an[0];
#pragma unroll
  for (int k = 1; k < NMAT; ++k) ssum = ssum + an[k];
  const T den = vmax(ssum, mm_floor<T>());
  T rho_new = T(0), rho_lin = T(0);
#pragma unroll
  for (int k = 0; k < NMAT; ++k) {
    an[k] = an[k] / den;
    const T dl = s[D + k];
    const T dk = fl[k] ? an[k] * c.rho[k] : dl;
    const T ek = fl[k] ? an[k] * c.rhoE[k] : s[EN + k];
    s[k] = an[k];
    s[D + k] = dk;
    s[EN + k] = ek;
    rho_new = k == 0 ? dk : rho_new + dk;
    rho_lin = k == 0 ? dl : rho_lin + dl;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) s[M + i] = rho_new * (s[M + i] / rho_lin);
}

// |v.n| + the mixture sound speed (MultiMatSystem.charvel)
template <typename T, int NMAT>
__device__ __forceinline__ T mm_charvel(const T* u, const MMPrim<T, NMAT>& q,
                                        const T* n) {
  constexpr int D = NMAT;
  T s = T(0);
#pragma unroll
  for (int k = 0; k < NMAT; ++k) {
    const T term = q.al[k] * (u[D + k] / q.al[k]) * (q.am[k] * q.am[k]);
    s = k == 0 ? term : s + term;
  }
  const T ac = sqrt(s / q.rho);
  return fabs(dot3(q.vel[0], q.vel[1], q.vel[2], n)) + ac;
}

// ghost state of a boundary face (MultiMatSystem.bc_state): symmetry
// reflects the rho-divided velocity, every other code copies
template <typename T, int NMAT>
__device__ __forceinline__ void mm_bc_state(int bt, const T* sL, const T* n,
                                            T* sR) {
  constexpr int NC = 3 * NMAT + 3, D = NMAT, M = 2 * NMAT;
#pragma unroll
  for (int c = 0; c < NC; ++c) sR[c] = sL[c];
  if (bt == BC_SYMMETRY) {
    T rho = sL[D];
#pragma unroll
    for (int k = 1; k < NMAT; ++k) rho = rho + sL[D + k];
    const T v0 = sL[M] / rho, v1 = sL[M + 1] / rho, v2 = sL[M + 2] / rho;
    const T vn = dot3(v0, v1, v2, n);
    sR[M] = rho * (v0 - T(2) * vn * n[0]);
    sR[M + 1] = rho * (v1 - T(2) * vn * n[1]);
    sR[M + 2] = rho * (v2 - T(2) * vn * n[2]);
  }
}

// DG(P0) (K = G = 1): one thread a face reads its 2 x C state words
// directly, where the shared-memory gather of the P1 kernel does not pay
// (PERF.md section 6); the basis is 1, so a state is its mode 0
template <typename T, int NMAT>
__global__ void __launch_bounds__(128)
mm_face_wflux_p0_kernel(const T* __restrict__ U, const int* __restrict__ el_,
                        const int* __restrict__ er_, const T* __restrict__ fn,
                        const T* __restrict__ farea,
                        const T* __restrict__ fmask,
                        const int* __restrict__ bctype,
                        const T* __restrict__ wface, MMEos<T> eos,
                        T* __restrict__ wfl, T* __restrict__ mxout,
                        long long E, long long F) {
  constexpr int NC = 3 * NMAT + 3;
  constexpr int NR = NC + 3 * NMAT + 1;
  const long long f = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (f >= F) return;
  const long long el = el_[f], er = er_[f];
  T sL[NC], sR[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    sL[c] = U[c * E + el];
    sR[c] = U[c * E + er];
  }
  const T n[3] = {fn[f], fn[F + f], fn[2 * F + f]};
  const T fa = farea[f] * fmask[f];
  const bool valid = fmask[f] > T(0);
  const int bt = bctype[f];
  const bool interior = bt == BC_INTERIOR;
  if (!valid) {
#pragma unroll
    for (int c = 0; c < NC; ++c) sL[c] = sR[c] = T(1);
  }
  if (!interior) mm_bc_state<T, NMAT>(bt, sL, n, sR);
  MMPrim<T, NMAT> pL, pR;
  mm_prim<T, NMAT>(eos, sL, pL);
  mm_prim<T, NMAT>(eos, sR, pR);
  const T wt = wface[0] * fa;
  const T vl = mm_charvel<T, NMAT>(sL, pL, n);
  mxout[f] = wt * (interior ? vmax(vl, mm_charvel<T, NMAT>(sR, pR, n)) : vl);
  T fl[NR];
  mm_ausm<T, NMAT>(n, sL, sR, pL, pR, fl);
#pragma unroll
  for (int r = 0; r < NR; ++r) wfl[r * F + f] = fl[r] * wt;
}

// faces a block of the DG(P1) kernel takes (3 threads a face): 64 for the
// float32 THINC instance at nmat 3, 32 otherwise, the faster of the two on
// the card (PERF.md section 6); the tile stays under 48 KB of shared memory
template <typename T, int NMAT, bool THINC>
__host__ __device__ constexpr int mm_tile() {
  return sizeof(T) == 4 && THINC && NMAT == 3 ? 64 : 32;
}

template <typename T, int NMAT, int K, int G, bool THINC>
__global__ void __launch_bounds__(mm_tile<T, NMAT, THINC>() * G)
mm_face_wflux_kernel(const T* __restrict__ U, const int* __restrict__ el_,
                     const int* __restrict__ er_, const T* __restrict__ fn,
                     const T* __restrict__ farea, const T* __restrict__ fmask,
                     const T* __restrict__ xil, const T* __restrict__ xir,
                     const int* __restrict__ bctype,
                     const T* __restrict__ wface, MMEos<T> eos,
                     const T* __restrict__ X, T beta, T* __restrict__ wfl,
                     T* __restrict__ mxout, long long E, long long F) {
  static_assert(!THINC || K == 4, "THINC is a DG(P1) flavour");
  constexpr int NC = 3 * NMAT + 3;
  constexpr int NR = NC + 3 * NMAT + 1;
  constexpr int TILE = mm_tile<T, NMAT, THINC>();
  constexpr int NX = THINC ? 8 * NMAT : 1;  // carrier rows (1: unused)
  __shared__ T sU[2][NC * K][TILE];         // el, er state rows
  __shared__ T sX[2][NX][TILE];             // el, er carrier rows
  __shared__ T smx[G][TILE];                // each point's weighted charvel
  // thread (g, j): point g of face f0 + j; a warp is 32 faces at one point
  const int g = threadIdx.x / TILE, j = threadIdx.x % TILE;
  const long long f0 = blockIdx.x * (long long)TILE, f = f0 + j;
  const bool active = f < F;

  // gather: thread (g, j) copies rows g, g + G, ... of face j's el and er
  if (active) {
    const long long el = el_[f], er = er_[f];
#pragma unroll
    for (int i = 0; i < (NC * K + G - 1) / G; ++i) {
      const int r = g + i * G;
      if (r < NC * K) {
        sU[0][r][j] = U[r * E + el];
        sU[1][r][j] = U[r * E + er];
      }
    }
    if constexpr (THINC) {
#pragma unroll
      for (int i = 0; i < (NX + G - 1) / G; ++i) {
        const int r = g + i * G;
        if (r < NX) {
          sX[0][r][j] = X[r * E + el];
          sX[1][r][j] = X[r * E + er];
        }
      }
    }
  }
  __syncthreads();

  if (active) {
    const T n[3] = {fn[f], fn[F + f], fn[2 * F + f]};
    const T fa = farea[f] * fmask[f];
    const bool valid = fmask[f] > T(0);
    const int bt = bctype[f];
    const bool interior = bt == BC_INTERIOR;
    T Bl[K], Br[K];
    basis_at<T, K>(xil[g * F + f], xil[(G + g) * F + f],
                   xil[(2 * G + g) * F + f], Bl);
    basis_at<T, K>(xir[g * F + f], xir[(G + g) * F + f],
                   xir[(2 * G + g) * F + f], Br);
    T sL[NC], sR[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      T a = Bl[0] * sU[0][c * K][j], b = Br[0] * sU[1][c * K][j];
#pragma unroll
      for (int k = 1; k < K; ++k) {
        a = a + Bl[k] * sU[0][c * K + k][j];
        b = b + Br[k] * sU[1][c * K + k][j];
      }
      sL[c] = a;
      sR[c] = b;
    }
    if (!valid) {
#pragma unroll
      for (int c = 0; c < NC; ++c) sL[c] = sR[c] = T(1);
    }
    if (!interior) mm_bc_state<T, NMAT>(bt, sL, n, sR);
    MMPrim<T, NMAT> pL, pR;
    mm_prim<T, NMAT>(eos, sL, pL);
    mm_prim<T, NMAT>(eos, sR, pR);
    const T wt = wface[g] * fa;
    const T vl = mm_charvel<T, NMAT>(sL, pL, n);
    smx[g][j] =
        wt * (interior ? vmax(vl, mm_charvel<T, NMAT>(sR, pR, n)) : vl);
    if constexpr (THINC) {
      ThincCarriers<T, NMAT> cL, cR;
      if (valid) {
        thinc_at<T, NMAT>(&sX[0][0][j], TILE, Bl, cL);
        if (interior) {
          thinc_at<T, NMAT>(&sX[1][0][j], TILE, Br, cR);
        } else {
          cR = cL;
        }
      } else {
        thinc_unit<T, NMAT>(cL);
        cR = cL;
      }
      thinc_faces<T, NMAT>(cL, beta, sL);
      thinc_faces<T, NMAT>(cR, beta, sR);
      mm_prim<T, NMAT>(eos, sL, pL);
      mm_prim<T, NMAT>(eos, sR, pR);
    }
    T fl[NR];
    mm_ausm<T, NMAT>(n, sL, sR, pL, pR, fl);
#pragma unroll
    for (int r = 0; r < NR; ++r) wfl[(r * G + g) * F + f] = fl[r] * wt;
  }
  __syncthreads();

  // the face's charvel, summed in point order by its point-0 thread
  if (active && g == 0) {
    T mx = smx[0][j];
#pragma unroll
    for (int q = 1; q < G; ++q) mx = mx + smx[q][j];
    mxout[f] = mx;
  }
}

template <typename T, int NMAT, int K, int G, bool THINC>
void launch_mm_face_wflux_nkg(const void* U, const void* el, const void* er,
                              const void* fn, const void* farea,
                              const void* fmask, const void* xil,
                              const void* xir, const void* bctype,
                              const void* wface, const MMEos<T>& eos,
                              const void* X, double beta, void* wfl, void* mx,
                              long long E, long long F, cudaStream_t stream) {
  if constexpr (K == 1) {
    static_assert(G == 1 && !THINC, "DG(P0) has one point and no THINC");
    const long long grid = (F + 127) / 128;
    mm_face_wflux_p0_kernel<T, NMAT><<<(unsigned)grid, 128, 0, stream>>>(
        (const T*)U, (const int*)el, (const int*)er, (const T*)fn,
        (const T*)farea, (const T*)fmask, (const int*)bctype,
        (const T*)wface, eos, (T*)wfl, (T*)mx, E, F);
  } else {
    constexpr int TILE = mm_tile<T, NMAT, THINC>();
    const long long grid = (F + TILE - 1) / TILE;
    mm_face_wflux_kernel<T, NMAT, K, G, THINC>
        <<<(unsigned)grid, TILE * G, 0, stream>>>(
            (const T*)U, (const int*)el, (const int*)er, (const T*)fn,
            (const T*)farea, (const T*)fmask, (const T*)xil, (const T*)xir,
            (const int*)bctype, (const T*)wface, eos, (const T*)X, T(beta),
            (T*)wfl, (T*)mx, E, F);
  }
}

template <typename T>
int launch_mm_face_wflux(const void* U, const void* el, const void* er,
                         const void* fn, const void* farea, const void* fmask,
                         const void* xil, const void* xir, const void* bctype,
                         const void* wface, const double* gamma,
                         const double* pstiff, const void* X, double beta,
                         void* wfl, void* mx, int nmat, int ndof, int thinc,
                         long long E, long long F, void* stream) {
  const MMEos<T> eos = mm_eos<T>(gamma, pstiff);
  const cudaStream_t s = (cudaStream_t)stream;
#define QTK_MM_FACE_WFLUX(NM, KK, GG, TH)                                   \
  if (nmat == NM && ndof == KK && (thinc != 0) == TH) {                     \
    launch_mm_face_wflux_nkg<T, NM, KK, GG, TH>(                            \
        U, el, er, fn, farea, fmask, xil, xir, bctype, wface, eos, X, beta, \
        wfl, mx, E, F, s);                                                  \
    return (int)cudaGetLastError();                                         \
  }
  QTK_MM_FACE_WFLUX(2, 1, 1, false)
  QTK_MM_FACE_WFLUX(2, 4, 3, false)
  QTK_MM_FACE_WFLUX(3, 1, 1, false)
  QTK_MM_FACE_WFLUX(3, 4, 3, false)
  QTK_MM_FACE_WFLUX(2, 4, 3, true)
  QTK_MM_FACE_WFLUX(3, 4, 3, true)
#undef QTK_MM_FACE_WFLUX
  return (int)cudaErrorInvalidValue;
}

}  // namespace qtk

#define QTK_MM_FACE_WFLUX_C(SFX, TYPE)                                      \
  extern "C" int qtk_mm_face_wflux_##SFX(                                   \
      const void* U, const void* el, const void* er, const void* fn,        \
      const void* farea, const void* fmask, const void* xil,                \
      const void* xir, const void* bctype, const void* wface, double g0,    \
      double g1, double g2, double p0, double p1, double p2, const void* X, \
      double beta, void* wfl, void* mx, int nmat, int ndof, int thinc,      \
      long long E, long long F, void* stream) {                             \
    const double gamma[3] = {g0, g1, g2}, pstiff[3] = {p0, p1, p2};         \
    return qtk::launch_mm_face_wflux<TYPE>(                                 \
        U, el, er, fn, farea, fmask, xil, xir, bctype, wface, gamma, pstiff, \
        X, beta, wfl, mx, nmat, ndof, thinc, E, F, stream);                 \
  }
QTK_MM_FACE_WFLUX_C(f32, float)
QTK_MM_FACE_WFLUX_C(f64, double)
