// K16 mm_volume: multimat DG(P1)'s volume Gauss-point pass, the flux
// volume integral and the non-conservative terms of one element in one
// thread.
//
// Replaces no TPU kernel: the JAX package leaves both integrals to XLA
// (quinoa_tpu/pde/dg.py dg_rhs :341-370, quinoa_tpu/pde/multimat.py
// _nonconservative_ho :452-482), which the port ran as some 200 torch
// launches a stage (einsums, stacks and elementwise passes over (C, G, E)
// intermediates, with four host-table uploads).  Plain version:
// pde/multimat.py mm_volume_plain, in this kernel's sum order.
//
// Two flavours, a template flag (NCF) apart, over the limited state U
// (C*K, E), C = 3*nmat + 3:
//  - volume only: the flux volume integral Rv (C*K, E) scaled by
//    vol*emask, what pde/dg.py volume_rhs gives for a multimat P1 system;
//  - non-conservative, the step's: it also reads the face pass's sums acc
//    (R*K, E), R = C + 3*nmat + 1, and writes the stage's rhs
//    ((acc's C*K rows + Rv) + Rnc) * emask.  Rnc is the integral against
//    w*B of the non-conservative integrands (MultiMatSystem._ncf) at the
//    volume points, from the riemannDeriv rows dap (3*nmat) and the
//    velocity divergence divu, mode 0 of acc's last 3*nmat + 1 rows,
//    each over the volume; it is scaled by vol*emask and added to the
//    fraction and energy rows, the integrands of the others being zero.
//
// Bound on the card: device-memory bytes.  At mm_sod_dgp1's shape (nmat
// 2, float32, E = 1,572,864) the non-conservative flavour reads 90 words
// an element (U 36, acc 36 + 7, jacInv 9, vol, emask) and writes 36:
// 793 MB, 0.237 ms at 3.35 TB/s; the volume-only flavour reads 47 and
// writes 36, 0.156 ms.  The arithmetic is some 2,000 flops and 45 IEEE
// divisions an element (no fast math): at each of the 5 points the
// state's 4-term sums, the primitives (3 + 2 nmat divisions), 3 flux
// columns, their jacInv contraction and the 6 nonzero (mode, direction)
// entries of w*dB/dxi a component, then the integrands' 4 modes.
//
// Design: one thread an element, its rows in registers, a block of
// MV_TPB consecutive elements, so that each row's load is one coalesced
// line a warp.  Every load of the element (U, jacInv, vol, emask and,
// with NCF, the face rows) is issued before the first point is
// evaluated; the 100 quadrature constants (B_vol, w*dB/dxi, w*B) sit in
// shared memory.  The point loop stays rolled and everything inside it is
// unrolled, so each register array is indexed by constants.  No
// intermediate reaches device memory.
//
// Each value is the same expression in the same order as in the plain
// version, so the bits do not change: the point state is the basis sum
// in mode order, the primitives are MultiMatSystem._prim's without the
// sound speed (which flux_cols does not read), each sum that torch takes
// with Python's sum starts from 0, the velocity is divided through quot
// (common.cuh) as K1's point values divide it, alpha and the material
// density are floored at 50 eps with a NaN-propagating maximum like
// torch.clamp_min, and every accumulation runs over the points, then the
// directions, then the modes, adding only the entries of w*dB/dxi that
// are not zero (common.cuh wdb_nonzero).  K14's mm_prim is not shared:
// it also takes the sound speed and sums the density from its first
// material, where torch's sum starts from 0.

#include "common.cuh"

namespace qtk {

constexpr int MV_TPB = 128;   // elements (threads) a block
static_assert(GV * K <= MV_TPB, "one table entry a thread");

template <typename T, int NMAT, bool NCF>
__global__ void __launch_bounds__(MV_TPB)
mm_volume_kernel(const T* __restrict__ U, const T* __restrict__ jac,
                 const T* __restrict__ vol, const T* __restrict__ emask,
                 const T* __restrict__ tab, const T* __restrict__ wb,
                 MMEos<T> eos, const T* __restrict__ acc,
                 T* __restrict__ out, long long E) {
  static_assert(NMAT == 2 || NMAT == 3, "the multimat paths' nmat");
  constexpr int NC = 3 * NMAT + 3;   // components
  constexpr int D0 = NMAT, M0 = 2 * NMAT, E0 = 2 * NMAT + 3;   // row starts
  __shared__ T sB[GV * K], sWB[GV * K], sW[GV * K * 3];
  if (threadIdx.x < GV * K) {
    sB[threadIdx.x] = tab[TAB_BVOL + threadIdx.x];
    sWB[threadIdx.x] = wb[threadIdx.x];
  }
  for (int i = threadIdx.x; i < GV * K * 3; i += blockDim.x)
    sW[i] = tab[TAB_WDB + i];

  const long long e = blockIdx.x * (long long)MV_TPB + threadIdx.x;
  const bool live = e < E;
  T u[NC][K], J[9], f[NC][K], dap[3 * NMAT], dv = T(0), vo = T(0),
      em = T(0);
  if (live) {
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int k = 0; k < K; ++k) u[c][k] = U[(c * K + k) * E + e];
#pragma unroll
    for (int i = 0; i < 9; ++i) J[i] = jac[i * E + e];
    vo = vol[e];
    em = emask[e];
    if constexpr (NCF) {
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int k = 0; k < K; ++k) f[c][k] = acc[(c * K + k) * E + e];
#pragma unroll
      for (int j = 0; j < 3 * NMAT; ++j) dap[j] = acc[(NC + j) * K * E + e];
      dv = acc[(NC + 3 * NMAT) * K * E + e];
    }
  }
  __syncthreads();
  if (!live) return;

  const T ve = vo * em;
  // the face sums over the volume (a padding element's over 1), and
  // their totals over the materials
  T dtot[3];
  if constexpr (NCF) {
    const T V = vo * em + (T(1) - em);
#pragma unroll
    for (int j = 0; j < 3 * NMAT; ++j) dap[j] = dap[j] / V;
    dv = dv / V;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      dtot[i] = T(0);
#pragma unroll
      for (int k = 0; k < NMAT; ++k) dtot[i] = dtot[i] + dap[3 * k + i];
    }
  }
  const T floor = mm_floor<T>();

  T R[NC][K], Rn[2 * NMAT][K];   // Rv; Rnc of the fraction, energy rows
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int c = 0; c < NC; ++c) R[c][k] = T(0);
#pragma unroll
    for (int r = 0; r < 2 * NMAT; ++r) Rn[r][k] = T(0);
  }

#pragma unroll 1
  for (int g = 0; g < GV; ++g) {
    const T* B = sB + g * K;
    T s[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      s[c] = B[0] * u[c][0];
#pragma unroll
      for (int k = 1; k < K; ++k) s[c] = s[c] + B[k] * u[c][k];
    }
    // MultiMatSystem._prim: bulk density, velocity, floored fractions,
    // material pressures; hm the energies' enthalpy flux factor
    T rho = T(0);
#pragma unroll
    for (int k = 0; k < NMAT; ++k) rho = rho + s[D0 + k];
    T v[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) v[i] = quot(s[M0 + i], rho);
    T al[NMAT], hm[NMAT], pb = T(0);
#pragma unroll
    for (int k = 0; k < NMAT; ++k) {
      const T a = vmax(s[k], floor);
      const T rk = vmax(s[D0 + k] / a, floor);
      const T ek = s[E0 + k] / a;
      const Eos<T> eos_k{eos.gamma[k], eos.gm1[k], eos.pstiff[k]};
      const T ap = a * pressure(eos_k, rk, v[0], v[1], v[2], ek);
      al[k] = a;
      hm[k] = s[E0 + k] + ap;
      pb = pb + ap;
    }
    // MultiMatSystem.flux_cols, column j of component c, contracted with
    // jacInv row m and added through the nonzero w*dB/dxi entries
    const T* w = sW + g * K * 3;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      T F[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        if (c < D0)
          F[j] = al[c] * v[j];
        else if (c >= E0)
          F[j] = hm[c - E0] * v[j];
        else if (c >= M0 && c - M0 == j)
          F[j] = s[c] * v[j] + pb;
        else
          F[j] = s[c] * v[j];
      }
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        const T fref = F[0] * J[3 * m] + F[1] * J[3 * m + 1] +
                       F[2] * J[3 * m + 2];
#pragma unroll
        for (int k = 0; k < K; ++k)
          if (wdb_nonzero(k, m)) R[c][k] = R[c][k] + w[k * 3 + m] * fref;
      }
    }
    if constexpr (NCF) {
      // MultiMatSystem._ncf: alpha_k div(u) and the velocity-dotted
      // pressure-gradient exchange, integrated against w*B
      const T* wB = sWB + g * K;
#pragma unroll
      for (int k = 0; k < NMAT; ++k) {
        const T na = s[k] * dv;
        const T y = s[D0 + k] / rho;
        T ne = T(0);
#pragma unroll
        for (int i = 0; i < 3; ++i)
          ne = ne - v[i] * (y * dtot[i] - dap[3 * k + i]);
#pragma unroll
        for (int q = 0; q < K; ++q) {
          Rn[k][q] = Rn[k][q] + wB[q] * na;
          Rn[NMAT + k][q] = Rn[NMAT + k][q] + wB[q] * ne;
        }
      }
    }
  }

#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      T r = R[c][k] * ve;
      if constexpr (NCF) {
        r = f[c][k] + r;
        if (c < D0)
          r = r + Rn[c][k] * ve;
        else if (c >= E0)
          r = r + Rn[NMAT + c - E0][k] * ve;
        r = r * em;
      }
      out[(c * K + k) * E + e] = r;
    }
  }
}

template <typename T, int NMAT>
int launch_mm_volume_nmat(const void* U, const void* jac, const void* vol,
                          const void* emask, const void* tab, const void* wb,
                          const double* gamma, const double* pstiff,
                          const void* acc, void* out, long long E,
                          void* stream) {
  const MMEos<T> eos = mm_eos<T>(gamma, pstiff);
  const long long grid = (E + MV_TPB - 1) / MV_TPB;
  if (acc)
    mm_volume_kernel<T, NMAT, true>
        <<<(unsigned)grid, MV_TPB, 0, (cudaStream_t)stream>>>(
            (const T*)U, (const T*)jac, (const T*)vol, (const T*)emask,
            (const T*)tab, (const T*)wb, eos, (const T*)acc, (T*)out, E);
  else
    mm_volume_kernel<T, NMAT, false>
        <<<(unsigned)grid, MV_TPB, 0, (cudaStream_t)stream>>>(
            (const T*)U, (const T*)jac, (const T*)vol, (const T*)emask,
            (const T*)tab, (const T*)wb, eos, nullptr, (T*)out, E);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_mm_volume(const void* U, const void* jac, const void* vol,
                     const void* emask, const void* tab, const void* wb,
                     double g0, double g1, double g2, double p0, double p1,
                     double p2, const void* acc, void* out, int nmat,
                     long long E, void* stream) {
  const double gamma[3] = {g0, g1, g2}, pstiff[3] = {p0, p1, p2};
  switch (nmat) {
    case 2:
      return launch_mm_volume_nmat<T, 2>(U, jac, vol, emask, tab, wb, gamma,
                                         pstiff, acc, out, E, stream);
    case 3:
      return launch_mm_volume_nmat<T, 3>(U, jac, vol, emask, tab, wb, gamma,
                                         pstiff, acc, out, E, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace qtk

extern "C" int qtk_mm_volume_f32(const void* U, const void* jac,
                                 const void* vol, const void* emask,
                                 const void* tab, const void* wb, double g0,
                                 double g1, double g2, double p0, double p1,
                                 double p2, const void* acc, void* out,
                                 int nmat, long long E, void* stream) {
  return qtk::launch_mm_volume<float>(U, jac, vol, emask, tab, wb, g0, g1, g2,
                                      p0, p1, p2, acc, out, nmat, E, stream);
}

extern "C" int qtk_mm_volume_f64(const void* U, const void* jac,
                                 const void* vol, const void* emask,
                                 const void* tab, const void* wb, double g0,
                                 double g1, double g2, double p0, double p1,
                                 double p2, const void* acc, void* out,
                                 int nmat, long long E, void* stream) {
  return qtk::launch_mm_volume<double>(U, jac, vol, emask, tab, wb, g0, g1,
                                       g2, p0, p1, p2, acc, out, nmat, E,
                                       stream);
}
