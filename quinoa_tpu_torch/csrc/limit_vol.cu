// K1 limit_vol: Superbee limiting of the P1 dofs plus the flux volume
// integral of the limited state, one thread per element.
//
// Replaces the TPU kernel quinoa_tpu/ops/nbr_bounds.py
// _make_bounds_limit_kernel + _bounds_body (pallas_call in
// superbee_limit_window).  Plain version: ops/nbr_bounds.py
// limit_vol_plain (superbee_p1 + volume_rhs_plain).
//
// Bound on the card: device-memory bytes.  Per element it reads 20 modal
// rows, 4 neighbour ids, 4 x 5 neighbour means, 9 jacInv entries and one
// volume, and writes 40 rows: about 75 words for a few hundred flops.
// Design: the element axis is the fastest axis of every array, so the
// 20-row reads and 40-row writes of a warp are coalesced; the neighbour
// means are gathers that the Hilbert element order keeps within nearby
// cache lines (the TPU kernel's 3-block window exists only because a TPU
// core cannot gather from HBM).  The 131 quadrature constants sit in
// shared memory.  The state lives in registers: the limited state never
// returns to device memory before the volume integral uses it.

#include "common.cuh"

namespace qtk {

template <typename T>
__global__ void __launch_bounds__(128)
limit_vol_kernel(const T* __restrict__ U, const int* __restrict__ nbr,
                 const T* __restrict__ jac, const T* __restrict__ vole,
                 const T* __restrict__ tab, T beta, Eos<T> eos,
                 T* __restrict__ ulim, T* __restrict__ rv, long long E) {
  __shared__ T st[TAB_SIZE];
  for (int i = threadIdx.x; i < TAB_SIZE; i += blockDim.x) st[i] = tab[i];
  __syncthreads();
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= E) return;

  T u[CK];
#pragma unroll
  for (int r = 0; r < CK; ++r) u[r] = U[r * E + e];

  // bounds: own mean and the valid face neighbours' means
  T hi[C], lo[C];
#pragma unroll
  for (int c = 0; c < C; ++c) hi[c] = lo[c] = u[c * K];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int n = nbr[a * E + e];
    if (n >= 0) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const T m = U[(c * K) * E + n];
        hi[c] = vmax(hi[c], m);
        lo[c] = vmin(lo[c], m);
      }
    }
  }

  // Superbee phi over the 4 x G self-face points (pde/limiter.py)
  const T eps = T(1.0e-14);
  T phi[C];
#pragma unroll
  for (int c = 0; c < C; ++c) phi[c] = T(1);
  for (int p = 0; p < 4 * G; ++p) {
    const T* B = st + TAB_BSELF + p * K;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const T u0 = u[c * K];
      const T uNeg = eval_mode_sum(B, u, c) - u0;
      T pg;
      if (uNeg > eps) {
        pg = vmin(T(1), (hi[c] - u0) / (T(2) * uNeg));
      } else if (uNeg < -eps) {
        pg = vmin(T(1), (lo[c] - u0) / (T(2) * uNeg));
      } else {
        pg = T(1);
      }
      pg = vmax(vmax(vmin(beta * pg, T(1)), vmin(pg, beta)), T(0));
      phi[c] = vmin(phi[c], pg);
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int k = 1; k < K; ++k) u[c * K + k] = u[c * K + k] * phi[c];
  }
#pragma unroll
  for (int r = 0; r < CK; ++r) ulim[r * E + e] = u[r];

  // flux volume integral of the limited state (volume_rhs_plain)
  T J[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) J[i] = jac[i * E + e];
  T R[CK];
#pragma unroll
  for (int r = 0; r < CK; ++r) R[r] = T(0);
  for (int g = 0; g < GV; ++g) {
    const T* B = st + TAB_BVOL + g * K;
    T s[C];
#pragma unroll
    for (int c = 0; c < C; ++c) s[c] = eval_mode_sum(B, u, c);
    const T p = pressure_cons(eos, s);
    T F[3][C];
#pragma unroll
    for (int j = 0; j < 3; ++j) euler_flux_dir(s, p, j, F[j]);
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      T fref[C];
#pragma unroll
      for (int c = 0; c < C; ++c)
        fref[c] = F[0][c] * J[3 * m] + F[1][c] * J[3 * m + 1] +
                  F[2][c] * J[3 * m + 2];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const T w = st[TAB_WDB + (g * K + k) * 3 + m];
        if (w == T(0)) continue;
#pragma unroll
        for (int c = 0; c < C; ++c) R[c * K + k] = R[c * K + k] + w * fref[c];
      }
    }
  }
  const T ve = vole[e];
#pragma unroll
  for (int r = 0; r < CK; ++r) rv[r * E + e] = R[r] * ve;
}

template <typename T>
int launch_limit_vol(const void* U, const void* nbr, const void* jac,
                     const void* vole, const void* tab, double beta,
                     double gamma, double pstiff, void* ulim, void* rv,
                     long long E, void* stream) {
  const int block = 128;
  const long long grid = (E + block - 1) / block;
  const Eos<T> eos{T(gamma), T(gamma - 1.0), T(pstiff)};
  limit_vol_kernel<T><<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)U, (const int*)nbr, (const T*)jac, (const T*)vole,
      (const T*)tab, T(beta), eos, (T*)ulim, (T*)rv, E);
  return (int)cudaGetLastError();
}

}  // namespace qtk

extern "C" int qtk_limit_vol_f32(const void* U, const void* nbr,
                                 const void* jac, const void* vole,
                                 const void* tab, double beta, double gamma,
                                 double pstiff, void* ulim, void* rv,
                                 long long E, void* stream) {
  return qtk::launch_limit_vol<float>(U, nbr, jac, vole, tab, beta, gamma,
                                      pstiff, ulim, rv, E, stream);
}

extern "C" int qtk_limit_vol_f64(const void* U, const void* nbr,
                                 const void* jac, const void* vole,
                                 const void* tab, double beta, double gamma,
                                 double pstiff, void* ulim, void* rv,
                                 long long E, void* stream) {
  return qtk::launch_limit_vol<double>(U, nbr, jac, vole, tab, beta, gamma,
                                       pstiff, ulim, rv, E, stream);
}
