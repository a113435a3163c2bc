// K7 alecg_vol: the ALECG Galerkin volume term per element, in two
// flavours (transport and compressible Euler).
//
// Replaces quinoa_tpu/ops/alecg_fused.py _make_vol_kernel (transport) and
// _make_vol_kernel_cf (compflow), the per-element half of their window
// passes: there a tile of element slots gathers the nodal state through
// one-hot window matmuls, evaluates the element term and scatters it back
// through the same windows.  Here the element gathers its four corner
// states through inpoelT, and the node sums are K9's (cg_assemble.cu).
// Plain version: ops/alecg_fused.py alecg_vol_plain, the JAX package's XLA
// formulation (quinoa_tpu/inciter/alecg.py:117-130):
//
//   cv[c, e] = -w[e] * sum_b sum_j grad[b, j, e] * F_j(u_b)[c]
//
// with w = J*emask/24 = V/4, summed over corners b = 0..3 and, inside
// each corner, over directions j = 0, 1, 2 in that order.  Transport:
// F_j = vel[c, j, n_b] * u_b, the static velocity of the corner's node
// n_b (rows (Cv, 3, N), component stride vs: 0 where every component
// has the same velocity).  Compflow: p = pressure_cons(u_b),
// F_j = euler_flux_dir(u_b, p, j).
//
// Bound on the card: device-memory bytes.  An element reads 4 node ids,
// 12 gradients and w and writes C values; its 4C states (and, for
// transport, 12 velocities) are gathered from node tables of 0.5-2.4 MB
// at 48^3, which the L2 holds.  Transport reads the velocity per node:
// per corner it would be 40% of the kernel's bytes.  Design: a thread
// per element reads its element rows once, streamed past L1 (__ldcs),
// which leaves L1 to the node gathers that neighbouring elements share.
// Transport issues every load and gather before the first product and
// carries at most AV_RPL rows a pass (a template parameter, so any row
// count runs).  Compflow goes corner by corner, as its arithmetic (an
// EoS and three flux columns a corner) would otherwise hold every
// gathered state in registers.  Both reach about a device copy of as
// many bytes; runs of 2-8 elements a thread, 16-byte vectors and 64-256
// threads a block gained nothing (PERF.md, section 6, the K7/K8 sweep).

#include "common.cuh"

namespace qtk {

constexpr int AV_RPL = 4;        // transport: rows a pass
constexpr int AV_BLOCK = 128;    // threads a block

template <typename T, int P>
__global__ void __launch_bounds__(AV_BLOCK)
alecg_vol_kernel(const T* __restrict__ u, const int* __restrict__ inpoelT,
                 const T* __restrict__ grad, const T* __restrict__ w,
                 const T* __restrict__ vel, T* __restrict__ cv, int nc,
                 long long vs, long long N, long long E) {
  const long long e = blockIdx.x * (long long)AV_BLOCK + threadIdx.x;
  if (e >= E) return;
  int node[4];
  T g[4][3];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    node[b] = __ldcs(inpoelT + b * E + e);
#pragma unroll
    for (int j = 0; j < 3; ++j) g[b][j] = __ldcs(grad + (b * 3 + j) * E + e);
  }
  const T mw = -__ldcs(w + e);
  for (int c0 = 0; c0 < nc; c0 += P) {
    T ub[P][4], vb[P][4][3];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      // a row past nc gathers row c0 again; its result is not stored
      const long long c = c0 + p < nc ? c0 + p : c0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        ub[p][b] = u[c * N + node[b]];
#pragma unroll
        for (int j = 0; j < 3; ++j)
          vb[p][b][j] = vel[c * vs + j * N + node[b]];
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      T divF = T(0);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const T x = ub[p][b];
        const T d = g[b][0] * (vb[p][b][0] * x) + g[b][1] * (vb[p][b][1] * x) +
                    g[b][2] * (vb[p][b][2] * x);
        divF = b == 0 ? d : divF + d;
      }
      if (c0 + p < nc) cv[(c0 + p) * E + e] = mw * divF;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(AV_BLOCK)
alecg_vol_cf_kernel(const T* __restrict__ u, const int* __restrict__ inpoelT,
                    const T* __restrict__ grad, const T* __restrict__ w,
                    Eos<T> eos, T* __restrict__ cv, long long N,
                    long long E) {
  const long long e = blockIdx.x * (long long)AV_BLOCK + threadIdx.x;
  if (e >= E) return;
  T divF[C] = {};
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const long long nb = __ldcs(inpoelT + b * E + e);
    const T g0 = __ldcs(grad + (b * 3 + 0) * E + e);
    const T g1 = __ldcs(grad + (b * 3 + 1) * E + e);
    const T g2 = __ldcs(grad + (b * 3 + 2) * E + e);
    T s[C];
#pragma unroll
    for (int c = 0; c < C; ++c) s[c] = u[c * N + nb];
    const T p = pressure_cons(eos, s);
    T F[3][C];
#pragma unroll
    for (int j = 0; j < 3; ++j) euler_flux_dir(s, p, j, F[j]);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const T d = g0 * F[0][c] + g1 * F[1][c] + g2 * F[2][c];
      divF[c] = b == 0 ? d : divF[c] + d;
    }
  }
  const T mw = -__ldcs(w + e);
#pragma unroll
  for (int c = 0; c < C; ++c) cv[c * E + e] = mw * divF[c];
}

// P rows a pass: the instance of P (1 .. AV_RPL)
template <typename T, int P>
int av_launch_p(int p, const void* u, const void* inpoelT, const void* grad,
                const void* w, const void* vel, void* cv, int nc,
                long long vs, long long N, long long E, cudaStream_t stream) {
  if constexpr (P == 0) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (p != P)
      return av_launch_p<T, P - 1>(p, u, inpoelT, grad, w, vel, cv, nc, vs, N,
                                   E, stream);
    const unsigned grid = (unsigned)((E + AV_BLOCK - 1) / AV_BLOCK);
    alecg_vol_kernel<T, P><<<grid, AV_BLOCK, 0, stream>>>(
        (const T*)u, (const int*)inpoelT, (const T*)grad, (const T*)w,
        (const T*)vel, (T*)cv, nc, vs, N, E);
    return (int)cudaGetLastError();
  }
}

template <typename T>
int launch_alecg_vol(const void* u, const void* inpoelT, const void* grad,
                     const void* w, const void* vel, void* cv, int nc,
                     long long vs, long long N, long long E, void* stream) {
  if (nc < 1 || N < 1 || E < 1) return (int)cudaErrorInvalidValue;
  return av_launch_p<T, AV_RPL>(nc < AV_RPL ? nc : AV_RPL, u, inpoelT, grad,
                                w, vel, cv, nc, vs, N, E,
                                (cudaStream_t)stream);
}

template <typename T>
int launch_alecg_vol_cf(const void* u, const void* inpoelT, const void* grad,
                        const void* w, double gamma, double pstiff, void* cv,
                        long long N, long long E, void* stream) {
  if (N < 1 || E < 1) return (int)cudaErrorInvalidValue;
  const Eos<T> eos{T(gamma), T(gamma - 1.0), T(pstiff)};
  const unsigned grid = (unsigned)((E + AV_BLOCK - 1) / AV_BLOCK);
  alecg_vol_cf_kernel<T><<<grid, AV_BLOCK, 0, (cudaStream_t)stream>>>(
      (const T*)u, (const int*)inpoelT, (const T*)grad, (const T*)w, eos,
      (T*)cv, N, E);
  return (int)cudaGetLastError();
}

}  // namespace qtk

extern "C" int qtk_alecg_vol_node_f32(const void* u, const void* inpoelT,
                                      const void* grad, const void* w,
                                      const void* vel, void* cv, int nc,
                                      long long vs, long long N, long long E,
                                      void* stream) {
  return qtk::launch_alecg_vol<float>(u, inpoelT, grad, w, vel, cv, nc, vs,
                                      N, E, stream);
}

extern "C" int qtk_alecg_vol_node_f64(const void* u, const void* inpoelT,
                                      const void* grad, const void* w,
                                      const void* vel, void* cv, int nc,
                                      long long vs, long long N, long long E,
                                      void* stream) {
  return qtk::launch_alecg_vol<double>(u, inpoelT, grad, w, vel, cv, nc, vs,
                                       N, E, stream);
}

extern "C" int qtk_alecg_vol_cf_f32(const void* u, const void* inpoelT,
                                    const void* grad, const void* w,
                                    double gamma, double pstiff, void* cv,
                                    long long N, long long E, void* stream) {
  return qtk::launch_alecg_vol_cf<float>(u, inpoelT, grad, w, gamma, pstiff,
                                         cv, N, E, stream);
}

extern "C" int qtk_alecg_vol_cf_f64(const void* u, const void* inpoelT,
                                    const void* grad, const void* w,
                                    double gamma, double pstiff, void* cv,
                                    long long N, long long E, void* stream) {
  return qtk::launch_alecg_vol_cf<double>(u, inpoelT, grad, w, gamma, pstiff,
                                          cv, N, E, stream);
}
