// K7 alecg_vol: the ALECG Galerkin volume term per element, one thread per
// element, in two flavours (transport and compressible Euler).
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
// F_j = vel[b, c, j, e] * u_b (the static corner velocity rows).
// Compflow: p = pressure_cons(u_b), F_j = euler_flux_dir(u_b, p, j).
//
// Bound on the card: device-memory bytes.  Transport reads 4 node ids,
// 4C gathered states, 12 gradients, w and 12C velocities and writes C
// values an element; compflow reads the 20 states instead of the
// velocities and writes 5.  Element-indexed rows are coalesced; the node
// gathers stay near each other because nodes are first-touch ordered
// along Hilbert-ordered elements.

#include "common.cuh"

namespace qtk {

template <typename T>
__global__ void __launch_bounds__(128)
alecg_vol_kernel(const T* __restrict__ u, const int* __restrict__ inpoelT,
                 const T* __restrict__ grad, const T* __restrict__ w,
                 const T* __restrict__ vel, T* __restrict__ cv, int nc,
                 long long N, long long E) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= E) return;
  long long node[4];
  T g[4][3];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    node[b] = inpoelT[b * E + e];
#pragma unroll
    for (int j = 0; j < 3; ++j) g[b][j] = grad[(b * 3 + j) * E + e];
  }
  const T mw = -w[e];
  for (int c = 0; c < nc; ++c) {
    T divF = T(0);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const T ub = u[c * N + node[b]];
      const T* v = vel + ((long long)(b * nc + c) * 3) * E + e;
      const T d = g[b][0] * (v[0] * ub) + g[b][1] * (v[E] * ub) +
                  g[b][2] * (v[2 * E] * ub);
      divF = b == 0 ? d : divF + d;
    }
    cv[c * E + e] = mw * divF;
  }
}

template <typename T>
__global__ void __launch_bounds__(128)
alecg_vol_cf_kernel(const T* __restrict__ u, const int* __restrict__ inpoelT,
                    const T* __restrict__ grad, const T* __restrict__ w,
                    Eos<T> eos, T* __restrict__ cv, long long N,
                    long long E) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= E) return;
  T divF[C] = {};
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const long long nb = inpoelT[b * E + e];
    T s[C];
#pragma unroll
    for (int c = 0; c < C; ++c) s[c] = u[c * N + nb];
    const T p = pressure_cons(eos, s);
    T F[3][C];
#pragma unroll
    for (int j = 0; j < 3; ++j) euler_flux_dir(s, p, j, F[j]);
    const T g0 = grad[(b * 3 + 0) * E + e];
    const T g1 = grad[(b * 3 + 1) * E + e];
    const T g2 = grad[(b * 3 + 2) * E + e];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const T d = g0 * F[0][c] + g1 * F[1][c] + g2 * F[2][c];
      divF[c] = b == 0 ? d : divF[c] + d;
    }
  }
  const T mw = -w[e];
#pragma unroll
  for (int c = 0; c < C; ++c) cv[c * E + e] = mw * divF[c];
}

template <typename T>
int launch_alecg_vol(const void* u, const void* inpoelT, const void* grad,
                     const void* w, const void* vel, void* cv, int nc,
                     long long N, long long E, void* stream) {
  const int block = 128;
  const long long grid = (E + block - 1) / block;
  alecg_vol_kernel<T><<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)u, (const int*)inpoelT, (const T*)grad, (const T*)w,
      (const T*)vel, (T*)cv, nc, N, E);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_alecg_vol_cf(const void* u, const void* inpoelT, const void* grad,
                        const void* w, double gamma, double pstiff, void* cv,
                        long long N, long long E, void* stream) {
  const int block = 128;
  const long long grid = (E + block - 1) / block;
  const Eos<T> eos{T(gamma), T(gamma - 1.0), T(pstiff)};
  alecg_vol_cf_kernel<T><<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)u, (const int*)inpoelT, (const T*)grad, (const T*)w, eos,
      (T*)cv, N, E);
  return (int)cudaGetLastError();
}

}  // namespace qtk

extern "C" int qtk_alecg_vol_f32(const void* u, const void* inpoelT,
                                 const void* grad, const void* w,
                                 const void* vel, void* cv, int nc,
                                 long long N, long long E, void* stream) {
  return qtk::launch_alecg_vol<float>(u, inpoelT, grad, w, vel, cv, nc, N, E,
                                      stream);
}

extern "C" int qtk_alecg_vol_f64(const void* u, const void* inpoelT,
                                 const void* grad, const void* w,
                                 const void* vel, void* cv, int nc,
                                 long long N, long long E, void* stream) {
  return qtk::launch_alecg_vol<double>(u, inpoelT, grad, w, vel, cv, nc, N, E,
                                       stream);
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
