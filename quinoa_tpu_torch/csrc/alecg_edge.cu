// K8 alecg_edge: the ALECG edge Rusanov dissipation per edge, one thread
// per edge, in two flavours (transport and compressible Euler).
//
// Replaces quinoa_tpu/ops/alecg_fused.py _make_edge_kernel (transport) and
// _make_edge_kernel_cf (compflow), the per-edge half of their window
// passes (endpoint gathers through one-hot windows, the weight, and the
// antisymmetric pair of slot values).  Here the edge gathers its two
// endpoint states through edges (2, nE), and K9 (cg_assemble.cu) adds
// +d to endpoint a and -d to endpoint b.  Plain version:
// ops/alecg_fused.py alecg_edge_plain, the JAX package's XLA formulation
// (quinoa_tpu/inciter/alecg.py:133-147):
//
//   d[c, k] = w[k] * (u[c, b] - u[c, a])
//
// Transport: w = A*lambda, static (the charspeed reads the coordinates
// only).  Compflow: w = A * max(cs(u_a), cs(u_b)) with cs = |v| + sound
// speed at the pressure clamped to p >= 0.  Both maxima propagate NaN as
// jnp.maximum does (vmax).
//
// Bound on the card: device-memory bytes: 2 node ids, 2C gathered states,
// the weight and C results an edge.  Edges are ordered by their low
// endpoint, so the endpoint gathers walk the node axis.

#include "common.cuh"

namespace qtk {

// |v| + a at the pressure clamped to 0 (CGCompFlow.charspeed)
template <typename T>
__device__ __forceinline__ T cg_charspeed(const Eos<T>& eos, const T* s) {
  const T rho = s[0];
  const T p = vmax(pressure_cons(eos, s), T(0));
  const T a = soundspeed(eos, rho, p);
  return sqrt(s[1] * s[1] + s[2] * s[2] + s[3] * s[3]) / rho + a;
}

template <typename T>
__global__ void __launch_bounds__(128)
alecg_edge_kernel(const T* __restrict__ u, const int* __restrict__ edges,
                  const T* __restrict__ w, T* __restrict__ d, int nc,
                  long long N, long long nE) {
  const long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (k >= nE) return;
  const long long a = edges[k], b = edges[nE + k];
  const T wk = w[k];
  for (int c = 0; c < nc; ++c)
    d[c * nE + k] = wk * (u[c * N + b] - u[c * N + a]);
}

template <typename T>
__global__ void __launch_bounds__(128)
alecg_edge_cf_kernel(const T* __restrict__ u, const int* __restrict__ edges,
                     const T* __restrict__ A, Eos<T> eos,
                     T* __restrict__ d, long long N, long long nE) {
  const long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (k >= nE) return;
  const long long a = edges[k], b = edges[nE + k];
  T ua[C], ub[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    ua[c] = u[c * N + a];
    ub[c] = u[c * N + b];
  }
  const T lam = vmax(cg_charspeed(eos, ua), cg_charspeed(eos, ub));
  const T wk = A[k] * lam;
#pragma unroll
  for (int c = 0; c < C; ++c) d[c * nE + k] = wk * (ub[c] - ua[c]);
}

template <typename T>
int launch_alecg_edge(const void* u, const void* edges, const void* w,
                      void* d, int nc, long long N, long long nE,
                      void* stream) {
  const int block = 128;
  const long long grid = (nE + block - 1) / block;
  alecg_edge_kernel<T><<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)u, (const int*)edges, (const T*)w, (T*)d, nc, N, nE);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_alecg_edge_cf(const void* u, const void* edges, const void* A,
                         double gamma, double pstiff, void* d, long long N,
                         long long nE, void* stream) {
  const int block = 128;
  const long long grid = (nE + block - 1) / block;
  const Eos<T> eos{T(gamma), T(gamma - 1.0), T(pstiff)};
  alecg_edge_cf_kernel<T><<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)u, (const int*)edges, (const T*)A, eos, (T*)d, N, nE);
  return (int)cudaGetLastError();
}

}  // namespace qtk

extern "C" int qtk_alecg_edge_f32(const void* u, const void* edges,
                                  const void* w, void* d, int nc,
                                  long long N, long long nE, void* stream) {
  return qtk::launch_alecg_edge<float>(u, edges, w, d, nc, N, nE, stream);
}

extern "C" int qtk_alecg_edge_f64(const void* u, const void* edges,
                                  const void* w, void* d, int nc,
                                  long long N, long long nE, void* stream) {
  return qtk::launch_alecg_edge<double>(u, edges, w, d, nc, N, nE, stream);
}

extern "C" int qtk_alecg_edge_cf_f32(const void* u, const void* edges,
                                     const void* A, double gamma,
                                     double pstiff, void* d, long long N,
                                     long long nE, void* stream) {
  return qtk::launch_alecg_edge_cf<float>(u, edges, A, gamma, pstiff, d, N,
                                          nE, stream);
}

extern "C" int qtk_alecg_edge_cf_f64(const void* u, const void* edges,
                                     const void* A, double gamma,
                                     double pstiff, void* d, long long N,
                                     long long nE, void* stream) {
  return qtk::launch_alecg_edge_cf<double>(u, edges, A, gamma, pstiff, d, N,
                                           nE, stream);
}
