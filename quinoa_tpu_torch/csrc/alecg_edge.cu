// K8 alecg_edge: the ALECG edge Rusanov dissipation per edge, in two
// flavours (transport and compressible Euler).
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
// Bound on the card: device-memory bytes: 2 node ids, the weight and C
// results an edge, and the endpoint states gathered from a node table the
// L2 holds.  Design: a thread takes a run of AE_EPT consecutive edges
// (AE_CF_EPT for compflow), reads the id rows and the weight as 16-byte
// vectors streamed past L1 (load_run), issues every gather
// before the first difference and stores each row of d as vectors.
// Compflow's charspeed costs IEEE divisions and square roots.  The edges
// come ordered by their low endpoint a, so a block's edges share few
// distinct a: the block evaluates each of those once into shared memory
// and every edge evaluates only its own b.  An edge whose a lies outside
// the block's range (edges in another order) evaluates both.  Both
// flavours reach about a device copy of as many bytes; PERF.md (section
// 6, the K7/K8 sweep) has the runs that chose the constants below.

#include <initializer_list>

#include "common.cuh"

namespace qtk {

constexpr int AE_EPT = 8;        // transport: edges a thread
constexpr int AE_RPL = 4;        // transport: rows a pass
constexpr int AE_BLOCK = 64;     // transport: threads a block
constexpr int AE_CF_EPT = 4;     // compflow: edges a thread
constexpr int AE_CF_BLOCK = 128; // compflow: threads a block
// compflow: low endpoints a block holds in shared memory (a block's edges
// span about N/nE of their count: 0.15 on a tet mesh)
constexpr int AE_CF_SPAN = AE_CF_BLOCK * AE_CF_EPT / 2;

// A thread's run of R consecutive entries k .. k+R-1 of a row of n; a
// load at or past n reads 0, a store there is dropped.  VEC (the
// launcher's choice): n is a multiple of R and every row starts 16-byte
// aligned, so a run that starts below n is whole and moves as 16-byte
// vectors (or R entries in one, where they take less); otherwise entry by
// entry.
template <typename X, int W> struct vec_of;
template <> struct vec_of<float, 1> { using type = float; };
template <> struct vec_of<float, 2> { using type = float2; };
template <> struct vec_of<float, 4> { using type = float4; };
template <> struct vec_of<double, 1> { using type = double; };
template <> struct vec_of<double, 2> { using type = double2; };
template <> struct vec_of<int, 1> { using type = int; };
template <> struct vec_of<int, 2> { using type = int2; };
template <> struct vec_of<int, 4> { using type = int4; };

template <typename X, int R>
__host__ __device__ constexpr int run_width() {
  return 16 / (int)sizeof(X) < R ? 16 / (int)sizeof(X) : R;
}

// each entry is read once, so the run streams past L1 (__ldcs)
template <bool VEC, typename X, int R>
__device__ __forceinline__ void load_run(const X* __restrict__ row,
                                         long long k, long long n,
                                         X (&v)[R]) {
  if constexpr (VEC) {
    constexpr int W = run_width<X, R>();
    using V = typename vec_of<X, W>::type;
#pragma unroll
    for (int i = 0; i < R; i += W) {
      V x{};
      if (k + i < n) x = __ldcs(reinterpret_cast<const V*>(row + k + i));
      const X* xs = reinterpret_cast<const X*>(&x);
#pragma unroll
      for (int j = 0; j < W; ++j) v[i + j] = xs[j];
    }
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) v[i] = k + i < n ? __ldcs(row + k + i) : X(0);
  }
}

template <bool VEC, typename X, int R>
__device__ __forceinline__ void store_run(X* __restrict__ row, long long k,
                                          long long n, const X (&v)[R]) {
  if constexpr (VEC) {
    constexpr int W = run_width<X, R>();
    using V = typename vec_of<X, W>::type;
#pragma unroll
    for (int i = 0; i < R; i += W) {
      V x;
      X* xs = reinterpret_cast<X*>(&x);
#pragma unroll
      for (int j = 0; j < W; ++j) xs[j] = v[i + j];
      if (k + i < n) *reinterpret_cast<V*>(row + k + i) = x;
    }
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i)
      if (k + i < n) row[k + i] = v[i];
  }
}

// whether runs of R entries of rows of n may move as vectors: n a multiple
// of R and each pointer 16-byte aligned
template <int R>
inline bool runs_aligned(long long n, std::initializer_list<const void*> ps) {
  if (n % R != 0) return false;
  for (const void* p : ps)
    if (reinterpret_cast<unsigned long long>(p) % 16 != 0) return false;
  return true;
}

// |v| + a at the pressure clamped to 0 (CGCompFlow.charspeed)
template <typename T>
__device__ __forceinline__ T cg_charspeed(const Eos<T>& eos, const T* s) {
  const T rho = s[0];
  const T p = vmax(pressure_cons(eos, s), T(0));
  const T a = soundspeed(eos, rho, p);
  return sqrt(s[1] * s[1] + s[2] * s[2] + s[3] * s[3]) / rho + a;
}

template <typename T, int R, int P, bool VEC>
__global__ void __launch_bounds__(AE_BLOCK)
alecg_edge_kernel(const T* __restrict__ u, const int* __restrict__ edges,
                  const T* __restrict__ w, T* __restrict__ d, int nc,
                  long long N, long long nE) {
  const long long k = (blockIdx.x * (long long)AE_BLOCK + threadIdx.x) * R;
  if (k >= nE) return;
  int a[R], b[R];
  T wk[R];
  load_run<VEC>(edges, k, nE, a);
  load_run<VEC>(edges + nE, k, nE, b);
  load_run<VEC>(w, k, nE, wk);
  for (int c0 = 0; c0 < nc; c0 += P) {
    T ua[P][R], ub[P][R];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      // a row past nc gathers row c0 again; its result is not stored
      const long long c = c0 + p < nc ? c0 + p : c0;
#pragma unroll
      for (int e = 0; e < R; ++e) {
        ua[p][e] = u[c * N + a[e]];
        ub[p][e] = u[c * N + b[e]];
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      T out[R];
#pragma unroll
      for (int e = 0; e < R; ++e) out[e] = wk[e] * (ub[p][e] - ua[p][e]);
      if (c0 + p < nc) store_run<VEC>(d + (c0 + p) * nE, k, nE, out);
    }
  }
}

template <typename T, int R, bool VEC>
__global__ void __launch_bounds__(AE_CF_BLOCK)
alecg_edge_cf_kernel(const T* __restrict__ u, const int* __restrict__ edges,
                     const T* __restrict__ A, Eos<T> eos,
                     T* __restrict__ d, long long N, long long nE) {
  __shared__ T cs_lo[AE_CF_SPAN];
  __shared__ T u_lo[C][AE_CF_SPAN];
  const long long k0 = blockIdx.x * (long long)(AE_CF_BLOCK * R);
  const long long k = k0 + threadIdx.x * R;
  const long long last = (k0 + AE_CF_BLOCK * R < nE ? k0 + AE_CF_BLOCK * R
                                                      : nE) - 1;
  // the block's low endpoints lo .. lo + span - 1 (edges ordered by a)
  const int lo = edges[k0];
  const int span = edges[last] - lo + 1;
  const bool held = span >= 1 && span <= AE_CF_SPAN;
  int a[R], b[R];
  T Ak[R], ub[R][C];
  load_run<VEC>(edges, k, nE, a);
  load_run<VEC>(edges + nE, k, nE, b);
  load_run<VEC>(A, k, nE, Ak);
#pragma unroll
  for (int e = 0; e < R; ++e)
#pragma unroll
    for (int c = 0; c < C; ++c) ub[e][c] = u[c * N + b[e]];
  if (held) {
    for (int i = threadIdx.x; i < span; i += AE_CF_BLOCK) {
      T s[C];
#pragma unroll
      for (int c = 0; c < C; ++c) s[c] = u[c * N + lo + i];
      cs_lo[i] = cg_charspeed(eos, s);
#pragma unroll
      for (int c = 0; c < C; ++c) u_lo[c][i] = s[c];
    }
  }
  __syncthreads();
  if (k >= nE) return;
  T out[C][R];
#pragma unroll
  for (int e = 0; e < R; ++e) {
    const int i = a[e] - lo;
    T ua[C], csa;
    if (held && i >= 0 && i < span) {
#pragma unroll
      for (int c = 0; c < C; ++c) ua[c] = u_lo[c][i];
      csa = cs_lo[i];
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) ua[c] = u[c * N + a[e]];
      csa = cg_charspeed(eos, ua);
    }
    const T wk = Ak[e] * vmax(csa, cg_charspeed(eos, ub[e]));
#pragma unroll
    for (int c = 0; c < C; ++c) out[c][e] = wk * (ub[e][c] - ua[c]);
  }
#pragma unroll
  for (int c = 0; c < C; ++c) store_run<VEC>(d + c * nE, k, nE, out[c]);
}

// P rows a pass: the instance of P (1 .. AE_RPL)
template <typename T, int P>
int ae_launch_p(int p, bool vec, const void* u, const void* edges,
                const void* w, void* d, int nc, long long N, long long nE,
                cudaStream_t stream) {
  if constexpr (P == 0) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (p != P)
      return ae_launch_p<T, P - 1>(p, vec, u, edges, w, d, nc, N, nE, stream);
    const long long per = AE_BLOCK * AE_EPT;
    auto kern = vec ? alecg_edge_kernel<T, AE_EPT, P, true>
                    : alecg_edge_kernel<T, AE_EPT, P, false>;
    kern<<<(unsigned)((nE + per - 1) / per), AE_BLOCK, 0, stream>>>(
        (const T*)u, (const int*)edges, (const T*)w, (T*)d, nc, N, nE);
    return (int)cudaGetLastError();
  }
}

template <typename T>
int launch_alecg_edge(const void* u, const void* edges, const void* w,
                      void* d, int nc, long long N, long long nE,
                      void* stream) {
  if (nc < 1 || N < 1 || nE < 1) return (int)cudaErrorInvalidValue;
  const bool vec = runs_aligned<AE_EPT>(nE, {edges, w, d});
  return ae_launch_p<T, AE_RPL>(nc < AE_RPL ? nc : AE_RPL, vec, u, edges, w,
                                d, nc, N, nE, (cudaStream_t)stream);
}

template <typename T>
int launch_alecg_edge_cf(const void* u, const void* edges, const void* A,
                         double gamma, double pstiff, void* d, long long N,
                         long long nE, void* stream) {
  if (N < 1 || nE < 1) return (int)cudaErrorInvalidValue;
  const Eos<T> eos{T(gamma), T(gamma - 1.0), T(pstiff)};
  const long long per = AE_CF_BLOCK * AE_CF_EPT;
  auto kern = runs_aligned<AE_CF_EPT>(nE, {edges, A, d})
                  ? alecg_edge_cf_kernel<T, AE_CF_EPT, true>
                  : alecg_edge_cf_kernel<T, AE_CF_EPT, false>;
  kern<<<(unsigned)((nE + per - 1) / per), AE_CF_BLOCK, 0,
         (cudaStream_t)stream>>>((const T*)u, (const int*)edges,
                                 (const T*)A, eos, (T*)d, N, nE);
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
