// K11 node_assemble: element-corner slabs to nodes through the slot table
// nsup, sum rows and max rows in one pass.
//
//   out[r, n]      = sum_d xa[a, r, e]       r < Ra   (pad slot -> 0)
//   out[Ra + r, n] = max_d xm[a or 0, r, e]  r < Rm   (pad slot -> lowest)
//
// with s = nsup[d, n] = a*E + e, and s = 4E a pad slot.  Each row starts
// from slot level 0 and takes levels 1, 2, ... in order, so float32 runs
// repeat bit for bit (no atomics) and match the plain version
// (ops/node_window.py node_assemble_plain: the JAX package's XLA
// assemble_add, assemble_max and assemble_add_max, quinoa_tpu/ops/
// assembly.py:64-127).  The max is the NaN-propagating vmax of common.cuh,
// as jnp.maximum and torch.maximum propagate NaN; a node no slot touches
// reads lowest (finfo.min) in a max row and 0 in a sum row.  The max slab
// xm has Am = 4 corners, or Am = 1 when every corner of an element carries
// the same row (the FCT allowed bounds), which the kernel then reads once
// per slot without a broadcast copy.
//
// Replaces quinoa_tpu/ops/node_window.py's _make_extreme_kernel
// (_one_pass_max / assemble_max_window, pallas_call at node_window.py:347)
// and the node use of ops/face_accum.py's _make_kernel by
// assemble_add_window (node_window.py:290-303): lo/hi window
// accumulators over target-sorted slot tiles with a far fold, because a
// TPU core cannot scatter or gather in HBM.  On the card each node gathers
// its own slots; K9 (cg_assemble.cu) shares the slot core of common.cuh.
//
// Bound on the card: device-memory bytes, but a thread that walks its
// slot levels one at a time waits on two dependent loads a level (the
// slot id, then the value).  So the lanes of a node (a few rows each,
// next to each other in a warp) read each group of slot ids once, in one
// coalesced load the lanes share, resolve them to (corner, element) in
// 32-bit compares, issue every value load of the group, and only then
// combine the group's levels in order.
// Each value gather still moves a 32-byte sector for 4 or 8 bytes;
// PERF.md (section 6, the K9/K11 slot core) has the sweep that chose the
// launch shapes below, and what keeps the kernel from its bound.

#include <cfloat>

#include "common.cuh"

namespace qtk {

// Rows a thread carries and slot levels loaded before they combine: 5
// and 8 where the call has one kind of row, 2 of each kind and 24 where
// it has sum rows and max rows (the P + Q call).
constexpr int NA_RPL = 5;
constexpr int NA_GL = 8;
constexpr int NA_RPL_BOTH = 2;
constexpr int NA_GL_BOTH = 24;

// Threads a block: 256 where a thread carries 1 or 2 rows of each kind,
// 512 where it carries more.
__host__ __device__ constexpr int na_block(int p) {
  return p > 2 ? 512 : 256;
}

template <typename T>
struct Lowest;
template <>
struct Lowest<float> {
  static __device__ __forceinline__ float value() { return -FLT_MAX; }
};
template <>
struct Lowest<double> {
  static __device__ __forceinline__ double value() { return -DBL_MAX; }
};

// PA sum rows and PM max rows a thread (either may be 0), lanes threads
// a node; na, nm of them are real rows (the last lane may have fewer).
template <typename T, int PA, int PM, int GL>
__global__ void __launch_bounds__(na_block(PA > PM ? PA : PM))
node_assemble_kernel(const T* __restrict__ xa, const T* __restrict__ xm,
                     const int* __restrict__ nsup, T* __restrict__ out,
                     int Ra, int Rm, int Am, int D, int N, int E,
                     int lanes) {
  const int t = (int)(blockIdx.x * blockDim.x + threadIdx.x);
  const int n = t / lanes;
  if (n >= N) return;
  const int lane = t - n * lanes;
  const int ra0 = lane * PA, rm0 = lane * PM;
  const int na = Ra - ra0, nm = Rm - rm0;
  T sa[PA > 0 ? PA : 1], sm[PM > 0 ? PM : 1];
  for (int d0 = 0; d0 < D; d0 += GL) {
    int s[GL];
    load_slots<4, GL>(nsup, d0, D, N, n, E, s);
    T va[GL][PA > 0 ? PA : 1], vm[GL][PM > 0 ? PM : 1];
#pragma unroll
    for (int g = 0; g < GL; ++g) {
      const int a = slot_corner<4>(s[g], E);
      const bool pad = a == 4;
      const int ac = pad ? 0 : a;
      const int e = s[g] - a * E;
      if constexpr (PA > 0) {
        const T* x = xa + (ac * Ra + ra0) * E + e;
#pragma unroll
        for (int j = 0; j < PA; ++j)
          va[g][j] = (!pad && j < na) ? x[j * E] : T(0);
      }
      if constexpr (PM > 0) {
        const T* x = xm + ((Am == 1 ? 0 : ac) * Rm + rm0) * E + e;
#pragma unroll
        for (int j = 0; j < PM; ++j)
          vm[g][j] = (!pad && j < nm) ? x[j * E] : Lowest<T>::value();
      }
    }
#pragma unroll
    for (int g = 0; g < GL; ++g) {
      if (d0 + g >= D) break;
      const bool first = d0 + g == 0;
#pragma unroll
      for (int j = 0; j < PA; ++j)
        sa[j] = first ? va[g][j] : sa[j] + va[g][j];
#pragma unroll
      for (int j = 0; j < PM; ++j)
        sm[j] = first ? vm[g][j] : vmax(sm[j], vm[g][j]);
    }
  }
#pragma unroll
  for (int j = 0; j < PA; ++j)
    if (j < na) out[(size_t)(ra0 + j) * N + n] = sa[j];
#pragma unroll
  for (int j = 0; j < PM; ++j)
    if (j < nm) out[(size_t)(Ra + rm0 + j) * N + n] = sm[j];
}

template <typename T, int PA, int PM>
int launch_rows(const void* xa, const void* xm, const void* nsup, void* out,
                int Ra, int Rm, int Am, int D, int N, int E, int lanes,
                cudaStream_t stream) {
  constexpr int block = na_block(PA > PM ? PA : PM);
  constexpr int gl = PA > 0 && PM > 0 ? NA_GL_BOTH : NA_GL;
  const long long threads = (long long)N * lanes;
  const unsigned grid = (unsigned)((threads + block - 1) / block);
  node_assemble_kernel<T, PA, PM, gl><<<grid, block, 0, stream>>>(
      (const T*)xa, (const T*)xm, (const int*)nsup, (T*)out, Ra, Rm, Am, D,
      N, E, lanes);
  return (int)cudaGetLastError();
}

// p rows of each kind a thread: the instance of p (1 .. P) and of the
// kinds present (both kinds with BOTH).
template <typename T, int P, bool BOTH>
int na_launch_p(int p, const void* xa, const void* xm, const void* nsup,
                void* out, int Ra, int Rm, int Am, int D, int N, int E,
                int lanes, cudaStream_t stream) {
  if constexpr (P == 0) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (p != P)
      return na_launch_p<T, P - 1, BOTH>(p, xa, xm, nsup, out, Ra, Rm, Am,
                                         D, N, E, lanes, stream);
    if constexpr (BOTH)
      return launch_rows<T, P, P>(xa, xm, nsup, out, Ra, Rm, Am, D, N, E,
                                  lanes, stream);
    if (Rm == 0)
      return launch_rows<T, P, 0>(xa, xm, nsup, out, Ra, Rm, Am, D, N, E,
                                  lanes, stream);
    return launch_rows<T, 0, P>(xa, xm, nsup, out, Ra, Rm, Am, D, N, E,
                                lanes, stream);
  }
}

template <typename T>
int launch_node_assemble(const void* xa, const void* xm, const void* nsup,
                         void* out, int Ra, int Rm, int Am, int D,
                         long long N, long long E, void* stream) {
  const int rows = Ra > Rm ? Ra : Rm;
  if (Ra < 0 || Rm < 0 || rows < 1 || (Am != 1 && Am != 4) || D < 1 ||
      N < 1 || E < 1)
    return (int)cudaErrorInvalidValue;
  const bool both = Ra > 0 && Rm > 0;
  const int cap = both ? NA_RPL_BOTH : NA_RPL;
  const int p = rows < cap ? rows : cap;
  const int lanes = (rows + p - 1) / p;
  // 32-bit offsets: every slot, value offset and thread index fits an int
  if (4 * E * rows >= (1LL << 31) || N * lanes + 512 >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (both)
    return na_launch_p<T, NA_RPL_BOTH, true>(p, xa, xm, nsup, out, Ra, Rm,
                                             Am, D, (int)N, (int)E, lanes,
                                             st);
  return na_launch_p<T, NA_RPL, false>(p, xa, xm, nsup, out, Ra, Rm, Am, D,
                                       (int)N, (int)E, lanes, st);
}

}  // namespace qtk

extern "C" int qtk_node_assemble_f32(const void* xa, const void* xm,
                                     const void* nsup, void* out, int Ra,
                                     int Rm, int Am, int D, long long N,
                                     long long E, void* stream) {
  return qtk::launch_node_assemble<float>(xa, xm, nsup, out, Ra, Rm, Am, D, N,
                                          E, stream);
}

extern "C" int qtk_node_assemble_f64(const void* xa, const void* xm,
                                     const void* nsup, void* out, int Ra,
                                     int Rm, int Am, int D, long long N,
                                     long long E, void* stream) {
  return qtk::launch_node_assemble<double>(xa, xm, nsup, out, Ra, Rm, Am, D,
                                           N, E, stream);
}
