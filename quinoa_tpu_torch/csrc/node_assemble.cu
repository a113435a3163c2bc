// K11 node_assemble: element-corner slabs to nodes through the slot table
// nsup, sum rows and max rows in one pass, one thread per (node, chunk of
// up to RC rows).
//
//   out[r, n]      = sum_d xa[a, r, e]       r < Ra   (pad slot -> 0)
//   out[Ra + r, n] = max_d xm[a or 0, r, e]  r < Rm   (pad slot -> lowest)
//
// with s = nsup[d, n], a = s / E, e = s % E, and s = 4E a pad slot.  Each
// row starts from slot level 0 and takes levels 1, 2, ... in order, so
// float32 runs repeat bit for bit (no atomics) and match the plain version
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
// its own slots; K9 (cg_assemble.cu) cannot serve, its element term has one
// value per element where DiagCG has one per corner.
//
// Bound on the card: device-memory bytes.  A node reads its D slot ids
// (coalesced along the node axis, once per row chunk: the second chunk's
// ids hit L2) and gathers one value a row a slot; the gathers stay near
// each other because nodes are first-touch ordered along Hilbert-ordered
// elements.  RC rows a thread keep the accumulators in registers for any
// row count; more row chunks give more threads.

#include <cfloat>

#include "common.cuh"

namespace qtk {

constexpr int RC = 4;

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

template <typename T>
__global__ void __launch_bounds__(128)
node_assemble_kernel(const T* __restrict__ xa, const T* __restrict__ xm,
                     const int* __restrict__ nsup, T* __restrict__ out,
                     int Ra, int Rm, int Am, int D, long long N, long long E) {
  const long long n = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int nca = (Ra + RC - 1) / RC;
  const bool is_max = (int)blockIdx.y >= nca;
  const int r0 = (is_max ? (int)blockIdx.y - nca : (int)blockIdx.y) * RC;
  const int R = is_max ? Rm : Ra;
  const T* x = is_max ? xm : xa;
  const T padv = is_max ? Lowest<T>::value() : T(0);
  T acc[RC];
  for (int lev = 0; lev < D; ++lev) {
    const long long s = nsup[lev * N + n];
    const bool pad = s >= 4 * E;
    const long long a = pad ? 0 : s / E;
    const long long e = pad ? 0 : s - a * E;
    const long long corner = is_max && Am == 1 ? 0 : a;
#pragma unroll
    for (int j = 0; j < RC; ++j) {
      if (r0 + j < R) {
        const T v = pad ? padv : x[(corner * R + r0 + j) * E + e];
        acc[j] = lev == 0 ? v : (is_max ? vmax(acc[j], v) : acc[j] + v);
      }
    }
  }
  const int orow = is_max ? Ra + r0 : r0;
#pragma unroll
  for (int j = 0; j < RC; ++j)
    if (r0 + j < R) out[(orow + j) * N + n] = acc[j];
}

template <typename T>
int launch_node_assemble(const void* xa, const void* xm, const void* nsup,
                         void* out, int Ra, int Rm, int Am, int D,
                         long long N, long long E, void* stream) {
  if (Ra < 0 || Rm < 0 || Ra + Rm < 1 || (Am != 1 && Am != 4) || D < 1 ||
      N < 1)
    return (int)cudaErrorInvalidValue;
  const int block = 128;
  const long long gx = (N + block - 1) / block;
  const int chunks = (Ra + RC - 1) / RC + (Rm + RC - 1) / RC;
  const dim3 grid((unsigned)gx, (unsigned)chunks);
  node_assemble_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)xa, (const T*)xm, (const int*)nsup, (T*)out, Ra, Rm, Am, D,
      N, E);
  return (int)cudaGetLastError();
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
