// K10 node_gather: nodal fields to element-corner slabs, one thread per
// element: out[a, c, e] = U[c, inpoelT[a, e]] for the four corners a and
// every row c of U (R, N), written straight into the (4, R, E) layout.
//
// Replaces quinoa_tpu/ops/node_window.py's _make_gather_kernel
// (gather_nodes_window, pallas_call at node_window.py:261).  The TPU
// kernel reads each tile's nodes through one-hot MXU products against a
// two-block VMEM window and patches the far slots in from a compact XLA
// gather, because a TPU core cannot gather from HBM.  None of that
// carries over: the card gathers each corner value from device memory.
// Plain version: ops/node_window.py node_gather_plain (the JAX package's
// XLA gather_nodes, quinoa_tpu/ops/assembly.py:56-61).  A copy, so kernel
// and plain version agree bit for bit.
//
// Bound on the card: device-memory bytes.  An element reads its 4 node
// ids (16 B) and writes 4R values; the node values are gathered, but with
// nodes first-touch ordered along Hilbert-ordered elements the corners of
// neighbouring threads fall on nearby lines, so most gathers hit L2.  The
// writes are coalesced along the element axis.

#include "common.cuh"

namespace qtk {

template <typename T>
__global__ void __launch_bounds__(256)
node_gather_kernel(const T* __restrict__ U, const int* __restrict__ inpoelT,
                   T* __restrict__ out, int R, long long N, long long E) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= E) return;
  long long id[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) id[a] = inpoelT[a * E + e];
  for (int c = 0; c < R; ++c) {
#pragma unroll
    for (int a = 0; a < 4; ++a)
      out[((long long)a * R + c) * E + e] = U[c * N + id[a]];
  }
}

template <typename T>
int launch_node_gather(const void* U, const void* inpoelT, void* out, int R,
                       long long N, long long E, void* stream) {
  if (R < 1 || E < 1) return (int)cudaErrorInvalidValue;
  const int block = 256;
  const long long grid = (E + block - 1) / block;
  node_gather_kernel<T><<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)U, (const int*)inpoelT, (T*)out, R, N, E);
  return (int)cudaGetLastError();
}

}  // namespace qtk

extern "C" int qtk_node_gather_f32(const void* U, const void* inpoelT,
                                   void* out, int R, long long N, long long E,
                                   void* stream) {
  return qtk::launch_node_gather<float>(U, inpoelT, out, R, N, E, stream);
}

extern "C" int qtk_node_gather_f64(const void* U, const void* inpoelT,
                                   void* out, int R, long long N, long long E,
                                   void* stream) {
  return qtk::launch_node_gather<double>(U, inpoelT, out, R, N, E, stream);
}
