// K5 face_gather: the modal state of one element per face,
// out[r, f] = U[r, idx[f]], one thread per face.
//
// Replaces quinoa_tpu/ops/face_accum.py gather_left_states (its Pallas
// _make_gather_kernel: one-hot window matmuls over el-sorted face tiles).
// The face-gp DG path calls it twice per sweep, with idx = el and with
// idx = er (the JAX package gathers the right states in XLA).  Plain
// version: ops/face_accum.py face_gather_plain.  An exact copy: kernel and
// plain version agree bit for bit.
//
// Bound on the card: device-memory bytes, R + 1 words read and R written
// per face.  The face axis is the fastest axis of out, so writes
// coalesce; faces are sorted by their left element and elements are
// Hilbert-ordered, so a warp's reads of U fall close together.

#include "common.cuh"

namespace qtk {

template <typename T>
__global__ void __launch_bounds__(128)
face_gather_kernel(const T* __restrict__ U, const int* __restrict__ idx,
                   T* __restrict__ out, int R, long long E, long long F) {
  const long long f = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (f >= F) return;
  const long long e = idx[f];
  for (int r = 0; r < R; ++r) out[r * F + f] = U[r * E + e];
}

template <typename T>
int launch_face_gather(const void* U, const void* idx, void* out, int R,
                       long long E, long long F, void* stream) {
  const int block = 128;
  const long long grid = (F + block - 1) / block;
  face_gather_kernel<T><<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)U, (const int*)idx, (T*)out, R, E, F);
  return (int)cudaGetLastError();
}

}  // namespace qtk

extern "C" int qtk_face_gather_f32(const void* U, const void* idx,
                                   void* out, int R, long long E,
                                   long long F, void* stream) {
  return qtk::launch_face_gather<float>(U, idx, out, R, E, F, stream);
}

extern "C" int qtk_face_gather_f64(const void* U, const void* idx,
                                   void* out, int R, long long E,
                                   long long F, void* stream) {
  return qtk::launch_face_gather<double>(U, idx, out, R, E, F, stream);
}
