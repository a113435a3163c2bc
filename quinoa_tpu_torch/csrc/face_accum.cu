// K6 face_accum: each element sums its four faces' rows onto a base, one
// thread per element, for any row count R.
//
// Replaces quinoa_tpu/ops/face_accum.py accumulate_faces (its Pallas
// _make_kernel via _one_pass: one-hot window matmuls into el- and
// er-sorted element blocks).  Plain version: ops/face_accum.py
// accumulate_faces_plain, the JAX package's XLA formulation
// (quinoa_tpu/pde/dg.py:446-449):
//
//   r[q, e] = base[q, e] + sum_{i<4} (fsideR[i,e] ? cR : cL)[q, fose[i,e]]
//
// summed in slot order from the base (zero when base is null), so float32
// runs repeat bit for bit (no atomics) and the kernel agrees with its plain
// version bit for bit.
//
// Bound on the card: device-memory bytes.  An element reads 4 face ids,
// 4 side flags, R base words and 4R gathered face words and writes R.
// The element axis is the fastest axis of base and r (coalesced); the
// face rows are gathers along the face axis, near each other because
// faces are sorted by their left element.

#include "common.cuh"

namespace qtk {

template <typename T>
__global__ void __launch_bounds__(128)
face_accum_kernel(const T* __restrict__ cL, const T* __restrict__ cR,
                  const int* __restrict__ fose, const T* __restrict__ fsideR,
                  const T* __restrict__ base, T* __restrict__ r, int R,
                  long long E, long long F) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= E) return;
  long long f[4];
  const T* src[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[i] = fose[i * E + e];
    src[i] = fsideR[i * E + e] > T(0) ? cR : cL;
  }
  for (int q = 0; q < R; ++q) {
    T acc = base ? base[q * E + e] : T(0);
#pragma unroll
    for (int i = 0; i < 4; ++i) acc = acc + src[i][q * F + f[i]];
    r[q * E + e] = acc;
  }
}

template <typename T>
int launch_face_accum(const void* cL, const void* cR, const void* fose,
                      const void* fsideR, const void* base, void* r, int R,
                      long long E, long long F, void* stream) {
  const int block = 128;
  const long long grid = (E + block - 1) / block;
  face_accum_kernel<T><<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)cL, (const T*)cR, (const int*)fose, (const T*)fsideR,
      (const T*)base, (T*)r, R, E, F);
  return (int)cudaGetLastError();
}

}  // namespace qtk

extern "C" int qtk_face_accum_f32(const void* cL, const void* cR,
                                  const void* fose, const void* fsideR,
                                  const void* base, void* r, int R,
                                  long long E, long long F, void* stream) {
  return qtk::launch_face_accum<float>(cL, cR, fose, fsideR, base, r, R, E,
                                       F, stream);
}

extern "C" int qtk_face_accum_f64(const void* cL, const void* cR,
                                  const void* fose, const void* fsideR,
                                  const void* base, void* r, int R,
                                  long long E, long long F, void* stream) {
  return qtk::launch_face_accum<double>(cL, cR, fose, fsideR, base, r, R, E,
                                        F, stream);
}
