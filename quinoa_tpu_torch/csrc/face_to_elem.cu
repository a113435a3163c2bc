// K3 face_to_elem: each element sums its four faces' contributions, one
// thread per element.
//
// Replaces the accumulation half of the TPU face pass in
// quinoa_tpu/ops/face_fused.py: the one-hot window accumulation of
// _make_nearfar_kernel and _make_far_raccum_kernel.  Plain version:
// ops/face_fused.py face_to_elem_plain, which is the JAX package's own
// gather formulation (quinoa_tpu/pde/dg.py:446-449 and :489).
//
//   r[:, e]  = rv[:, e] + sum_{i<4} (fsideR[i,e] ? contribR : contribL)[:, fose[i,e]]
//   delt[e]  = sum_{i<4} mx[fose[i,e]]
//
// summed in slot order, so float32 runs repeat bit for bit (no atomics).
//
// Bound on the card: device-memory bytes.  An element reads 4 face ids,
// 4 side flags, 20 rv rows and 4 x 21 gathered face rows and writes 21
// words, for 84 additions.  Design: the element axis is the fastest axis
// of rv, r and delt (coalesced), and the face rows are gathers along the
// face axis; faces are sorted by their left element, so an element's
// left faces lie near each other and near its neighbours'.

#include "common.cuh"

namespace qtk {

template <typename T>
__global__ void __launch_bounds__(128)
face_to_elem_kernel(const T* __restrict__ cL, const T* __restrict__ cR,
                    const T* __restrict__ mx, const int* __restrict__ fose,
                    const T* __restrict__ fsideR, const T* __restrict__ rv,
                    T* __restrict__ r, T* __restrict__ delt, long long E,
                    long long F) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= E) return;
  T acc[CK];
#pragma unroll
  for (int q = 0; q < CK; ++q) acc[q] = rv ? rv[q * E + e] : T(0);
  T d = T(0);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long f = fose[i * E + e];
    const T* src = fsideR[i * E + e] > T(0) ? cR : cL;
#pragma unroll
    for (int q = 0; q < CK; ++q) acc[q] = acc[q] + src[q * F + f];
    d = d + mx[f];
  }
#pragma unroll
  for (int q = 0; q < CK; ++q) r[q * E + e] = acc[q];
  delt[e] = d;
}

template <typename T>
int launch_face_to_elem(const void* cL, const void* cR, const void* mx,
                        const void* fose, const void* fsideR, const void* rv,
                        void* r, void* delt, long long E, long long F,
                        void* stream) {
  const int block = 128;
  const long long grid = (E + block - 1) / block;
  face_to_elem_kernel<T><<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)cL, (const T*)cR, (const T*)mx, (const int*)fose,
      (const T*)fsideR, (const T*)rv, (T*)r, (T*)delt, E, F);
  return (int)cudaGetLastError();
}

}  // namespace qtk

extern "C" int qtk_face_to_elem_f32(const void* cL, const void* cR,
                                    const void* mx, const void* fose,
                                    const void* fsideR, const void* rv,
                                    void* r, void* delt, long long E,
                                    long long F, void* stream) {
  return qtk::launch_face_to_elem<float>(cL, cR, mx, fose, fsideR, rv, r,
                                         delt, E, F, stream);
}

extern "C" int qtk_face_to_elem_f64(const void* cL, const void* cR,
                                    const void* mx, const void* fose,
                                    const void* fsideR, const void* rv,
                                    void* r, void* delt, long long E,
                                    long long F, void* stream) {
  return qtk::launch_face_to_elem<double>(cL, cR, mx, fose, fsideR, rv, r,
                                          delt, E, F, stream);
}
