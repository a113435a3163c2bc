// K3 face_to_elem: each element sums its four faces' contributions, its
// 20 rows split over row lanes.
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
// words, for 84 additions.
//
// Design: row lanes.  A block is F2E_EPB elements x F2E_L lanes,
// lane-major, so each warp is 32 consecutive elements of one lane (the
// lane is warp-uniform and a template parameter behind
// face_to_elem_dispatch: every row offset is a constant).  Lane l sums rows
// l, l + L, ... of its element's four faces in slot order, lane 0 also
// the charvel into delt; each lane reads the face ids and side flags
// itself (coalesced, and the L1 serves the other lanes).  One thread
// carrying all 20 rows keeps 84 gathers of one element in flight at 128
// threads a block; the lanes spread them over L threads, so more elements'
// gathers are in flight at once.  The element axis is the fastest axis of
// rv, r and delt (coalesced); the face rows are gathers along the face
// axis, and faces are sorted by their left element, so an element's left
// faces lie near each other and near its neighbours'.  Of 1 to 20 lanes
// and 32 to 128 elements a block, 6 lanes of 128 (768 threads) were the
// fastest (PERF.md).

#include "common.cuh"

namespace qtk {

constexpr int F2E_L = 6;                          // lanes an element
constexpr int F2E_RL = (CK + F2E_L - 1) / F2E_L;  // rows a lane
constexpr int F2E_EPB = 128;                      // elements a block
static_assert(F2E_EPB % 32 == 0, "a warp is 32 elements of one lane");
static_assert(F2E_EPB * F2E_L <= 1024, "a block has at most 1024 threads");

template <typename T, int LANE>
__device__ __forceinline__ void face_to_elem_lane(
    const T* __restrict__ cL, const T* __restrict__ cR,
    const T* __restrict__ mx, const int* __restrict__ fose,
    const T* __restrict__ fsideR, const T* __restrict__ rv,
    T* __restrict__ r, T* __restrict__ delt, long long e, long long E,
    long long F) {
  T acc[F2E_RL];
#pragma unroll
  for (int j = 0; j < F2E_RL; ++j) {
    const int q = LANE + j * F2E_L;
    if (q < CK) acc[j] = rv ? rv[q * E + e] : T(0);
  }
  T d = T(0);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long f = fose[i * E + e];
    const T* src = fsideR[i * E + e] > T(0) ? cR : cL;
#pragma unroll
    for (int j = 0; j < F2E_RL; ++j) {
      const int q = LANE + j * F2E_L;
      if (q < CK) acc[j] = acc[j] + src[q * F + f];
    }
    if (LANE == 0) d = d + mx[f];
  }
#pragma unroll
  for (int j = 0; j < F2E_RL; ++j) {
    const int q = LANE + j * F2E_L;
    if (q < CK) r[q * E + e] = acc[j];
  }
  if (LANE == 0) delt[e] = d;
}

// lane (warp-uniform) -> face_to_elem_lane<..., lane>
template <typename T, int LANE = 0>
__device__ __forceinline__ void face_to_elem_dispatch(
    int lane, const T* cL, const T* cR, const T* mx, const int* fose,
    const T* fsideR, const T* rv, T* r, T* delt, long long e, long long E,
    long long F) {
  if constexpr (LANE < F2E_L) {
    if (lane == LANE)
      face_to_elem_lane<T, LANE>(cL, cR, mx, fose, fsideR, rv, r, delt, e, E,
                                 F);
    else
      face_to_elem_dispatch<T, LANE + 1>(lane, cL, cR, mx, fose, fsideR, rv,
                                         r, delt, e, E, F);
  }
}

template <typename T>
__global__ void __launch_bounds__(F2E_EPB * F2E_L)
face_to_elem_kernel(const T* __restrict__ cL, const T* __restrict__ cR,
                    const T* __restrict__ mx, const int* __restrict__ fose,
                    const T* __restrict__ fsideR, const T* __restrict__ rv,
                    T* __restrict__ r, T* __restrict__ delt, long long E,
                    long long F) {
  const long long e =
      blockIdx.x * (long long)F2E_EPB + threadIdx.x % F2E_EPB;
  if (e >= E) return;
  face_to_elem_dispatch<T>(threadIdx.x / F2E_EPB, cL, cR, mx, fose, fsideR,
                           rv, r, delt, e, E, F);
}

template <typename T>
int launch_face_to_elem(const void* cL, const void* cR, const void* mx,
                        const void* fose, const void* fsideR, const void* rv,
                        void* r, void* delt, long long E, long long F,
                        void* stream) {
  const long long grid = (E + F2E_EPB - 1) / F2E_EPB;
  face_to_elem_kernel<T><<<(unsigned)grid, F2E_EPB * F2E_L, 0,
                           (cudaStream_t)stream>>>(
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
