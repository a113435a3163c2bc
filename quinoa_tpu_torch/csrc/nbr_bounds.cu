// K4 nbr_bounds: min/max of each element's own cell mean and its face
// neighbours' cell means, one thread per element.
//
// Replaces quinoa_tpu/ops/nbr_bounds.py neighbor_mean_bounds (its Pallas
// _make_kernel: element windows, lane gathers and a one-hot placement of
// the far neighbours).  Plain version: ops/nbr_bounds.py
// neighbor_mean_bounds_plain.
//
//   umin[c, e] = min(u0[c, e], u0[c, n] for n in esuelT[:, e] if n >= 0)
//   umax[c, e] = max(...)
//
// with u0[c, :] = U[c*K, :], read straight from the modal state, so no
// (C, E) copy of the means is made.  A missing neighbour reads as -big /
// +big (the largest finite value), as in the plain version; min and max
// propagate NaN like torch's (common.cuh vmin/vmax).  Only selects and
// comparisons: kernel and plain version agree bit for bit.
//
// Bound on the card: device-memory bytes.  An element reads 4 neighbour
// ids and 5*C means and writes 2*C words.  The element axis is the
// fastest axis of every array, so a warp's own reads and writes
// coalesce; Hilbert element order keeps the neighbour reads near.

#include <cfloat>

#include "common.cuh"

namespace qtk {

template <typename T>
__device__ __forceinline__ T finite_max();
template <>
__device__ __forceinline__ float finite_max<float>() { return FLT_MAX; }
template <>
__device__ __forceinline__ double finite_max<double>() { return DBL_MAX; }

template <typename T>
__global__ void __launch_bounds__(128)
nbr_bounds_kernel(const T* __restrict__ U, const int* __restrict__ esuelT,
                  T* __restrict__ umin, T* __restrict__ umax, int C, int K,
                  long long E) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= E) return;
  const T big = finite_max<T>();
  long long nbr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) nbr[i] = esuelT[i * E + e];
  for (int c = 0; c < C; ++c) {
    const T* u0 = U + (long long)c * K * E;
    T mx = u0[e];
    T mn = mx;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool valid = nbr[i] >= 0;
      const T un = u0[valid ? nbr[i] : 0];
      mx = vmax(mx, valid ? un : -big);
      mn = vmin(mn, valid ? un : big);
    }
    umin[c * E + e] = mn;
    umax[c * E + e] = mx;
  }
}

template <typename T>
int launch_nbr_bounds(const void* U, const void* esuelT, void* umin,
                      void* umax, int C, int K, long long E, void* stream) {
  const int block = 128;
  const long long grid = (E + block - 1) / block;
  nbr_bounds_kernel<T><<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)U, (const int*)esuelT, (T*)umin, (T*)umax, C, K, E);
  return (int)cudaGetLastError();
}

}  // namespace qtk

extern "C" int qtk_nbr_bounds_f32(const void* U, const void* esuelT,
                                  void* umin, void* umax, int C, int K,
                                  long long E, void* stream) {
  return qtk::launch_nbr_bounds<float>(U, esuelT, umin, umax, C, K, E,
                                       stream);
}

extern "C" int qtk_nbr_bounds_f64(const void* U, const void* esuelT,
                                  void* umin, void* umax, int C, int K,
                                  long long E, void* stream) {
  return qtk::launch_nbr_bounds<double>(U, esuelT, umin, umax, C, K, E,
                                        stream);
}
