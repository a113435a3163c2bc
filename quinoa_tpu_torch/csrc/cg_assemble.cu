// K9 cg_assemble: the ALECG stage rhs at each node, the sum of its element
// slots (K7's values) plus the sum of its edge slots (K8's values), one
// thread per node, for up to MAXR rows.
//
// Replaces the assembly half of quinoa_tpu/ops/alecg_fused.py's window
// passes (_sum_pass, alecg_fused.py:340-358): the lo/hi window
// accumulators, the far-slot emit, and the far fold through
// ops/face_accum.py's B7 kernel.  Plain version: ops/alecg_fused.py
// cg_assemble_plain, the JAX package's XLA formulation
// (quinoa_tpu/ops/assembly.py:63-75 twice, then vol + dis as
// quinoa_tpu/inciter/alecg.py:266-270 adds them):
//
//   vol[c, n] = sum_d cv[c, e(nsup[d, n])],  slot s = a*E + e, pad 4E -> 0
//   dis[c, n] = sum_d +-d[c, k(ensup[d, n])], slot s = side*nE + k
//               (side 0 -> +d, side 1 -> -d), pad 2nE -> 0
//   r = vol + dis
//
// Each sum starts from slot level 0 and adds levels 1, 2, ... in order,
// so float32 runs repeat bit for bit (no atomics) and agree with the
// plain version bit for bit.
//
// Bound on the card: device-memory bytes.  A node reads D + D' slot ids,
// gathers C values for each and writes C.  The slot tables are read
// coalesced along the node axis; the value gathers stay near each other
// because nodes are first-touch ordered along Hilbert-ordered elements.

#include "common.cuh"

namespace qtk {

constexpr int MAXR = 8;

template <typename T>
__global__ void __launch_bounds__(128)
cg_assemble_kernel(const T* __restrict__ cv, const T* __restrict__ d,
                   const int* __restrict__ nsup,
                   const int* __restrict__ ensup, T* __restrict__ r, int nc,
                   int Dv, int Dd, long long N, long long E, long long nE) {
  const long long n = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (n >= N) return;
  T vol[MAXR], dis[MAXR];
  for (int lev = 0; lev < Dv; ++lev) {
    const long long s = nsup[lev * N + n];
    const bool pad = s >= 4 * E;
    const long long e = pad ? 0 : s % E;
#pragma unroll
    for (int c = 0; c < MAXR; ++c) {
      if (c < nc) {
        const T x = pad ? T(0) : cv[c * E + e];
        vol[c] = lev == 0 ? x : vol[c] + x;
      }
    }
  }
  for (int lev = 0; lev < Dd; ++lev) {
    const long long s = ensup[lev * N + n];
    const int side = s < nE ? 0 : (s < 2 * nE ? 1 : 2);
    const long long k = side == 0 ? s : (side == 1 ? s - nE : 0);
#pragma unroll
    for (int c = 0; c < MAXR; ++c) {
      if (c < nc) {
        const T y = d[c * nE + k];
        const T x = side == 0 ? y : (side == 1 ? -y : T(0));
        dis[c] = lev == 0 ? x : dis[c] + x;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < MAXR; ++c)
    if (c < nc) r[c * N + n] = vol[c] + dis[c];
}

template <typename T>
int launch_cg_assemble(const void* cv, const void* d, const void* nsup,
                       const void* ensup, void* r, int nc, int Dv, int Dd,
                       long long N, long long E, long long nE,
                       void* stream) {
  if (nc < 1 || nc > MAXR || Dv < 1 || Dd < 1)
    return (int)cudaErrorInvalidValue;
  const int block = 128;
  const long long grid = (N + block - 1) / block;
  cg_assemble_kernel<T><<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)cv, (const T*)d, (const int*)nsup, (const int*)ensup, (T*)r,
      nc, Dv, Dd, N, E, nE);
  return (int)cudaGetLastError();
}

}  // namespace qtk

extern "C" int qtk_cg_assemble_f32(const void* cv, const void* d,
                                   const void* nsup, const void* ensup,
                                   void* r, int nc, int Dv, int Dd,
                                   long long N, long long E, long long nE,
                                   void* stream) {
  return qtk::launch_cg_assemble<float>(cv, d, nsup, ensup, r, nc, Dv, Dd, N,
                                        E, nE, stream);
}

extern "C" int qtk_cg_assemble_f64(const void* cv, const void* d,
                                   const void* nsup, const void* ensup,
                                   void* r, int nc, int Dv, int Dd,
                                   long long N, long long E, long long nE,
                                   void* stream) {
  return qtk::launch_cg_assemble<double>(cv, d, nsup, ensup, r, nc, Dv, Dd,
                                         N, E, nE, stream);
}
