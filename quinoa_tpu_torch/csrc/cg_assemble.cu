// K9 cg_assemble: the ALECG stage rhs at each node, the sum of its element
// slots (K7's values) plus the sum of its edge slots (K8's values).
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
// Bound on the card: device-memory bytes; at one row the two slot tables
// are most of them.  As in K11 (node_assemble.cu), the lanes of a node
// (CA_RPL rows a lane, next to each other in a warp) read each group of
// CA_GL slot ids once, coalesced along the node axis and shared by the
// lanes, resolve them to (element or edge, side) in 32-bit compares
// (common.cuh slot_corner), issue the group's value loads, and then add
// its levels in order.  PERF.md (section 6, the K9/K11 slot core) has
// the sweep that chose CA_RPL, CA_GL and CA_BLOCK, and what keeps the
// kernel from its bound.

#include "common.cuh"

namespace qtk {

constexpr int CA_RPL = 5;       // rows a thread carries
constexpr int CA_GL = 4;        // slot levels loaded before they add
constexpr int CA_BLOCK = 512;   // threads a block

template <typename T, int P>
__global__ void __launch_bounds__(CA_BLOCK)
cg_assemble_kernel(const T* __restrict__ cv, const T* __restrict__ d,
                   const int* __restrict__ nsup,
                   const int* __restrict__ ensup, T* __restrict__ r, int nc,
                   int Dv, int Dd, int N, int E, int nE, int lanes) {
  const int t = (int)(blockIdx.x * blockDim.x + threadIdx.x);
  const int n = t / lanes;
  if (n >= N) return;
  const int c0 = (t - n * lanes) * P;
  const int nr = nc - c0;
  T vol[P], dis[P];
  for (int d0 = 0; d0 < Dv; d0 += CA_GL) {
    int s[CA_GL];
    load_slots<4, CA_GL>(nsup, d0, Dv, N, n, E, s);
    T v[CA_GL][P];
#pragma unroll
    for (int g = 0; g < CA_GL; ++g) {
      const int a = slot_corner<4>(s[g], E);
      const T* x = cv + c0 * E + (s[g] - a * E);
#pragma unroll
      for (int j = 0; j < P; ++j)
        v[g][j] = (a < 4 && j < nr) ? x[j * E] : T(0);
    }
#pragma unroll
    for (int g = 0; g < CA_GL; ++g) {
      if (d0 + g >= Dv) break;
#pragma unroll
      for (int j = 0; j < P; ++j)
        vol[j] = d0 + g == 0 ? v[g][j] : vol[j] + v[g][j];
    }
  }
  for (int d0 = 0; d0 < Dd; d0 += CA_GL) {
    int s[CA_GL];
    load_slots<2, CA_GL>(ensup, d0, Dd, N, n, nE, s);
    T v[CA_GL][P];
#pragma unroll
    for (int g = 0; g < CA_GL; ++g) {
      const int side = slot_corner<2>(s[g], nE);
      const T* x = d + c0 * nE + (s[g] - side * nE);
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const T y = (side < 2 && j < nr) ? x[j * nE] : T(0);
        v[g][j] = side == 0 ? y : (side == 1 ? -y : T(0));
      }
    }
#pragma unroll
    for (int g = 0; g < CA_GL; ++g) {
      if (d0 + g >= Dd) break;
#pragma unroll
      for (int j = 0; j < P; ++j)
        dis[j] = d0 + g == 0 ? v[g][j] : dis[j] + v[g][j];
    }
  }
#pragma unroll
  for (int j = 0; j < P; ++j)
    if (j < nr) r[(size_t)(c0 + j) * N + n] = vol[j] + dis[j];
}

// P rows a thread: the instance of P (1 .. CA_RPL).
template <typename T, int P>
int ca_launch_p(int p, const void* cv, const void* d, const void* nsup,
                const void* ensup, void* r, int nc, int Dv, int Dd, int N,
                int E, int nE, int lanes, cudaStream_t stream) {
  if constexpr (P == 0) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (p != P)
      return ca_launch_p<T, P - 1>(p, cv, d, nsup, ensup, r, nc, Dv, Dd, N,
                                   E, nE, lanes, stream);
    const long long threads = (long long)N * lanes;
    const unsigned grid = (unsigned)((threads + CA_BLOCK - 1) / CA_BLOCK);
    cg_assemble_kernel<T, P><<<grid, CA_BLOCK, 0, stream>>>(
        (const T*)cv, (const T*)d, (const int*)nsup, (const int*)ensup,
        (T*)r, nc, Dv, Dd, N, E, nE, lanes);
    return (int)cudaGetLastError();
  }
}

template <typename T>
int launch_cg_assemble(const void* cv, const void* d, const void* nsup,
                       const void* ensup, void* r, int nc, int Dv, int Dd,
                       long long N, long long E, long long nE,
                       void* stream) {
  if (nc < 1 || Dv < 1 || Dd < 1 || N < 1 || E < 1 || nE < 1)
    return (int)cudaErrorInvalidValue;
  const int p = nc < CA_RPL ? nc : CA_RPL;
  const int lanes = (nc + p - 1) / p;
  // 32-bit offsets: every slot, value offset and thread index fits an int
  if (4 * E * nc >= (1LL << 31) || 2 * nE * nc >= (1LL << 31) ||
      N * lanes + CA_BLOCK >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  return ca_launch_p<T, CA_RPL>(p, cv, d, nsup, ensup, r, nc, Dv, Dd,
                                (int)N, (int)E, (int)nE, lanes,
                                (cudaStream_t)stream);
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
