// K15 mm_limit: consistent Superbee limiting of multimat DG(P1), each
// element on C = 3*nmat + 3 component lanes.
//
// Replaces, on the multimat path, the neighbour bounds of
// quinoa_tpu/ops/nbr_bounds.py _make_kernel (B6, pallas_call at :258;
// K4 here) and the XLA Superbee phi, consistent_mm_phi and P1 scaling of
// quinoa_tpu/pde/multimat.py mm_consistent_limit.  Plain version:
// pde/multimat.py mm_consistent_limit_plain (neighbor_mean_bounds,
// pde/limiter.py superbee_phi and consistent_mm_phi, then the scaling):
// some 370 torch launches a call, each streaming a (C, E) tensor.
//
// Bound on the card: device-memory bytes.  At mm_sod_dgp1's shape (nmat
// 2, C = 9, float32, E = 1,572,864) a call reads the state once (36 rows,
// 226.5 MB) and writes the limited state once (226.5 MB): 0.135 ms at
// 3.35 TB/s.  The 4 x C neighbour means a lane gathers through esuelT come
// mostly from L2 (Hilbert element order) and are not counted.  The
// arithmetic is 12 face points a component: a 4-term basis sum, the
// Superbee clamps and at most one IEEE division (no fast math).
//
// Design: component lanes, as K1 (csrc/limit_vol.cu).  Everything but
// the consistent step is separable by component, so a block is ML_EPB
// elements x C lanes, lane-major: each warp is 32 consecutive elements of
// one component (warp-uniform lane, coalesced rows).  Two phases, split
// by __syncthreads:
//   1. lane c loads its 4 modal rows and its 4 neighbours' means (esuelT,
//      -1 = none) before the first barrier, takes the bounds in K4's
//      NaN-propagating vmax/vmin order, then phi over the 4 x G self-face
//      points (B_selfface in shared memory), writes its mode-0 row and
//      leaves phi in shared memory;
//   2. lane c forms phi_al, the NaN-propagating minimum of the nmat
//      fraction lanes' phi, then its own factor as consistent_mm_phi does
//      (fractions phi_al, densities and energies min(own, phi_al),
//      momenta their own) and writes its 3 scaled P1 rows.
// The output is a new tensor: u stays the RK anchor's input.
//
// Each value is the same expression in the same order as in the plain
// version, so the bits do not change: the bounds select -big / +big for a
// missing neighbour as the plain gather does, the face state is the basis
// sum in mode order, the taken Superbee branch divides the same operands
// (one division serves both branches; a zero numerator skips the
// division's slow path, common.cuh quot), a point that takes neither
// branch gets the clamp of 1 evaluated once, and the minima propagate
// NaN like torch.minimum and amin.  The phi loop of K1 is copied, not
// shared, so that K1's code and timing stay as they are.

#include <cfloat>

#include "common.cuh"

namespace qtk {

constexpr int ML_EPB = 32;   // elements a block
constexpr int ML_NPT = 4 * G;   // self-face points
static_assert(ML_EPB % 32 == 0, "a warp is 32 elements of one lane");

static __device__ __forceinline__ float ml_big(float) { return FLT_MAX; }
static __device__ __forceinline__ double ml_big(double) { return DBL_MAX; }

template <typename T, int NMAT>
struct MMLimitShared {
  alignas(16) T bself[ML_NPT * K];         // a basis row is one 16 B load
  T phi[3 * NMAT + 3][ML_EPB];
};

template <typename T, int NMAT>
__global__ void __launch_bounds__((3 * NMAT + 3) * ML_EPB)
mm_limit_kernel(const T* __restrict__ U, const int* __restrict__ nbr,
                const T* __restrict__ tab, T beta, T* __restrict__ out,
                long long E) {
  static_assert(NMAT == 2 || NMAT == 3, "the multimat paths' nmat");
  static_assert((3 * NMAT + 3) * ML_EPB <= 1024,
                "a block has at most 1024 threads");
  __shared__ MMLimitShared<T, NMAT> sm;
  // every thread reaches each barrier; the ragged last block's idle
  // elements skip the work between them
  const int c = threadIdx.x / ML_EPB, el = threadIdx.x % ML_EPB;
  const long long e = blockIdx.x * (long long)ML_EPB + el;
  const bool live = e < E;
  const T* Uc = U + (long long)c * K * E;
  T u[K], un[4];
  int n[4];
  if (live) {
#pragma unroll
    for (int k = 0; k < K; ++k) u[k] = Uc[k * E + e];
#pragma unroll
    for (int a = 0; a < 4; ++a) n[a] = nbr[a * E + e];
#pragma unroll
    for (int a = 0; a < 4; ++a) un[a] = n[a] >= 0 ? Uc[n[a]] : T(0);
  }
  for (int i = threadIdx.x; i < ML_NPT * K; i += blockDim.x)
    sm.bself[i] = tab[TAB_BSELF + i];
  __syncthreads();

  T phi = T(1);
  if (live) {
    // bounds: the own mean against each neighbour's, -big / +big where
    // there is none (ops/nbr_bounds.py neighbor_mean_bounds_plain)
    const T u0 = u[0], big = ml_big(T(0));
    T hi = u0, lo = u0;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const bool valid = n[a] >= 0;
      hi = vmax(hi, valid ? un[a] : -big);
      lo = vmin(lo, valid ? un[a] : big);
    }
    // Superbee phi over the self-face points (pde/limiter.py
    // superbee_phi): the taken branch's quotient, the same expression; a
    // point that takes neither (pg = 1) gets the clamp of 1
    const T eps = T(1.0e-14);
    const T clamp1 =
        vmax(vmax(vmin(beta * T(1), T(1)), vmin(T(1), beta)), T(0));
#pragma unroll
    for (int p = 0; p < ML_NPT; ++p) {
      const T uNeg = eval_mode_sum(sm.bself + p * K, u, 0) - u0;
      const bool up = uNeg > eps;
      T pg = clamp1;
      if (up || uNeg < -eps) {
        pg = vmin(T(1), quot((up ? hi : lo) - u0, T(2) * uNeg));
        pg = vmax(vmax(vmin(beta * pg, T(1)), vmin(pg, beta)), T(0));
      }
      phi = vmin(phi, pg);
    }
    sm.phi[c][el] = phi;
    out[(long long)c * K * E + e] = u0;
  }
  __syncthreads();
  if (!live) return;

  // consistent_mm_phi: the fractions' common factor, the densities and
  // energies cut at least as hard, the momenta their own
  T al = sm.phi[0][el];
#pragma unroll
  for (int m = 1; m < NMAT; ++m) al = vmin(al, sm.phi[m][el]);
  T f;
  if (c < NMAT)
    f = al;
  else if (c < 2 * NMAT || c >= 2 * NMAT + 3)
    f = vmin(phi, al);
  else
    f = phi;
#pragma unroll
  for (int k = 1; k < K; ++k) out[((long long)c * K + k) * E + e] = u[k] * f;
}

template <typename T, int NMAT>
int launch_mm_limit_nmat(const void* U, const void* nbr, const void* tab,
                         double beta, void* out, long long E, void* stream) {
  const long long grid = (E + ML_EPB - 1) / ML_EPB;
  mm_limit_kernel<T, NMAT>
      <<<(unsigned)grid, (3 * NMAT + 3) * ML_EPB, 0, (cudaStream_t)stream>>>(
          (const T*)U, (const int*)nbr, (const T*)tab, T(beta), (T*)out, E);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_mm_limit(const void* U, const void* nbr, const void* tab,
                    double beta, void* out, int nmat, long long E,
                    void* stream) {
  switch (nmat) {
    case 2:
      return launch_mm_limit_nmat<T, 2>(U, nbr, tab, beta, out, E, stream);
    case 3:
      return launch_mm_limit_nmat<T, 3>(U, nbr, tab, beta, out, E, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace qtk

extern "C" int qtk_mm_limit_f32(const void* U, const void* nbr,
                                const void* tab, double beta, void* out,
                                int nmat, long long E, void* stream) {
  return qtk::launch_mm_limit<float>(U, nbr, tab, beta, out, nmat, E,
                                     stream);
}

extern "C" int qtk_mm_limit_f64(const void* U, const void* nbr,
                                const void* tab, double beta, void* out,
                                int nmat, long long E, void* stream) {
  return qtk::launch_mm_limit<double>(U, nbr, tab, beta, out, nmat, E,
                                      stream);
}
