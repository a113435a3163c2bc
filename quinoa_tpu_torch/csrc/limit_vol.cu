// K1 limit_vol: Superbee limiting of the P1 dofs plus the flux volume
// integral of the limited state, each element on C = 5 component lanes.
//
// Replaces the TPU kernel quinoa_tpu/ops/nbr_bounds.py
// _make_bounds_limit_kernel + _bounds_body (pallas_call in
// superbee_limit_window).  Plain version: ops/nbr_bounds.py
// limit_vol_plain (superbee_p1 + volume_rhs_plain).
//
// Two flavours, a template flag (PREF) apart: limit_vol_kernel, and the
// p-adaptive limit_vol_pref_kernel, which also reads ndofel (E,) int32,
// each element's active dofs (1 or 4 at P1).  An element at 4 runs the
// code of limit_vol_kernel.  An element at 1 (P0) skips the bounds, phi
// and its volume points: it writes its mean row as it is and its slope
// rows times 0, as the plain route's u * dofmask forms them, so the
// kernel's limited state is the masked one; its volume rows are all zero
// (row 0 is a structural zero of w_vol * dBdxi_vol, and the solver's RK
// restore drops rows k >= 1 of an inactive dof).  Plain version:
// limit_vol_plain(..., ndofel=), bit for bit on the limited state and on
// every active volume row.  Elements are in Hilbert order and P1 ones
// cluster at the shock, so almost every warp takes one side.  Without
// the flag nothing reads ndofel and the code is limit_vol_kernel's own.
//
// Bound on the card: device-memory bytes, 0.0586 ms at 48^3 in float32.
// Per element it reads 20 modal rows, 4 neighbour ids, 4 x 5 neighbour
// means, 9 jacInv entries and one volume, and writes 40 rows: about 75
// words against ~2,000 flops and up to 75 IEEE divisions (no fast math),
// so the issue of the arithmetic, not the bytes, is what holds it back.
//
// Design: component lanes.  Everything but the pressure at a volume point
// is separable by component: the bounds, the 12-point Superbee phi and the
// P1 scaling of component c, and the volume rows c*K + k, which read only
// component c's flux.  A block is LV_EPB elements x C lanes, lane-major,
// so each warp is 32 consecutive elements of one lane (warp-uniform).
// Three phases, split by __syncthreads:
//   1. lane c reads its 4 rows (coalesced), gathers its own mean of the 4
//      neighbours (esuelT, -1 = none), takes phi over the 4 x G self-face
//      points, writes its 4 limited rows and leaves them in shared memory;
//      the lanes also stage the element's 9 jacInv entries and volume;
//   2. lane g evaluates volume point g once (GV = C: a point a lane): the
//      point's state, its pressure and velocities, into shared memory;
//   3. lane c forms its component's flux at each point and accumulates its
//      K volume rows in the plain version's (g, m, k) order.
// Each value is the same expression in the same order as in the plain
// version, so the bits do not change.  Less to issue: the Superbee
// branches share one division, a zero numerator skips the division's
// slow path (quot), a point that takes neither branch gets the clamp of
// 1 evaluated once, and the volume rows skip the P1 basis's structural
// zeros of w_vol * dBdxi_vol at compile time (common.cuh wdb_nonzero;
// pack_tables refuses a table with other zeros).  Each lane runs its own inlined copy
// of the code, with constant row offsets, and the point loops stay
// rolled: unrolled, the five copies took twice the SASS and twice the
// time (PERF.md).  The 131 quadrature constants sit in shared memory.

#include "common.cuh"

namespace qtk {

constexpr int LV_EPB = 32;      // elements a block (64 was no faster)
constexpr int LV_PT = 4 + C;    // p, v_x, v_y, v_z, s[0..4]
static_assert(LV_EPB % 32 == 0, "a warp is 32 elements of one lane");
static_assert(LV_EPB * C <= 1024, "a block has at most 1024 threads");
static_assert(GV == C, "phase 2 puts volume point g on lane g");

template <typename T>
struct LimitVolShared {
  alignas(16) T tab[TAB_SIZE];             // a basis row is one 16 B load
  T u[CK][LV_EPB];                         // the limited state
  T jv[10][LV_EPB];                        // jacInv (row-major), vol*emask
  T pt[GV][LV_PT][LV_EPB];                 // phase 2's point values
};

// phase 1 of lane c: bounds, phi, the limited rows (to ulim and shared
// memory), and this lane's share of jacInv and the volume
template <typename T>
__device__ __forceinline__ void limit_lane(
    LimitVolShared<T>& sm, int c, int el, const T* __restrict__ U,
    const int* __restrict__ nbr, const T* __restrict__ jac,
    const T* __restrict__ vole, T beta, T* __restrict__ ulim, long long e,
    long long E, bool p0) {
  T u[K];
#pragma unroll
  for (int k = 0; k < K; ++k) u[k] = U[(c * K + k) * E + e];
  // jacInv rows c and c + C; the last lane's second row is the volume
  sm.jv[c][el] = jac[c * E + e];
  if (c + C < 9)
    sm.jv[c + C][el] = jac[(c + C) * E + e];
  else
    sm.jv[9][el] = vole[e];
  if (p0) {
    // a P0 element of the p-adaptive flavour: the masked state, which no
    // volume point reads
#pragma unroll
    for (int k = 0; k < K; ++k)
      ulim[(c * K + k) * E + e] = k == 0 ? u[0] : u[k] * T(0);
    return;
  }

  // bounds: own mean and the valid face neighbours' means
  const T u0 = u[0];
  T hi = u0, lo = u0;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int n = nbr[a * E + e];
    if (n >= 0) {
      const T m = U[(c * K) * E + n];
      hi = vmax(hi, m);
      lo = vmin(lo, m);
    }
  }

  // Superbee phi over the 4 x G self-face points (pde/limiter.py).  One
  // division serves both branches, whose sides a warp's elements split
  // between: the taken branch's quotient, the same expression; a point
  // that takes neither (pg = 1) gets the clamp of 1, evaluated once.
  const T eps = T(1.0e-14);
  const T clamp1 =
      vmax(vmax(vmin(beta * T(1), T(1)), vmin(T(1), beta)), T(0));
  T phi = T(1);
#pragma unroll 1
  for (int p = 0; p < 4 * G; ++p) {
    const T uNeg = eval_mode_sum(sm.tab + TAB_BSELF + p * K, u, 0) - u0;
    const bool up = uNeg > eps;
    T pg = clamp1;
    if (up || uNeg < -eps) {
      pg = vmin(T(1), quot((up ? hi : lo) - u0, T(2) * uNeg));
      pg = vmax(vmax(vmin(beta * pg, T(1)), vmin(pg, beta)), T(0));
    }
    phi = vmin(phi, pg);
  }
#pragma unroll
  for (int k = 1; k < K; ++k) u[k] = u[k] * phi;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    ulim[(c * K + k) * E + e] = u[k];
    sm.u[c * K + k][el] = u[k];
  }
}

// the values every component's flux at volume point g reads: pressure,
// velocities and the point's state (pde/eos.py pressure_cons_cm,
// euler_flux_dir)
template <typename T>
__device__ __forceinline__ void point_values(const LimitVolShared<T>& sm,
                                             const Eos<T>& eos, int g, int el,
                                             T* pv) {
  const T* B = sm.tab + TAB_BVOL + g * K;
  T s[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    s[c] = B[0] * sm.u[c * K][el];
#pragma unroll
    for (int k = 1; k < K; ++k) s[c] = s[c] + B[k] * sm.u[c * K + k][el];
  }
  // pressure_cons(eos, s) with its velocities formed by quot
#pragma unroll
  for (int j = 0; j < 3; ++j) pv[1 + j] = quot(s[1 + j], s[0]);
  pv[0] = pressure(eos, s[0], pv[1], pv[2], pv[3], s[4]);
#pragma unroll
  for (int c = 0; c < C; ++c) pv[4 + c] = s[c];
}

// phase 3 of lane c: the K volume rows of component c, scaled by the
// volume; a P0 element (p0) adds no point and writes zero rows
template <typename T>
__device__ __forceinline__ void volume_lane(const LimitVolShared<T>& sm,
                                            int c, int el,
                                            T* __restrict__ rv, long long e,
                                            long long E, bool p0) {
  T J[9], R[K];
#pragma unroll
  for (int k = 0; k < K; ++k) R[k] = T(0);
#pragma unroll
  for (int i = 0; i < 9; ++i) J[i] = sm.jv[i][el];
#pragma unroll 1
  for (int g = 0; g < (p0 ? 0 : GV); ++g) {
    T pv[LV_PT];
#pragma unroll
    for (int i = 0; i < LV_PT; ++i) pv[i] = sm.pt[g][i][el];
    const T sc = pv[4 + c];
    // component c of euler_flux_dir(s, p, j), as common.cuh writes it
    T F[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const T p = pv[0], vj = pv[1 + j];
      if (c == 0)
        F[j] = pv[5 + j];
      else if (c == C - 1)
        F[j] = (sc + p) * vj;
      else
        F[j] = sc * vj + (j == c - 1 ? p : T(0));
    }
    T fref[3];
#pragma unroll
    for (int m = 0; m < 3; ++m)
      fref[m] = F[0] * J[3 * m] + F[1] * J[3 * m + 1] + F[2] * J[3 * m + 2];
    const T* w = sm.tab + TAB_WDB + g * K * 3;
#pragma unroll
    for (int m = 0; m < 3; ++m) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (wdb_nonzero(k, m)) R[k] = R[k] + w[k * 3 + m] * fref[m];
    }
  }
  const T ve = sm.jv[9][el];
#pragma unroll
  for (int k = 0; k < K; ++k) rv[(c * K + k) * E + e] = R[k] * ve;
}

// lane (warp-uniform) -> limit_lane (PHASE 1) or volume_lane (PHASE 3)
template <typename T, int PHASE>
__device__ __forceinline__ void lane_phase(
    int lane, LimitVolShared<T>& sm, int el, const T* U, const int* nbr,
    const T* jac, const T* vole, T beta, T* ulim, T* rv,
    long long e, long long E, bool p0) {
  if constexpr (PHASE == 1)
    limit_lane(sm, lane, el, U, nbr, jac, vole, beta, ulim, e, E, p0);
  else
    volume_lane(sm, lane, el, rv, e, E, p0);
}

// a switch whose every case inlines the phase at a constant lane: one
// copy of the lane code per lane, with constant row offsets and flux
// branch (one copy at the run-time lane was slower, PERF.md)
template <typename T, int PHASE>
__device__ __forceinline__ void limit_vol_lane_dispatch(
    int lane, LimitVolShared<T>& sm, int el, const T* U, const int* nbr,
    const T* jac, const T* vole, T beta, T* ulim, T* rv,
    long long e, long long E, bool p0) {
  static_assert(C == 5, "one case a component");
  switch (lane) {
#define QTK_LV_CASE(L)                                                     \
  case L:                                                                  \
    lane_phase<T, PHASE>(L, sm, el, U, nbr, jac, vole, beta, ulim, rv, e, \
                         E, p0);                                           \
    break;
    QTK_LV_CASE(0)
    QTK_LV_CASE(1)
    QTK_LV_CASE(2)
    QTK_LV_CASE(3)
    QTK_LV_CASE(4)
#undef QTK_LV_CASE
  }
}

// the block's work; p0 is false for every element unless PREF, and then
// nothing reads ndofel
template <typename T, bool PREF>
__device__ __forceinline__ void limit_vol_block(
    const T* __restrict__ U, const int* __restrict__ nbr,
    const int* __restrict__ ndofel, const T* __restrict__ jac,
    const T* __restrict__ vole, const T* __restrict__ tab, T beta,
    const Eos<T>& eos, T* __restrict__ ulim, T* __restrict__ rv,
    long long E) {
  __shared__ LimitVolShared<T> sm;
  for (int i = threadIdx.x; i < TAB_SIZE; i += blockDim.x) sm.tab[i] = tab[i];
  __syncthreads();
  // every thread reaches each barrier; the ragged last block's idle
  // elements skip the work between them
  const int lane = threadIdx.x / LV_EPB, el = threadIdx.x % LV_EPB;
  const long long e = blockIdx.x * (long long)LV_EPB + el;
  const bool live = e < E;
  bool p0 = false;
  if constexpr (PREF) p0 = live && ndofel[e] == 1;
  if (live)
    limit_vol_lane_dispatch<T, 1>(lane, sm, el, U, nbr, jac, vole, beta,
                                  ulim, rv, e, E, p0);
  __syncthreads();
  if (live && !p0) {
    T pv[LV_PT];
    point_values(sm, eos, lane, el, pv);
#pragma unroll
    for (int i = 0; i < LV_PT; ++i) sm.pt[lane][i][el] = pv[i];
  }
  __syncthreads();
  if (live)
    limit_vol_lane_dispatch<T, 3>(lane, sm, el, U, nbr, jac, vole, beta,
                                  ulim, rv, e, E, p0);
}

template <typename T>
__global__ void __launch_bounds__(C * LV_EPB)
limit_vol_kernel(const T* __restrict__ U, const int* __restrict__ nbr,
                 const T* __restrict__ jac, const T* __restrict__ vole,
                 const T* __restrict__ tab, T beta, Eos<T> eos,
                 T* __restrict__ ulim, T* __restrict__ rv, long long E) {
  limit_vol_block<T, false>(U, nbr, nullptr, jac, vole, tab, beta, eos, ulim,
                            rv, E);
}

template <typename T>
__global__ void __launch_bounds__(C * LV_EPB)
limit_vol_pref_kernel(const T* __restrict__ U, const int* __restrict__ nbr,
                      const int* __restrict__ ndofel,
                      const T* __restrict__ jac, const T* __restrict__ vole,
                      const T* __restrict__ tab, T beta, Eos<T> eos,
                      T* __restrict__ ulim, T* __restrict__ rv, long long E) {
  limit_vol_block<T, true>(U, nbr, ndofel, jac, vole, tab, beta, eos, ulim,
                           rv, E);
}

// PREF picks the kernel at compile time: limit_vol_kernel (ndofel unread)
// or the p-adaptive limit_vol_pref_kernel
template <typename T, bool PREF>
int launch_limit_vol(const void* U, const void* nbr, const void* ndofel,
                     const void* jac, const void* vole, const void* tab,
                     double beta, double gamma, double pstiff, void* ulim,
                     void* rv, long long E, void* stream) {
  const long long grid = (E + LV_EPB - 1) / LV_EPB;
  const Eos<T> eos{T(gamma), T(gamma - 1.0), T(pstiff)};
  if constexpr (PREF)
    limit_vol_pref_kernel<T><<<(unsigned)grid, C * LV_EPB, 0,
                               (cudaStream_t)stream>>>(
        (const T*)U, (const int*)nbr, (const int*)ndofel, (const T*)jac,
        (const T*)vole, (const T*)tab, T(beta), eos, (T*)ulim, (T*)rv, E);
  else
    limit_vol_kernel<T><<<(unsigned)grid, C * LV_EPB, 0,
                          (cudaStream_t)stream>>>(
        (const T*)U, (const int*)nbr, (const T*)jac, (const T*)vole,
        (const T*)tab, T(beta), eos, (T*)ulim, (T*)rv, E);
  return (int)cudaGetLastError();
}

}  // namespace qtk

extern "C" int qtk_limit_vol_f32(const void* U, const void* nbr,
                                 const void* jac, const void* vole,
                                 const void* tab, double beta, double gamma,
                                 double pstiff, void* ulim, void* rv,
                                 long long E, void* stream) {
  return qtk::launch_limit_vol<float, false>(U, nbr, nullptr, jac, vole, tab,
                                             beta, gamma, pstiff, ulim, rv, E,
                                             stream);
}

extern "C" int qtk_limit_vol_f64(const void* U, const void* nbr,
                                 const void* jac, const void* vole,
                                 const void* tab, double beta, double gamma,
                                 double pstiff, void* ulim, void* rv,
                                 long long E, void* stream) {
  return qtk::launch_limit_vol<double, false>(U, nbr, nullptr, jac, vole, tab,
                                              beta, gamma, pstiff, ulim, rv, E,
                                              stream);
}

extern "C" int qtk_limit_vol_pref_f32(const void* U, const void* nbr,
                                      const void* ndofel, const void* jac,
                                      const void* vole, const void* tab,
                                      double beta, double gamma,
                                      double pstiff, void* ulim, void* rv,
                                      long long E, void* stream) {
  return qtk::launch_limit_vol<float, true>(U, nbr, ndofel, jac, vole, tab,
                                            beta, gamma, pstiff, ulim, rv, E,
                                            stream);
}

extern "C" int qtk_limit_vol_pref_f64(const void* U, const void* nbr,
                                      const void* ndofel, const void* jac,
                                      const void* vole, const void* tab,
                                      double beta, double gamma,
                                      double pstiff, void* ulim, void* rv,
                                      long long E, void* stream) {
  return qtk::launch_limit_vol<double, true>(U, nbr, ndofel, jac, vole, tab,
                                             beta, gamma, pstiff, ulim, rv, E,
                                             stream);
}
