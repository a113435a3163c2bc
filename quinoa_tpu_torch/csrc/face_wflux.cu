// K12 face_wflux: the weighted Riemann flux at every face's Gauss points
// for DG(P0) (K = 1, G = 1), DG(P1) (K = 4, G = 3) and DG(P2) (K = 10, G
// = 6), with the HLLC or the Lax-Friedrichs flux (template parameter
// FLUX; the int flux argument of the C entry points).  The only face
// kernel of the compressible-Euler DG step: every order and flux.
//
// Replaces the per-face work of the TPU face passes of the compressible
// Euler system: quinoa_tpu/ops/face_fused.py _make_fused_kernel (B11, the
// single-stream fused_face_pass) and the near/far kernels
// _make_nearfar_kernel, _make_far_rstate_kernel and
// _make_far_raccum_kernel (B2-B5, fused_face_pass_nearfar): states,
// basis, ghost, Riemann flux, the weighted-flux output and the charvel
// row.  The accumulation is K13's (basis_accum.cu), which contracts both
// sides' weighted flux with each element's own basis.  Plain version:
// ops/face_fused.py face_wflux_plain.
//
// Per face: gather the el and er modal states, evaluate the basis at the G
// points of both sides from xi_l/xi_r, substitute a finite unit state on
// pad faces (their weights are zero), apply the symmetry/extrapolate ghost
// on boundary faces, evaluate HLLC or Lax-Friedrichs (the JAX package
// traces DGCompFlow.riemann, so its face kernels are one instance per
// flux), and write
//   wfl (C*G, F): row c*G + g = fl_c(g) * w_g * area * fmask,
//   mx (F,) = sum_g w_g * area * fmask * (interior ? max(vl, vr) : vl),
// the dt sweep's weighted charvel, summed in point order.
//
// Bound on the card: device-memory bytes.  At P2 a face reads 2 x 50 state
// words, 36 Gauss coordinates, 3 normal words and 4 scalars and writes 31
// words; HLLC and the two bases are ~600 flops a point, under half the byte
// time at 67 TFLOP/s.  At P1 a face reads 2 x 20 state words and 18
// coordinates and writes 16; at P0 10 state words and 9 words of face
// data, and writes 6 (basis_at<T, 1> is 1 and reads no coordinate).
//
// Design: gather apart from compute, as K14 (mm_face_wflux.cu), for HLLC
// at DG(P1) and both fluxes at DG(P2).  A block takes a tile of TILE
// faces (fw_tile) and G*TILE threads.  Thread (g, j) loads rows g, g + G,
// ... of face j's el and er states into registers, then its point's Gauss
// coordinates (evaluating both bases) and the face's normal, area, mask
// and boundary type, and only then stores the rows to shared memory, so
// that all these loads are in flight at once; a warp's loads of a row are
// the el (or er) of consecutive faces, which the el-sorted faces and the
// Hilbert element order keep near each other.  After the barrier thread
// (g, j) sums both sides' states at point g in mode order from shared
// memory, applies the pad substitution, the ghost, the Riemann flux and
// the charvel, and writes its C weighted rows: threads are point-major,
// so a warp writes consecutive faces of one wfl row.  The face's mx is
// summed in point order by its point-0 thread through shared memory.
// One thread per face (face_wflux_face_kernel, the whole per-face work in
// registers: 2*C*K state words beside both bases and the flux) is kept
// where the tile does not pay: at DG(P0), whose 10 state words leave
// nothing to stage, and for Lax-Friedrichs at DG(P1), whose lighter flux
// keeps it at 64% of its bound.  The tile sizes (32 faces at P1, 16 at
// P2), the choice between the two kernels and the gather (register
// staging against cp.async, loads before or after the barrier) are the
// fastest of a sweep on the card (PERF.md section 6).  ptxas, float32
// registers: tile P1 HLLC 56, P2 56; a thread per face P1 LF 88, P0 55 and
// 40; float64 at most 164 (P1 LF); no spill.  Static shared memory: at
// most 13.6 KB (P2, float64).  Every sum keeps its order, so the bits
// equal the plain version's; no atomics.  The template parameters K and G
// hide common.cuh's DG(P1) constants of those names.

#include "common.cuh"

namespace qtk {

// faces a block of the tiled kernel takes at K modes with the flux FLUX
// (G threads a face); 0: a thread per face (face_wflux_face_kernel)
template <typename T, int K, int FLUX>
__host__ __device__ constexpr int fw_tile() {
  return K == 1 ? 0 : K == 4 ? (FLUX == FLUX_LF ? 0 : 32) : 16;
}

// what a thread reads for a face point besides the states: the face's
// normal, area * fmask, whether it is real (fmask > 0) and its boundary
// type (load_face); both sides' basis at point g and its weight w_g *
// area * fmask (load_basis)
template <typename T, int K>
struct FacePoint {
  T Bl[K], Br[K], n[3], fa, wt;
  bool valid;
  int bt;
};

template <typename T, int K>
__device__ __forceinline__ void load_face(FacePoint<T, K>& p, long long f,
                                          long long F,
                                          const T* __restrict__ fn,
                                          const T* __restrict__ farea,
                                          const T* __restrict__ fmask,
                                          const int* __restrict__ bctype) {
  p.n[0] = fn[f];
  p.n[1] = fn[F + f];
  p.n[2] = fn[2 * F + f];
  p.fa = farea[f] * fmask[f];
  p.valid = fmask[f] > T(0);
  p.bt = bctype[f];
}

template <typename T, int K, int G>
__device__ __forceinline__ void load_basis(FacePoint<T, K>& p, int g,
                                           long long f, long long F,
                                           const T* __restrict__ xil,
                                           const T* __restrict__ xir,
                                           const T* __restrict__ wface) {
  basis_at<T, K>(xil[g * F + f], xil[(G + g) * F + f],
                 xil[(2 * G + g) * F + f], p.Bl);
  basis_at<T, K>(xir[g * F + f], xir[(G + g) * F + f],
                 xir[(2 * G + g) * F + f], p.Br);
  p.wt = wface[g] * p.fa;
}

// the flux at one face point from both sides' modal rows (row r of side
// s at u_s[r * stride]): the states summed in mode order, the pad
// substitution, the ghost, the Riemann flux; writes the C weighted rows
// of point g and returns the weighted charvel
template <typename T, int K, int G, int FLUX>
__device__ __forceinline__ T face_point(const FacePoint<T, K>& p,
                                        const T* uL, const T* uR,
                                        long long stride, int g, long long f,
                                        long long F, const Eos<T>& eos,
                                        T* __restrict__ wfl) {
  const bool interior = p.bt == BC_INTERIOR;
  T sL[C], sR[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    T a = p.Bl[0] * uL[c * K * stride], b = p.Br[0] * uR[c * K * stride];
#pragma unroll
    for (int k = 1; k < K; ++k) {
      a = a + p.Bl[k] * uL[(c * K + k) * stride];
      b = b + p.Br[k] * uR[(c * K + k) * stride];
    }
    sL[c] = a;
    sR[c] = b;
  }
  if (!p.valid) {
#pragma unroll
    for (int c = 0; c < C; ++c) sL[c] = sR[c] = T(1);
  }
  if (!interior) bc_state(p.bt, sL, p.n, sR);
  T fl[C];
  if constexpr (FLUX == FLUX_LF) {
    lax_friedrichs(eos, p.n, sL, sR, fl);
  } else {
    hllc(eos, p.n, sL, sR, fl);
  }
  const T vl = charvel(eos, sL, p.n);
  const T m = p.wt * (interior ? vmax(vl, charvel(eos, sR, p.n)) : vl);
#pragma unroll
  for (int c = 0; c < C; ++c) wfl[(c * G + g) * F + f] = fl[c] * p.wt;
  return m;
}

// a thread per face: its states in registers, its G points in order
template <typename T, int K, int G, int FLUX>
__global__ void __launch_bounds__(128)
face_wflux_face_kernel(const T* __restrict__ U, const int* __restrict__ el_,
                       const int* __restrict__ er_, const T* __restrict__ fn,
                       const T* __restrict__ farea,
                       const T* __restrict__ fmask, const T* __restrict__ xil,
                       const T* __restrict__ xir,
                       const int* __restrict__ bctype,
                       const T* __restrict__ wface, Eos<T> eos,
                       T* __restrict__ wfl, T* __restrict__ mxout,
                       long long E, long long F) {
  constexpr int NW = C * K;  // state words a side
  const long long f = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (f >= F) return;
  const long long el = el_[f], er = er_[f];
  T ul[NW], ur[NW];
#pragma unroll
  for (int r = 0; r < NW; ++r) {
    ul[r] = U[r * E + el];
    ur[r] = U[r * E + er];
  }
  FacePoint<T, K> p;
  load_face(p, f, F, fn, farea, fmask, bctype);
  T mx = T(0);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load_basis<T, K, G>(p, g, f, F, xil, xir, wface);
    const T m = face_point<T, K, G, FLUX>(p, ul, ur, 1, g, f, F, eos, wfl);
    mx = g == 0 ? m : mx + m;
  }
  mxout[f] = mx;
}

// DG(P1) and DG(P2): a tile of faces staged in shared memory, a thread per
// (face, point)
template <typename T, int K, int G, int FLUX>
__global__ void __launch_bounds__(fw_tile<T, K, FLUX>() * G)
face_wflux_kernel(const T* __restrict__ U, const int* __restrict__ el_,
                  const int* __restrict__ er_, const T* __restrict__ fn,
                  const T* __restrict__ farea, const T* __restrict__ fmask,
                  const T* __restrict__ xil, const T* __restrict__ xir,
                  const int* __restrict__ bctype, const T* __restrict__ wface,
                  Eos<T> eos, T* __restrict__ wfl, T* __restrict__ mxout,
                  long long E, long long F) {
  constexpr int TILE = fw_tile<T, K, FLUX>();
  constexpr int NW = C * K;  // state words a side
  constexpr int RT = (NW + G - 1) / G;  // rows a thread copies a side
  static_assert((2 * NW + G) * TILE * sizeof(T) <= 48 * 1024,
                "the tile must fit the 48 KB of static shared memory");
  __shared__ T sU[2][NW][TILE];         // el, er state rows
  __shared__ T smx[G][TILE];            // each point's weighted charvel
  // thread (g, j): point g of face f0 + j; the threads are point-major
  const int g = threadIdx.x / TILE, j = threadIdx.x % TILE;
  const long long f = blockIdx.x * (long long)TILE + j;
  const bool active = f < F;

  // gather: thread (g, j) loads rows g, g + G, ... of face j's el and er,
  // then its point's coordinates and face data, all before the first
  // value is stored, so that their latencies overlap
  T ul[RT], ur[RT];
  FacePoint<T, K> p;
  if (active) {
    const long long el = el_[f], er = er_[f];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = g + i * G;
      if (r < NW) {
        ul[i] = U[r * E + el];
        ur[i] = U[r * E + er];
      }
    }
    load_face(p, f, F, fn, farea, fmask, bctype);
    load_basis<T, K, G>(p, g, f, F, xil, xir, wface);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = g + i * G;
      if (r < NW) {
        sU[0][r][j] = ul[i];
        sU[1][r][j] = ur[i];
      }
    }
  }
  __syncthreads();

  if (active)
    smx[g][j] = face_point<T, K, G, FLUX>(p, &sU[0][0][j], &sU[1][0][j],
                                          TILE, g, f, F, eos, wfl);
  __syncthreads();

  // the face's charvel, summed in point order by its point-0 thread
  if (active && g == 0) {
    T mx = smx[0][j];
#pragma unroll
    for (int q = 1; q < G; ++q) mx = mx + smx[q][j];
    mxout[f] = mx;
  }
}

template <typename T, int K, int G, int FLUX>
int launch_face_wflux_kg(const void* U, const void* el, const void* er,
                         const void* fn, const void* farea, const void* fmask,
                         const void* xil, const void* xir, const void* bctype,
                         const void* wface, const Eos<T>& eos, void* wfl,
                         void* mx, long long E, long long F,
                         cudaStream_t stream) {
  constexpr int TILE = fw_tile<T, K, FLUX>();
  if constexpr (TILE == 0) {
    const long long grid = (F + 127) / 128;
    face_wflux_face_kernel<T, K, G, FLUX>
        <<<(unsigned)grid, 128, 0, stream>>>(
        (const T*)U, (const int*)el, (const int*)er, (const T*)fn,
        (const T*)farea, (const T*)fmask, (const T*)xil, (const T*)xir,
        (const int*)bctype, (const T*)wface, eos, (T*)wfl, (T*)mx, E, F);
  } else {
    const long long grid = (F + TILE - 1) / TILE;
    face_wflux_kernel<T, K, G, FLUX>
        <<<(unsigned)grid, TILE * G, 0, stream>>>(
            (const T*)U, (const int*)el, (const int*)er, (const T*)fn,
            (const T*)farea, (const T*)fmask, (const T*)xil, (const T*)xir,
            (const int*)bctype, (const T*)wface, eos, (T*)wfl, (T*)mx, E, F);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_face_wflux(const void* U, const void* el, const void* er,
                      const void* fn, const void* farea, const void* fmask,
                      const void* xil, const void* xir, const void* bctype,
                      const void* wface, double gamma, double pstiff,
                      void* wfl, void* mx, int ndof, int flux, long long E,
                      long long F, void* stream) {
  const Eos<T> eos{T(gamma), T(gamma - 1.0), T(pstiff)};
  const cudaStream_t s = (cudaStream_t)stream;
#define QTK_FACE_WFLUX(KK, GG, FL)                                          \
  if (ndof == KK && flux == FL)                                             \
    return launch_face_wflux_kg<T, KK, GG, FL>(U, el, er, fn, farea, fmask, \
                                               xil, xir, bctype, wface,     \
                                               eos, wfl, mx, E, F, s);
  QTK_FACE_WFLUX(1, 1, FLUX_HLLC)
  QTK_FACE_WFLUX(4, 3, FLUX_HLLC)
  QTK_FACE_WFLUX(10, 6, FLUX_HLLC)
  QTK_FACE_WFLUX(1, 1, FLUX_LF)
  QTK_FACE_WFLUX(4, 3, FLUX_LF)
  QTK_FACE_WFLUX(10, 6, FLUX_LF)
#undef QTK_FACE_WFLUX
  return (int)cudaErrorInvalidValue;
}

}  // namespace qtk

#define QTK_FACE_WFLUX_C(SFX, TYPE)                                         \
  extern "C" int qtk_face_wflux_##SFX(                                      \
      const void* U, const void* el, const void* er, const void* fn,        \
      const void* farea, const void* fmask, const void* xil,                \
      const void* xir, const void* bctype, const void* wface, double gamma, \
      double pstiff, void* wfl, void* mx, int ndof, int flux, long long E,  \
      long long F, void* stream) {                                          \
    return qtk::launch_face_wflux<TYPE>(U, el, er, fn, farea, fmask, xil,   \
                                        xir, bctype, wface, gamma, pstiff,  \
                                        wfl, mx, ndof, flux, E, F, stream); \
  }
QTK_FACE_WFLUX_C(f32, float)
QTK_FACE_WFLUX_C(f64, double)
