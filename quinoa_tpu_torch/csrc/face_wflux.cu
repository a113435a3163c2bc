// K12 face_wflux: the weighted Riemann flux at every face's Gauss points,
// one thread per face, for DG(P0) (K = 1, G = 1), DG(P1) (K = 4, G = 3)
// and DG(P2) (K = 10, G = 6), with the HLLC or the Lax-Friedrichs flux
// (template parameter FLUX; the int flux argument of the C entry points).
//
// Replaces the per-face work of the TPU single-stream face pass,
// quinoa_tpu/ops/face_fused.py _make_fused_kernel (fused_face_pass):
// states, basis, ghost, Riemann flux, the weighted-flux output and the
// charvel row.  Its left-side accumulation moves to K13 (basis_accum.cu),
// which accumulates both sides.  Plain version: ops/face_fused.py
// face_wflux_plain.
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
// time at 67 TFLOP/s.  Design: the weighted flux is C*G = 30 rows a face
// where K2's contracted contributions are 2*C*K = 100, so the contraction
// with the basis moves to the element kernel, which evaluates each face's
// basis at its own side.  Faces are sorted by their left element, so the el
// gathers of a warp hit a few cache lines; the er gathers rely on the
// Hilbert element order.  Nothing is accumulated here: no atomics.  The
// template parameters K and G hide common.cuh's DG(P1) constants of those
// names; at K = 10 the 100 state words a thread may spill (the ptxas report
// beside the library says).  At P0 the basis is 1 and the Gauss
// coordinates are not read (basis_at<T, 1>), so a face moves 10 state
// words, 9 words of face data and writes 6.

#include "common.cuh"

namespace qtk {

template <typename T, int K, int G, int FLUX>
__global__ void __launch_bounds__(128)
face_wflux_kernel(const T* __restrict__ U, const int* __restrict__ el_,
                  const int* __restrict__ er_, const T* __restrict__ fn,
                  const T* __restrict__ farea, const T* __restrict__ fmask,
                  const T* __restrict__ xil, const T* __restrict__ xir,
                  const int* __restrict__ bctype, const T* __restrict__ wface,
                  Eos<T> eos, T* __restrict__ wfl, T* __restrict__ mxout,
                  long long E, long long F) {
  const long long f = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (f >= F) return;
  const long long el = el_[f], er = er_[f];
  T UL[C * K], UR[C * K];
#pragma unroll
  for (int r = 0; r < C * K; ++r) {
    UL[r] = U[r * E + el];
    UR[r] = U[r * E + er];
  }
  const T n[3] = {fn[f], fn[F + f], fn[2 * F + f]};
  const T fa = farea[f] * fmask[f];
  const bool valid = fmask[f] > T(0);
  const int bt = bctype[f];
  const bool interior = bt == BC_INTERIOR;

  T mx = T(0);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    T Bl[K], Br[K];
    basis_at<T, K>(xil[g * F + f], xil[(G + g) * F + f],
                   xil[(2 * G + g) * F + f], Bl);
    basis_at<T, K>(xir[g * F + f], xir[(G + g) * F + f],
                   xir[(2 * G + g) * F + f], Br);
    T sL[C], sR[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      T a = Bl[0] * UL[c * K], b = Br[0] * UR[c * K];
#pragma unroll
      for (int k = 1; k < K; ++k) {
        a = a + Bl[k] * UL[c * K + k];
        b = b + Br[k] * UR[c * K + k];
      }
      sL[c] = a;
      sR[c] = b;
    }
    if (!valid) {
#pragma unroll
      for (int c = 0; c < C; ++c) sL[c] = sR[c] = T(1);
    }
    if (!interior) bc_state(bt, sL, n, sR);
    T fl[C];
    if constexpr (FLUX == FLUX_LF) {
      lax_friedrichs(eos, n, sL, sR, fl);
    } else {
      hllc(eos, n, sL, sR, fl);
    }
    const T wt = wface[g] * fa;
    const T vl = charvel(eos, sL, n);
    const T m = wt * (interior ? vmax(vl, charvel(eos, sR, n)) : vl);
    mx = g == 0 ? m : mx + m;
#pragma unroll
    for (int c = 0; c < C; ++c) wfl[(c * G + g) * F + f] = fl[c] * wt;
  }
  mxout[f] = mx;
}

template <typename T, int K, int G, int FLUX>
void launch_face_wflux_kg(const void* U, const void* el, const void* er,
                          const void* fn, const void* farea,
                          const void* fmask, const void* xil,
                          const void* xir, const void* bctype,
                          const void* wface, const Eos<T>& eos, void* wfl,
                          void* mx, long long E, long long F,
                          cudaStream_t stream) {
  const int block = 128;
  const long long grid = (F + block - 1) / block;
  face_wflux_kernel<T, K, G, FLUX><<<(unsigned)grid, block, 0, stream>>>(
      (const T*)U, (const int*)el, (const int*)er, (const T*)fn,
      (const T*)farea, (const T*)fmask, (const T*)xil, (const T*)xir,
      (const int*)bctype, (const T*)wface, eos, (T*)wfl, (T*)mx, E, F);
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
  if (ndof == KK && flux == FL) {                                           \
    launch_face_wflux_kg<T, KK, GG, FL>(U, el, er, fn, farea, fmask, xil,   \
                                        xir, bctype, wface, eos, wfl, mx,   \
                                        E, F, s);                           \
    return (int)cudaGetLastError();                                         \
  }
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
