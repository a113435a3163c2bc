// K2 face_flux: the DG(P1) surface integrand of every face, one thread
// per face.
//
// Replaces the per-face half of the TPU face pass in
// quinoa_tpu/ops/face_fused.py: _make_nearfar_kernel (near and far
// streams), _make_far_rstate_kernel and the basis contraction of
// _make_far_raccum_kernel.  Plain version: ops/face_fused.py
// face_flux_plain.
//
// Per face: gather the el and er modal states, evaluate the P1 basis at
// the G Gauss points of both sides, apply the symmetry/extrapolate ghost
// on boundary faces, evaluate HLLC, weight by w_g * area, and write
//   contribL (CK, F) = -sum_g B_l * wfl,  contribR (CK, F) = +sum_g B_r * wfl,
//   mx (F,) = sum_g w_g * area * (interior ? max(vl, vr) : vl)
// (the dt sweep's weighted max characteristic speed).
//
// Bound on the card: device-memory bytes.  A face reads 40 state words
// (two gathers of 20 rows), 18 Gauss coordinates, 3 normal words and a few
// scalars, and writes 41 words; the HLLC arithmetic (~300 flops per point)
// stays below the memory time.  Design: faces are sorted by their left
// element, so the el gathers of a warp hit a few cache lines and the face
// tables are read coalesced; the er gathers rely on the Hilbert element
// order.  Nothing is accumulated here, so there are no atomics and the
// element kernel (face_to_elem.cu) sums in a fixed order.

#include "common.cuh"

namespace qtk {

template <typename T>
__global__ void __launch_bounds__(128)
face_flux_kernel(const T* __restrict__ U, const int* __restrict__ el_,
                 const int* __restrict__ er_, const T* __restrict__ fn,
                 const T* __restrict__ farea, const T* __restrict__ fmask,
                 const T* __restrict__ xil, const T* __restrict__ xir,
                 const int* __restrict__ bctype, const T* __restrict__ tab,
                 Eos<T> eos, T* __restrict__ cLout, T* __restrict__ cRout,
                 T* __restrict__ mxout, long long E, long long F) {
  const long long f = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (f >= F) return;
  const long long el = el_[f], er = er_[f];
  T UL[CK], UR[CK];
#pragma unroll
  for (int r = 0; r < CK; ++r) {
    UL[r] = U[r * E + el];
    UR[r] = U[r * E + er];
  }
  const T n[3] = {fn[f], fn[F + f], fn[2 * F + f]};
  const T fa = farea[f] * fmask[f];
  const bool valid = fmask[f] > T(0);
  const int bt = bctype[f];
  const bool interior = bt == BC_INTERIOR;

  T cL[CK], cR[CK], mx = T(0);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    T Bl[K], Br[K];
    basis_p1(xil[g * F + f], xil[(G + g) * F + f], xil[(2 * G + g) * F + f],
             Bl);
    basis_p1(xir[g * F + f], xir[(G + g) * F + f], xir[(2 * G + g) * F + f],
             Br);
    T sL[C], sR[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      sL[c] = eval_mode_sum(Bl, UL, c);
      sR[c] = eval_mode_sum(Br, UR, c);
    }
    if (!valid) {
      // pad faces: a finite unit state (their weights are zero)
#pragma unroll
      for (int c = 0; c < C; ++c) sL[c] = sR[c] = T(1);
    }
    if (!interior) bc_state(bt, sL, n, sR);
    T fl[C];
    hllc(eos, n, sL, sR, fl);
    const T wt = tab[TAB_WFACE + g] * fa;
    const T vl = charvel(eos, sL, n);
    const T m = wt * (interior ? vmax(vl, charvel(eos, sR, n)) : vl);
    mx = g == 0 ? m : mx + m;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const T wfl = fl[c] * wt;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const T tl = Bl[k] * wfl, tr = Br[k] * wfl;
        cL[c * K + k] = g == 0 ? tl : cL[c * K + k] + tl;
        cR[c * K + k] = g == 0 ? tr : cR[c * K + k] + tr;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < CK; ++r) {
    cLout[r * F + f] = -cL[r];
    cRout[r * F + f] = cR[r];
  }
  mxout[f] = mx;
}

template <typename T>
int launch_face_flux(const void* U, const void* el, const void* er,
                     const void* fn, const void* farea, const void* fmask,
                     const void* xil, const void* xir, const void* bctype,
                     const void* tab, double gamma, double pstiff, void* cL,
                     void* cR, void* mx, long long E, long long F,
                     void* stream) {
  const int block = 128;
  const long long grid = (F + block - 1) / block;
  const Eos<T> eos{T(gamma), T(gamma - 1.0), T(pstiff)};
  face_flux_kernel<T><<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)U, (const int*)el, (const int*)er, (const T*)fn,
      (const T*)farea, (const T*)fmask, (const T*)xil, (const T*)xir,
      (const int*)bctype, (const T*)tab, eos, (T*)cL, (T*)cR, (T*)mx, E, F);
  return (int)cudaGetLastError();
}

}  // namespace qtk

extern "C" int qtk_face_flux_f32(const void* U, const void* el,
                                 const void* er, const void* fn,
                                 const void* farea, const void* fmask,
                                 const void* xil, const void* xir,
                                 const void* bctype, const void* tab,
                                 double gamma, double pstiff, void* cL,
                                 void* cR, void* mx, long long E,
                                 long long F, void* stream) {
  return qtk::launch_face_flux<float>(U, el, er, fn, farea, fmask, xil, xir,
                                      bctype, tab, gamma, pstiff, cL, cR, mx,
                                      E, F, stream);
}

extern "C" int qtk_face_flux_f64(const void* U, const void* el,
                                 const void* er, const void* fn,
                                 const void* farea, const void* fmask,
                                 const void* xil, const void* xir,
                                 const void* bctype, const void* tab,
                                 double gamma, double pstiff, void* cL,
                                 void* cR, void* mx, long long E,
                                 long long F, void* stream) {
  return qtk::launch_face_flux<double>(U, el, er, fn, farea, fmask, xil, xir,
                                       bctype, tab, gamma, pstiff, cL, cR,
                                       mx, E, F, stream);
}
