// K13 basis_accum: each element contracts its four faces' weighted flux
// with its own basis and sums them, one thread per element, for R flux
// rows at DG(P0) (K = 1, G = 1), DG(P1) (K = 4, G = 3) and DG(P2) (K = 10,
// G = 6): compressible Euler (R = 5, K12's rows) at every order, multimat
// (R = 16 or 22, K14's rows for 2 or 3 materials) at P0 and P1.
//
// Replaces the TPU single-stream face pass's accumulation:
// quinoa_tpu/ops/face_fused.py _make_basis_accum_kernel (basis_accum_pass:
// the er-sorted weighted flux contracted with B_r and accumulated at the
// right element) and the left-side accumulation of _make_fused_kernel,
// and, for the multimat facade, the accumulation of the near/far kernels
// B2-B5 (_make_nearfar_kernel, _make_far_raccum_kernel).  Plain version:
// ops/face_fused.py basis_accum_plain.
//
// For slot i < 4 of element e, with f = fose[i, e]:
//   right = fsideR[i, e] > 0: the element is the face's right side;
//   B     = the basis at the face's G points in this element's reference
//           coordinates (xi_r if right, else xi_l);
//   s     = sum_g B[:, g] * wfl[r*G + g, f] (R*K sums, in point order);
//   acc   = right ? acc + s : acc - s      (acc starts from rv, or 0);
//   delt  = sum_i mx[f]                    (the dt sweep's charvel sum);
// summed in slot order, so float32 runs repeat bit for bit (no atomics).
// At K = 4 this is the same arithmetic as K2 + K3 (contribL = -s at el,
// contribR = +s at er), so both forms give the same bits.
//
// Bound on the card: device-memory bytes.  At P2 an element reads 4 face
// ids, 4 side flags, 4 x 30 weighted-flux words, 4 x 18 Gauss coordinates
// and 50 rv words and writes 51 words, for ~3,400 flops (the basis at 24
// points and 1,200 multiply-adds).  Design: the element axis is the fastest
// axis of rv, r and delt (coalesced); the face rows are gathers along the
// face axis, which the Hilbert element order and the el-sorted faces keep
// near each other.  A face's G x K basis values are evaluated once, then
// each row's K sums are formed and added at once, so a thread holds the
// R*K sums and one row's partial contraction.  The template parameters K
// and G hide common.cuh's DG(P1) constants of those names; the R*K sums (88
// at R = 22, K = 4) may spill (the ptxas report beside the library says).

#include "common.cuh"

namespace qtk {

template <typename T, int R, int K, int G>
__global__ void __launch_bounds__(128)
basis_accum_kernel(const T* __restrict__ wfl, const T* __restrict__ mx,
                   const int* __restrict__ fose, const T* __restrict__ fsideR,
                   const T* __restrict__ xil, const T* __restrict__ xir,
                   const T* __restrict__ rv, T* __restrict__ r,
                   T* __restrict__ delt, long long E, long long F) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= E) return;
  T acc[R * K];
#pragma unroll
  for (int q = 0; q < R * K; ++q) acc[q] = rv ? rv[q * E + e] : T(0);
  T d = T(0);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long f = fose[i * E + e];
    const bool right = fsideR[i * E + e] > T(0);
    const T* xi = right ? xir : xil;
    T B[G][K];
#pragma unroll
    for (int g = 0; g < G; ++g)
      basis_at<T, K>(xi[g * F + f], xi[(G + g) * F + f],
                     xi[(2 * G + g) * F + f], B[g]);
#pragma unroll
    for (int c = 0; c < R; ++c) {
      T s[K];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const T w = wfl[(c * G + g) * F + f];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const T t = B[g][k] * w;
          s[k] = g == 0 ? t : s[k] + t;
        }
      }
#pragma unroll
      for (int k = 0; k < K; ++k)
        acc[c * K + k] = right ? acc[c * K + k] + s[k] : acc[c * K + k] - s[k];
    }
    d = d + mx[f];
  }
#pragma unroll
  for (int q = 0; q < R * K; ++q) r[q * E + e] = acc[q];
  delt[e] = d;
}

template <typename T, int R, int K, int G>
void launch_basis_accum_rkg(const void* wfl, const void* mx, const void* fose,
                            const void* fsideR, const void* xil,
                            const void* xir, const void* rv, void* r,
                            void* delt, long long E, long long F,
                            cudaStream_t stream) {
  const int block = 128;
  const long long grid = (E + block - 1) / block;
  basis_accum_kernel<T, R, K, G><<<(unsigned)grid, block, 0, stream>>>(
      (const T*)wfl, (const T*)mx, (const int*)fose, (const T*)fsideR,
      (const T*)xil, (const T*)xir, (const T*)rv, (T*)r, (T*)delt, E, F);
}

// the (R, K) instances of kernels/__init__.py BASIS_ACCUM_SHAPES
template <typename T>
int launch_basis_accum(const void* wfl, const void* mx, const void* fose,
                       const void* fsideR, const void* xil, const void* xir,
                       const void* rv, void* r, void* delt, int rows,
                       int ndof, long long E, long long F, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
#define QTK_BASIS_ACCUM(RR, KK, GG)                                         \
  if (rows == RR && ndof == KK) {                                           \
    launch_basis_accum_rkg<T, RR, KK, GG>(wfl, mx, fose, fsideR, xil, xir,  \
                                          rv, r, delt, E, F, s);            \
    return (int)cudaGetLastError();                                         \
  }
  QTK_BASIS_ACCUM(5, 1, 1)
  QTK_BASIS_ACCUM(5, 4, 3)
  QTK_BASIS_ACCUM(5, 10, 6)
  QTK_BASIS_ACCUM(16, 1, 1)
  QTK_BASIS_ACCUM(16, 4, 3)
  QTK_BASIS_ACCUM(22, 1, 1)
  QTK_BASIS_ACCUM(22, 4, 3)
#undef QTK_BASIS_ACCUM
  return (int)cudaErrorInvalidValue;
}

}  // namespace qtk

extern "C" int qtk_basis_accum_f32(const void* wfl, const void* mx,
                                   const void* fose, const void* fsideR,
                                   const void* xil, const void* xir,
                                   const void* rv, void* r, void* delt,
                                   int rows, int ndof, long long E,
                                   long long F, void* stream) {
  return qtk::launch_basis_accum<float>(wfl, mx, fose, fsideR, xil, xir, rv,
                                        r, delt, rows, ndof, E, F, stream);
}

extern "C" int qtk_basis_accum_f64(const void* wfl, const void* mx,
                                   const void* fose, const void* fsideR,
                                   const void* xil, const void* xir,
                                   const void* rv, void* r, void* delt,
                                   int rows, int ndof, long long E,
                                   long long F, void* stream) {
  return qtk::launch_basis_accum<double>(wfl, mx, fose, fsideR, xil, xir,
                                         rv, r, delt, rows, ndof, E, F,
                                         stream);
}
