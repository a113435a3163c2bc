// K13 basis_accum: each element contracts its four faces' weighted flux
// with its own basis and sums them, for R flux rows at DG(P0) (K = 1, G =
// 1), DG(P1) (K = 4, G = 3) and DG(P2) (K = 10, G = 6): compressible Euler
// (R = 5, K12's rows) at every order, multimat (R = 16 or 22, K14's rows
// for 2 or 3 materials) at P0 and P1.
//
// Replaces the TPU single-stream face pass's accumulation:
// quinoa_tpu/ops/face_fused.py _make_basis_accum_kernel (basis_accum_pass:
// the er-sorted weighted flux contracted with B_r and accumulated at the
// right element) and the left-side accumulation of _make_fused_kernel,
// and the accumulation of the near/far kernels B2-B5
// (_make_nearfar_kernel, _make_far_raccum_kernel), which the JAX package
// runs for DG(P1) Euler with HLLC and for the multimat facade.  Plain
// version: ops/face_fused.py basis_accum_plain.
//
// For slot i < 4 of element e, with f = fose[i, e]:
//   right = fsideR[i, e] > 0: the element is the face's right side;
//   B     = the basis at the face's G points in this element's reference
//           coordinates (xi_r if right, else xi_l);
//   s     = sum_g B[:, g] * wfl[r*G + g, f] (R*K sums, in point order);
//   acc   = right ? acc + s : acc - s      (acc starts from rv, or 0);
//   delt  = sum_i mx[f]                    (the dt sweep's charvel sum);
// summed in slot order, so float32 runs repeat bit for bit (no atomics).
//
// Bound on the card: device-memory bytes.  At (R, K) = (22, 4) an element
// reads 4 face ids and side flags, 4 x 66 weighted-flux words (each face
// is read by both its elements: 2 x 66 words a face against 66 in the
// bound) and 4 x 9 Gauss coordinates and writes 89 words, for ~2,800
// flops; at P2 (5, 10) ~3,400 flops against 4 x 30 + 4 x 18 words read.
//
// Design: L lanes per element (ba_lanes).  Lane l owns rows l, l + L, l +
// 2L, ... of R and is a template parameter (basis_accum_dispatch), so each
// row's offsets are constants.  It evaluates the face basis itself (cheap;
// the element's lanes read the same face ids and coordinates, which the L1
// serves) and keeps only its ceil(R/L)*K sums in registers, where one
// thread holding all R*K of them (88 at (22, 4)) needs 154 float32
// registers and leaves 3 blocks an SM.  Each output's sum keeps its order
// (slots 0..3, points in order, plus on right faces and minus on left), so
// the bits do not change; delt is summed in slot order by lane 0.  A block
// is EPB elements x L lanes, lane-major: each warp is 32 consecutive
// elements of one lane, so the rv, r and delt rows (element axis fastest)
// are read and written 128 bytes a warp, and a warp's face reads are one
// row at 32 elements' faces, which the Hilbert element order and the
// el-sorted faces keep near each other.  A face's G x K basis values are
// evaluated once, then each row's K sums are formed and added at once.
// The template parameters K and G hide common.cuh's DG(P1) constants of
// those names.  ptxas, float32 registers at (R, K) = (5, 1), (5, 4), (5,
// 10), (16, 1), (16, 4), (22, 1), (22, 4): 32, 56, 168, 40, 80, 40, 80;
// float64 at most 254 (P2), 132 at (22, 4); no spill.

#include "common.cuh"

namespace qtk {

// lanes an element's R rows are split over at K modes: of 1, 2, 3, 4, 6
// and 8 lanes, the fastest on the card at the paths' shapes (PERF.md)
__host__ __device__ constexpr int ba_lanes(int R, int K) {
  return K == 4 ? 4 : (K == 1 && R > 5 ? 6 : 1);
}

// an instance's lanes L, rows a lane owns RL and elements a block EPB (a
// warp is 32 elements of one lane; 128 threads a block, 32L for L > 2)
template <int R, int K>
struct BasisAccumShape {
  static constexpr int L = ba_lanes(R, K);
  static constexpr int RL = (R + L - 1) / L;
  static constexpr int EPB = L == 1 ? 128 : (L == 2 ? 64 : 32);
};

// the rows of lane LANE of element e (compile-time, so each row's offsets
// are constants), and with lane 0 the element's delt
template <typename T, int R, int K, int G, int LANE>
__device__ __forceinline__ void basis_accum_lane(
    const T* __restrict__ wfl, const T* __restrict__ mx,
    const int* __restrict__ fose, const T* __restrict__ fsideR,
    const T* __restrict__ xil, const T* __restrict__ xir,
    const T* __restrict__ rv, T* __restrict__ r, T* __restrict__ delt,
    long long e, long long E, long long F) {
  using S = BasisAccumShape<R, K>;
  constexpr int L = S::L, RL = S::RL;
  T acc[RL * K];
#pragma unroll
  for (int j = 0; j < RL; ++j) {
    const int c = LANE + j * L;
    if (c < R) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        acc[j * K + k] = rv ? rv[(c * K + k) * E + e] : T(0);
    }
  }
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
    for (int j = 0; j < RL; ++j) {
      const int c = LANE + j * L;
      if (c < R) {
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
        for (int k = 0; k < K; ++k) {
          const int q = j * K + k;
          acc[q] = right ? acc[q] + s[k] : acc[q] - s[k];
        }
      }
    }
    if (LANE == 0) d = d + mx[f];
  }
#pragma unroll
  for (int j = 0; j < RL; ++j) {
    const int c = LANE + j * L;
    if (c < R) {
#pragma unroll
      for (int k = 0; k < K; ++k) r[(c * K + k) * E + e] = acc[j * K + k];
    }
  }
  if (LANE == 0) delt[e] = d;
}

// lane (warp-uniform) -> basis_accum_lane<..., lane>
template <typename T, int R, int K, int G, int LANE = 0>
__device__ __forceinline__ void basis_accum_dispatch(
    int lane, const T* wfl, const T* mx, const int* fose, const T* fsideR,
    const T* xil, const T* xir, const T* rv, T* r, T* delt, long long e,
    long long E, long long F) {
  if constexpr (LANE < BasisAccumShape<R, K>::L) {
    if (lane == LANE)
      basis_accum_lane<T, R, K, G, LANE>(wfl, mx, fose, fsideR, xil, xir, rv,
                                         r, delt, e, E, F);
    else
      basis_accum_dispatch<T, R, K, G, LANE + 1>(lane, wfl, mx, fose, fsideR,
                                                 xil, xir, rv, r, delt, e, E,
                                                 F);
  }
}

template <typename T, int R, int K, int G>
__global__ void __launch_bounds__(BasisAccumShape<R, K>::EPB *
                                  BasisAccumShape<R, K>::L)
basis_accum_kernel(const T* __restrict__ wfl, const T* __restrict__ mx,
                   const int* __restrict__ fose, const T* __restrict__ fsideR,
                   const T* __restrict__ xil, const T* __restrict__ xir,
                   const T* __restrict__ rv, T* __restrict__ r,
                   T* __restrict__ delt, long long E, long long F) {
  using S = BasisAccumShape<R, K>;
  const long long e = blockIdx.x * (long long)S::EPB + threadIdx.x % S::EPB;
  if (e >= E) return;
  basis_accum_dispatch<T, R, K, G>(threadIdx.x / S::EPB, wfl, mx, fose,
                                   fsideR, xil, xir, rv, r, delt, e, E, F);
}

template <typename T, int R, int K, int G>
void launch_basis_accum_rkg(const void* wfl, const void* mx, const void* fose,
                            const void* fsideR, const void* xil,
                            const void* xir, const void* rv, void* r,
                            void* delt, long long E, long long F,
                            cudaStream_t stream) {
  using S = BasisAccumShape<R, K>;
  const long long grid = (E + S::EPB - 1) / S::EPB;
  basis_accum_kernel<T, R, K, G><<<(unsigned)grid, S::EPB * S::L, 0, stream>>>(
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
