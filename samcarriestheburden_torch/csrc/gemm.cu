// K14: the bare matrix product C = A @ W^T on sm_90a, in three types:
//    bf16 x bf16 -> fp32, bf16 x bf16 -> bf16 (fp32 accumulate, one rounding),
//    int8 x int8 -> int32.
//
// Replaces the dot-only Pallas kernels of the JAX experiment tools:
//    tools/exp_int8.py:pallas_dot (bf16 -> fp32 and int8 -> int32, row
//    blocks of 256), tools/exp_3d.py:dot3d, :dotreshape and :dot2d (bf16 ->
//    bf16 over (100, 196, 1280) as a 3-D block, reshaped in the kernel, or as
//    2-D rows in blocks of 784).  On the card the three forms are one product
//    over the same rows: the 3-D and reshaped inputs are views of the 2-D one.
// A is (M, K) and W (N, K), both K-contiguous, as the weights of K1-K4 are.
//
// What bounds it: at the tools' shape (19600 x 1280 x 5120) the product has
// 2.57e11 operations against 0.08-0.46 GB moved, above the card's ridge, so
// the tensor-core rate bounds it; the fp32 and int32 outputs (401 MB) still
// take about half as long to store as the products take.  The design is the
// point of the tool: the TMA + wgmma mainloop of K2, K4 and K15 (gemm_sm90.cuh,
// 128 x 256 tiles, a four-stage ring of 128-byte-swizzled boxes) with an
// epilogue that only stores, so its time is what those kernels' products
// reach alone.  Each quad of lanes stores two adjacent columns of a row per
// 8-column group: 32 contiguous bytes per row for fp32 and int32.  Rows past
// M (19600 = 153 * 128 + 16) are loaded as zeros and not stored.
#include <type_traits>

#include "gemm_sm90.cuh"

namespace {

enum { DOT_BF16_F32 = 0, DOT_BF16_BF16 = 1, DOT_S8_S32 = 2 };

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(int* p, int a, int b) {
  *reinterpret_cast<int2*>(p) = make_int2(a, b);
}

// The block's tile of accumulators to C[M, N] (layout: gemm_sm90.cuh).
template <int BN, class T, class Acc>
__device__ __forceinline__ void store_tile(T* __restrict__ C, const Acc (&acc)[BN / 2], int M,
                                           int N) {
  const int m0 = blockIdx.y * 128, n0 = blockIdx.x * BN;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + tile_col(j);
    if (col >= N) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = m0 + tile_row(hh);
      if (row < M) store2(C + (size_t)row * N + col, acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
    }
  }
}

template <int MODE>
using DotTile = GemmSm90<std::conditional_t<MODE == DOT_S8_S32, int8_t, bf16>, 256>;

template <int MODE>
__global__ void __launch_bounds__(256, DotTile<MODE>::BLOCKS)
dot_kernel(const __grid_constant__ CUtensorMap tmA, const __grid_constant__ CUtensorMap tmW,
           void* __restrict__ C, int M, int N, int K) {
  using G = DotTile<MODE>;
  extern __shared__ __align__(1024) unsigned char smem[];
  typename G::Acc acc[G::BN / 2];
  gemm_sm90_mainloop<G>(&tmA, &tmW, K, smem, acc);
  if constexpr (MODE == DOT_S8_S32)
    store_tile<G::BN>(static_cast<int*>(C), acc, M, N);
  else if constexpr (MODE == DOT_BF16_F32)
    store_tile<G::BN>(static_cast<float*>(C), acc, M, N);
  else
    store_tile<G::BN>(static_cast<bf16*>(C), acc, M, N);
}

template <int MODE>
cudaError_t launch_dot(const void* A, const void* W, void* C, int M, int N, int K,
                       cudaStream_t stream) {
  using G = DotTile<MODE>;
  using T = typename G::Elem;
  CUtensorMap ta, tw;
  if (!encode_map_2d(&ta, A, Sm90Elem<T>::TMA, sizeof(T), K, M, G::BM) ||
      !encode_map_2d(&tw, W, Sm90Elem<T>::TMA, sizeof(T), K, N, G::BN))
    return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(dot_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + G::BN - 1) / G::BN, (M + G::BM - 1) / G::BM);
  dot_kernel<MODE><<<grid, G::THREADS, G::SMEM, stream>>>(ta, tw, C, M, N, K);
  return cudaGetLastError();
}

}  // namespace

// Shapes: a (M, K), w (N, K), c (M, N); mode 0: bf16 inputs, fp32 c; 1: bf16
// inputs, bf16 c; 2: int8 inputs, int32 c.  K must be a multiple of 16 bytes
// (8 bf16, 16 int8: TMA's row pitch) and N of 8; all pointers 16-byte aligned.
extern "C" int k14_dot(const void* a, const void* w, void* c, int M, int N, int K, int mode,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 1 || K < 1 || N % 8 || K % (mode == DOT_S8_S32 ? 16 : 8))
    return cudaErrorInvalidValue;
  switch (mode) {
    case DOT_BF16_F32: return launch_dot<DOT_BF16_F32>(a, w, c, M, N, K, st);
    case DOT_BF16_BF16: return launch_dot<DOT_BF16_BF16>(a, w, c, M, N, K, st);
    case DOT_S8_S32: return launch_dot<DOT_S8_S32>(a, w, c, M, N, K, st);
    default: return cudaErrorInvalidValue;
  }
}
