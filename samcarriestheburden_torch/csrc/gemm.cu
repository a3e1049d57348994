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
// point of the tool: the mainloops of K1-K4 exactly (common.cuh, mma.sync
// 128 x 128 tiles, three-stage cp.async ring) with an epilogue that only
// stores, so its time is what those kernels' products reach alone.  Each quad
// of lanes stores two adjacent columns of 8 rows: 32 contiguous bytes per row
// for fp32 and int32.  Rows past M (19600 = 153 * 128 + 16) are loaded as
// zeros and not stored.
#include "common.cuh"

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

// The block's tile of accumulators to C[M, N] (layout: common.cuh).
template <class T, class Acc>
__device__ __forceinline__ void store_tile(T* __restrict__ C, const Acc (&acc)[4][4][4], int M,
                                           int N) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.y * 128, n0 = blockIdx.x * 128;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn * 32 + ni * 8 + (lane & 3) * 2;
      if (col >= N) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = m0 + wm * 64 + mi * 16 + (lane >> 2) + hh * 8;
        if (row < M)
          store2(C + (size_t)row * N + col, acc[mi][ni][2 * hh], acc[mi][ni][2 * hh + 1]);
      }
    }
}

template <int MODE>
__global__ void __launch_bounds__(256)
dot_kernel(const void* __restrict__ A, const void* __restrict__ W, void* __restrict__ C, int M,
           int N, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (MODE == DOT_S8_S32) {
    int acc[4][4][4];
    gemm_s8_mainloop(static_cast<const int8_t*>(A), static_cast<const int8_t*>(W), M, N, K, smem,
                     acc);
    store_tile(static_cast<int*>(C), acc, M, N);
  } else {
    float acc[4][4][4];
    gemm_bf16_mainloop(static_cast<const bf16*>(A), static_cast<const bf16*>(W), M, N, K, smem,
                       acc);
    if constexpr (MODE == DOT_BF16_F32)
      store_tile(static_cast<float*>(C), acc, M, N);
    else
      store_tile(static_cast<bf16*>(C), acc, M, N);
  }
}

template <int MODE>
cudaError_t launch_dot(const void* A, const void* W, void* C, int M, int N, int K,
                       cudaStream_t stream) {
  static_assert(gemm_bf16::BM == 128 && gemm_bf16::BN == 128 && gemm_s8::BM == 128 &&
                    gemm_s8::BN == 128 && gemm_bf16::THREADS == 256 && gemm_s8::THREADS == 256,
                "store_tile assumes 128 x 128 tiles of 256 threads");
  const int smem = MODE == DOT_S8_S32 ? gemm_s8::SMEM : gemm_bf16::SMEM;
  cudaError_t err =
      cudaFuncSetAttribute(dot_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + 127) / 128, (M + 127) / 128);
  dot_kernel<MODE><<<grid, 256, smem, stream>>>(A, W, C, M, N, K);
  return cudaGetLastError();
}

}  // namespace

// Shapes: a (M, K), w (N, K), c (M, N); mode 0: bf16 inputs, fp32 c; 1: bf16
// inputs, bf16 c; 2: int8 inputs, int32 c.  K must be a multiple of 16 bytes
// (8 bf16, 16 int8) and N of 8; all pointers 16-byte aligned.
extern "C" int k14_dot(const void* a, const void* w, void* c, int M, int N, int K, int mode,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 1 || N % 8 || K % (mode == DOT_S8_S32 ? 16 : 8)) return cudaErrorInvalidValue;
  switch (mode) {
    case DOT_BF16_F32: return launch_dot<DOT_BF16_F32>(a, w, c, M, N, K, st);
    case DOT_BF16_BF16: return launch_dot<DOT_BF16_BF16>(a, w, c, M, N, K, st);
    case DOT_S8_S32: return launch_dot<DOT_S8_S32>(a, w, c, M, N, K, st);
    default: return cudaErrorInvalidValue;
  }
}
