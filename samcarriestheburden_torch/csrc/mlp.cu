// K1 and K3: the encoder's LayerNorm + matrix product kernels, bf16 on sm_90a.
//
// K1 replaces samcarriestheburden_tpu/kernels/mlp.py:fused_ln_masked_linear
//    out = bf16((bf16(LN(x) * mask)) @ W^T + b)      the qkv projection, pad
//    tokens re-zeroed after the LayerNorm so their q/k/v equal the bias.
// K3 replaces samcarriestheburden_tpu/kernels/mlp.py:fused_ln_mlp_residual
//    s = x (+ add);  h = bf16(GELU_erf(bf16(LN(s)) @ W1^T + b1))
//    out = bf16(s + (h @ W2^T + b2))
// LayerNorm statistics are fp32, both products accumulate in fp32, biases
// and LayerNorm affines are fp32, weights are (out, in) bf16.
//
// What bounds them on the card: at ViT-H shapes (T = 5000 tokens per image,
// E = 1280, qkv 3840 wide, MLP 5120 wide) both are matrix products with
// ~900 (K1) and ~2500 (K3) operations per byte moved, far above the card's
// ~295 ops/byte ridge, so tensor-core throughput bounds them.  The design: a
// one-warp-per-row LayerNorm pass that writes the normalised bf16 rows once
// (the same bf16 rounding the TPU kernel applies before its product), then
// one GEMM per product on the TMA + wgmma mainloop of gemm_sm90.cuh (a ring
// of 128-byte-swizzled boxes, two warpgroups of m64nBNk16 bf16 -> fp32) with
// the bias / GELU / residual in its epilogue.  The qkv product and lin1 run
// on 128 x 128 tiles at two blocks per SM, so that one block's epilogue
// (their wide stores, lin1's erff) runs beside the other's products; lin2 on
// K14's 128 x 256 at one, which reads A half as often under its 5120-long
// contraction and 1280-wide output (each GEMM's faster tile on the H100,
// tools/ab_gemm.py).  K3 stages its (T, 5120) bf16 hidden through a device
// scratch buffer the wrapper allocates: at E = 1280 a 64-row fp32 slice of
// lin2's output alone is 327 KB, more than an SM holds.  Rows past T read
// zeros through TMA's out-of-bounds fill and are not stored.  The epilogues'
// arithmetic is the mma.sync kernel's that this one replaced, value for
// value, and erff inlines (no call: a call anywhere in the kernel makes ptxas
// serialize its wgmma, warning C7520).
#include "gemm_sm90.cuh"

namespace {

constexpr int LN_ROWS = 8;  // rows per LayerNorm block, one warp each

__global__ void __launch_bounds__(LN_ROWS * 32)
ln_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ add,
               const bf16* __restrict__ mask, const float* __restrict__ gamma,
               const float* __restrict__ beta, bf16* __restrict__ out,
               int T, int E, float eps) {
  const int row = blockIdx.x * LN_ROWS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= T) return;
  const size_t base = (size_t)row * E;
  auto val = [&](int i) {
    float v = __bfloat162float(x[base + i]);
    if (add != nullptr) v += __bfloat162float(add[base + i]);
    return v;
  };
  float s = 0.f;
  for (int i = lane; i < E; i += 32) s += val(i);
  const float mean = warp_sum(s) / E;
  float q = 0.f;
  for (int i = lane; i < E; i += 32) {
    const float d = val(i) - mean;
    q += d * d;
  }
  const float rstd = rsqrtf(warp_sum(q) / E + eps);
  const float m = mask != nullptr ? __bfloat162float(mask[row]) : 1.f;
  for (int i = lane; i < E; i += 32)
    out[base + i] = __float2bfloat16(((val(i) - mean) * rstd * gamma[i] + beta[i]) * m);
}

enum { EPI_BIAS = 0, EPI_BIAS_GELU = 1, EPI_BIAS_RESIDUAL = 2 };

// C[M, N] = epilogue(A[M, K] @ W[N, K]^T + bias) on tile configuration G
// (gemm_sm90.cuh); A and W are K-contiguous bf16, mapped by tmA and tmW.
template <int EPI, class G>
__global__ void __launch_bounds__(256, G::BLOCKS)
gemm_kernel(const __grid_constant__ CUtensorMap tmA, const __grid_constant__ CUtensorMap tmW,
            const float* __restrict__ bias, bf16* __restrict__ C, const bf16* __restrict__ rx,
            const bf16* __restrict__ radd, int M, int N, int K) {
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr int BN = G::BN;
  float acc[BN / 2];
  gemm_sm90_mainloop<G>(&tmA, &tmW, K, smem, acc);
  const int m0 = blockIdx.y * G::BM, n0 = blockIdx.x * BN;

#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + tile_col(j);
    if (col >= N) continue;
    const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = m0 + tile_row(hh);
      if (row >= M) continue;
      float v0 = acc[4 * j + 2 * hh] + b0;
      float v1 = acc[4 * j + 2 * hh + 1] + b1;
      const size_t o = (size_t)row * N + col;
      if (EPI == EPI_BIAS_GELU) {
        v0 = 0.5f * v0 * (1.f + erff(v0 * 0.70710678118654752f));
        v1 = 0.5f * v1 * (1.f + erff(v1 * 0.70710678118654752f));
      } else if (EPI == EPI_BIAS_RESIDUAL) {
        const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(rx + o);
        float s0 = __bfloat162float(xv.x), s1 = __bfloat162float(xv.y);
        if (radd != nullptr) {
          const __nv_bfloat162 av = *reinterpret_cast<const __nv_bfloat162*>(radd + o);
          s0 += __bfloat162float(av.x);
          s1 += __bfloat162float(av.y);
        }
        v0 = s0 + v0;
        v1 = s1 + v1;
      }
      *reinterpret_cast<__nv_bfloat162*>(C + o) = __floats2bfloat162_rn(v0, v1);
    }
  }
}

template <int EPI, class G>
cudaError_t launch_gemm(const bf16* A, const bf16* W, const float* bias, bf16* C,
                        const bf16* rx, const bf16* radd, int M, int N, int K,
                        cudaStream_t stream) {
  CUtensorMap ta, tw;
  if (!encode_map_2d(&ta, A, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, K, M, G::BM) ||
      !encode_map_2d(&tw, W, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, K, N, G::BN))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(gemm_kernel<EPI, G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + G::BN - 1) / G::BN, (M + G::BM - 1) / G::BM);
  gemm_kernel<EPI, G><<<grid, G::THREADS, G::SMEM, stream>>>(ta, tw, bias, C, rx, radd, M, N, K);
  return cudaGetLastError();
}

// the qkv product and lin1: 128 x 128 tiles, two blocks per SM; lin2: 128 x 256, one
using NarrowTile = GemmSm90<bf16, 128, 2>;
using WideTile = GemmSm90<bf16, 256, 1>;

cudaError_t launch_ln(const bf16* x, const bf16* add, const bf16* mask, const float* g,
                      const float* b, bf16* out, int T, int E, float eps, cudaStream_t stream) {
  ln_rows_kernel<<<(T + LN_ROWS - 1) / LN_ROWS, LN_ROWS * 32, 0, stream>>>(x, add, mask, g, b,
                                                                          out, T, E, eps);
  return cudaGetLastError();
}

}  // namespace

// Shapes: x (T, E), mask (T,) or null, w (O, E), b (O,); scratch xn (T, E); out (T, O).
// T >= 1; E and O must be multiples of 8 (TMA's 16-byte row pitch); all
// pointers 16-byte aligned.
extern "C" int k1_ln_masked_linear(const void* x, const void* mask, const void* gamma,
                                   const void* beta, const void* w, const void* b, void* xn,
                                   void* out, int T, int E, int O, float eps, void* stream) {
  if (T < 1 || E < 8 || O < 8 || E % 8 || O % 8) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_ln(static_cast<const bf16*>(x), nullptr, static_cast<const bf16*>(mask),
                              static_cast<const float*>(gamma), static_cast<const float*>(beta),
                              static_cast<bf16*>(xn), T, E, eps, s);
  if (err != cudaSuccess) return err;
  return launch_gemm<EPI_BIAS, NarrowTile>(static_cast<const bf16*>(xn),
                                           static_cast<const bf16*>(w),
                                           static_cast<const float*>(b), static_cast<bf16*>(out),
                                           nullptr, nullptr, T, O, E, s);
}

// Shapes: x, add (T, E) (add may be null), w1 (M, E), b1 (M,), w2 (E, M), b2 (E,);
// scratch xn (T, E) and hidden (T, M); out (T, E).  T >= 1; E and M must be
// multiples of 8.
extern "C" int k3_ln_mlp_residual(const void* x, const void* add, const void* gamma,
                                  const void* beta, const void* w1, const void* b1,
                                  const void* w2, const void* b2, void* xn, void* hidden,
                                  void* out, int T, int E, int M, float eps, void* stream) {
  if (T < 1 || E < 8 || M < 8 || E % 8 || M % 8) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* ab = static_cast<const bf16*>(add);
  cudaError_t err = launch_ln(xb, ab, nullptr, static_cast<const float*>(gamma),
                              static_cast<const float*>(beta), static_cast<bf16*>(xn), T, E, eps, s);
  if (err != cudaSuccess) return err;
  err = launch_gemm<EPI_BIAS_GELU, NarrowTile>(static_cast<const bf16*>(xn),
                                               static_cast<const bf16*>(w1),
                                               static_cast<const float*>(b1),
                                               static_cast<bf16*>(hidden), nullptr, nullptr, T,
                                               M, E, s);
  if (err != cudaSuccess) return err;
  return launch_gemm<EPI_BIAS_RESIDUAL, WideTile>(static_cast<const bf16*>(hidden),
                                                  static_cast<const bf16*>(w2),
                                                  static_cast<const float*>(b2),
                                                  static_cast<bf16*>(out), xb, ab, T, E, M, s);
}
