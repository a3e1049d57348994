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
// ~295 ops/byte ridge, so tensor-core throughput bounds them.  The design: one tiled
// tensor-core GEMM (128x128x32 tiles, 8 warps each owning 64x32, three-stage
// cp.async ring, mma.sync m16n8k16) with the bias / GELU / residual fused
// into its epilogue, preceded by a one-warp-per-row LayerNorm pass that
// writes the normalised bf16 rows once (the same bf16 rounding the TPU
// kernel applies before its product).  K3 stages its (T, 5120) bf16 hidden
// through a device scratch buffer the wrapper allocates; keeping it on chip
// (and wgmma/TMA in place of mma.sync) is later work.
#include "common.cuh"

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

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 3, LDS = BK + 8;
constexpr int GEMM_THREADS = 256;
constexpr int GEMM_SMEM = STAGES * (BM + BN) * LDS * (int)sizeof(bf16);

enum { EPI_BIAS = 0, EPI_BIAS_GELU = 1, EPI_BIAS_RESIDUAL = 2 };

// C[M, N] = epilogue(A[M, K] @ W[N, K]^T + bias); rows of A and W are K-contiguous.
template <int EPI>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
            const float* __restrict__ bias, bf16* __restrict__ C,
            const bf16* __restrict__ rx, const bf16* __restrict__ radd,
            int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = sA + STAGES * BM * LDS;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;  // 2 x 4 warps, 64 x 32 each
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int KT = (K + BK - 1) / BK;

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < (BM * BK / 8) / GEMM_THREADS; ++i) {
      const int c = tid + i * GEMM_THREADS;
      const int r = c >> 2, kc = (c & 3) * 8;
      const int gk = k0 + kc;
      const bool oka = m0 + r < M && gk < K;
      cp_async16(sA + (stage * BM + r) * LDS + kc,
                 oka ? A + (size_t)(m0 + r) * K + gk : A, oka ? 16 : 0);
      const bool okb = n0 + r < N && gk < K;
      cp_async16(sB + (stage * BN + r) * LDS + kc,
                 okb ? W + (size_t)(n0 + r) * K + gk : W, okb ? 16 : 0);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed; stage kt-1 is free for the next load
    const int nk = kt + STAGES - 1;
    if (nk < KT) load_stage(nk % STAGES, nk);
    cp_async_commit();

    const bf16* a_s = sA + (kt % STAGES) * BM * LDS;
    const bf16* b_s = sB + (kt % STAGES) * BN * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(af[mi], a_s + (wm * 64 + mi * 16 + (lane & 15)) * LDS + kk + (lane >> 4) * 8);
      uint32_t bfr[4][2];
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t r[4];
        ldmatrix_x4(r, b_s + (wn * 32 + nj * 16 + (lane & 7) + (lane >> 4) * 8) * LDS + kk +
                           ((lane >> 3) & 1) * 8);
        bfr[2 * nj][0] = r[0];
        bfr[2 * nj][1] = r[1];
        bfr[2 * nj + 1][0] = r[2];
        bfr[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn * 32 + ni * 8 + (lane & 3) * 2;
      if (col >= N) continue;
      const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = m0 + wm * 64 + mi * 16 + (lane >> 2) + hh * 8;
        if (row >= M) continue;
        float v0 = acc[mi][ni][2 * hh] + b0;
        float v1 = acc[mi][ni][2 * hh + 1] + b1;
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
}

template <int EPI>
cudaError_t launch_gemm(const bf16* A, const bf16* W, const float* bias, bf16* C,
                        const bf16* rx, const bf16* radd, int M, int N, int K,
                        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(gemm_kernel<EPI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_kernel<EPI><<<grid, GEMM_THREADS, GEMM_SMEM, stream>>>(A, W, bias, C, rx, radd, M, N, K);
  return cudaGetLastError();
}

cudaError_t launch_ln(const bf16* x, const bf16* add, const bf16* mask, const float* g,
                      const float* b, bf16* out, int T, int E, float eps, cudaStream_t stream) {
  ln_rows_kernel<<<(T + LN_ROWS - 1) / LN_ROWS, LN_ROWS * 32, 0, stream>>>(x, add, mask, g, b,
                                                                          out, T, E, eps);
  return cudaGetLastError();
}

}  // namespace

// Shapes: x (T, E), mask (T,) or null, w (O, E), b (O,); scratch xn (T, E); out (T, O).
// E and O must be multiples of 8; all pointers 16-byte aligned.
extern "C" int k1_ln_masked_linear(const void* x, const void* mask, const void* gamma,
                                   const void* beta, const void* w, const void* b, void* xn,
                                   void* out, int T, int E, int O, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_ln(static_cast<const bf16*>(x), nullptr, static_cast<const bf16*>(mask),
                              static_cast<const float*>(gamma), static_cast<const float*>(beta),
                              static_cast<bf16*>(xn), T, E, eps, s);
  if (err != cudaSuccess) return err;
  return launch_gemm<EPI_BIAS>(static_cast<const bf16*>(xn), static_cast<const bf16*>(w),
                               static_cast<const float*>(b), static_cast<bf16*>(out), nullptr,
                               nullptr, T, O, E, s);
}

// Shapes: x, add (T, E) (add may be null), w1 (M, E), b1 (M,), w2 (E, M), b2 (E,);
// scratch xn (T, E) and hidden (T, M); out (T, E).
extern "C" int k3_ln_mlp_residual(const void* x, const void* add, const void* gamma,
                                  const void* beta, const void* w1, const void* b1,
                                  const void* w2, const void* b2, void* xn, void* hidden,
                                  void* out, int T, int E, int M, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* ab = static_cast<const bf16*>(add);
  cudaError_t err = launch_ln(xb, ab, nullptr, static_cast<const float*>(gamma),
                              static_cast<const float*>(beta), static_cast<bf16*>(xn), T, E, eps, s);
  if (err != cudaSuccess) return err;
  err = launch_gemm<EPI_BIAS_GELU>(static_cast<const bf16*>(xn), static_cast<const bf16*>(w1),
                                   static_cast<const float*>(b1), static_cast<bf16*>(hidden),
                                   nullptr, nullptr, T, M, E, s);
  if (err != cudaSuccess) return err;
  return launch_gemm<EPI_BIAS_RESIDUAL>(static_cast<const bf16*>(hidden),
                                        static_cast<const bf16*>(w2),
                                        static_cast<const float*>(b2), static_cast<bf16*>(out), xb,
                                        ab, T, E, M, s);
}
