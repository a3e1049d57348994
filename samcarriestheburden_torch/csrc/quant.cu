// K2 and K4: the encoder's LayerNorm + matrix product kernels in dynamic
// int8, over prequantized weights, on sm_90a.
//
// K2 replaces samcarriestheburden_tpu/kernels/quant.py:fused_ln_masked_linear_int8
//    xn = LN(x) * mask;  sx = max(absmax_row(xn), 1e-12) / 127;  xq = rint(xn / sx)
//    out = bf16(int32(xq @ Wq^T) * (sx[row] * s[col]) + b[col])
// K4 replaces samcarriestheburden_tpu/kernels/quant.py:fused_ln_mlp_residual_int8
//    s = x (+ add);  xq, sx = rowquant(LN(s))
//    h = GELU(int32(xq @ W1q^T) * (sx * s1) + b1)            fp32
//    hq, sh = rowquant(h)                                    from the fp32 h
//    out = bf16(s + int32(hq @ W2q^T) * (sh * s2) + b2)
// Weights are int8 (out, in) with fp32 per-output-channel scales; LayerNorm
// statistics, GELU and the residual are fp32; the rounding is half-to-even
// and the quotient a true division, as in the TPU kernels.
//
// What bounds them on the card: at ViT-H shapes (T = 10,000 tokens, E = 1280,
// qkv 3840 wide, MLP 5120 wide) both are matrix products with ~1000 (K2) and
// ~2800 (K4) operations per byte their function must move, far above the
// card's ~590 int8 ops/byte ridge, so the int8 tensor-core rate bounds them.
// The design is the bf16 kernels' (csrc/mlp.cu) with one byte per element:
// a one-warp-per-row LayerNorm pass that also takes the row's absmax and
// writes the int8 row and its scale, then one tiled int8 tensor-core GEMM
// (128x128x64 tiles, 8 warps each owning 64x32, three-stage cp.async ring,
// mma.sync m16n8k32 s8 x s8 -> s32) with the dequantization and the bias /
// GELU / residual in its epilogue.  Both operands are contiguous along the
// contracted axis, so ldmatrix's 8 x 16-byte tiles are the .row.col
// fragments as they are.  K4's second quantization needs a whole 5120-wide
// row of the fp32 hidden, which spans every column tile of the first GEMM:
// its epilogue writes the fp32 hidden to a device scratch buffer and folds
// the row absmax in with one atomicMax per quad (non-negative floats order
// as integers), a pass quantizes the rows, and the second GEMM reads int8.
// That staging moves 4 + 4 + 1 + 1 bytes per hidden element that the
// function itself does not need; keeping the hidden on chip is later work.
#include "common.cuh"

namespace {

constexpr int LN_ROWS = 8;  // rows per LayerNorm block, one warp each

__device__ __forceinline__ uint32_t pack_s8(float a, float b, float c, float d, float s) {
  const int q0 = __float2int_rn(a / s), q1 = __float2int_rn(b / s);
  const int q2 = __float2int_rn(c / s), q3 = __float2int_rn(d / s);
  return (uint32_t)(q0 & 0xff) | ((uint32_t)(q1 & 0xff) << 8) | ((uint32_t)(q2 & 0xff) << 16) |
         ((uint32_t)(q3 & 0xff) << 24);
}

// xq[row] = rint(xn / sx[row]) with xn = LN(x (+ add)) * mask; E % 4 == 0.
// hmax, where given, is zeroed for the row absmax the first GEMM folds in.
__global__ void __launch_bounds__(LN_ROWS * 32)
ln_quant_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ add,
                     const bf16* __restrict__ mask, const float* __restrict__ gamma,
                     const float* __restrict__ beta, int8_t* __restrict__ xq,
                     float* __restrict__ sx, float* __restrict__ hmax, int T, int E, float eps) {
  const int row = blockIdx.x * LN_ROWS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= T) return;
  const size_t base = (size_t)row * E;
  auto load4 = [&](int i, float (&v)[4]) {
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(x + base + i);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(x + base + i + 2);
    v[0] = __bfloat162float(a.x), v[1] = __bfloat162float(a.y);
    v[2] = __bfloat162float(b.x), v[3] = __bfloat162float(b.y);
    if (add != nullptr) {
      const __nv_bfloat162 c = *reinterpret_cast<const __nv_bfloat162*>(add + base + i);
      const __nv_bfloat162 d = *reinterpret_cast<const __nv_bfloat162*>(add + base + i + 2);
      v[0] += __bfloat162float(c.x), v[1] += __bfloat162float(c.y);
      v[2] += __bfloat162float(d.x), v[3] += __bfloat162float(d.y);
    }
  };
  float v[4];
  float s = 0.f;
  for (int i = lane * 4; i < E; i += 128) {
    load4(i, v);
    s += (v[0] + v[1]) + (v[2] + v[3]);
  }
  const float mean = warp_sum(s) / E;
  float q = 0.f;
  for (int i = lane * 4; i < E; i += 128) {
    load4(i, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) q += (v[e] - mean) * (v[e] - mean);
  }
  const float rstd = rsqrtf(warp_sum(q) / E + eps);
  const float m = mask != nullptr ? __bfloat162float(mask[row]) : 1.f;
  auto norm4 = [&](int i, float (&n)[4]) {
    load4(i, n);
    const float4 g = *reinterpret_cast<const float4*>(gamma + i);
    const float4 b = *reinterpret_cast<const float4*>(beta + i);
    n[0] = ((n[0] - mean) * rstd * g.x + b.x) * m;
    n[1] = ((n[1] - mean) * rstd * g.y + b.y) * m;
    n[2] = ((n[2] - mean) * rstd * g.z + b.z) * m;
    n[3] = ((n[3] - mean) * rstd * g.w + b.w) * m;
  };
  float amax = 0.f;
  for (int i = lane * 4; i < E; i += 128) {
    norm4(i, v);
    amax = fmaxf(fmaxf(amax, fmaxf(fabsf(v[0]), fabsf(v[1]))), fmaxf(fabsf(v[2]), fabsf(v[3])));
  }
  const float scale = fmaxf(warp_max(amax), 1e-12f) / 127.f;
  for (int i = lane * 4; i < E; i += 128) {
    norm4(i, v);
    *reinterpret_cast<uint32_t*>(xq + base + i) = pack_s8(v[0], v[1], v[2], v[3], scale);
  }
  if (lane == 0) {
    sx[row] = scale;
    if (hmax != nullptr) hmax[row] = 0.f;
  }
}

// hq[row] = rint(h[row] / sh) with sh = max(hmax[row], 1e-12) / 127; M % 4 == 0.
__global__ void __launch_bounds__(256)
quant_rows_kernel(const float* __restrict__ h, const float* __restrict__ hmax,
                  int8_t* __restrict__ hq, size_t total4, int M) {
  const size_t i4 = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (i4 >= total4) return;
  const size_t i = i4 * 4;
  const float sh = fmaxf(hmax[i / M], 1e-12f) / 127.f;
  const float4 v = *reinterpret_cast<const float4*>(h + i);
  *reinterpret_cast<uint32_t*>(hq + i) = pack_s8(v.x, v.y, v.z, v.w, sh);
}

// K4's GELU, fp32.  'poly': the odd-polynomial fit of Phi, Horner in u = h^2.
__device__ __forceinline__ float gelu_poly(float h) {
  const float u = h * h;
  float p = 1.0962050526e-08f;
  p = p * u + -9.3423034307e-07f;
  p = p * u + 3.3436889582e-05f;
  p = p * u + -6.5934551371e-04f;
  p = p * u + 7.9518464564e-03f;
  p = p * u + -6.2628257803e-02f;
  p = p * u + 3.9645120080e-01f;
  return h * fminf(fmaxf(0.5f + h * p, 0.f), 1.f);
}

// 'erf': 0.5 h (1 + erf(h / sqrt 2)) with Abramowitz & Stegun 7.1.26.
__device__ __forceinline__ float gelu_erf(float h) {
  const float x = h * 0.7071067811865476f;
  const float a = fabsf(x);
  const float t = 1.f / (1.f + 0.3275911f * a);
  const float poly = t * (0.254829592f + t * (-0.284496736f + t * (1.421413741f +
                     t * (-1.453152027f + t * 1.061405429f))));
  const float erf_a = 1.f - poly * expf(-a * a);
  const float sign = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  return 0.5f * h * (1.f + sign * erf_a);
}

// byte geometry: 64 contracted int8 per stage, rows padded to 80 bytes so the
// eight 16-byte rows of an ldmatrix tile fall in distinct banks
constexpr int BM = 128, BN = 128, BK = 64, STAGES = 3, LDS = BK + 16;
constexpr int GEMM_THREADS = 256;
constexpr int GEMM_SMEM = STAGES * (BM + BN) * LDS;

enum { EPI_BIAS = 0, EPI_GELU_POLY = 1, EPI_GELU_ERF = 2, EPI_RESIDUAL = 3 };

// acc[M, N] = A[M, K] @ W[N, K]^T in int32; rows of A and W are K-contiguous int8.
//   EPI_BIAS       C bf16 = acc * (sa[row] * sw[col]) + bias[col]
//   EPI_GELU_*     C fp32 = GELU(the same); rowmax[row] = max |C[row, :]|
//   EPI_RESIDUAL   C bf16 = (rx (+ radd)) + acc * (sh * sw[col]) + bias[col],
//                  sh = max(sa[row], 1e-12) / 127 from the row absmax in sa
template <int EPI>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_s8_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ W,
               const float* __restrict__ sa, const float* __restrict__ sw,
               const float* __restrict__ bias, void* __restrict__ Cout,
               float* __restrict__ rowmax, const bf16* __restrict__ rx,
               const bf16* __restrict__ radd, int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* sA = reinterpret_cast<int8_t*>(smem);
  int8_t* sB = sA + STAGES * BM * LDS;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;  // 2 x 4 warps, 64 x 32 each
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int KT = (K + BK - 1) / BK;

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < (BM * BK / 16) / GEMM_THREADS; ++i) {
      const int c = tid + i * GEMM_THREADS;
      const int r = c >> 2, kc = (c & 3) * 16;
      const int gk = k0 + kc;
      const bool oka = m0 + r < M && gk < K;
      cp_async16(sA + (stage * BM + r) * LDS + kc,
                 oka ? A + (size_t)(m0 + r) * K + gk : A, oka ? 16 : 0);
      const bool okb = n0 + r < N && gk < K;
      cp_async16(sB + (stage * BN + r) * LDS + kc,
                 okb ? W + (size_t)(n0 + r) * K + gk : W, okb ? 16 : 0);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

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

    const int8_t* a_s = sA + (kt % STAGES) * BM * LDS;
    const int8_t* b_s = sB + (kt % STAGES) * BN * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(af[mi], a_s + (wm * 64 + mi * 16 + (lane & 15)) * LDS + kk + (lane >> 4) * 16);
      uint32_t bfr[4][2];
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t r[4];
        ldmatrix_x4(r, b_s + (wn * 32 + nj * 16 + (lane & 7) + (lane >> 4) * 8) * LDS + kk +
                           ((lane >> 3) & 1) * 16);
        bfr[2 * nj][0] = r[0];
        bfr[2 * nj][1] = r[1];
        bfr[2 * nj + 1][0] = r[2];
        bfr[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
    }
  }
  cp_async_wait<0>();

  constexpr bool GELU = EPI == EPI_GELU_POLY || EPI == EPI_GELU_ERF;
  float rmax[4][2];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) rmax[mi][0] = rmax[mi][1] = 0.f;

#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = n0 + wn * 32 + ni * 8 + (lane & 3) * 2;
    const bool colok = col < N;
    const float w0 = colok ? sw[col] : 0.f, w1 = colok ? sw[col + 1] : 0.f;
    const float b0 = colok ? bias[col] : 0.f, b1 = colok ? bias[col + 1] : 0.f;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = m0 + wm * 64 + mi * 16 + (lane >> 2) + hh * 8;
        if (row >= M || !colok) continue;
        const float sr = EPI == EPI_RESIDUAL ? fmaxf(sa[row], 1e-12f) / 127.f : sa[row];
        const size_t o = (size_t)row * N + col;
        float v0 = (float)acc[mi][ni][2 * hh] * (sr * w0);
        float v1 = (float)acc[mi][ni][2 * hh + 1] * (sr * w1);
        if (EPI == EPI_RESIDUAL) {
          const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(rx + o);
          float s0 = __bfloat162float(xv.x), s1 = __bfloat162float(xv.y);
          if (radd != nullptr) {
            const __nv_bfloat162 av = *reinterpret_cast<const __nv_bfloat162*>(radd + o);
            s0 += __bfloat162float(av.x);
            s1 += __bfloat162float(av.y);
          }
          v0 = (s0 + v0) + b0;
          v1 = (s1 + v1) + b1;
        } else {
          v0 += b0;
          v1 += b1;
        }
        if (GELU) {
          v0 = EPI == EPI_GELU_POLY ? gelu_poly(v0) : gelu_erf(v0);
          v1 = EPI == EPI_GELU_POLY ? gelu_poly(v1) : gelu_erf(v1);
          rmax[mi][hh] = fmaxf(rmax[mi][hh], fmaxf(fabsf(v0), fabsf(v1)));
          *reinterpret_cast<float2*>(static_cast<float*>(Cout) + o) = make_float2(v0, v1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(Cout) + o) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }

  if (GELU) {
    // the four lanes of a quad hold one row's columns of this warp's 32
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float r = rmax[mi][hh];
        r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 1));
        r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 2));
        const int row = m0 + wm * 64 + mi * 16 + (lane >> 2) + hh * 8;
        if ((lane & 3) == 0 && row < M)
          atomicMax(reinterpret_cast<int*>(rowmax + row), __float_as_int(r));
      }
  }
}

template <int EPI>
cudaError_t launch_gemm(const int8_t* A, const int8_t* W, const float* sa, const float* sw,
                        const float* bias, void* C, float* rowmax, const bf16* rx,
                        const bf16* radd, int M, int N, int K, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(gemm_s8_kernel<EPI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_s8_kernel<EPI><<<grid, GEMM_THREADS, GEMM_SMEM, stream>>>(A, W, sa, sw, bias, C, rowmax, rx,
                                                                 radd, M, N, K);
  return cudaGetLastError();
}

cudaError_t launch_ln_quant(const bf16* x, const bf16* add, const bf16* mask, const float* g,
                            const float* b, int8_t* xq, float* sx, float* hmax, int T, int E,
                            float eps, cudaStream_t stream) {
  ln_quant_rows_kernel<<<(T + LN_ROWS - 1) / LN_ROWS, LN_ROWS * 32, 0, stream>>>(
      x, add, mask, g, b, xq, sx, hmax, T, E, eps);
  return cudaGetLastError();
}

}  // namespace

// Shapes: x (T, E) bf16, mask (T,) bf16 or null, wq (O, E) int8, s, b (O,) fp32;
// scratch xq (T, E) int8 and sx (T,) fp32; out (T, O) bf16.
// E must be a multiple of 16 and O of 8; all pointers 16-byte aligned.
extern "C" int k2_ln_masked_linear_int8(const void* x, const void* mask, const void* gamma,
                                        const void* beta, const void* wq, const void* s,
                                        const void* b, void* xq, void* sx, void* out, int T,
                                        int E, int O, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_ln_quant(
      static_cast<const bf16*>(x), nullptr, static_cast<const bf16*>(mask),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<int8_t*>(xq), static_cast<float*>(sx), nullptr, T, E, eps, st);
  if (err != cudaSuccess) return err;
  return launch_gemm<EPI_BIAS>(static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wq),
                               static_cast<const float*>(sx), static_cast<const float*>(s),
                               static_cast<const float*>(b), out, nullptr, nullptr, nullptr, T, O,
                               E, st);
}

// Shapes: x, add (T, E) bf16 (add may be null), w1q (M, E), w2q (E, M) int8,
// s1, b1 (M,), s2, b2 (E,) fp32; scratch xq (T, E) int8, sx (T,) fp32,
// hidden (T, M) fp32, hmax (T,) fp32, hq (T, M) int8; out (T, E) bf16.
// gelu: 0 the polynomial, 1 the erf form.  E and M must be multiples of 16.
extern "C" int k4_ln_mlp_residual_int8(const void* x, const void* add, const void* gamma,
                                       const void* beta, const void* w1q, const void* s1,
                                       const void* b1, const void* w2q, const void* s2,
                                       const void* b2, void* xq, void* sx, void* hidden,
                                       void* hmax, void* hq, void* out, int T, int E, int M,
                                       float eps, int gelu, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* ab = static_cast<const bf16*>(add);
  float* hm = static_cast<float*>(hmax);
  cudaError_t err = launch_ln_quant(xb, ab, nullptr, static_cast<const float*>(gamma),
                                    static_cast<const float*>(beta), static_cast<int8_t*>(xq),
                                    static_cast<float*>(sx), hm, T, E, eps, st);
  if (err != cudaSuccess) return err;
  const int8_t* xqi = static_cast<const int8_t*>(xq);
  const int8_t* w1 = static_cast<const int8_t*>(w1q);
  const float* sxf = static_cast<const float*>(sx);
  const float* s1f = static_cast<const float*>(s1);
  const float* b1f = static_cast<const float*>(b1);
  if (gelu == 0)
    err = launch_gemm<EPI_GELU_POLY>(xqi, w1, sxf, s1f, b1f, hidden, hm, nullptr, nullptr, T, M, E,
                                     st);
  else if (gelu == 1)
    err = launch_gemm<EPI_GELU_ERF>(xqi, w1, sxf, s1f, b1f, hidden, hm, nullptr, nullptr, T, M, E,
                                    st);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  const size_t total4 = (size_t)T * M / 4;
  quant_rows_kernel<<<(unsigned)((total4 + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(hidden), hm, static_cast<int8_t*>(hq), total4, M);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_gemm<EPI_RESIDUAL>(static_cast<const int8_t*>(hq),
                                   static_cast<const int8_t*>(w2q), hm,
                                   static_cast<const float*>(s2), static_cast<const float*>(b2),
                                   out, nullptr, xb, ab, T, E, M, st);
}
