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
// K15 replaces the int8 MLP variants of the JAX experiment tools,
//    tools/exp_int8.py:mk_chunked and :mk_diag, tools/exp_mlp2.py:mk: K4
//    (without add) with the hidden split into `chunks` column chunks of ch = M /
//    chunks, each requantized per (row, chunk) by its own absmax and its lin2
//    partial dequantized and summed in fp32 in chunk order; the activation erf,
//    poly, sigmoid (h * sigmoid(1.702 h)) or relu; the row quantization by a
//    divide (K4's) or by the row's reciprocal (q = rint(x * (127 / a)), s =
//    a * (1/127)); or a fixed hidden scale of 1/8 (q = sat_s8(rint(8 h))).
//    At chunks = 1, divide, no fixed scale and GELU it is K4 bit for bit.
// Weights are int8 (out, in) with fp32 per-output-channel scales; LayerNorm
// statistics, GELU and the residual are fp32; the rounding is half-to-even
// and the quotient a true division, as in the TPU kernels.
//
// What bounds them on the card: at ViT-H shapes (T = 10,000 tokens, E = 1280,
// qkv 3840 wide, MLP 5120 wide) both are matrix products with ~1000 (K2) and
// ~2800 (K4) operations per byte their function must move, far above the
// card's ~590 int8 ops/byte ridge, so the int8 tensor-core rate bounds them.
// The design: a one-warp-per-row LayerNorm pass that also takes the row's
// absmax and writes the int8 row and its scale, then one int8 GEMM on the
// TMA + wgmma mainloop of gemm_sm90.cuh (128 x 128 tiles, two blocks per SM,
// a three-stage ring of 128-byte-swizzled boxes, two warpgroups of m64n128k32
// s8 x s8 -> s32) with the dequantization and the bias / GELU / residual in
// its epilogue.  Both operands are contiguous along the contracted axis, as
// int8 wgmma requires.  K4's second quantization needs a whole 5120-wide
// row of the fp32 hidden, which spans every column tile of the first GEMM:
// its epilogue writes the fp32 hidden to a device scratch buffer and folds
// the row absmax in with one atomicMax per quad (non-negative floats order
// as integers), a pass quantizes the rows, and the second GEMM reads int8.
// That staging moves 4 + 4 + 1 + 1 bytes per hidden element that the
// function itself does not need; keeping the hidden on chip is later work.
// K14 times the mainloop bare.  K15 runs K4's passes with three changes: the
// first GEMM's epilogue folds the absmax per (row, chunk) (ch % 128 == 0, so
// a 128-column tile lies in one chunk), the quantize pass takes each chunk's
// scale (or the fixed 1/8) and writes it, and the second GEMM (one block per
// SM: its fp32 sums double the accumulators) flushes its int32 accumulators
// at every chunk boundary but the last (ch / 128 k-tiles, one stage each) into
// fp32 ones, dequantized by the chunk's row scale; the epilogue lands the last
// chunk's partial on the residual plus that sum in one fused multiply-add, as
// K4 lands its one partial, so that K15 at K4's settings is K4 bit for bit.
// The epilogues' arithmetic is the mma.sync kernels' that these replaced,
// value for value, and the int32 products are exact: the outputs are the same
// bits.  Their divisions are div_rn_inline's, not the compiler's.
#include <math.h>

#include "gemm_sm90.cuh"

namespace {

constexpr int LN_ROWS = 8;  // rows per LayerNorm block, one warp each

// rint(v / s) four times, packed; RECIP: rint(v * s), s the row's 127 / absmax
template <bool RECIP = false>
__device__ __forceinline__ uint32_t pack_s8(float a, float b, float c, float d, float s) {
  const int q0 = __float2int_rn(RECIP ? a * s : a / s), q1 = __float2int_rn(RECIP ? b * s : b / s);
  const int q2 = __float2int_rn(RECIP ? c * s : c / s), q3 = __float2int_rn(RECIP ? d * s : d / s);
  return (uint32_t)(q0 & 0xff) | ((uint32_t)(q1 & 0xff) << 8) | ((uint32_t)(q2 & 0xff) << 16) |
         ((uint32_t)(q3 & 0xff) << 24);
}

// xq[row] = rint(xn / sx[row]) with xn = LN(x (+ add)) * mask; E % 4 == 0.
// RECIP: xq[row] = rint(xn * (127 / a)), sx[row] = a * (1/127), a = max(absmax, 1e-12).
// hmax, where given, has its nh entries of the row zeroed for the absmax the
// first GEMM folds in.
template <bool RECIP = false>
__global__ void __launch_bounds__(LN_ROWS * 32)
ln_quant_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ add,
                     const bf16* __restrict__ mask, const float* __restrict__ gamma,
                     const float* __restrict__ beta, int8_t* __restrict__ xq,
                     float* __restrict__ sx, float* __restrict__ hmax, int nh, int T, int E,
                     float eps) {
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
  const float a = fmaxf(warp_max(amax), 1e-12f);
  const float scale = RECIP ? a * (1.f / 127.f) : a / 127.f;
  const float step = RECIP ? 127.f / a : scale;
  for (int i = lane * 4; i < E; i += 128) {
    norm4(i, v);
    *reinterpret_cast<uint32_t*>(xq + base + i) = pack_s8<RECIP>(v[0], v[1], v[2], v[3], step);
  }
  if (lane == 0) {
    sx[row] = scale;
    if (hmax != nullptr)
      for (int j = 0; j < nh; ++j) hmax[(size_t)row * nh + j] = 0.f;
  }
}

enum { RQ_DIV = 0, RQ_RECIP = 1, RQ_FIXED = 2 };

// hq[row, c] = the row quantization of the hidden h[row, c] within its chunk
// j = c / ch, from the chunk's absmax hmax[row, j]: K4's rint(h / sh) with sh =
// max(hmax, 1e-12) / 127 (one chunk, ch = M), or K15's (RQ_RECIP: rint(h *
// (127 / a)), sh = a * (1/127); RQ_FIXED: sat_s8(rint(8 h)), sh = 1/8).  Where
// given, sh[row, j] receives the scale.  M % 4 == 0, ch % 4 == 0.
template <int RQ>
__global__ void __launch_bounds__(256)
quant_chunks_kernel(const float* __restrict__ h, const float* __restrict__ hmax,
                    int8_t* __restrict__ hq, float* __restrict__ sh, size_t total4, int M, int ch,
                    int chunks) {
  const size_t i4 = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (i4 >= total4) return;
  const size_t i = i4 * 4;
  const size_t row = i / M;
  const int col = (int)(i % M), j = col / ch;
  const float4 v = *reinterpret_cast<const float4*>(h + i);
  float s;
  uint32_t q;
  if constexpr (RQ == RQ_FIXED) {
    auto sat = [](float x) {
      return (uint32_t)(min(max(__float2int_rn(x * 8.f), -128), 127) & 0xff);
    };
    q = sat(v.x) | (sat(v.y) << 8) | (sat(v.z) << 16) | (sat(v.w) << 24);
    s = 0.125f;
  } else {
    const float a = fmaxf(hmax[row * chunks + j], 1e-12f);
    s = RQ == RQ_RECIP ? a * (1.f / 127.f) : a / 127.f;
    q = pack_s8<RQ == RQ_RECIP>(v.x, v.y, v.z, v.w, RQ == RQ_RECIP ? 127.f / a : s);
  }
  *reinterpret_cast<uint32_t*>(hq + i) = q;
  if (sh != nullptr && col % ch == 0) sh[row * chunks + j] = s;
}

// a / b rounded to nearest even: the bits of IEEE division (div.rn.f32, and
// rcp.rn.f32 for 1 / b), without its call.  The compiler's division keeps a
// slow path for extreme operands in a subroutine, and a call anywhere in a
// kernel makes ptxas serialize its wgmma (C7520).  Here the quotient is taken
// in fp64 (rcp.approx, two Newton steps, one correction of the product:
// relative error about 2^-53) and rounded once to fp32.  The exact quotient of
// two floats lies at least 2^-50 of itself away from every midpoint between
// floats (a midpoint has 25 significant bits, so midpoint x b never equals a),
// so the fp64 value rounds to the float the exact quotient rounds to.  Zeros,
// infinities and NaN as IEEE has them.
__device__ __forceinline__ float div_rn_inline(float a, float b) {
  const double da = a, db = b;
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;\n" : "=d"(r) : "d"(db));
  r = fma(r, fma(-db, r, 1.0), r);
  r = fma(r, fma(-db, r, 1.0), r);
  double q = da * r;
  q = fma(r, fma(-db, q, da), q);
  float out = __double2float_rn(q);
  const bool neg = signbit(a) != signbit(b);
  if (a == 0.f || isinf(b)) out = neg ? -0.f : 0.f;            // 0 / b, a / inf
  if (b == 0.f || isinf(a)) out = neg ? -INFINITY : INFINITY;  // a / 0, inf / b
  if (isnan(a) || isnan(b) || (a == 0.f && b == 0.f) || (isinf(a) && isinf(b))) out = NAN;
  return out;
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
  const float t = div_rn_inline(1.f, 1.f + 0.3275911f * a);
  const float poly = t * (0.254829592f + t * (-0.284496736f + t * (1.421413741f +
                     t * (-1.453152027f + t * 1.061405429f))));
  const float erf_a = 1.f - poly * expf(-a * a);
  const float sign = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  return 0.5f * h * (1.f + sign * erf_a);
}

enum {
  EPI_BIAS = 0, EPI_GELU_POLY = 1, EPI_GELU_ERF = 2, EPI_RESIDUAL = 3,
  EPI_SIGMOID = 4, EPI_RELU = 5, EPI_RESIDUAL_CHUNKED = 6
};

__host__ __device__ constexpr bool is_act(int epi) {
  return epi == EPI_GELU_POLY || epi == EPI_GELU_ERF || epi == EPI_SIGMOID || epi == EPI_RELU;
}

template <int EPI>
__device__ __forceinline__ float activation(float h) {
  if constexpr (EPI == EPI_GELU_POLY) return gelu_poly(h);
  else if constexpr (EPI == EPI_GELU_ERF) return gelu_erf(h);
  else if constexpr (EPI == EPI_SIGMOID) return h * div_rn_inline(1.f, 1.f + expf(-1.702f * h));
  else return fmaxf(h, 0.f);
}

// acc[M, N] = A[M, K] @ W[N, K]^T in int32 (gemm_sm90.cuh's mainloop); rows
// of A and W are K-contiguous int8, mapped by tmA and tmW.
//   EPI_BIAS       C bf16 = acc * (sa[row] * sw[col]) + bias[col]
//   activations    C fp32 = act(the same); rowmax[row, col / ch] = max |C| over the
//                  row's columns of chunk col / ch, (M, chunks) (ch % 128 == 0)
//   EPI_RESIDUAL   C bf16 = (rx (+ radd)) + acc * (sh * sw[col]) + bias[col],
//                  sh = max(sa[row], 1e-12) / 127 from the row absmax in sa
//   EPI_RESIDUAL_CHUNKED  the same without radd, the contraction in chunks of
//                  ch: chunk j's int32 partial times (sa[row, j] * sw[col]), sa the
//                  chunk scales (M, chunks), summed in fp32 in chunk order
//                  (ch % 128 == 0); the last chunk's is fused onto rx + the sum
template <int EPI, class G>
__global__ void __launch_bounds__(256, G::BLOCKS)
gemm_s8_kernel(const __grid_constant__ CUtensorMap tmA, const __grid_constant__ CUtensorMap tmW,
               const float* __restrict__ sa, const float* __restrict__ sw,
               const float* __restrict__ bias, void* __restrict__ Cout,
               float* __restrict__ rowmax, const bf16* __restrict__ rx,
               const bf16* __restrict__ radd, int M, int N, int K, int ch, int chunks) {
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr int BN = G::BN;
  const int lane = threadIdx.x % 32;
  const int m0 = blockIdx.y * G::BM, n0 = blockIdx.x * BN;
  constexpr bool CHUNKED = EPI == EPI_RESIDUAL_CHUNKED;
  int acc[BN / 2];
  float facc[CHUNKED ? BN / 2 : 1];
  if constexpr (CHUNKED) {
    gemm_sm90_mainloop<G>(&tmA, &tmW, K, smem, acc, ch / G::BK, [&](int j) {
      if (j == chunks - 1) return;  // the last chunk: the epilogue
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = m0 + tile_row(hh);
        const float sr = row < M ? sa[(size_t)row * chunks + j] : 0.f;
#pragma unroll
        for (int jj = 0; jj < BN / 8; ++jj) {
          const int col = n0 + tile_col(jj);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * jj + 2 * hh + e;
            const float v = col + e < N ? (float)acc[i] * (sr * sw[col + e]) : 0.f;
            float& f = facc[i];
            f = j == 0 ? v : f + v;
            acc[i] = 0;
          }
        }
      }
    });
  } else {
    gemm_sm90_mainloop<G>(&tmA, &tmW, K, smem, acc);
  }

  constexpr bool ACT = is_act(EPI);
  static_assert(!ACT || BN == 128, "an activation tile lies in one chunk (ch % 128 == 0)");
  float rmax[2] = {0.f, 0.f};

#pragma unroll
  for (int jj = 0; jj < BN / 8; ++jj) {
    const int col = n0 + tile_col(jj);
    const bool colok = col < N;
    const float w0 = colok ? sw[col] : 0.f, w1 = colok ? sw[col + 1] : 0.f;
    const float b0 = colok ? bias[col] : 0.f, b1 = colok ? bias[col + 1] : 0.f;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = m0 + tile_row(hh);
      if (row >= M || !colok) continue;
      const size_t o = (size_t)row * N + col;
      const int i = 4 * jj + 2 * hh;
      float v0, v1;
      if constexpr (CHUNKED) {
        // the last chunk's partial lands on the residual and the earlier
        // chunks' sum in one fused multiply-add, as K4's single chunk does
        const float sr = sa[(size_t)row * chunks + chunks - 1];
        const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(rx + o);
        float s0 = __bfloat162float(xv.x), s1 = __bfloat162float(xv.y);
        if (chunks > 1) {
          s0 += facc[i];
          s1 += facc[i + 1];
        }
        v0 = __fmaf_rn((float)acc[i], sr * w0, s0) + b0;
        v1 = __fmaf_rn((float)acc[i + 1], sr * w1, s1) + b1;
      } else {
        const float sr =
            EPI == EPI_RESIDUAL ? div_rn_inline(fmaxf(sa[row], 1e-12f), 127.f) : sa[row];
        v0 = (float)acc[i] * (sr * w0);
        v1 = (float)acc[i + 1] * (sr * w1);
      }
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
      } else if (!CHUNKED) {
        v0 += b0;
        v1 += b1;
      }
      if (ACT) {
        v0 = activation<EPI>(v0);
        v1 = activation<EPI>(v1);
        rmax[hh] = fmaxf(rmax[hh], fmaxf(fabsf(v0), fabsf(v1)));
        *reinterpret_cast<float2*>(static_cast<float*>(Cout) + o) = make_float2(v0, v1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(Cout) + o) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }

  if (ACT) {
    // the four lanes of a quad hold one row's columns of the tile, which lies
    // in chunk n0 / ch
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float r = rmax[hh];
      r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 1));
      r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 2));
      const int row = m0 + tile_row(hh);
      if ((lane & 3) == 0 && row < M)
        atomicMax(reinterpret_cast<int*>(rowmax + (size_t)row * chunks + n0 / ch),
                  __float_as_int(r));
    }
  }
}

// the tile of each epilogue: 128 x 128, two blocks per SM, so that one
// block's epilogue (the dequantization, the GELU, the fp32 hidden's stores)
// runs beside the other's products (on the H100, K4 at 8416 rows 0.451
// against 0.505 ms at one block per SM of the same tiles, the same bits:
// tools/ab_gemm.py).  K15's chunked sums hold twice the accumulators: one
// block per SM.
template <int EPI>
using GemmTile = GemmSm90<int8_t, 128, EPI == EPI_RESIDUAL_CHUNKED ? 1 : 2>;

// ch = 0: the whole of N is one chunk (K2, K4)
template <int EPI>
cudaError_t launch_gemm(const int8_t* A, const int8_t* W, const float* sa, const float* sw,
                        const float* bias, void* C, float* rowmax, const bf16* rx,
                        const bf16* radd, int M, int N, int K, cudaStream_t stream, int ch = 0,
                        int chunks = 1) {
  using G = GemmTile<EPI>;
  CUtensorMap ta, tw;
  if (!encode_map_2d(&ta, A, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K, M, G::BM) ||
      !encode_map_2d(&tw, W, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K, N, G::BN))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(gemm_s8_kernel<EPI, G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + G::BN - 1) / G::BN, (M + G::BM - 1) / G::BM);
  gemm_s8_kernel<EPI, G><<<grid, G::THREADS, G::SMEM, stream>>>(
      ta, tw, sa, sw, bias, C, rowmax, rx, radd, M, N, K, ch > 0 ? ch : N, chunks);
  return cudaGetLastError();
}

template <bool RECIP = false>
cudaError_t launch_ln_quant(const bf16* x, const bf16* add, const bf16* mask, const float* g,
                            const float* b, int8_t* xq, float* sx, float* hmax, int T, int E,
                            float eps, cudaStream_t stream, int nh = 1) {
  ln_quant_rows_kernel<RECIP><<<(T + LN_ROWS - 1) / LN_ROWS, LN_ROWS * 32, 0, stream>>>(
      x, add, mask, g, b, xq, sx, hmax, nh, T, E, eps);
  return cudaGetLastError();
}

// K15's first GEMM, its activation chosen at run time
cudaError_t launch_gemm_act(int act, const int8_t* A, const int8_t* W, const float* sa,
                            const float* sw, const float* bias, float* C, float* rowmax, int M,
                            int N, int K, int ch, int chunks, cudaStream_t st) {
  switch (act) {
    case 0: return launch_gemm<EPI_GELU_POLY>(A, W, sa, sw, bias, C, rowmax, nullptr, nullptr, M,
                                              N, K, st, ch, chunks);
    case 1: return launch_gemm<EPI_GELU_ERF>(A, W, sa, sw, bias, C, rowmax, nullptr, nullptr, M,
                                             N, K, st, ch, chunks);
    case 2: return launch_gemm<EPI_SIGMOID>(A, W, sa, sw, bias, C, rowmax, nullptr, nullptr, M,
                                            N, K, st, ch, chunks);
    case 3: return launch_gemm<EPI_RELU>(A, W, sa, sw, bias, C, rowmax, nullptr, nullptr, M, N,
                                         K, st, ch, chunks);
    default: return cudaErrorInvalidValue;
  }
}

template <int RQ>
cudaError_t launch_quant_chunks(const float* h, const float* hmax, int8_t* hq, float* sh, int T,
                                int M, int ch, int chunks, cudaStream_t st) {
  const size_t total4 = (size_t)T * M / 4;
  quant_chunks_kernel<RQ><<<(unsigned)((total4 + 255) / 256), 256, 0, st>>>(h, hmax, hq, sh,
                                                                            total4, M, ch, chunks);
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
  err = launch_quant_chunks<RQ_DIV>(static_cast<const float*>(hidden), hm,
                                    static_cast<int8_t*>(hq), nullptr, T, M, M, 1, st);
  if (err != cudaSuccess) return err;
  return launch_gemm<EPI_RESIDUAL>(static_cast<const int8_t*>(hq),
                                   static_cast<const int8_t*>(w2q), hm,
                                   static_cast<const float*>(s2), static_cast<const float*>(b2),
                                   out, nullptr, xb, ab, T, E, M, st);
}

// Shapes: x (T, E) bf16, w1q (M, E), w2q (E, M) int8, s1, b1 (M,), s2, b2 (E,)
// fp32; scratch xq (T, E) int8, sx (T,) fp32, hidden (T, M) fp32, hmax and sh
// (T, chunks) fp32, hq (T, M) int8; out (T, E) bf16.
// act: 0 GELU poly, 1 GELU erf, 2 sigmoid, 3 relu; rq: 0 divide, 1 reciprocal
// (x's quantization and, without fixed_hscale, the hidden's); fixed_hscale:
// the hidden at the fixed scale 1/8.  E must be a multiple of 16, M of chunks
// and M / chunks of 128.
extern "C" int k15_ln_mlp_residual_int8_exp(const void* x, const void* gamma, const void* beta,
                                            const void* w1q, const void* s1, const void* b1,
                                            const void* w2q, const void* s2, const void* b2,
                                            void* xq, void* sx, void* hidden, void* hmax,
                                            void* sh, void* hq, void* out, int T, int E, int M,
                                            float eps, int chunks, int act, int rq,
                                            int fixed_hscale, void* stream) {
  if (E % 16 || chunks < 1 || M % chunks || (M / chunks) % 128 || rq < 0 || rq > 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ch = M / chunks;
  const bf16* xb = static_cast<const bf16*>(x);
  float* hm = static_cast<float*>(hmax);
  float* hf = static_cast<float*>(hidden);
  float* shf = static_cast<float*>(sh);
  int8_t* hqi = static_cast<int8_t*>(hq);
  cudaError_t err =
      rq == 1 ? launch_ln_quant<true>(xb, nullptr, nullptr, static_cast<const float*>(gamma),
                                      static_cast<const float*>(beta), static_cast<int8_t*>(xq),
                                      static_cast<float*>(sx), hm, T, E, eps, st, chunks)
              : launch_ln_quant<false>(xb, nullptr, nullptr, static_cast<const float*>(gamma),
                                       static_cast<const float*>(beta), static_cast<int8_t*>(xq),
                                       static_cast<float*>(sx), hm, T, E, eps, st, chunks);
  if (err != cudaSuccess) return err;
  err = launch_gemm_act(act, static_cast<const int8_t*>(xq), static_cast<const int8_t*>(w1q),
                        static_cast<const float*>(sx), static_cast<const float*>(s1),
                        static_cast<const float*>(b1), hf, hm, T, M, E, ch, chunks, st);
  if (err != cudaSuccess) return err;
  if (fixed_hscale)
    err = launch_quant_chunks<RQ_FIXED>(hf, hm, hqi, shf, T, M, ch, chunks, st);
  else if (rq == 1)
    err = launch_quant_chunks<RQ_RECIP>(hf, hm, hqi, shf, T, M, ch, chunks, st);
  else
    err = launch_quant_chunks<RQ_DIV>(hf, hm, hqi, shf, T, M, ch, chunks, st);
  if (err != cudaSuccess) return err;
  return launch_gemm<EPI_RESIDUAL_CHUNKED>(hqi, static_cast<const int8_t*>(w2q), shf,
                                           static_cast<const float*>(s2),
                                           static_cast<const float*>(b2), out, nullptr, xb,
                                           nullptr, T, E, M, st, ch, chunks);
}
