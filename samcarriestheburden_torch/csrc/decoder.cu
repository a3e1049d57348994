// D1: the SAM mask decoder's image-to-token branch in one fp32 kernel, on sm_90a.
//
// Replaces no TPU kernel: the JAX package leaves this branch to XLA
// (samcarriestheburden_tpu/models/transformer.py, the image-to-token step of
// block_apply and block_apply_image_shared).  It fuses what
// models/transformer.py:TwoWayAttentionBlock ran as nine passes over the
// (B, HW, 256) image side: keys + key_pe, the q projection, the logits, their
// softmax, the product with v, the merge of the heads, the out projection,
// the residual and norm4's LayerNorm.  For image row x of image i and each of
// the G items b = i * G + g that share it:
//    q     = x . Wq^T + peq[hw]                       peq = pe . Wq^T + b_q
//    o_h   = softmax(q_h . (k_b,h / 4)^T) . v_b,h      8 heads of 16, k, v (Nq, 128)
//    out_b = LayerNorm(x + (o . Wout^T + b_out))       eps, fp32 statistics
// where k_b = k_proj(queries_b + query_pe_b) and v_b = v_proj(queries_b) are
// the item's Nq token keys and values (kernels/decoder.py computes them, and
// the (HW, 128) table peq, with plain PyTorch).  Every product is an IEEE
// fp32 fma: no TF32, no bf16.  Only the order of the sums, and q's split into
// x . Wq^T + peq, differ from the unfused branch.
//
// What bounds it on the card: 2 * 256 * 128 * 2 operations a row for the two
// projections (131 kflop, 146 GFLOP at 272 x 4096 rows), against 2 KB of row
// read and written: fp32 fma (67 TFLOP/s) bounds it, far above the memory's
// 0.7 ms.  So the design is a register-tiled SIMT product with everything
// between the two projections kept on chip:
//   * a block owns BM = 64 image rows and G_b of the items sharing them; 256
//     threads, two blocks an SM.  It reads each row once by the caller's
//     strides (row-contiguous or round 2's channel-major view of src, no copy)
//     into a k-major staging tile, and computes q once for all its items;
//   * the products are 8 x 4 (q) and 8 x 8 (out) outer products a thread and
//     k step, operands in shared memory, Wq^T and Wout^T streamed from L2 in
//     chunks of KC rows by cp.async, double-buffered;
//   * q and the attention's output live in k-major (128, BM) tiles whose
//     4-float row units are XOR-swizzled by their k, so the q stores, the
//     attention's per-row reads and writes and the out product's broadcast
//     reads are all free of bank conflicts;
//   * the attention runs one thread per (row, head) pair, two pairs a thread,
//     in two passes over the Nq tokens (the row's max, then exp, sum and
//     p . v), as Attention._attend's fp32 softmax does;
//   * the epilogue adds the bias and the residual (the image row, re-read
//     from L2, shared by the G items with no repeat), takes the row's mean and
//     variance across the 32 threads that hold it (shuffles, then one shared
//     sum across the two warps of a row), and writes the row once.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int C = 256;          // the decoder's width: one image-side row
constexpr int D = 128;          // the attention's internal width (C / 2)
constexpr int HD = 16;          // head size (8 heads)
constexpr int BM = 64;          // image rows a block
constexpr int KC = 8;           // weight rows a staged chunk
constexpr int THREADS = 256;
// shared memory, in floats: q and o tiles, the staging ring, the LayerNorm sums
constexpr int TILE = D * BM;
constexpr int STAGE = (2 * KC * (BM + D) > 2 * KC * C) ? 2 * KC * (BM + D) : 2 * KC * C;
constexpr int RED = 2 * 2 * BM;
constexpr int FIXED = 2 * TILE + STAGE + RED;

// Index of (k, r) in a k-major (rows, BM) tile: row r's 4-float unit XORed
// with k's unit, so four consecutive r stay one aligned float4.
__device__ __forceinline__ int swz(int k, int r) {
  return k * BM + ((((r >> 2) ^ (k >> 2)) & 15) << 2) + (r & 3);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// MODE 0: channels contiguous (x[.., hw, c] at hw * sxr + c); 1: rows
// contiguous (channel-major, hw + c * sxc).  Both 16-byte aligned, strides
// multiples of 4 (kernels/decoder.py checks).
template <int MODE>
__device__ __forceinline__ void load_x_chunk(const float* __restrict__ xb, long long sxr,
                                             long long sxc, int hw0, int k0, int t,
                                             float (&r)[2]) {
  if (MODE == 1) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(
        xb + (long long)(k0 + (t >> 5)) * sxc + hw0 + (t & 31) * 2));
    r[0] = v.x;
    r[1] = v.y;
  } else {
    const float2 v = __ldg(reinterpret_cast<const float2*>(
        xb + (long long)(hw0 + (t >> 2)) * sxr + k0 + (t & 3) * 2));
    r[0] = v.x;
    r[1] = v.y;
  }
}

template <int MODE>
__device__ __forceinline__ void store_x_chunk(float* xs, int t, const float (&r)[2]) {
  if (MODE == 1) {
    const int kk = t >> 5, m = (t & 31) * 2;
    *reinterpret_cast<float2*>(xs + swz(kk, m)) = make_float2(r[0], r[1]);
  } else {
    const int m = t >> 2, kk = (t & 3) * 2;
    xs[swz(kk, m)] = r[0];
    xs[swz(kk + 1, m)] = r[1];
  }
}

// acc[i][j] = x + (acc[i][j] + b_out[j]) for the residual rows hw..hw+7 at
// columns c0..c0+3 (j < 4) and c0+64..c0+67, read one row (MODE 0) or one
// column (MODE 1) at a time so that no second 8 x 8 tile is live.
template <int MODE>
__device__ __forceinline__ void add_residual(const float* __restrict__ xb, long long sxr,
                                             long long sxc, int hw, int c0,
                                             const float (&bb)[8], float (&acc)[8][8]) {
  if (MODE == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float* p = xb + (long long)(hw + i) * sxr + c0;
      const float4 a = ldg4(p), b = ldg4(p + 64);
      const float r[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = r[j] + (acc[i][j] + bb[j]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float* p = xb + (long long)(c0 + (j & 3) + (j >> 2) * 64) * sxc + hw;
      const float4 a = ldg4(p), b = ldg4(p + 4);
      const float r[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i][j] = r[i] + (acc[i][j] + bb[j]);
    }
  }
}

// Grid (HW / BM, n_img * nsplit); block (img, split) owns rows
// [blockIdx.x * BM, +BM) of image img and items g in [split * gpb, +gpb) of G.
template <int MODE>
__global__ void __launch_bounds__(THREADS, 2)
d1_kernel(const float* __restrict__ x, long long sxb, long long sxr, long long sxc,
          const float* __restrict__ peq, const float* __restrict__ wqT,
          const float* __restrict__ kt, const float* __restrict__ vt,
          const float* __restrict__ woT, const float* __restrict__ bo,
          const float* __restrict__ gamma, const float* __restrict__ beta, float eps,
          float* __restrict__ out, int G, int gpb, int nsplit, int hw_total, int nq) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                     // (D, BM) swizzled: q
  float* os = qs + TILE;                // (D, BM) swizzled: the heads' outputs
  float* stage = os + TILE;             // weight (and x) chunks, double-buffered
  float* red = stage + STAGE;           // (2 stats, 2 column halves, BM)
  float* ks = red + RED;                // (nq, D): the item's keys / 4
  float* vs = ks + nq * D;              // (nq, D): its values

  const int t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;
  const int wr = warp & 3, wc = warp >> 2;
  const int lr = lane >> 4, lc = lane & 15;
  const int r0 = wr * 16 + lr * 8;      // the thread's 8 rows in the products
  const int img = blockIdx.y / nsplit;
  const int g_begin = (blockIdx.y % nsplit) * gpb;
  const int g_end = min(G, g_begin + gpb);
  const int hw0 = blockIdx.x * BM;
  const float* xb = x + (long long)img * sxb;

  // ---- q = x . Wq^T + peq (BM x D, K = C) -------------------------------
  {
    const int n0 = wc * 64 + lc * 4;
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    float xr[2];
    auto w_chunk = [&](int ck, int buf) {
      float* ws = stage + buf * KC * (BM + D) + KC * BM;
      cp_async16(ws + (t >> 5) * D + (t & 31) * 4,
                 wqT + (long long)(ck * KC + (t >> 5)) * D + (t & 31) * 4, 16);
      cp_async_commit();
    };
    load_x_chunk<MODE>(xb, sxr, sxc, hw0, 0, t, xr);
    w_chunk(0, 0);
    store_x_chunk<MODE>(stage, t, xr);
    cp_async_wait<0>();
    __syncthreads();
    constexpr int NCH = C / KC;
    for (int ck = 0; ck < NCH; ++ck) {
      const int buf = ck & 1;
      if (ck + 1 < NCH) {
        w_chunk(ck + 1, buf ^ 1);
        load_x_chunk<MODE>(xb, sxr, sxc, hw0, (ck + 1) * KC, t, xr);
      }
      const float* xs = stage + buf * KC * (BM + D);
      const float* ws = xs + KC * BM;
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        const float4 a0 = ld4(xs + swz(kk, r0)), a1 = ld4(xs + swz(kk, r0 + 4));
        const float4 b = ld4(ws + kk * D + n0);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
      }
      if (ck + 1 < NCH) store_x_chunk<MODE>(stage + (buf ^ 1) * KC * (BM + D), t, xr);
      cp_async_wait<0>();
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 p = ldg4(peq + (long long)(hw0 + r0 + i) * D + n0);
      acc[i][0] += p.x; acc[i][1] += p.y; acc[i][2] += p.z; acc[i][3] += p.w;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(qs + swz(n0 + j, r0)) =
          make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
      *reinterpret_cast<float4*>(qs + swz(n0 + j, r0 + 4)) =
          make_float4(acc[4][j], acc[5][j], acc[6][j], acc[7][j]);
    }
  }
  __syncthreads();

  const int c0 = wc * 128 + lc * 4;     // the thread's columns: c0 + 0..3, c0 + 64..67
  for (int g = g_begin; g < g_end; ++g) {
    const long long item = (long long)img * G + g;
    // ---- the item's tokens, and the first Wout^T chunk ------------------
    auto wo_chunk = [&](int ck, int buf) {
      float* wos = stage + buf * KC * C;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int idx = t + u * THREADS;
        cp_async16(wos + (idx >> 6) * C + (idx & 63) * 4,
                   woT + (long long)(ck * KC + (idx >> 6)) * C + (idx & 63) * 4, 16);
      }
      cp_async_commit();
    };
    wo_chunk(0, 0);
    {
      const float* kb = kt + item * nq * D;
      const float* vb = vt + item * nq * D;
      for (int i = t * 4; i < nq * D; i += THREADS * 4) {
        const float4 k4 = ldg4(kb + i);
        *reinterpret_cast<float4*>(ks + i) =
            make_float4(k4.x * 0.25f, k4.y * 0.25f, k4.z * 0.25f, k4.w * 0.25f);
        *reinterpret_cast<float4*>(vs + i) = ldg4(vb + i);
      }
    }
    __syncthreads();

    // ---- attention: thread = (row, two heads) ---------------------------
    {
      const int row = t & (BM - 1);
#pragma unroll 1
      for (int hh = 0; hh < 2; ++hh) {
        const int h = (t >> 6) * 2 + hh;
        float q[HD], o[HD];
#pragma unroll
        for (int d = 0; d < HD; ++d) q[d] = qs[swz(h * HD + d, row)];
        float m = -INFINITY;
        for (int tk = 0; tk < nq; ++tk) {
          const float* kp = ks + tk * D + h * HD;
          float s = 0.f;
#pragma unroll
          for (int d4 = 0; d4 < HD; d4 += 4) {
            const float4 k4 = ld4(kp + d4);
            s = fmaf(q[d4], k4.x, s);
            s = fmaf(q[d4 + 1], k4.y, s);
            s = fmaf(q[d4 + 2], k4.z, s);
            s = fmaf(q[d4 + 3], k4.w, s);
          }
          m = fmaxf(m, s);
        }
        float l = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) o[d] = 0.f;
        for (int tk = 0; tk < nq; ++tk) {
          const float* kp = ks + tk * D + h * HD;
          const float* vp = vs + tk * D + h * HD;
          float s = 0.f;
#pragma unroll
          for (int d4 = 0; d4 < HD; d4 += 4) {
            const float4 k4 = ld4(kp + d4);
            s = fmaf(q[d4], k4.x, s);
            s = fmaf(q[d4 + 1], k4.y, s);
            s = fmaf(q[d4 + 2], k4.z, s);
            s = fmaf(q[d4 + 3], k4.w, s);
          }
          const float p = expf(s - m);
          l += p;
#pragma unroll
          for (int d4 = 0; d4 < HD; d4 += 4) {
            const float4 v4 = ld4(vp + d4);
            o[d4] = fmaf(p, v4.x, o[d4]);
            o[d4 + 1] = fmaf(p, v4.y, o[d4 + 1]);
            o[d4 + 2] = fmaf(p, v4.z, o[d4 + 2]);
            o[d4 + 3] = fmaf(p, v4.w, o[d4 + 3]);
          }
        }
#pragma unroll
        for (int d = 0; d < HD; ++d) os[swz(h * HD + d, row)] = o[d] / l;
      }
    }
    cp_async_wait<0>();
    __syncthreads();

    // ---- out = o . Wout^T (BM x C, K = D) --------------------------------
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    constexpr int NCH2 = D / KC;
    for (int ck = 0; ck < NCH2; ++ck) {
      const int buf = ck & 1;
      if (ck + 1 < NCH2) wo_chunk(ck + 1, buf ^ 1);
      const float* wos = stage + buf * KC * C;
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        const int k = ck * KC + kk;
        const float4 a0 = ld4(os + swz(k, r0)), a1 = ld4(os + swz(k, r0 + 4));
        const float4 b0 = ld4(wos + kk * C + c0), b1 = ld4(wos + kk * C + c0 + 64);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      cp_async_wait<0>();
      __syncthreads();
    }

    // ---- residual, LayerNorm, one write of the row -----------------------
    {
      const float4 bo0 = ldg4(bo + c0), bo1 = ldg4(bo + c0 + 64);
      const float bb[8] = {bo0.x, bo0.y, bo0.z, bo0.w, bo1.x, bo1.y, bo1.z, bo1.w};
      add_residual<MODE>(xb, sxr, sxc, hw0 + r0, c0, bb, acc);
      float sum[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        sum[i] = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) sum[i] += acc[i][j];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int s = 1; s < 16; s <<= 1) sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], s);
        if (lc == 0) red[wc * BM + r0 + i] = sum[i];
      }
      __syncthreads();
      float mean[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        mean[i] = (red[r0 + i] + red[BM + r0 + i]) * (1.f / C);
        sum[i] = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[i][j] -= mean[i];
          sum[i] = fmaf(acc[i][j], acc[i][j], sum[i]);
        }
#pragma unroll
        for (int s = 1; s < 16; s <<= 1) sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], s);
        if (lc == 0) red[2 * BM + wc * BM + r0 + i] = sum[i];
      }
      __syncthreads();
      const float4 ga0 = ldg4(gamma + c0), ga1 = ldg4(gamma + c0 + 64);
      const float4 be0 = ldg4(beta + c0), be1 = ldg4(beta + c0 + 64);
      const float ga[8] = {ga0.x, ga0.y, ga0.z, ga0.w, ga1.x, ga1.y, ga1.z, ga1.w};
      const float be[8] = {be0.x, be0.y, be0.z, be0.w, be1.x, be1.y, be1.z, be1.w};
      float* ob = out + (item * hw_total + hw0 + r0) * C + c0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float var = (red[2 * BM + r0 + i] + red[3 * BM + r0 + i]) * (1.f / C);
        const float rstd = rsqrtf(var + eps);
        float y[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) y[j] = fmaf(acc[i][j] * rstd, ga[j], be[j]);
        *reinterpret_cast<float4*>(ob + i * C) = make_float4(y[0], y[1], y[2], y[3]);
        *reinterpret_cast<float4*>(ob + i * C + 64) = make_float4(y[4], y[5], y[6], y[7]);
      }
    }
  }
}

template <int MODE>
int launch(const float* x, long long sxb, long long sxr, long long sxc, const float* peq,
           const float* wqT, const float* kt, const float* vt, const float* woT,
           const float* bo, const float* gamma, const float* beta, float eps, float* out,
           int n_img, int G, int gpb, int hw, int nq, cudaStream_t stream) {
  const int smem = (FIXED + 2 * nq * D) * (int)sizeof(float);
  const int nsplit = (G + gpb - 1) / gpb;
  if ((long long)n_img * nsplit > 65535) return cudaErrorInvalidValue;   // grid y
  cudaError_t err =
      cudaFuncSetAttribute(d1_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  d1_kernel<MODE><<<dim3(hw / BM, n_img * nsplit), THREADS, smem, stream>>>(
      x, sxb, sxr, sxc, peq, wqT, kt, vt, woT, bo, gamma, beta, eps, out, G, gpb, nsplit, hw,
      nq);
  return cudaGetLastError();
}

}  // namespace

// The largest Nq whose tokens fit beside the fixed tiles in 227 KB.
extern "C" int d1_max_tokens() {
  return (232448 / (int)sizeof(float) - FIXED) / (2 * D);
}

// x: image rows (n_img, hw, 256) by element strides sxb, sxr, sxc, with
// sxc == 1 or sxr == 1 and the others multiples of 4; peq (hw, 128); wqT
// (256, 128); kt, vt (n_img * G, nq, 128); woT (128, 256); bo, gamma, beta
// (256,); out (n_img * G, hw, 256) contiguous.  hw a multiple of 64; every
// pointer 16-byte aligned.  gpb: items a block (1..G).
extern "C" int d1_image_to_token(const void* x, long long sxb, long long sxr, long long sxc,
                                 const void* peq, const void* wqT, const void* kt,
                                 const void* vt, const void* woT, const void* bo,
                                 const void* gamma, const void* beta, float eps, void* out,
                                 int n_img, int G, int gpb, int hw, int nq, void* stream) {
  const bool rows = sxc == 1 && sxr % 4 == 0, channels = sxr == 1 && sxc % 4 == 0;
  if (n_img < 1 || G < 1 || gpb < 1 || gpb > G || hw < BM || hw % BM || nq < 1
      || nq > d1_max_tokens() || !(rows || channels) || sxb % 4
      || reinterpret_cast<uintptr_t>(x) % 16)
    return cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows)
    return launch<0>(xf, sxb, sxr, sxc, f(peq), f(wqT), f(kt), f(vt), f(woT), f(bo), f(gamma),
                     f(beta), eps, o, n_img, G, gpb, hw, nq, s);
  return launch<1>(xf, sxb, sxr, sxc, f(peq), f(wqT), f(kt), f(vt), f(woT), f(bo), f(gamma),
                   f(beta), eps, o, n_img, G, gpb, hw, nq, s);
}
