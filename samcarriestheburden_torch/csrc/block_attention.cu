// K12: a whole windowed attention of SAM's ViT encoder in one launch, on sm_90a.
//
// K12 replaces samcarriestheburden_tpu/kernels/attention.py:fused_window_block_attention
// (body _block_attn_kernel).  Input xn (nwin, n, E) holds LayerNormed,
// pad-masked window tokens, n = WS * WS.  Per window and head h:
//    q, k, v = bf16(xn . W_h^T + b_h)            W_h: the head's 3 * HD rows of the
//                                                per-head-grouped qkv weight (3E, E)
//    rel_h[i, kh] = bf16(q_i . Rh[ph - kh + WS - 1] / scale)      (same for w)
//    logit[i, j]  = scale * (q_i . k_j + rel_h[i, kh(j)] + rel_w[i, kw(j)])
//    o_h          = bf16(softmax_j(logit) . v)
//    out         += o_h . Wp_h^T                 Wp_h: columns h*HD.. of proj_w (E, E)
// and out = bf16(sum over heads), every product and the sum in fp32.  The
// attention is K5's (csrc/attention.cu) on q, k, v that never leave shared
// memory.  The TPU body keeps q and k in fp32 up to the logits and rounds its
// output after every head, because its grid walks the heads in order; the
// tensor cores take bf16 operands, and blocks run in no order, so here q and
// k are rounded once and the sum over heads is rounded once.  Its expanded
// tables and mask-and-select products were a TPU device for the table gather
// and are not carried over: the stacked [Rh; Rw] tables are indexed as in K5.
//
// What bounds it: 2 * n * E * 4 * E operations per window for the two
// projections (~2.6 GFLOP at n = 196, E = 1280) on 0.5 MB of tokens in and out,
// far above the card's ~295 ops/byte ridge: the tensor cores bound it.
//
// Design.  One block of 13 warps per (window, head); warp w owns rows
// 16w..16w+15 of the window throughout, so q fragments, the online softmax and
// the attention output stay in its registers.
//   A. three products (q, k, v) of 208 x HD x E: xn and the head's weight rows
//      stream through a three-stage cp.async ring in 32-wide k-tiles, as in
//      csrc/mlp.cu (a window's 490 KB of tokens fit no shared memory); the
//      results go to shared memory in bf16.  xn is read once per product from
//      L2; a single pass over all 3 * HD columns would need 120 accumulator
//      registers per thread at 416 threads.
//   B. K5's rel terms and flash loop over the resident keys.
//   C. the normalised output becomes A fragments as the probabilities do in
//      B, and is multiplied against 64-column tiles of Wp_h streamed through a
//      two-stage ring.
// The sum over heads: a (196, 1280) fp32 accumulator is 1 MB and fits no SM,
// and nothing carries over between blocks, so each block stores its share
// o_h . Wp_h^T into a slice of its own of an fp32 scratch (heads, nwin, n, E)
// in device memory, and a second small kernel sums the heads in the order
// 0 .. H-1 in fp32 and rounds once to bf16, as the plain version does: the
// output is the same on every call.  Chosen over recomputing the attention
// per output tile (ten times the projection work, which is most of the
// kernel) and, as the simpler version, over a cluster reduction through
// distributed shared memory (eight blocks of two heads each would add their
// partial sums one column tile at a time in a fixed order without the
// scratch, the next step for this kernel).  The scratch's cost: H times the
// output in fp32 written once and read once (0.8 GB at 50 ViT-H windows).
#include <math.h>

#include "common.cuh"

namespace {

constexpr int NW = 13, NTHREADS = NW * 32, BQ = NW * 16;  // 208 rows: one window
constexpr int BKV = 64;      // keys per attention tile; output columns per projection tile
constexpr int KROWS = 256;   // key rows in shared memory: whole tiles
constexpr int BK = 32, STAGES = 3, LDS = BK + 8;  // the qkv products' k-tiles

template <int HD>
constexpr size_t ring_elems() {
  constexpr size_t gemm = (size_t)STAGES * (BQ + HD) * LDS, proj = (size_t)2 * BKV * (HD + 8);
  return gemm > proj ? gemm : proj;
}

template <int HD>
constexpr size_t smem_bytes(int ws) {
  return ((size_t)(BQ + 2 * KROWS) * (HD + 8) + (size_t)BQ * 2 * ws + ring_elems<HD>()) *
         sizeof(bf16);
}

template <int HD>
__global__ void __launch_bounds__(NTHREADS)
block_attention_kernel(const bf16* __restrict__ xn, const bf16* __restrict__ wqkv,
                       const float* __restrict__ bqkv, const bf16* __restrict__ wp,
                       const bf16* __restrict__ tab, float* __restrict__ acc, int n, int E,
                       int WS, float scale, float inv_scale) {
  constexpr int LD = HD + 8, KSTEPS = HD / 16, DT = HD / 8, CH = HD / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // [BQ][LD]
  bf16* sK = sQ + BQ * LD;                   // [KROWS][LD]
  bf16* sV = sK + KROWS * LD;                // [KROWS][LD]
  bf16* sRel = sV + KROWS * LD;              // [BQ][2 * WS]
  bf16* ring = sRel + BQ * 2 * WS;           // k-tiles, then the tables, then Wp tiles

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h = blockIdx.x, w = blockIdx.y;
  const bf16* xw = xn + (size_t)w * n * E;

  // key rows beyond the block's 208 belong to the last tile: zero, so that a
  // zero weight times them is zero
  for (int c = tid; c < (KROWS - BQ) * LD; c += NTHREADS) {
    sK[BQ * LD + c] = __float2bfloat16(0.f);
    sV[BQ * LD + c] = __float2bfloat16(0.f);
  }

  // A. q, k, v = bf16(xn . W^T + b), one product each; rows >= n are zero
  //    tokens, whose projection is the bias (dead rows, never keys)
  bf16* sA = ring;                      // [STAGES][BQ][LDS]
  bf16* sB = ring + STAGES * BQ * LDS;  // [STAGES][HD][LDS]
  const int KT = (E + BK - 1) / BK;
  for (int part = 0; part < 3; ++part) {
    const bf16* Wh = wqkv + (size_t)(h * 3 + part) * HD * E;
    const float* bh = bqkv + (h * 3 + part) * HD;
    bf16* dst = part == 0 ? sQ : (part == 1 ? sK : sV);

    auto load_stage = [&](int stage, int kt) {
      for (int c = tid; c < BQ * (BK / 8); c += NTHREADS) {
        const int r = c >> 2, kc = (c & 3) * 8, gk = kt * BK + kc;
        const bool ok = r < n && gk < E;
        cp_async16(sA + (stage * BQ + r) * LDS + kc, ok ? xw + (size_t)r * E + gk : xw,
                   ok ? 16 : 0);
      }
      for (int c = tid; c < HD * (BK / 8); c += NTHREADS) {
        const int r = c >> 2, kc = (c & 3) * 8, gk = kt * BK + kc;
        const bool ok = gk < E;
        cp_async16(sB + (stage * HD + r) * LDS + kc, ok ? Wh + (size_t)r * E + gk : Wh,
                   ok ? 16 : 0);
      }
    };

    float cf[DT][4];
#pragma unroll
    for (int d = 0; d < DT; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) cf[d][e] = 0.f;

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
      const bf16* a_s = sA + (kt % STAGES) * BQ * LDS;
      const bf16* b_s = sB + (kt % STAGES) * HD * LDS;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t af[4];
        ldmatrix_x4(af, a_s + (warp * 16 + (lane & 15)) * LDS + kk + (lane >> 4) * 8);
#pragma unroll
        for (int nj = 0; nj < HD / 16; ++nj) {
          uint32_t r[4];
          ldmatrix_x4(r, b_s + (nj * 16 + (lane & 7) + (lane >> 4) * 8) * LDS + kk +
                             ((lane >> 3) & 1) * 8);
          mma_bf16(cf[2 * nj], af, r[0], r[1]);
          mma_bf16(cf[2 * nj + 1], af, r[2], r[3]);
        }
      }
    }
    cp_async_wait<0>();
    const int row = warp * 16 + (lane >> 2);
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      const int col = d * 8 + (lane & 3) * 2;
      const float b0 = bh[col], b1 = bh[col + 1];
      *reinterpret_cast<__nv_bfloat162*>(dst + row * LD + col) =
          __floats2bfloat162_rn(cf[d][0] + b0, cf[d][1] + b1);
      *reinterpret_cast<__nv_bfloat162*>(dst + (row + 8) * LD + col) =
          __floats2bfloat162_rn(cf[d][2] + b0, cf[d][3] + b1);
    }
    __syncthreads();  // the ring is free for the next product; dst is whole
  }

  // B. K5's attention on the resident q, k, v.  The stacked tables [Rh; Rw]
  //    take the ring's place first.
  const int RH = 2 * WS - 1, NT = 2 * RH, NTP = (NT + 15) / 16 * 16, KR = 2 * WS;
  bf16* sT = ring;
  for (int c = tid; c < NTP * CH; c += NTHREADS) {
    const int r = c / CH, cc = (c % CH) * 8;
    const bool ok = r < NT;
    cp_async16(sT + r * LD + cc, ok ? tab + (size_t)r * HD + cc : tab, ok ? 16 : 0);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // each thread holds two query rows of its warp's 16: rl[0] and rl[0] + 8
  int rl[2], ph[2], pw[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rl[i] = warp * 16 + (lane >> 2) + i * 8;
    ph[i] = min(rl[i] / WS, WS - 1);  // dead rows clamp, as K5's do
    pw[i] = rl[i] % WS;
  }
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
    ldmatrix_x4(qf[kk], sQ + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);

  // rel terms: g = q . table_row, scattered to the (row, kh) and (row, WS + kw)
  // entries each table row serves for this query
  for (int np = 0; np < NTP / 16; ++np) {
    float g[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t r[4];
      ldmatrix_x4(r, sT + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                         ((lane >> 3) & 1) * 8);
      mma_bf16(g[0], qf[kk], r[0], r[1]);
      mma_bf16(g[1], qf[kk], r[2], r[3]);
    }
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int r = np * 16 + t * 8 + (lane & 3) * 2 + (e & 1);
        int slot = -1;
        if (r < RH) {
          const int k = ph[i] + WS - 1 - r;
          if (k >= 0 && k < WS) slot = k;
        } else if (r < NT) {
          const int k = pw[i] + WS - 1 - (r - RH);
          if (k >= 0 && k < WS) slot = WS + k;
        }
        if (slot >= 0) sRel[rl[i] * KR + slot] = __float2bfloat16(g[t][e] * inv_scale);
      }
  }
  __syncthreads();  // sRel is whole; the tables' space becomes the Wp ring

  const bf16* wph = wp + h * HD;  // Wp_h[col][d] = wp[col * E + h * HD + d]
  float* part = acc + ((size_t)h * gridDim.y + w) * n * E;  // this block's (n, E) slice
  const int NCT = (E + BKV - 1) / BKV;
  auto load_wp = [&](int stage, int t) {
    for (int c = tid; c < BKV * CH; c += NTHREADS) {
      const int r = c / CH, cc = (c % CH) * 8;
      const int col = t * BKV + r;
      const bool ok = col < E;
      cp_async16(ring + (stage * BKV + r) * LD + cc, ok ? wph + (size_t)col * E + cc : wph,
                 ok ? 16 : 0);
    }
  };
  load_wp(0, 0);  // in flight during the attention
  cp_async_commit();

  float o[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  constexpr float LOG2E = 1.4426950408889634f;
  const float inv_ws = 1.f / WS;
  const bf16* rel0 = sRel + rl[0] * KR;
  const bf16* rel1 = sRel + rl[1] * KR;
  const int NKT = (n + BKV - 1) / BKV;

  for (int kt = 0; kt < NKT; ++kt) {
    const bf16* sKt = sK + kt * BKV * LD;
    const bf16* sVt = sV + kt * BKV * LD;
    float sc[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[t][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t r[4];
        ldmatrix_x4(r, sKt + (nj * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                           ((lane >> 3) & 1) * 8);
        mma_bf16(sc[2 * nj], qf[kk], r[0], r[1]);
        mma_bf16(sc[2 * nj + 1], qf[kk], r[2], r[3]);
      }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = kt * BKV + t * 8 + (lane & 3) * 2 + (e & 1);
        float v = -INFINITY;
        if (j < n) {
          const int kh = __float2int_rz((j + 0.5f) * inv_ws);
          const int kw = j - kh * WS;
          const bf16* rel = (e >> 1) ? rel1 : rel0;
          v = (sc[t][e] + __bfloat162float(rel[kh]) + __bfloat162float(rel[WS + kw])) * scale;
        }
        sc[t][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    float alpha[2], ls[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float mn = fmaxf(m[i], mx[i]);  // finite: key 0 is always live
      alpha[i] = exp2f((m[i] - mn) * LOG2E);
      m[i] = mn;
    }
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f((sc[t][e] - m[e >> 1]) * LOG2E);
        sc[t][e] = p;
        ls[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + ls[i];
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      o[d][0] *= alpha[0];
      o[d][1] *= alpha[0];
      o[d][2] *= alpha[1];
      o[d][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t a[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                       pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                       pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                       pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < HD / 16; ++dn) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, sVt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + dn * 16 +
                                 (lane >> 4) * 8);
        mma_bf16(o[2 * dn], a, r[0], r[1]);
        mma_bf16(o[2 * dn + 1], a, r[2], r[3]);
      }
    }
  }

  // C. o_h = bf16(o / l) as A fragments, times Wp_h in 64-column tiles, stored
  //    into the block's slice of the fp32 scratch
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = 1.f / l[i];
  }
  uint32_t of[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    of[kk][0] = pack_bf16(o[2 * kk][0] * inv[0], o[2 * kk][1] * inv[0]);
    of[kk][1] = pack_bf16(o[2 * kk][2] * inv[1], o[2 * kk][3] * inv[1]);
    of[kk][2] = pack_bf16(o[2 * kk + 1][0] * inv[0], o[2 * kk + 1][1] * inv[0]);
    of[kk][3] = pack_bf16(o[2 * kk + 1][2] * inv[1], o[2 * kk + 1][3] * inv[1]);
  }

  for (int t = 0; t < NCT; ++t) {
    if (t + 1 < NCT) load_wp((t + 1) & 1, t + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* sW = ring + (t & 1) * BKV * LD;
    float sc[8][4];
#pragma unroll
    for (int tt = 0; tt < 8; ++tt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[tt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t r[4];
        ldmatrix_x4(r, sW + (nj * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                           ((lane >> 3) & 1) * 8);
        mma_bf16(sc[2 * nj], of[kk], r[0], r[1]);
        mma_bf16(sc[2 * nj + 1], of[kk], r[2], r[3]);
      }
#pragma unroll
    for (int tt = 0; tt < 8; ++tt) {
      const int col = t * BKV + tt * 8 + (lane & 3) * 2;
      if (col >= E) continue;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (rl[i] >= n) continue;
        *reinterpret_cast<float2*>(part + (size_t)rl[i] * E + col) =
            make_float2(sc[tt][2 * i], sc[tt][2 * i + 1]);
      }
    }
    __syncthreads();  // this stage is reloaded two tiles on
  }
}

// out = bf16(acc[0] + acc[1] + ... + acc[heads - 1]), summed in fp32 in that
// order, four values per thread; count4 values of four per head.
__global__ void __launch_bounds__(256)
round_kernel(const float* __restrict__ acc, bf16* __restrict__ out, size_t count4, int heads) {
  const size_t i = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (i >= count4) return;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int h = 0; h < heads; ++h) {
    const float4 p = reinterpret_cast<const float4*>(acc)[h * count4 + i];
    v.x += p.x;
    v.y += p.y;
    v.z += p.z;
    v.w += p.w;
  }
  __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(out) + 2 * i;
  dst[0] = __floats2bfloat162_rn(v.x, v.y);
  dst[1] = __floats2bfloat162_rn(v.z, v.w);
}

template <int HD>
cudaError_t launch(const bf16* xn, const bf16* wqkv, const float* bqkv, const bf16* wp,
                   const bf16* tab, float* acc, bf16* out, int nwin, int n, int E, int heads,
                   int ws, float scale, float inv_scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>(ws);
  cudaError_t err = cudaFuncSetAttribute(block_attention_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  block_attention_kernel<HD><<<dim3(heads, nwin), NTHREADS, smem, stream>>>(
      xn, wqkv, bqkv, wp, tab, acc, n, E, ws, scale, inv_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t count4 = (size_t)nwin * n * E / 4;
  round_kernel<<<(unsigned)((count4 + 255) / 256), 256, 0, stream>>>(acc, out, count4, heads);
  return cudaGetLastError();
}

}  // namespace

// xn, out (nwin, n, E) bf16 with n = ws * ws <= 208; wqkv (heads*3*hd, E) bf16
// and bqkv (heads*3*hd) fp32 grouped per head ([q | k | v] rows of each head
// together); wp (E, E) bf16, the projection as nn.Linear holds it; tab
// (2 * (2*ws-1), hd) bf16 rows [Rh; Rw]; scratch acc (heads, nwin, n, E) fp32.
// E = heads * hd, a multiple of 8; hd in {16, 32, 64, 80}.
extern "C" int k12_window_block_attention(const void* xn, const void* wqkv, const void* bqkv,
                                          const void* wp, const void* tab, void* acc, void* out,
                                          int nwin, int n, int E, int heads, int ws, float scale,
                                          float inv_scale, void* stream) {
  if (heads < 1 || E % heads || E % 8 || n != ws * ws || n < 1 || n > BQ || nwin < 1)
    return cudaErrorInvalidValue;
  const bf16* x = static_cast<const bf16*>(xn);
  const bf16* wq = static_cast<const bf16*>(wqkv);
  const float* bq = static_cast<const float*>(bqkv);
  const bf16* w = static_cast<const bf16*>(wp);
  const bf16* t = static_cast<const bf16*>(tab);
  float* a = static_cast<float*>(acc);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (E / heads) {
    case 16: return launch<16>(x, wq, bq, w, t, a, o, nwin, n, E, heads, ws, scale, inv_scale, s);
    case 32: return launch<32>(x, wq, bq, w, t, a, o, nwin, n, E, heads, ws, scale, inv_scale, s);
    case 64: return launch<64>(x, wq, bq, w, t, a, o, nwin, n, E, heads, ws, scale, inv_scale, s);
    case 80: return launch<80>(x, wq, bq, w, t, a, o, nwin, n, E, heads, ws, scale, inv_scale, s);
    default: return cudaErrorInvalidValue;
  }
}
