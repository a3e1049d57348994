// K5 and K7: attention with the decomposed relative-position bias of SAM's
// ViT encoder, bf16 on sm_90a.
//
// K5 replaces samcarriestheburden_tpu/kernels/attention.py:fused_rel_attention_window3d
//    (one 14x14 window per sequence, 200 slots of which 196 are live keys),
// K7 replaces samcarriestheburden_tpu/kernels/attention.py:fused_rel_attention_global3d
//    with int8_qk=False (the whole 64x64 grid, 4096 keys).
// Both compute, per sequence s, head h and query i at grid cell (ph, pw):
//    rel_h[i, kh] = bf16(q_i . Rh[ph - kh + KH - 1] / scale)      (same for w)
//    logit[i, j] = scale * (q_i . k_j + rel_h[i, kh(j)] + rel_w[i, kw(j)])
//    out_i       = softmax_j(logit) . v
// over the live keys j < nkeys (dead slots get no weight).  The bf16
// rounding of the rel terms at 1/scale is the TPU kernel's own.  Input qkv is
// (nseq, nrows, heads * 3 * HD) with each head's [q | k | v] columns side by
// side (the port's per-head grouping); output is token-major
// (nseq, nrows, heads, HD), ready for the output projection.
//
// What bounds them on the card: K7 does 2 x 4096 x 4096 x 80 x 2 operations
// per (image, head) on 1.3 MB of q/k/v, so tensor-core throughput bounds it.
// K5's 14x14 windows do ~110 operations per byte of qkv read and output
// written, below the card's ~295 ops/byte ridge, so memory bounds it: each
// window's q/k/v must be read once.  The design is a flash-attention loop on
// mma.sync: a block owns NW x 16 query rows of one (sequence, head), keeps
// its q fragments in registers, streams 64-key K/V tiles through a two-stage
// cp.async ring and keeps an online softmax, so no logit row ever leaves the
// registers (a 4096-wide fp32 row per query would not fit in shared memory).
// The rel-pos terms are one small product of q against the packed tables at
// block start, scattered to a per-row (KH + KW)-entry table in shared memory;
// the TPU kernel's lane rolls and reversed key index were a TPU layout device
// and are not carried over.
// K5 runs 13 warps so one block holds all 200 rows of a window and reads its
// q/k/v once; K7 runs 8 warps per 128-row query tile.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int BKV = 64;  // keys per tile

template <int HD, int NW>
constexpr size_t attn_smem_bytes(int kh, int kw) {
  return (size_t)(NW * 16 * (HD + 8) + 4 * BKV * (HD + 8) + NW * 16 * (kh + kw)) * sizeof(bf16);
}

template <int HD, int NW>
__global__ void __launch_bounds__(NW * 32)
rel_attention_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ tab,
                     bf16* __restrict__ out, int nrows, int nkeys, int heads, int KH, int KW,
                     float scale, float inv_scale) {
  constexpr int BQ = NW * 16, LD = HD + 8, KSTEPS = HD / 16, DT = HD / 8, CH = HD / 8;
  constexpr int NTHREADS = NW * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // [BQ][LD]
  bf16* sKV = sQ + BQ * LD;                  // [2 stages][K | V][BKV][LD]; tables first
  bf16* sRel = sKV + 4 * BKV * LD;           // [BQ][KH + KW]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, s = blockIdx.z;
  const int stride = heads * 3 * HD;
  const bf16* base = qkv + (size_t)s * nrows * stride + h * 3 * HD;
  const int RH = 2 * KH - 1, NT = RH + 2 * KW - 1, NTP = (NT + 15) / 16 * 16;
  const int KR = KH + KW;

  // 1. this block's q rows and the stacked rel tables [Rh; Rw] into shared memory
  for (int c = tid; c < BQ * CH; c += NTHREADS) {
    const int r = c / CH, cc = (c % CH) * 8;
    const bool ok = q0 + r < nrows;
    cp_async16(sQ + r * LD + cc, ok ? base + (size_t)(q0 + r) * stride + cc : base, ok ? 16 : 0);
  }
  for (int c = tid; c < NTP * CH; c += NTHREADS) {
    const int r = c / CH, cc = (c % CH) * 8;
    const bool ok = r < NT;
    cp_async16(sKV + r * LD + cc, ok ? tab + (size_t)r * HD + cc : tab, ok ? 16 : 0);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // each thread holds two query rows of its warp's 16: rl[0] and rl[0] + 8
  int rl[2], ph[2], pw[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rl[i] = warp * 16 + (lane >> 2) + i * 8;
    const int t = q0 + rl[i];
    ph[i] = min(t / KW, KH - 1);  // dead slots clamp, as the reference does
    pw[i] = t % KW;
  }
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
    ldmatrix_x4(qf[kk], sQ + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);

  // 2. rel terms: g = q . table_row, scattered to the (row, kh) and
  //    (row, KH + kw) entries each table row serves for this query
  for (int np = 0; np < NTP / 16; ++np) {
    float g[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t r[4];
      ldmatrix_x4(r, sKV + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
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
          const int k = ph[i] + KH - 1 - r;
          if (k >= 0 && k < KH) slot = k;
        } else if (r < NT) {
          const int k = pw[i] + KW - 1 - (r - RH);
          if (k >= 0 && k < KW) slot = KH + k;
        }
        if (slot >= 0) sRel[rl[i] * KR + slot] = __float2bfloat16(g[t][e] * inv_scale);
      }
  }
  __syncthreads();  // the tables' space becomes the K/V ring

  // 3. flash loop over 64-key tiles
  const int NKT = (nkeys + BKV - 1) / BKV;
  auto load_kv = [&](int stage, int kt) {
    bf16* sK = sKV + stage * 2 * BKV * LD;
    bf16* sV = sK + BKV * LD;
    for (int c = tid; c < BKV * CH; c += NTHREADS) {
      const int r = c / CH, cc = (c % CH) * 8;
      const int j = kt * BKV + r;
      const bool ok = j < nkeys;
      const bf16* src = base + (size_t)j * stride + cc;
      cp_async16(sK + r * LD + cc, ok ? src + HD : base, ok ? 16 : 0);
      cp_async16(sV + r * LD + cc, ok ? src + 2 * HD : base, ok ? 16 : 0);
    }
  };

  float o[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  constexpr float LOG2E = 1.4426950408889634f;
  const float inv_kw = 1.f / KW;
  const bf16* rel0 = sRel + rl[0] * KR;
  const bf16* rel1 = sRel + rl[1] * KR;

  load_kv(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < NKT; ++kt) {
    if (kt + 1 < NKT) load_kv((kt + 1) & 1, kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* sK = sKV + (kt & 1) * 2 * BKV * LD;
    const bf16* sV = sK + BKV * LD;

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
        ldmatrix_x4(r, sK + (nj * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
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
        if (j < nkeys) {
          const int kh = __float2int_rz((j + 0.5f) * inv_kw);
          const int kw = j - kh * KW;
          const bf16* rel = (e >> 1) ? rel1 : rel0;
          v = (sc[t][e] + __bfloat162float(rel[kh]) + __bfloat162float(rel[KH + kw])) * scale;
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
        ldmatrix_x4_trans(r, sV + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + dn * 16 +
                                 (lane >> 4) * 8);
        mma_bf16(o[2 * dn], a, r[0], r[1]);
        mma_bf16(o[2 * dn + 1], a, r[2], r[3]);
      }
    }
    __syncthreads();  // this stage is reloaded two tiles on
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + rl[i];
    if (row >= nrows) continue;
    const float inv = 1.f / l[i];
    bf16* dst = out + ((size_t)(s * nrows + row) * heads + h) * HD + (lane & 3) * 2;
#pragma unroll
    for (int d = 0; d < DT; ++d)
      *reinterpret_cast<__nv_bfloat162*>(dst + d * 8) =
          __floats2bfloat162_rn(o[d][2 * i] * inv, o[d][2 * i + 1] * inv);
  }
}

template <int HD, int NW>
cudaError_t launch(const bf16* qkv, const bf16* tab, bf16* out, int nseq, int nrows, int nkeys,
                   int heads, int kh, int kw, float scale, float inv_scale, cudaStream_t stream) {
  const int nt = 2 * kh - 1 + 2 * kw - 1;
  if ((nt + 15) / 16 * 16 > 4 * BKV || nkeys < 1 || nkeys > nrows) return cudaErrorInvalidValue;
  const size_t smem = attn_smem_bytes<HD, NW>(kh, kw);
  cudaError_t err = cudaFuncSetAttribute(rel_attention_kernel<HD, NW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((nrows + NW * 16 - 1) / (NW * 16), heads, nseq);
  rel_attention_kernel<HD, NW><<<grid, NW * 32, smem, stream>>>(qkv, tab, out, nrows, nkeys, heads,
                                                                kh, kw, scale, inv_scale);
  return cudaGetLastError();
}

template <int NW>
int dispatch(int hd, const void* qkv, const void* tab, void* out, int nseq, int nrows, int nkeys,
             int heads, int kh, int kw, float scale, float inv_scale, void* stream) {
  const bf16* q = static_cast<const bf16*>(qkv);
  const bf16* t = static_cast<const bf16*>(tab);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16, NW>(q, t, o, nseq, nrows, nkeys, heads, kh, kw, scale, inv_scale, s);
    case 32: return launch<32, NW>(q, t, o, nseq, nrows, nkeys, heads, kh, kw, scale, inv_scale, s);
    case 64: return launch<64, NW>(q, t, o, nseq, nrows, nkeys, heads, kh, kw, scale, inv_scale, s);
    case 80: return launch<80, NW>(q, t, o, nseq, nrows, nkeys, heads, kh, kw, scale, inv_scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// qkv (nseq, nrows, heads*3*hd) bf16; tab (2*kh-1 + 2*kw-1, hd) bf16 rows [Rh; Rw];
// out (nseq, nrows, heads, hd) bf16.  hd in {16, 32, 64, 80}.
extern "C" int k5_rel_attention_window(const void* qkv, const void* tab, void* out, int nseq,
                                       int nrows, int nkeys, int heads, int hd, int ws,
                                       float scale, float inv_scale, void* stream) {
  return dispatch<13>(hd, qkv, tab, out, nseq, nrows, nkeys, heads, ws, ws, scale, inv_scale,
                      stream);
}

extern "C" int k7_rel_attention_global(const void* qkv, const void* tab, void* out, int nseq,
                                       int nrows, int heads, int hd, int kh, int kw, float scale,
                                       float inv_scale, void* stream) {
  return dispatch<8>(hd, qkv, tab, out, nseq, nrows, nrows, heads, kh, kw, scale, inv_scale,
                     stream);
}
