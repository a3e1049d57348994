// rel_attention_kernel, the mma.sync kernel of K7's int8 p . v pair (K7-pv,
// K7-int8pv), and what the attention kernels share: the softmax forms and rel
// modes, the padded per-row rel table, the operands of a launch, and K7-int8's
// and K7-pv's pre-passes (column absmax, int8 keys and values).  Included by
// global_attention.cuh (K7, K7-int8, K9 on the grid, K11, K16 v1 and v3 on the
// grid), which window_attention.cuh (K5, K6, K9 on windows, K10, K16 on
// windows) includes in turn.  The design of the int8 p . v pair is
// attention.cu's.
#pragma once

#include <math.h>

#include "common.cuh"

namespace {

constexpr int BKV = 64;  // keys per tile

// The softmax forms (SM) and rel terms (REL) of the attention experiment tools
// (K16; the other instances run SM_ONLINE with REL_FULL), as the global and
// window kernels take them.  With m and l the row's final max and sum:
//   SM_ONLINE  1 / l after p . v (the flash loop's online softmax; the tools' v2)
//   SM_V1      p = bf16(exp(logit - m) / l) before p . v
//   SM_V3      p = bf16(exp(bf16(logit - m))), l = sum of those p, 1 / l after p . v
//   SM_NOEXP   p = logit - m in place of exp, 1 / l after p . v; the dead slots
//              (nkeys <= j < nrows) take part with logit -1e30 and their v rows
//   REL_NONE   no rel term; REL_BASE0 every query's rel term at cell (0, 0).
enum : int { SM_ONLINE = 0, SM_V1 = 1, SM_V3 = 3, SM_NOEXP = 4 };
enum : int { REL_FULL = 0, REL_NONE = 1, REL_BASE0 = 2 };

// The row stride, in bf16, of the per-row rel table sRel (kh + kw entries):
// 4 x an odd number of 4-byte words.  The eight rows a warp's lanes hold then
// start in eight distinct groups of four banks, so a rel-term load, in which
// a quad's four lanes read one word (rh) or four consecutive words (rw) of
// their row, is free of bank conflicts on every grid.  (An odd word stride
// would leave the rw loads two-way conflicted: rows that start one bank
// apart overlap in their four words.)
__host__ __device__ constexpr int rel_stride(int kr) {
  return 2 * (((kr + 1) / 2 + 3) / 8 * 8 + 4);
}

constexpr int PV_NW = 8;  // warps of rel_attention_kernel: 128 query rows


// four int8 values in one register, the first in the low byte
__device__ __forceinline__ uint32_t pack_s8(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | ((uint32_t)(b & 0xff) << 8) | ((uint32_t)(c & 0xff) << 16) |
         ((uint32_t)(d & 0xff) << 24);
}

// int8 keys: hd padded to the 32-wide k-step, rows padded by 16 bytes so the
// eight 16-byte rows of an ldmatrix tile fall in distinct banks
__host__ __device__ constexpr int padded_hd(int hd) { return (hd + 31) / 32 * 32; }

// the int8 v tiles of K7-pv: HD channel rows of BKV keys, padded by 16 bytes
constexpr int LDV8 = BKV + 16;

// q rows, four 64-key tiles (the tables, then the K/V ring), the per-row rel
// table; int8 q . k adds the int8 q rows and the row and key-channel scales;
// int8 p . v the value-channel scales
template <int HD, bool INT8>
constexpr size_t attn_smem_total(int kh, int kw) {
  return (size_t)(PV_NW * 16 * (HD + 8) + 4 * BKV * (HD + 8) +
                  PV_NW * 16 * rel_stride(kh + kw)) * sizeof(bf16) +
         (INT8 ? PV_NW * 16 * (padded_hd(HD) + 16) + (PV_NW * 16 + HD) * sizeof(float) : 0) +
         HD * sizeof(float);
}

// kmax[s, h, c] = max_j |x[s, j, h, col + c]| of the keys (col = HD) or values
// (col = 2 HD), folded in with atomicMax (kmax zeroed before).
template <int HD>
__global__ void __launch_bounds__(HD * 4)
k_absmax_kernel(const bf16* __restrict__ qkv, float* __restrict__ kmax, int nrows, int heads,
                int rows_per_block, int col) {
  constexpr int CH = HD / 8;
  __shared__ float sm[32][HD];
  const int tid = threadIdx.x, cc = tid % CH, r0 = tid / CH;
  const int h = blockIdx.y, s = blockIdx.z;
  const int stride = heads * 3 * HD;
  const bf16* base = qkv + (size_t)s * nrows * stride + h * 3 * HD + col + cc * 8;
  const int j0 = blockIdx.x * rows_per_block, j1 = min(j0 + rows_per_block, nrows);
  float m[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) m[e] = 0.f;
  for (int j = j0 + r0; j < j1; j += 32) {
    const uint4 raw = *reinterpret_cast<const uint4*>(base + (size_t)j * stride);
    const bf16* v = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int e = 0; e < 8; ++e) m[e] = fmaxf(m[e], fabsf(__bfloat162float(v[e])));
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) sm[r0][cc * 8 + e] = m[e];
  __syncthreads();
  if (tid < HD) {
    float r = 0.f;
    for (int i = 0; i < 32; ++i) r = fmaxf(r, sm[i][tid]);
    atomicMax(reinterpret_cast<int*>(kmax + (size_t)(s * heads + h) * HD + tid),
              __float_as_int(r));
  }
}

// kq[s, h, j, :] = rint(k[s, j, h, :] / sk) as int8, zero beyond HD.
template <int HD>
__global__ void __launch_bounds__(256)
k_quant_kernel(const bf16* __restrict__ qkv, const float* __restrict__ kmax,
               int8_t* __restrict__ kq, int nrows, int heads) {
  constexpr int CH = HD / 8, HDP = padded_hd(HD), CHP = HDP / 8;
  const int c = blockIdx.x * 256 + threadIdx.x;
  if (c >= nrows * CHP) return;
  const int j = c / CHP, cc = c % CHP;
  const int h = blockIdx.y, s = blockIdx.z;
  uint32_t w[2] = {0u, 0u};
  if (cc < CH) {
    const int stride = heads * 3 * HD;
    const uint4 raw = *reinterpret_cast<const uint4*>(
        qkv + ((size_t)s * nrows + j) * stride + h * 3 * HD + HD + cc * 8);
    const bf16* v = reinterpret_cast<const bf16*>(&raw);
    const float* km = kmax + (size_t)(s * heads + h) * HD + cc * 8;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float sk = km[e] / 127.f + 1e-12f;
      const int q = __float2int_rn(__bfloat162float(v[e]) / sk);
      w[e >> 2] |= (uint32_t)(q & 0xff) << (8 * (e & 3));
    }
  }
  *reinterpret_cast<uint2*>(kq + ((size_t)(s * heads + h) * nrows + j) * HDP + cc * 8) =
      make_uint2(w[0], w[1]);
}

// The key of position kp in its 32-key chunk of vq: a thread's four int8
// probabilities of one row sit at positions 4q..4q+3 (and 16 + 4q..), and its
// score fragments hold keys 2q, 2q+1 of two consecutive 8-key tiles.
__device__ __forceinline__ int pv_key(int kp) {
  const int half = kp >> 4, r = kp & 15, q = r >> 2, e = r & 3;
  return half * 16 + (e >> 1) * 8 + 2 * q + (e & 1);
}

// vq[s, h, c, kp] = rint(v[s, key(kp), h, c] / sv[c]) as int8, zero for keys >=
// nrows; one block per 64-key tile, its v rows staged in shared memory so that
// both the loads and the channel-major stores are coalesced.
template <int HD>
__global__ void __launch_bounds__(256)
v_quant_kernel(const bf16* __restrict__ qkv, const float* __restrict__ vmax,
               int8_t* __restrict__ vq, int nrows, int nkp, int heads) {
  constexpr int CH = HD / 8;
  __shared__ __align__(16) bf16 tile[BKV][HD + 8];
  __shared__ float inv[HD];
  const int tid = threadIdx.x, h = blockIdx.y, s = blockIdx.z, j0 = blockIdx.x * BKV;
  const int stride = heads * 3 * HD;
  for (int c = tid; c < BKV * CH; c += 256) {
    const int r = c / CH, cc = (c % CH) * 8;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (j0 + r < nrows)
      raw = *reinterpret_cast<const uint4*>(qkv + ((size_t)s * nrows + j0 + r) * stride +
                                            h * 3 * HD + 2 * HD + cc);
    *reinterpret_cast<uint4*>(&tile[r][cc]) = raw;
  }
  for (int c = tid; c < HD; c += 256)
    inv[c] = vmax[(size_t)(s * heads + h) * HD + c] / 127.f + 1e-12f;
  __syncthreads();
  int8_t* dst = vq + (size_t)(s * heads + h) * HD * nkp + j0;
  for (int w = tid; w < HD * (BKV / 4); w += 256) {
    const int c = w / (BKV / 4), kp0 = (w % (BKV / 4)) * 4;
    uint32_t word = 0u;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kp = kp0 + e;
      const int r = (kp & ~31) + pv_key(kp & 31);
      const int q = __float2int_rn(__bfloat162float(tile[r][c]) / inv[c]);
      word |= (uint32_t)(q & 0xff) << (8 * e);
    }
    *reinterpret_cast<uint32_t*>(dst + (size_t)c * nkp + kp0) = word;
  }
}

// K7-pv (INT8 false) and K7-int8pv (INT8 true) over a KH x KW grid, every
// row a key.  q, k, v point at row 0 of (sequence 0, head 0); a row is
// `stride` elements from the next, a head `head_stride`, a sequence
// `seq_stride`.  p . v runs in int8 over vq (nseq, heads, HD, nkp) with the
// value scales vmax; with INT8 q . k too, over kq and kmax.  Two passes over
// the keys: pass 0 the row max and sum (the online softmax), pass 1 the
// normalised int8 probabilities and their product with vq.
template <int HD, bool INT8>
__global__ void __launch_bounds__(PV_NW * 32)
rel_attention_kernel(const bf16* __restrict__ qp, const bf16* __restrict__ kp, int stride,
                     size_t seq_stride, int head_stride, const bf16* __restrict__ tab,
                     const int8_t* __restrict__ kq, const float* __restrict__ kmax,
                     const int8_t* __restrict__ vq, const float* __restrict__ vmax,
                     bf16* __restrict__ out, int nrows, int heads, int KH, int KW, float scale,
                     float inv_scale) {
  constexpr int BQ = PV_NW * 16, LD = HD + 8, KSTEPS = HD / 16, DT = HD / 8, CH = HD / 8;
  constexpr int HDP = padded_hd(HD), LDK = HDP + 16, KSTEPS8 = HDP / 32, CHK = HDP / 16;
  constexpr int NTHREADS = PV_NW * 32;
  // the ring's stage: a K tile (bf16, or int8 rows) and an int8 V tile of
  // channel rows
  constexpr int K_BYTES = INT8 ? BKV * LDK : BKV * LD * 2;
  constexpr int STAGE_BYTES = K_BYTES + HD * LDV8;
  static_assert(2 * STAGE_BYTES <= 4 * BKV * LD * 2, "the ring outgrows the tables' space");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // [BQ][LD]
  bf16* sKV = sQ + BQ * LD;                  // [2 stages][K | V][..]; tables first
  const int SR = rel_stride(KH + KW);
  bf16* sRel = sKV + 4 * BKV * LD;           // [BQ][SR]: KH + KW entries a row
  int8_t* sQi = reinterpret_cast<int8_t*>(sRel + BQ * SR);  // [BQ][LDK]    (INT8)
  float* sSq = reinterpret_cast<float*>(sQi + (INT8 ? BQ * LDK : 0));  // [BQ] row scales
  float* sSk = sSq + (INT8 ? BQ : 0);       // [HD] key channel scales    (INT8)
  float* sSv = sSk + (INT8 ? HD : 0);       // [HD] value dequant scales

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, s = blockIdx.z;
  const size_t seq_off = (size_t)s * seq_stride + (size_t)h * head_stride;
  const bf16* qb = qp + seq_off;
  const bf16* kb = kp + seq_off;
  const int RH = 2 * KH - 1, NT = RH + 2 * KW - 1, NTP = (NT + 15) / 16 * 16;

  // 1. this block's q rows and the stacked rel tables [Rh; Rw] into shared memory
  for (int c = tid; c < BQ * CH; c += NTHREADS) {
    const int r = c / CH, cc = (c % CH) * 8;
    const bool ok = q0 + r < nrows;
    cp_async16(sQ + r * LD + cc, ok ? qb + (size_t)(q0 + r) * stride + cc : qb, ok ? 16 : 0);
  }
  for (int c = tid; c < NTP * CH; c += NTHREADS) {
    const int r = c / CH, cc = (c % CH) * 8;
    const bool ok = r < NT;
    cp_async16(sKV + r * LD + cc, ok ? tab + (size_t)r * HD + cc : tab, ok ? 16 : 0);
  }
  cp_async_commit();
  if (INT8)
    for (int c = tid; c < HD; c += NTHREADS)
      sSk[c] = kmax[(size_t)(s * heads + h) * HD + c] / 127.f + 1e-12f;
  for (int c = tid; c < HD; c += NTHREADS)
    sSv[c] = (vmax[(size_t)(s * heads + h) * HD + c] / 127.f + 1e-12f) / 127.f;
  cp_async_wait<0>();
  __syncthreads();

  // each thread holds two query rows of its warp's 16: rl[0] and rl[0] + 8
  int rl[2], ph[2], pw[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rl[i] = warp * 16 + (lane >> 2) + i * 8;
    const int t = q0 + rl[i];
    ph[i] = min(t / KW, KH - 1);  // dead rows clamp, as the reference does
    pw[i] = t % KW;
  }
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
    ldmatrix_x4(qf[kk], sQ + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);

  // int8: fold the key channel scales into q, quantize each of this warp's
  // rows by its own absmax, and take the int8 fragments
  uint32_t qf8[KSTEPS8][4];
  float sq[2] = {0.f, 0.f};
  if (INT8) {
    for (int r = 0; r < 16; ++r) {
      const int row = warp * 16 + r;
      float qs[KSTEPS8];
      float amax = 0.f;
#pragma unroll
      for (int i = 0; i < KSTEPS8; ++i) {
        const int c = lane + 32 * i;
        qs[i] = c < HD ? __bfloat162float(sQ[row * LD + c]) * sSk[c] : 0.f;
        amax = fmaxf(amax, fabsf(qs[i]));
      }
      const float sr = warp_max(amax) / 127.f + 1e-12f;
#pragma unroll
      for (int i = 0; i < KSTEPS8; ++i)
        sQi[row * LDK + lane + 32 * i] = (int8_t)__float2int_rn(qs[i] / sr);
      if (lane == 0) sSq[row] = sr;
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < KSTEPS8; ++kk)
      ldmatrix_x4(qf8[kk], sQi + (warp * 16 + (lane & 15)) * LDK + kk * 32 + (lane >> 4) * 16);
    sq[0] = sSq[rl[0]];
    sq[1] = sSq[rl[1]];
  }

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
        if (slot >= 0) sRel[rl[i] * SR + slot] = __float2bfloat16(g[t][e] * inv_scale);
      }
  }
  __syncthreads();  // the tables' space becomes the K/V ring

  // 3. two passes over 64-key tiles: pass 0 takes each row's max and sum,
  //    pass 1 the int8 p . v product
  const int NKT = (nrows + BKV - 1) / BKV;
  const int nkp = NKT * BKV;
  unsigned char* ring = reinterpret_cast<unsigned char*>(sKV);
  const int8_t* kq_base = INT8 ? kq + (size_t)(s * heads + h) * nrows * HDP : nullptr;
  const int8_t* vq_base = vq + (size_t)(s * heads + h) * HD * nkp;
  auto stage_k = [&](int stage) { return ring + stage * STAGE_BYTES; };
  auto load_kv = [&](int stage, int kt, bool with_v) {
    if (!INT8) {
      bf16* sK = reinterpret_cast<bf16*>(stage_k(stage));
      for (int c = tid; c < BKV * CH; c += NTHREADS) {
        const int r = c / CH, cc = (c % CH) * 8;
        const int j = kt * BKV + r;
        const bool ok = j < nrows;
        cp_async16(sK + r * LD + cc, ok ? kb + (size_t)j * stride + cc : kb, ok ? 16 : 0);
      }
    } else {
      for (int c = tid; c < BKV * CHK; c += NTHREADS) {
        const int r = c / CHK, cc = (c % CHK) * 16;
        const int j = kt * BKV + r;
        const bool ok = j < nrows;
        cp_async16(stage_k(stage) + r * LDK + cc, ok ? kq_base + (size_t)j * HDP + cc : kq_base,
                   ok ? 16 : 0);
      }
    }
    if (with_v)
      for (int c = tid; c < HD * (BKV / 16); c += NTHREADS) {
        const int r = c / (BKV / 16), cc = (c % (BKV / 16)) * 16;
        cp_async16(stage_k(stage) + K_BYTES + r * LDV8 + cc,
                   vq_base + (size_t)r * nkp + kt * BKV + cc, 16);
      }
  };

  int acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, linv[2] = {0.f, 0.f};
  constexpr float LOG2E = 1.4426950408889634f;
  const float inv_qw = 1.f / KW;
  const bf16* rel0 = sRel + rl[0] * SR;
  const bf16* rel1 = sRel + rl[1] * SR;
  // a 64-key tile that is one grid row (KW % 64 == 0) has one kh: its rh is
  // one load per row per tile, and kw needs no division
  const bool row_tiles = KW % BKV == 0;

  for (int pass = 0; pass < 2; ++pass) {
    const bool stats = pass == 0;  // the row max and sum, no product
    load_kv(0, 0, !stats);
    cp_async_commit();
    for (int kt = 0; kt < NKT; ++kt) {
      if (kt + 1 < NKT) load_kv((kt + 1) & 1, kt + 1, !stats);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const bf16* sK = reinterpret_cast<const bf16*>(stage_k(kt & 1));

      float sc[8][4];
      if (INT8) {
        const unsigned char* sK8 = stage_k(kt & 1);
        int si[8][4];
#pragma unroll
        for (int t = 0; t < 8; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) si[t][e] = 0;
#pragma unroll
        for (int kk = 0; kk < KSTEPS8; ++kk)
#pragma unroll
          for (int nj = 0; nj < 4; ++nj) {
            uint32_t r[4];
            ldmatrix_x4(r, sK8 + (nj * 16 + (lane & 7) + (lane >> 4) * 8) * LDK + kk * 32 +
                               ((lane >> 3) & 1) * 16);
            mma_s8(si[2 * nj], qf8[kk], r[0], r[1]);
            mma_s8(si[2 * nj + 1], qf8[kk], r[2], r[3]);
          }
#pragma unroll
        for (int t = 0; t < 8; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[t][e] = (float)si[t][e];  // * sq below, fused
      } else {
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
      }

      const int kh_t = row_tiles ? kt * BKV / KW : 0;
      const int kw_t = kt * BKV - kh_t * KW;
      float rh_t[2] = {0.f, 0.f};
      if (row_tiles) {
        rh_t[0] = __bfloat162float(rel0[kh_t]);
        rh_t[1] = __bfloat162float(rel1[kh_t]);
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = t * 8 + (lane & 3) * 2 + (e & 1);
          const int j = kt * BKV + c;
          float v = -INFINITY;
          if (j < nrows) {
            const bf16* rel = (e >> 1) ? rel1 : rel0;
            float rh, rw;
            if (row_tiles) {
              rh = rh_t[e >> 1];
              rw = __bfloat162float(rel[KH + kw_t + c]);
            } else {
              const int kh = __float2int_rz((j + 0.5f) * inv_qw);
              const int kw = j - kh * KW;
              rh = __bfloat162float(rel[kh]);
              rw = __bfloat162float(rel[KH + kw]);
            }
            // int8: the row scale and the rel terms in one fused multiply-add
            v = INT8 ? __fmaf_rn(sc[t][e], sq[e >> 1], rh + rw) * scale
                     : (sc[t][e] + rh + rw) * scale;
          }
          sc[t][e] = v;
          mx[e >> 1] = fmaxf(mx[e >> 1], v);
        }

      if (!stats) {
        // the normalised probabilities at the fixed scale 127, four keys of a
        // row per A register (the order vq's chunks were written in)
        int pq[8][4];
#pragma unroll
        for (int t = 0; t < 8; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            pq[t][e] = __float2int_rn(exp2f((sc[t][e] - m[e >> 1]) * LOG2E) * linv[e >> 1] * 127.f);
        const unsigned char* sV8 = stage_k(kt & 1) + K_BYTES;
#pragma unroll
        for (int kk = 0; kk < BKV / 32; ++kk) {
          const int t = 4 * kk;
          const uint32_t a[4] = {pack_s8(pq[t][0], pq[t][1], pq[t + 1][0], pq[t + 1][1]),
                                 pack_s8(pq[t][2], pq[t][3], pq[t + 1][2], pq[t + 1][3]),
                                 pack_s8(pq[t + 2][0], pq[t + 2][1], pq[t + 3][0], pq[t + 3][1]),
                                 pack_s8(pq[t + 2][2], pq[t + 2][3], pq[t + 3][2], pq[t + 3][3])};
#pragma unroll
          for (int nj = 0; nj < HD / 16; ++nj) {
            uint32_t r[4];
            ldmatrix_x4(r, sV8 + (nj * 16 + (lane & 7) + (lane >> 4) * 8) * LDV8 + kk * 32 +
                               ((lane >> 3) & 1) * 16);
            mma_s8(acc[2 * nj], a, r[0], r[1]);
            mma_s8(acc[2 * nj + 1], a, r[2], r[3]);
          }
        }
      } else {  // the online softmax: running max, rescaled sum
        float ls[2] = {0.f, 0.f}, alpha[2];
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
          for (int e = 0; e < 4; ++e) ls[e >> 1] += exp2f((sc[t][e] - m[e >> 1]) * LOG2E);
#pragma unroll
        for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + ls[i];
      }
      __syncthreads();  // this stage is reloaded two tiles on
    }
    if (stats)  // the rows' sums, whole, before the first product
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        linv[i] = 1.f / l[i];
      }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + rl[i];
    if (row >= nrows) continue;
    bf16* dst = out + ((size_t)(s * nrows + row) * heads + h) * HD + (lane & 3) * 2;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      const int c = d * 8 + (lane & 3) * 2;
      *reinterpret_cast<__nv_bfloat162*>(dst + d * 8) = __floats2bfloat162_rn(
          (float)acc[d][2 * i] * sSv[c], (float)acc[d][2 * i + 1] * sSv[c + 1]);
    }
  }
}

// What a launch of the attention kernels reads: q, k, v with their strides
// (in elements), the rel-pos tables (tab) or the caller's rel terms (rel_h,
// rel_w: K9-K11), the int8 path's scratch (kq (nseq, heads, nrows, padded hd)
// int8 and kmax (nseq, heads, hd) fp32; null for bf16), the int8 p . v scratch
// (vq (nseq, heads, hd, keys padded to 64) int8 and vmax (nseq, heads, hd)
// fp32; null otherwise) and the qkv bias of K6's pad cells (null otherwise).
struct Operands {
  const bf16 *q, *k, *v;
  int stride;
  size_t seq_stride;
  int head_stride;
  const bf16 *tab, *rel_h, *rel_w;
  int8_t* kq;
  float* kmax;
  int8_t* vq;
  float* vmax;
  const float* bias;
};

// The head-grouped layout of K5-K7, K10 and K11: (nseq, nrows, heads * 3 * hd).
Operands grouped(const void* qkv, int nrows, int heads, int hd) {
  const bf16* q = static_cast<const bf16*>(qkv);
  Operands op = {};
  op.q = q;
  op.k = q + hd;
  op.v = q + 2 * hd;
  op.stride = heads * 3 * hd;
  op.seq_stride = (size_t)nrows * op.stride;
  op.head_stride = 3 * hd;
  return op;
}

// kmax (nseq, heads, HD) <- the column absmax of the keys (col = HD) or values
// (col = 2 HD) of a grouped qkv.
template <int HD>
cudaError_t column_absmax(const bf16* qkv, float* kmax, int nseq, int nrows, int heads, int col,
                          cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(kmax, 0, (size_t)nseq * heads * HD * sizeof(float), stream);
  if (err != cudaSuccess) return err;
  const int rows_per_block = 256;
  k_absmax_kernel<HD><<<dim3((nrows + rows_per_block - 1) / rows_per_block, heads, nseq), HD * 4,
                        0, stream>>>(qkv, kmax, nrows, heads, rows_per_block, col);
  return cudaGetLastError();
}

// K7-pv and K7-int8pv (INT8) on a kh x kw grid of nrows = kh * kw tokens.
template <int HD, bool INT8>
cudaError_t launch_pv(const Operands& op, bf16* out, int nseq, int nrows, int heads, int kh,
                      int kw, float scale, float inv_scale, cudaStream_t stream) {
  const int nt = 2 * kh - 1 + 2 * kw - 1;
  if ((nt + 15) / 16 * 16 > 4 * BKV || nrows < 1 || nrows != kh * kw || op.tab == nullptr ||
      op.vq == nullptr || op.vmax == nullptr || (INT8 && (op.kq == nullptr || op.kmax == nullptr)))
    return cudaErrorInvalidValue;
  cudaError_t err;
  if (INT8) {
    err = column_absmax<HD>(op.q, op.kmax, nseq, nrows, heads, HD, stream);
    if (err != cudaSuccess) return err;
    const int chunks = nrows * (padded_hd(HD) / 8);
    k_quant_kernel<HD><<<dim3((chunks + 255) / 256, heads, nseq), 256, 0, stream>>>(
        op.q, op.kmax, op.kq, nrows, heads);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  err = column_absmax<HD>(op.q, op.vmax, nseq, nrows, heads, 2 * HD, stream);
  if (err != cudaSuccess) return err;
  const int tiles = (nrows + BKV - 1) / BKV;
  v_quant_kernel<HD><<<dim3(tiles, heads, nseq), 256, 0, stream>>>(op.q, op.vmax, op.vq, nrows,
                                                                  tiles * BKV, heads);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = attn_smem_total<HD, INT8>(kh, kw);
  err = cudaFuncSetAttribute(rel_attention_kernel<HD, INT8>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((nrows + PV_NW * 16 - 1) / (PV_NW * 16), heads, nseq);
  rel_attention_kernel<HD, INT8><<<grid, PV_NW * 32, smem, stream>>>(
      op.q, op.k, op.stride, op.seq_stride, op.head_stride, op.tab, op.kq, op.kmax, op.vq,
      op.vmax, out, nrows, heads, kh, kw, scale, inv_scale);
  return cudaGetLastError();
}

template <bool INT8>
int dispatch_pv(int hd, const Operands& op, void* out, int nseq, int nrows, int heads, int kh,
                int kw, float scale, float inv_scale, void* stream) {
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return launch_pv<16, INT8>(op, o, nseq, nrows, heads, kh, kw, scale, inv_scale, s);
    case 32:
      return launch_pv<32, INT8>(op, o, nseq, nrows, heads, kh, kw, scale, inv_scale, s);
    case 64:
      return launch_pv<64, INT8>(op, o, nseq, nrows, heads, kh, kw, scale, inv_scale, s);
    case 80:
      return launch_pv<80, INT8>(op, o, nseq, nrows, heads, kh, kw, scale, inv_scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
