// What the attention kernels share: the softmax forms and rel modes, the
// padded per-row rel table, the operands of a launch, and the pre-passes of
// K7-int8 and of K7's int8 p . v pair (K7-pv, K7-int8pv): the column absmax,
// the int8 keys, and the int8 values in the key order of the p . v product's
// A fragments.  Included by global_attention.cuh (K7, K7-int8, K7-pv,
// K7-int8pv, K9 on the grid, K11, K16 v1 and v3 on the grid), which
// window_attention.cuh (K5, K6, K9 on windows, K10, K16 on windows) includes
// in turn.
#pragma once

#include <math.h>

#include "common.cuh"

namespace {

constexpr int BKV = 64;  // keys per tile

// The softmax forms (SM) and rel terms (REL) of the attention experiment tools
// (K16) and of K7's int8 p . v pair (SM_PV; the other instances run SM_ONLINE
// with REL_FULL), as the global and window kernels take them.  With m and l
// the row's final max and sum:
//   SM_ONLINE  1 / l after p . v (the flash loop's online softmax; the tools' v2)
//   SM_V1      p = bf16(exp(logit - m) / l) before p . v
//   SM_V3      p = bf16(exp(bf16(logit - m))), l = sum of those p, 1 / l after p . v
//   SM_NOEXP   p = logit - m in place of exp, 1 / l after p . v; the dead slots
//              (nkeys <= j < nrows) take part with logit -1e30 and their v rows
//   SM_PV      p = rint(127 exp(logit - m) / l) in int8, p . v in int32 over
//              the int8 values vq, dequantized by sv / 127 (K7-pv, K7-int8pv)
//   REL_NONE   no rel term; REL_BASE0 every query's rel term at cell (0, 0).
enum : int { SM_ONLINE = 0, SM_V1 = 1, SM_V3 = 3, SM_NOEXP = 4, SM_PV = 5 };
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

// int8 keys and q: hd padded to the 32-wide k-step of the 8-bit products
__host__ __device__ constexpr int padded_hd(int hd) { return (hd + 31) / 32 * 32; }

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

// The key of position kp in its 32-key chunk of vq (kernels/attention.py:
// pv_key_order mirrors it).  The int8 A fragment of wgmma m64nNk32 gives the
// thread of quad lane q the columns 4q..4q+3 and 16 + 4q..16 + 4q + 3 of its
// rows, and its S accumulator (m64n64, fp32) holds keys 8t + 2q and 8t + 2q + 1
// of each 8-key group t: so a register packs keys 2q, 2q + 1 of two
// consecutive 8-key groups, and vq holds at those positions the keys it gets.
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

}  // namespace
