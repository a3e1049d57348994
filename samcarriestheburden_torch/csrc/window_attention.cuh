// window_attention_kernel: the window attention of K5, K6, K9 on a sequence
// of at most 208 rows, K10 and K16's forms on windows, written for Hopper
// (sm_90a): TMA, mbarriers and wgmma on persistent blocks.  Included by
// attention.cu (K5, K6, K9, K10) and attention_forms.cu (K16).  The TPU
// kernels it replaces: samcarriestheburden_tpu/kernels/attention.py:
// fused_rel_attention_window3d (K5), fused_rel_attention_window_rect (K6),
// fused_rel_attention at the window shape (K9),
// fused_rel_attention_headmajor (K10), and the window forms of
// tools/exp_attn.py:mk_window and tools/exp_attn2.py:mk_window_ablate (K16).
//
// The function is attention.cu's, per (sequence, head) and query row i at
// cell (ph, pw) of the query grid QH x QW (the key grid KH x KW itself but
// for K6): with R[i] the row's KH + KW rel terms, bf16 at 1 / scale (from
// q . [Rh; Rw], or from the caller's rel_h, rel_w: PRE), and E the one-hot
// selector of each key column's grid row and column,
//    logit[i, j] = scale * (q_i . k_j + R[i] . E[j])
// over the live keys j < nkeys.  That is the TPU kernel's own formulation
// (_attn_kernel_window3d: qcat = [q, relh, relw] against kcat = [k, ehT,
// ewT]): the rel terms enter the tensor-core product as extra columns, so
// no per-score gather and no division remain.  Only the order of the fp32
// sums inside the products differs from the gather form.
//
// What bounds it: a 14 x 14 window moves ~100 operations per byte of q, k, v
// and output, below the card's ~295 ops/byte ridge, so bytes bound it (K5's
// 50 windows x 16 heads: 0.031 ms).  What held the mma.sync template back was
// one block's serial chain (loads, table product, four key tiles behind block
// barriers, a gathered rel term per score) on 3-4 waves of blocks.  The design:
//   * persistent blocks: grid = (blocks per SM) x SMs, each walking a strided
//     list of items, one item a (sequence, head), with two warpgroups: g
//     takes 64-row slabs g, g + 2, ...  Each item's q, k, v come by TMA (one
//     box of the item's rows rounded up to 8 per 16-column group, 32-byte
//     swizzled; 3-D maps, so no box reads another sequence's rows) into a
//     ring of W_STAGES item stages with a full mbarrier each: thread 0 loads
//     the first W_STAGES items, and the last of the eight warps done with a
//     stage refills it, so the next item is in flight while one is computed.
//     No producer warp: a ninth warp would put three warps on one of the
//     SM's four register files and cap every thread at 168 registers, where
//     the S and O accumulators and the table product spill; eight warps may
//     take 255.
//   * a whole row in one product: S = Q . K^T + R . E^T is wgmma m64n208k16
//     (K-major K from shared memory, W_NK = 208 key columns), so the softmax
//     runs once over whole rows in registers (row max and sum by quad
//     shuffles): no online rescale, and one pass for every softmax form.
//   * the rel terms: the table product q . [Rh; Rw] (wgmma m64n64k16 per 64
//     table rows) scattered, at 1 / scale in bf16, into the warpgroup's R
//     tile (64 rows x KH + KW padded to 16) in shared memory, the A operand
//     of R . E^T; E is built once per block.  The table product is issued
//     ahead of q . k^T and scattered while q . k^T runs.
//   * no call anywhere (1 / l is the SFU's reciprocal and one Newton step):
//     a call makes ptxas wait for each wgmma before issuing the next.
//   * P . V is wgmma m64n{HD}k16 with P in registers (the S fragment converts
//     in place), V MN-major; key rows past the sequence read zeros.
//   * K6's pad cells (the window's cells outside the carried QH x QW
//     rectangle, k = b_k, v = b_v) are the key columns nrows .. nrows + npad,
//     in the TPU kernel's order: their S entries are R . E_pad (their K rows
//     are zeros), plus q . bf16(b_k) summed in fp32; they enter the row max
//     and sum, and sum_pad p . b_v is added to the accumulator in fp32.
// The softmax forms keep the placement of the normalisation and the rounding
// points of the kernels they replace: SM_ONLINE applies 1 / l after p . v (l the fp32 sum of
// the unrounded p; K5, K6, K9, K10, the tools' v2, norel, noroll); SM_V1
// p = bf16(exp(logit - m) / l), correctly rounded by a product and one fma;
// SM_V3 p = bf16(exp(bf16(logit - m))), l their sum; SM_NOEXP p = logit - m
// with the dead slots (nkeys <= j < nrows) at logit -1e30 and their v rows.
#pragma once

#include "global_attention.cuh"

namespace {

constexpr int W_NK = 208;        // key columns of one S product (the wgmma N)
constexpr int W_STAGES = 2;      // item stages in flight
constexpr int W_THREADS = 256;  // two warpgroups

// S (64 x 208, fp32) = or += A (64 x 16) . B (208 x 16)^T, both bf16 from
// shared memory, K-major (scale_d = 0 overwrites S)
__device__ __forceinline__ void wgmma_s208(float (&d)[104], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %106, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n208k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103},"
      "%104, %105, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103])
      : "l"(da), "l"(db), "r"(scale_d));
}

// A block's shared memory, in bytes from a 1024-byte boundary: W_STAGES item
// stages of [q | k | v] (hd / 16 column groups each: q rb rows, k and v
// W_NK rows, so that the key columns past the item's rows read zeros), the
// stacked tables [Rh; Rw] (ntp rows), the selectors E (W_NK rows of krp
// slots), each warpgroup's R tile (64 rows of krp slots) and the mbarriers.
// Every tile is rows of 32 bytes, 32-byte swizzled, at a multiple of 256
// bytes (the swizzle's period).
struct WinSmem {
  int q, k, v, stage, tab, e, r, bar, bytes;
};

template <int HD>
__host__ __device__ constexpr WinSmem win_smem(int rb, int ntp, int krp) {
  WinSmem l{};
  l.q = 0;
  l.k = HD / 16 * rb * 32;
  l.v = l.k + HD / 16 * W_NK * 32;
  l.stage = l.v + HD / 16 * W_NK * 32;
  l.tab = W_STAGES * l.stage;
  l.e = l.tab + HD / 16 * ntp * 32;
  l.r = l.e + krp / 16 * W_NK * 32;
  l.bar = l.r + 2 * (krp / 16) * 64 * 32;
  l.bytes = l.bar + 2 * W_STAGES * 8;  // full[W_STAGES], done[W_STAGES] (8 bytes each)
  return l;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// bf16(v) into shared memory where p holds, by a predicated st.shared (no
// branch around the store)
__device__ __forceinline__ void sts_bf16_if(bool p, void* ptr, float v) {
  const bf16 b = __float2bfloat16(v);
  asm volatile("{\n.reg .pred q;\nsetp.ne.b32 q, %0, 0;\n@q st.shared.b16 [%1], %2;\n}\n"
               :: "r"((int)p), "r"(smem_addr(ptr)),
               "h"(*reinterpret_cast<const unsigned short*>(&b)) : "memory");
}

// 1 / y: the SFU's approximation and one Newton step, within an ulp of the
// quotient.  (1.f / y and __frcp_rn keep a slow path that is a call, and a
// call anywhere in the kernel makes ptxas wait for every wgmma before the next.)
__device__ __forceinline__ float rcp_nr(float y) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(y));
  return __fmaf_rn(r, __fmaf_rn(-y, r, 1.f), r);
}

// tm_q, tm_k, tm_v: 3-D maps (sequence, row, column) of bf16, boxes of 16
// columns x rb rows, from the bases of head 0's q, k, v; head h's start at
// column h * head_stride.  RECT (K6): qkv_bias (heads * 3 * HD fp32) gives the
// pad cells' k and v.  PRE (K9, K10): the rel terms come from rel_h (heads,
// nseq, nrows, KH) and rel_w (.., KW).  out is (nseq, nrows, heads, HD).
template <int HD, int SM, int REL, bool RECT, bool PRE>
__global__ void __launch_bounds__(W_THREADS, 1)
window_attention_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v, int head_stride,
                        const bf16* __restrict__ tab, const bf16* __restrict__ rel_h,
                        const bf16* __restrict__ rel_w, const float* __restrict__ qkv_bias,
                        bf16* __restrict__ out, int nseq, int nrows, int nkeys, int heads,
                        int KH, int KW, int QH, int QW, int rb, int ntp, int krp, float scale,
                        float inv_scale) {
  constexpr int KSTEPS = HD / 16, NT8 = W_NK / 8, PV_STEPS = W_NK / 16;
  constexpr bool RELTERMS = REL != REL_NONE;
  constexpr bool TABLES = RELTERMS && !PRE;
  constexpr float LOG2E = 1.4426950408889634f;
  static_assert(!(RECT || PRE) || (SM == SM_ONLINE && REL == REL_FULL),
                "the softmax forms and rel modes are K16's, on K5's windows");
  const WinSmem L = win_smem<HD>(rb, ntp, krp);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sTab = smem + L.tab;
  unsigned char* sE = smem + L.e;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar);
  unsigned* done = reinterpret_cast<unsigned*>(full + W_STAGES);  // warps done, per stage

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nitems = nseq * heads;
  const int npad = RECT ? KH * KW - nkeys : 0;  // K6: nkeys = QH * QW carried cells

  // 0. zeros everywhere (the key rows past an item, R's padding slots, E),
  //    then the barriers, the selectors and the tables
  for (int i = tid; i < L.bytes / 16; i += W_THREADS)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  if (tid == 0) {
    for (int i = 0; i < W_STAGES; ++i) mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (RELTERMS) {
    // E[c]: ones at slot kh(c) and KH + kw(c) of key column c's window cell;
    // K6's pad cells follow the nrows carried slots, row-major over the window
    const bf16 one = __float2bfloat16(1.f);
    for (int c = tid; c < W_NK; c += W_THREADS) {
      int kh = -1, kw = 0;
      if (c < nkeys) {
        kh = c / QW;
        kw = c - kh * QW;
      } else if (RECT && c >= nrows && c < nrows + npad) {
        const int p = c - nrows, side = KW - QW;
        if (p < QH * side) {
          kh = p / side;
          kw = QW + p - kh * side;
        } else {
          const int p2 = p - QH * side;
          kh = QH + p2 / KW;
          kw = p2 - (kh - QH) * KW;
        }
      }
      if (kh >= 0) {
        const int s0 = kh, s1 = KH + kw;
        *reinterpret_cast<bf16*>(sE + s0 / 16 * (W_NK * 32) + sw32(c, s0 % 16 * 2)) = one;
        *reinterpret_cast<bf16*>(sE + s1 / 16 * (W_NK * 32) + sw32(c, s1 % 16 * 2)) = one;
      }
    }
  }
  if (TABLES) {
    const int nt = 2 * KH - 1 + 2 * KW - 1;
    for (int x = tid; x < nt * (HD / 8); x += W_THREADS) {
      const int r = x / (HD / 8), c = x % (HD / 8) * 8;
      *reinterpret_cast<uint4*>(sTab + c / 16 * (ntp * 32) + sw32(r, c % 16 * 2)) =
          *reinterpret_cast<const uint4*>(tab + (size_t)r * HD + c);
    }
  }
  fence_async_shared();  // the zeros, E and the tables for TMA and wgmma
  __syncthreads();

  // item it's q, k, v into stage it % W_STAGES by TMA: the first W_STAGES
  // items now, each later one by the last warp done with its stage's item
  auto load_item = [&](int it) {
    const int item = blockIdx.x + it * gridDim.x, st = it % W_STAGES;
    if (item >= nitems) return;
    unsigned char* base = smem + st * L.stage;
    const int s = item / heads, h = item - s * heads;
    mbar_expect_tx(&full[st], 3 * KSTEPS * rb * 32);
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const int col = h * head_stride + kk * 16;
      tma_load(base + L.q + kk * rb * 32, &tm_q, &full[st], col, 0, s);
      tma_load(base + L.k + kk * W_NK * 32, &tm_k, &full[st], col, 0, s);
      tma_load(base + L.v + kk * W_NK * 32, &tm_v, &full[st], col, 0, s);
    }
  };
  if (tid == 0)
    for (int it = 0; it < W_STAGES; ++it) load_item(it);

  // ---- warpgroup g, warp wq of it holds 16 rows of each of its slabs; each
  // thread two rows, lr and lr + 8 of the slab
  const int g = warp / 4, wq = warp % 4, lr = wq * 16 + (lane >> 2);
  const int nslabs = (nrows + 63) / 64;
  unsigned char* sR = smem + L.r + g * (krp / 16) * 2048;  // the warpgroup's R tile
  const int RH = 2 * KH - 1, NT = RH + 2 * KW - 1;

  for (int item = blockIdx.x, it = 0; item < nitems; item += gridDim.x, ++it) {
    const int st = it % W_STAGES;
    mbar_wait(&full[st], (it / W_STAGES) & 1);
    const unsigned char* sQ = smem + st * L.stage + L.q;
    const unsigned char* sK = smem + st * L.stage + L.k;
    const unsigned char* sV = smem + st * L.stage + L.v;
    const int s = item / heads, h = item - s * heads;

    for (int slab = g; slab < nslabs; slab += 2) {
      const unsigned char* sQs = sQ + slab * 64 * 32;  // the slab's rows of each q group
      int rows[2], ph[2], pw[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        rows[i] = slab * 64 + lr + 8 * i;
        // dead rows clamp, as the reference does; REL_BASE0 puts every row at (0, 0)
        ph[i] = REL == REL_BASE0 ? 0 : min(rows[i] / QW, QH - 1);
        pw[i] = REL == REL_BASE0 ? 0 : rows[i] % QW;
      }

      // 1. S = q . k^T, issued behind the last table product: the rel terms
      //    are scattered while it runs.  (No instruction writes an accumulator
      //    while a product is in flight: ptxas would then wait for every wgmma
      //    of the kernel before the next.)
      float sc[4 * NT8], gg[32];
#pragma unroll
      for (int x = 0; x < 4 * NT8; ++x) sc[x] = 0.f;
#pragma unroll
      for (int x = 0; x < 32; ++x) gg[x] = 0.f;
      fence_regs(sc);
      if (TABLES) fence_regs(gg);
      // g = q . table_row (64 table rows a chunk), scattered to the (row, kh)
      // and (row, KH + kw) entries each table row serves for this query; this
      // thread's rows are its warp's own 16 of R
      auto scatter = [&](int c) {
        fence_regs(gg);
#pragma unroll
        for (int x = 0; x < 32; ++x) {
          const int i = (x >> 1) & 1;
          const int r = c * 64 + (x >> 2) * 8 + (lane & 3) * 2 + (x & 1);
          const int kh = ph[i] + KH - 1 - r, kw = pw[i] + KW - 1 - (r - RH);
          const bool hpart = r < RH;
          const int slot = hpart ? kh : KH + kw;
          sts_bf16_if(hpart ? (unsigned)kh < (unsigned)KH : (r < NT && (unsigned)kw < (unsigned)KW),
                      sR + (slot >> 4) * 2048 + sw32(lr + 8 * i, (slot & 15) * 2),
                      gg[x] * inv_scale);
        }
      };
      auto table_product = [&](int c) {
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk)
          wgmma_qk_bf16(gg, desc_kmajor(sQs + kk * rb * 32),
                        desc_kmajor(sTab + kk * ntp * 32 + c * 64 * 32), kk > 0);
        wgmma_commit();
      };
      if (TABLES)  // the chunks past the first (grids wider than 16 + 16), alone
        for (int c = 1; c < ntp / 64; ++c) {
          wgmma_fence();
          table_product(c);
          wgmma_wait<0>();
          scatter(c);
        }
      wgmma_fence();
      if (TABLES) table_product(0);
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        wgmma_s208(sc, desc_kmajor(sQs + kk * rb * 32), desc_kmajor(sK + kk * W_NK * 32), kk > 0);
      wgmma_commit();
      if (TABLES) {
        wgmma_wait<1>();  // the table product; q . k^T may still run
        scatter(0);
      }

      // 2. the slab's rel terms in R (bf16 at 1 / scale), then S += R . E^T
      if (RELTERMS) {
        if (PRE) {  // the caller's rel terms, rounded at 1 / scale as the TPU kernel's body
          // thread (r, part) of the warpgroup: row r's KH terms of rel_h or KW of rel_w
          named_sync(2 + g, 128);  // the previous slab's products have read R
          const int r = tid % 64, part = (tid % 128) / 64, row = slab * 64 + r;
          const int n = part ? KW : KH, off = part ? KH : 0;
          const bf16* src = (part ? rel_w : rel_h) + (((size_t)h * nseq + s) * nrows + row) * n;
          if (row < nrows) {
#pragma unroll 8
            for (int k = 0; k < n; ++k)
              sts_bf16_if(true, sR + ((off + k) >> 4) * 2048 + sw32(r, ((off + k) & 15) * 2),
                          __bfloat162float(src[k]) * inv_scale);
          }  // rows past the sequence keep earlier values: their outputs are not stored
        }
        fence_async_shared();
        named_sync(2 + g, 128);  // every warp's rows of R are written
        wgmma_fence();
        for (int kr = 0; kr < krp / 16; ++kr)
          wgmma_s208(sc, desc_kmajor(sR + kr * 2048), desc_kmajor(sE + kr * W_NK * 32), 1);
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_regs(sc);

      // K6: q . bf16(b_k), the pad keys' q . k, in fp32 (a quad splits the channels)
      float qbk[2] = {0.f, 0.f};
      if (RECT) {
        const float* bk = qkv_bias + h * 3 * HD + HD;
        for (int c = lane & 3; c < HD; c += 4) {
          const float b = bf16_round(bk[c]);
#pragma unroll
          for (int i = 0; i < 2; ++i)
            qbk[i] += __bfloat162float(*reinterpret_cast<const bf16*>(
                          sQs + c / 16 * rb * 32 + sw32(lr + 8 * i, c % 16 * 2))) * b;
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          qbk[i] += __shfl_xor_sync(0xffffffffu, qbk[i], 1);
          qbk[i] += __shfl_xor_sync(0xffffffffu, qbk[i], 2);
        }
      }

      // 3. the softmax over whole rows; sc[4t + e] is row rows[(e >> 1)], key
      //    column 8t + 2 (lane % 4) + (e & 1).  SM_ONLINE and SM_V1 keep the
      //    unscaled sums (scale > 0 keeps the max) and take exp as one fma and
      //    the SFU's 2^x; SM_V3 and SM_NOEXP round or use the logits themselves.
      constexpr bool LOGITS = SM == SM_V3 || SM == SM_NOEXP;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int x = 0; x < 4 * NT8; ++x) {
        const int i = (x >> 1) & 1;
        const int j = (x >> 2) * 8 + (lane & 3) * 2 + (x & 1);
        float v = -INFINITY;
        if (j < nkeys)
          v = LOGITS ? sc[x] * scale : sc[x];
        else if (RECT && j >= nrows && j < nrows + npad)
          v = sc[x] + qbk[i];
        else if (SM == SM_NOEXP && j < nrows)
          v = -1e30f;  // a dead slot: the reference adds -1e30, which absorbs q . k
        sc[x] = v;
        mx[i] = fmaxf(mx[i], v);
      }
      float l[2] = {0.f, 0.f}, sp[2] = {0.f, 0.f};
      const float c = scale * LOG2E;
      float mc[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        mc[i] = -mx[i] * c;
      }
#pragma unroll
      for (int x = 0; x < 4 * NT8; x += 2) {  // a row's two neighbouring keys at a time
        const int i = (x >> 1) & 1;
        float p[2];
        if (SM == SM_V3) {  // both roundings two values per conversion
          const float2 d = __bfloat1622float2(__floats2bfloat162_rn(sc[x] - mx[i], sc[x + 1] - mx[i]));
          const float2 e = __bfloat1622float2(
              __floats2bfloat162_rn(ex2_ftz(d.x * LOG2E), ex2_ftz(d.y * LOG2E)));
          p[0] = e.x;
          p[1] = e.y;
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (SM == SM_NOEXP)  // a key beyond the sequence takes no part
            p[u] = sc[x + u] == -INFINITY ? 0.f : sc[x + u] - mx[i];
          else if (SM != SM_V3)
            p[u] = ex2_ftz(__fmaf_rn(sc[x + u], c, mc[i]));
          l[i] += p[u];
          if (RECT && (x >> 2) * 8 + (lane & 3) * 2 + u >= nrows) sp[i] += p[u];
          sc[x + u] = p[u];
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        if (RECT) {
          sp[i] += __shfl_xor_sync(0xffffffffu, sp[i], 1);
          sp[i] += __shfl_xor_sync(0xffffffffu, sp[i], 2);
        }
      }
      if (SM == SM_V1) {
        const float linv[2] = {rcp_nr(l[0]), rcp_nr(l[1])};
#pragma unroll
        for (int x = 0; x < 4 * NT8; ++x) {
          const int i = (x >> 1) & 1;
          sc[x] = div_rn_by(sc[x], l[i], linv[i]);
        }
      }

      // 4. O = P . V over the key columns whose v rows take part (K6's pad
      //    columns meet zero rows), P from the S fragment as bf16 A fragments
      const int nkk = ((SM == SM_NOEXP ? nrows : nkeys) + 15) / 16;
      uint32_t a[PV_STEPS][4];
#pragma unroll
      for (int kk = 0; kk < PV_STEPS; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
      float o[HD / 2];
#pragma unroll
      for (int x = 0; x < HD / 2; ++x) o[x] = 0.f;
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < PV_STEPS; ++kk)
        if (kk < nkk) wgmma_pv<HD>(o, a[kk], desc_sw32(sV + kk * 16 * 32, W_NK * 32, 256));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);

      // K6: the pad keys' values, (sum of their weights) x bf16(b_v), in fp32
      if (RECT) {
        const float* bv = qkv_bias + h * 3 * HD + 2 * HD;
#pragma unroll
        for (int d = 0; d < HD / 8; ++d) {
          const int c = d * 8 + (lane & 3) * 2;
          const float bv0 = bf16_round(bv[c]), bv1 = bf16_round(bv[c + 1]);
          o[4 * d] += sp[0] * bv0;
          o[4 * d + 1] += sp[0] * bv1;
          o[4 * d + 2] += sp[1] * bv0;
          o[4 * d + 3] += sp[1] * bv1;
        }
      }

#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (rows[i] >= nrows) continue;
        const float inv = SM == SM_V1 ? 1.f : rcp_nr(l[i]);  // v1's p are normalised already
        bf16* dst = out + ((size_t)(s * nrows + rows[i]) * heads + h) * HD + (lane & 3) * 2;
#pragma unroll
        for (int d = 0; d < HD / 8; ++d)
          *reinterpret_cast<__nv_bfloat162*>(dst + d * 8) =
              __floats2bfloat162_rn(o[4 * d + 2 * i] * inv, o[4 * d + 2 * i + 1] * inv);
      }
    }
    // this warp is done with the stage (its products waited for); the last of
    // the eight refills it with the item W_STAGES on
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      if (atomicAdd(&done[st], 1u) % 8 == 7) load_item(it + W_STAGES);
    }
  }
}

// ---------------------------------------------------------------------------
// the launch
// ---------------------------------------------------------------------------

// the launch's layout parameters: rows per box (nrows rounded up to 8), the
// table rows rounded up to the 64-row table product, the rel slots rounded up
// to the 16-wide k-step (0 without rel terms)
struct WinShape {
  int rb, ntp, krp;
};

inline WinShape win_shape(int nrows, int kh, int kw, bool tables, bool relterms) {
  const int nt = 2 * kh - 1 + 2 * kw - 1;
  return {(nrows + 7) / 8 * 8, tables ? (nt + 63) / 64 * 64 : 0,
          relterms ? (kh + kw + 15) / 16 * 16 : 0};
}

template <int HD>
size_t window_launch_smem(const WinShape& w) {
  return win_smem<HD>(w.rb, w.ntp, w.krp).bytes + 1024;
}

// The persistent grid of an instance at `smem` bytes: blocks per SM x SMs,
// set up and looked up once per instance and shared-memory size (the host
// path is the launch's latency on small calls).
template <int HD, int SM, int REL, bool RECT, bool PRE>
cudaError_t persistent_grid(size_t smem, int* grid) {
  auto kernel = window_attention_kernel<HD, SM, REL, RECT, PRE>;
  static int smem_set = -1, grid_max = 0;
  if (smem_set != (int)smem) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err;
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem)) != cudaSuccess ||
        (err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, W_THREADS,
                                                             smem)) != cudaSuccess)
      return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    smem_set = (int)smem;
    grid_max = per_sm * sms;
  }
  *grid = grid_max;
  return cudaSuccess;
}

// op (Operands, rel_attention.cuh), a sequence
// seq_stride = nrows * stride elements long.  qh x qw is the carried grid
// (kh x kw unless RECT).  A launch the kernel cannot take returns
// cudaErrorInvalidValue; nothing falls back.
template <int HD, int SM, int REL, bool RECT, bool PRE>
cudaError_t launch_window(const Operands& op, bf16* out, int nseq, int nrows, int nkeys,
                          int heads, int kh, int kw, int qh, int qw, float scale, float inv_scale,
                          cudaStream_t stream) {
  constexpr bool RELTERMS = REL != REL_NONE, TABLES = RELTERMS && !PRE;
  if (nseq < 1 || heads < 1 || kh < 1 || kw < 1 || nrows < 1 || nrows > W_NK || nkeys < 1 ||
      nkeys > nrows || op.seq_stride != (size_t)nrows * op.stride)
    return cudaErrorInvalidValue;
  if (RECT ? (qh < 1 || qw < 1 || qh > kh || qw > kw || nkeys != qh * qw || op.bias == nullptr ||
              nrows + kh * kw - nkeys > W_NK)
           : (qh != kh || qw != kw || nkeys > kh * kw))
    return cudaErrorInvalidValue;
  if (PRE && (op.rel_h == nullptr || op.rel_w == nullptr || nkeys != kh * kw))
    return cudaErrorInvalidValue;
  if (TABLES && op.tab == nullptr) return cudaErrorInvalidValue;
  const WinShape w = win_shape(nrows, kh, kw, TABLES, RELTERMS);
  const size_t smem = window_launch_smem<HD>(w);
  if (smem > 232448) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  const CUtensorMapDataType BF = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!encode_map(&tq, op.q, BF, 2, op.stride, nrows, nseq, 16, w.rb) ||
      !encode_map(&tk, op.k, BF, 2, op.stride, nrows, nseq, 16, w.rb) ||
      !encode_map(&tv, op.v, BF, 2, op.stride, nrows, nseq, 16, w.rb))
    return cudaErrorInvalidValue;
  auto kernel = window_attention_kernel<HD, SM, REL, RECT, PRE>;
  int grid_max = 0;
  cudaError_t err = persistent_grid<HD, SM, REL, RECT, PRE>(smem, &grid_max);
  if (err != cudaSuccess) return err;
  const int grid = nseq * heads < grid_max ? nseq * heads : grid_max;
  kernel<<<grid, W_THREADS, smem, stream>>>(tq, tk, tv, op.head_stride, op.tab, op.rel_h,
                                            op.rel_w, op.bias, out, nseq, nrows, nkeys, heads, kh,
                                            kw, qh, qw, w.rb, w.ntp, w.krp, scale, inv_scale);
  return cudaGetLastError();
}

template <int SM, int REL, bool RECT, bool PRE>
int dispatch_window(int hd, const Operands& op, void* out, int nseq, int nrows, int nkeys,
                    int heads, int kh, int kw, int qh, int qw, float scale, float inv_scale,
                    void* stream) {
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return launch_window<16, SM, REL, RECT, PRE>(op, o, nseq, nrows, nkeys, heads, kh, kw, qh,
                                                   qw, scale, inv_scale, st);
    case 32:
      return launch_window<32, SM, REL, RECT, PRE>(op, o, nseq, nrows, nkeys, heads, kh, kw, qh,
                                                   qw, scale, inv_scale, st);
    case 64:
      return launch_window<64, SM, REL, RECT, PRE>(op, o, nseq, nrows, nkeys, heads, kh, kw, qh,
                                                   qw, scale, inv_scale, st);
    case 80:
      return launch_window<80, SM, REL, RECT, PRE>(op, o, nseq, nrows, nkeys, heads, kh, kw, qh,
                                                   qw, scale, inv_scale, st);
    default: return cudaErrorInvalidValue;
  }
}

// The persistent grid of one instance over nrows rows of a kh x kw grid
// (negative: the cudaError_t that refused it)
template <int HD, int SM, int REL, bool RECT, bool PRE>
int window_grid(int nrows, int kh, int kw) {
  const WinShape w = win_shape(nrows, kh, kw, REL != REL_NONE && !PRE, REL != REL_NONE);
  int grid = 0;
  const cudaError_t err = persistent_grid<HD, SM, REL, RECT, PRE>(window_launch_smem<HD>(w), &grid);
  return err == cudaSuccess ? grid : -(int)err;
}

// The dynamic shared memory (bytes) of a window launch at head dim hd over
// sequences of nrows rows on a kh x kw key grid, with the table product
// (tables) or the caller's rel terms; -1 for a head dim it has no instance of.
int window_smem(int hd, int nrows, int kh, int kw, bool tables) {
  const WinShape w = win_shape(nrows, kh, kw, tables, true);
  switch (hd) {
    case 16: return (int)window_launch_smem<16>(w);
    case 32: return (int)window_launch_smem<32>(w);
    case 64: return (int)window_launch_smem<64>(w);
    case 80: return (int)window_launch_smem<80>(w);
    default: return -1;
  }
}

}  // namespace
