// global_attention_kernel: the global attention of K7, K7-int8, K9 on a
// sequence longer than one block, K11, and K16's two-pass forms v1 and v3 on
// the grid, written for Hopper (sm_90a): TMA, mbarriers and wgmma.  Included
// by attention.cu (K7, K7-int8, K9, K11) and attention_forms.cu (K16).  The
// TPU kernels it replaces: samcarriestheburden_tpu/kernels/attention.py:
// fused_rel_attention_global3d (K7, K7-int8), fused_rel_attention at the
// global shape (K9), fused_rel_attention_headmajor_global (K11), and the v1
// and v3 forms of tools/exp_attn.py:mk_global (K16).
//
// It computes the function of attention.cu's header with the rounding points
// of the mma.sync kernels it replaced: the rel terms
// bf16 at 1 / scale, (s + rh + rw) * scale (int8: fma(s, sq, rh + rw) * scale),
// P rounded to bf16 before p . v, 1 / l after p . v (v1: p / l before,
// correctly rounded), fp32 accumulation.  Only the order of the fp32 sums inside the tensor-core
// products differs.
//
// What bounds it: per (sequence, head) 2 x n^2 x hd x 2 operations on
// 3 x n x hd x 2 bytes of q, k, v: at n = 4096 that is ~1700 operations per
// byte, far above the card's ~295 ops/byte ridge, so the tensor cores bound
// it (0.18 ms for K7's ViT-H call at 989 TFLOP/s), and behind them the
// softmax's exp and the rel-term adds, which run on the SM's other units
// beside the products.  The design:
//   * a block of 288 threads owns 128 query rows of one (sequence, head):
//     two consumer warpgroups of 64 rows each and one producer warp, whose
//     lane 0 issues every TMA copy (the consumers copy only the small rel
//     tables, once, before the key loop).
//   * K and V stream through a ring of STAGES 64-key tiles, filled by TMA and
//     handed over through full / empty mbarrier pairs: no block-wide barrier
//     in the key loop, and both warpgroups share every tile.  Each tile is
//     hd / 16 boxes of 64 rows x 16 bf16 (32 bytes), 32-byte swizzled: one
//     box is one wgmma k-step of K (K-major) and 16 columns of V (MN-major),
//     for every hd in {16, 32, 64, 80} (80 fits no 64- or 128-byte atom).
//     The tensor maps are 3-D (sequence, row, column), so a tile past a
//     sequence's last row reads zeros, not the next sequence's rows.
//   * q . k is wgmma m64n64k16 (bf16, both operands in shared memory; q is
//     loaded once by TMA); K7-int8's is m64n64k32 s8 -> s32 over its int8
//     keys (the pre-pass of rel_attention.cuh, streamed by TMA in 32-byte
//     boxes) and q quantized in the block, as rel_attention_kernel does, into
//     a 32-byte-swizzled tile.
//   * p . v is wgmma m64n{hd}k16 with P in registers: the S accumulator's
//     fragment is the A fragment of the next product, row for row, so P
//     converts to bf16 in place; V is the transposed (MN-major) B.
//   * the rel terms: the small product q . [Rh; Rw] at block start (mma.sync)
//     scatters each row's KH + KW terms into the per-row table of
//     rel_attention.cuh, whose stride (rel_stride) keeps every rel-term load
//     free of bank conflicts; K9 and K11 fill it from the caller's rel_h,
//     rel_w.  On a 64-wide grid (every ViT global grid) a 64-key tile is one
//     grid row: each thread keeps its 2 rows x 16 keys of rw in registers for
//     the whole key loop and reads one rh per row per tile.  Other grids read
//     the table per score.
//   * the two-pass forms (v1, v3) need each row's final max before its first
//     probability: the producer runs the key sequence twice, K alone on the
//     first pass (max and sum), K and V on the second (the products).
#pragma once

#include "hopper.cuh"
#include "rel_attention.cuh"

namespace {

constexpr int G_BQ = 128;           // query rows per block
constexpr int G_STAGES = 3;         // K/V tiles in flight
constexpr int G_CONSUMERS = 256;    // two warpgroups
constexpr int G_THREADS = G_CONSUMERS + 32;
constexpr int G_BOX = 64 * 32;      // one box: 64 rows x 32 bytes

// V as the MN-major B of p . v: 16 keys (two 8-row groups, 256 bytes apart)
// by hd columns in boxes of 16, one box (G_BOX bytes) from the next
__device__ __forceinline__ uint64_t desc_v(const void* p) { return desc_sw32(p, G_BOX, 256); }

// S (64 x 64, fp32) = or += A (64 x 16) . B (64 x 16)^T, both bf16 from shared
// memory, K-major (scale_d = 0 overwrites S)
__device__ __forceinline__ void wgmma_qk_bf16(float (&d)[32], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// S (64 x 64, s32) = or += A (64 x 32) . B (64 x 32)^T, both int8 from shared
// memory, K-major (8-bit wgmma takes no other layout)
__device__ __forceinline__ void wgmma_qk_s8(int (&d)[32], uint64_t da, uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      "%32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// O (64 x HD, fp32) += P (64 x 16, bf16 A fragments in registers) . V (16 x HD),
// V from shared memory MN-major (its rows are keys, HD contiguous: trans-b)
template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&d)[HD / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (HD == 16)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  if constexpr (HD == 32)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  if constexpr (HD == 64)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
          "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  if constexpr (HD == 80)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39},"
        "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
          "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// A block's shared memory, in bytes from a 1024-byte boundary: q (hd / 16
// boxes of 128 rows), the ring (STAGES x [K | V], K int8 for K7-int8), the
// per-row rel table (128 rows of rel_stride(kh + kw)), K7-int8's q tile (hd
// padded to 32, in boxes of 32 bytes), its row and key-channel scales, and the
// mbarriers: full[STAGES], empty[STAGES], q, tables.  The stacked rel-pos
// tables sit in the ring until the block's table product has read them.
struct GlobalSmem {
  int q, ring, kbytes, stage, rel, qi, sq, sk, bar, bytes;
};

template <int HD, bool INT8>
__host__ __device__ constexpr GlobalSmem global_smem(int kh, int kw) {
  GlobalSmem l{};
  l.q = 0;
  l.ring = HD / 16 * 2 * G_BOX;
  l.kbytes = INT8 ? padded_hd(HD) / 32 * G_BOX : HD / 16 * G_BOX;
  l.stage = l.kbytes + HD / 16 * G_BOX;
  l.rel = l.ring + G_STAGES * l.stage;
  l.qi = l.rel + (G_BQ * rel_stride(kh + kw) * 2 + 1023) / 1024 * 1024;
  l.sq = l.qi + (INT8 ? padded_hd(HD) / 32 * 2 * G_BOX : 0);
  l.sk = l.sq + (INT8 ? G_BQ * 4 : 0);
  l.bar = l.sk + (INT8 ? HD * 4 : 0);
  l.bytes = l.bar + (2 * G_STAGES + 2) * 8;
  return l;
}

// x / y correctly rounded, given r = 1 / y correctly rounded (__frcp_rn): the
// product and one fused correction (Markstein's theorem: the IEEE quotient
// for every x, y whose quotient and residual stay out of the subnormals), at a
// fraction of the full division's cost
__device__ __forceinline__ float div_rn_by(float x, float y, float r) {
  const float q = __fmul_rn(x, r);
  return __fmaf_rn(__fmaf_rn(-y, q, x), r, q);
}

// bf16 -> fp32 of the low and the high half of a register
__device__ __forceinline__ float bf16_lo(uint32_t x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t x) { return __uint_as_float(x & 0xffff0000u); }

// tm_q, tm_k, tm_v: 3-D maps (sequence, row, column) of bf16, boxes of 16
// columns x 64 rows, from the bases of head 0's q, k, v; head h's start at
// column h * head_stride.  tm_kq (K7-int8): the int8 keys (nseq * heads, nrows, hd
// padded to 32), boxes of 32 bytes x 64 rows.  PRE: the rel terms come from
// rel_h (heads, nseq, nrows, KH) and rel_w (.., KW), not from tab.  SM: the
// softmax form (SM_ONLINE; K16's SM_V1 and SM_V3 make two passes).  Every row
// is a key (nrows = KH * KW); out is (nseq, nrows, heads, HD).
template <int HD, bool INT8, bool PRE, int SM>
__global__ void __launch_bounds__(G_THREADS, 1)
global_attention_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_kq, int head_stride,
                        const bf16* __restrict__ tab,
                        const bf16* __restrict__ rel_h, const bf16* __restrict__ rel_w,
                        const float* __restrict__ kmax, bf16* __restrict__ out, int nrows,
                        int heads, int KH, int KW, float scale, float inv_scale) {
  constexpr int KSTEPS = HD / 16, DT = HD / 8, LD = HD + 8;
  constexpr int KSTEPS8 = padded_hd(HD) / 32;
  constexpr bool TABLES = !PRE;
  constexpr int NPASS = SM == SM_ONLINE ? 1 : 2;
  constexpr float LOG2E = 1.4426950408889634f;
  static_assert(SM == SM_ONLINE || SM == SM_V1 || SM == SM_V3, "no such global form");
  static_assert(SM == SM_ONLINE || (!INT8 && !PRE), "the two-pass forms are K16's");
  const GlobalSmem L = global_smem<HD, INT8>(KH, KW);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = smem + L.q;
  unsigned char* ring = smem + L.ring;
  bf16* sRel = reinterpret_cast<bf16*>(smem + L.rel);
  int8_t* sQi = reinterpret_cast<int8_t*>(smem + L.qi);
  float* sSq = reinterpret_cast<float*>(smem + L.sq);
  float* sSk = reinterpret_cast<float*>(smem + L.sk);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar);
  uint64_t* empty = full + G_STAGES;
  uint64_t* qbar = empty + G_STAGES;
  uint64_t* tabbar = qbar + 1;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * G_BQ, h = blockIdx.y, s = blockIdx.z;
  const int SR = rel_stride(KH + KW);
  const int NKT = (nrows + BKV - 1) / BKV;

  if (tid == 0) {
    for (int i = 0; i < G_STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], G_CONSUMERS / 32);
    }
    mbar_init(qbar, 1);
    mbar_init(tabbar, G_CONSUMERS / 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // ---- the producer warp: q once, then the key sequence (twice for the
  // two-pass forms, V on the last pass only), once the tables are read
  if (warp == G_CONSUMERS / 32) {
    if (lane == 0) {
      mbar_expect_tx(qbar, KSTEPS * 2 * G_BOX);
      for (int kk = 0; kk < KSTEPS; ++kk)
        for (int half = 0; half < 2; ++half)
          tma_load(sQ + (2 * kk + half) * G_BOX, &tm_q, qbar, h * head_stride + kk * 16,
                   q0 + half * 64, s);
      mbar_wait(tabbar, 0);
      int stage = 0, phase = 0;
      for (int pass = 0; pass < NPASS; ++pass) {
        const bool with_v = pass == NPASS - 1;
        for (int kt = 0; kt < NKT; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* st = ring + stage * L.stage;
          mbar_expect_tx(&full[stage], L.kbytes + (with_v ? KSTEPS * G_BOX : 0));
          if (INT8)
            for (int kk = 0; kk < KSTEPS8; ++kk)
              tma_load(st + kk * G_BOX, &tm_kq, &full[stage], kk * 32, kt * BKV, s * heads + h);
          else
            for (int kk = 0; kk < KSTEPS; ++kk)
              tma_load(st + kk * G_BOX, &tm_k, &full[stage], h * head_stride + kk * 16,
                       kt * BKV, s);
          if (with_v)
            for (int kk = 0; kk < KSTEPS; ++kk)
              tma_load(st + L.kbytes + kk * G_BOX, &tm_v, &full[stage],
                       h * head_stride + kk * 16, kt * BKV, s);
          if (++stage == G_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- the consumers: warpgroup g holds rows g * 64 .. g * 64 + 63, warp wq
  // of it 16 of them; each thread two rows, rl[0] and rl[0] + 8
  const int g = warp / 4, wq = warp % 4;
  int rl[2], ph[2], pw[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rl[i] = g * 64 + wq * 16 + (lane >> 2) + i * 8;
    const int t = q0 + rl[i];
    ph[i] = min(t / KW, KH - 1);  // dead rows clamp, as the reference does
    pw[i] = t % KW;
  }

  // 1. the stacked rel tables [Rh; Rw] into the ring (the producer waits for
  //    them to be read), or the caller's rel terms into the table; int8 key scales
  const int RH = 2 * KH - 1, NT = RH + 2 * KW - 1, NTP = (NT + 15) / 16 * 16;
  bf16* sTab = reinterpret_cast<bf16*>(ring);  // [NTP][LD]
  if (TABLES) {
    for (int c = tid; c < NTP * (HD / 8); c += G_CONSUMERS) {
      const int r = c / (HD / 8), cc = (c % (HD / 8)) * 8;
      const bool ok = r < NT;
      cp_async16(sTab + r * LD + cc, ok ? tab + (size_t)r * HD + cc : tab, ok ? 16 : 0);
    }
    cp_async_commit();
  }
  if (PRE) {  // the caller's rel terms, rounded at 1/scale as the TPU kernel's body rounds them
    const size_t row0 = ((size_t)h * gridDim.z + s) * nrows + q0;
    const int KR = KH + KW;
    for (int c = tid; c < G_BQ * KR; c += G_CONSUMERS) {
      const int r = c / KR, slot = c - r * KR;
      float v = 0.f;
      if (q0 + r < nrows)
        v = __bfloat162float(slot < KH ? rel_h[(row0 + r) * KH + slot]
                                       : rel_w[(row0 + r) * KW + slot - KH]);
      sRel[r * SR + slot] = __float2bfloat16(v * inv_scale);
    }
  }
  if (INT8)
    for (int c = tid; c < HD; c += G_CONSUMERS)
      sSk[c] = kmax[(size_t)(s * heads + h) * HD + c] / 127.f + 1e-12f;
  cp_async_wait<0>();
  named_sync(1, G_CONSUMERS);
  mbar_wait(qbar, 0);

  // 2. rel terms: g = q . table_row (mma.sync), scattered to the (row, kh) and
  //    (row, KH + kw) entries each table row serves for this query
  if (TABLES) {
    uint32_t qf[KSTEPS][4];
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      ldmatrix_x4(qf[kk], sQ + 2 * kk * G_BOX +
                              sw32(g * 64 + wq * 16 + (lane & 15), (lane >> 4) * 16));
    for (int np = 0; np < NTP / 16; ++np) {
      float gg[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t r[4];
        ldmatrix_x4(r, sTab + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                           ((lane >> 3) & 1) * 8);
        mma_bf16(gg[0], qf[kk], r[0], r[1]);
        mma_bf16(gg[1], qf[kk], r[2], r[3]);
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
          if (slot >= 0) sRel[rl[i] * SR + slot] = __float2bfloat16(gg[t][e] * inv_scale);
        }
    }
  }

  // 3. int8: fold the key channel scales into q, quantize each of this warp's
  //    rows by its own absmax into the swizzled int8 q tile
  float sq[2] = {0.f, 0.f};
  if (INT8) {
    for (int r = 0; r < 16; ++r) {
      const int row = g * 64 + wq * 16 + r;
      float qs[KSTEPS8];
      float amax = 0.f;
#pragma unroll
      for (int i = 0; i < KSTEPS8; ++i) {
        const int c = lane + 32 * i;
        qs[i] = c < HD ? __bfloat162float(*reinterpret_cast<const bf16*>(
                             sQ + 2 * (c / 16) * G_BOX + sw32(row, (c % 16) * 2))) * sSk[c]
                       : 0.f;
        amax = fmaxf(amax, fabsf(qs[i]));
      }
      const float sr = warp_max(amax) / 127.f + 1e-12f;
#pragma unroll
      for (int i = 0; i < KSTEPS8; ++i)
        sQi[2 * i * G_BOX + sw32(row, lane)] = (int8_t)__float2int_rn(qs[i] / sr);
      if (lane == 0) sSq[row] = sr;
    }
  }
  __syncwarp();
  fence_async_shared();  // the int8 q tile for wgmma; the tables read before TMA reuses the ring
  if (lane == 0) mbar_arrive(tabbar);
  named_sync(2 + g, 128);  // the warpgroup's q rows are all written
  if (INT8) {
    sq[0] = sSq[rl[0]];
    sq[1] = sSq[rl[1]];
  }

  // on a 64-wide grid each tile is grid row kt: this thread's rw for its two
  // rows and 16 keys, kept in registers for the whole key loop
  const bool row64 = KW == BKV;
  const bf16* rel0 = sRel + rl[0] * SR;
  const bf16* rel1 = sRel + rl[1] * SR;
  uint32_t rwp[2][8] = {};
  if (row64)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const bf16* r = (i ? rel1 : rel0) + KH + t * 8 + (lane & 3) * 2;
        rwp[i][t] = pack_bf16(__bfloat162float(r[0]), __bfloat162float(r[1]));
      }

  // 4. the key loop
  float o[HD / 2], sc[32];
#pragma unroll
  for (int x = 0; x < HD / 2; ++x) o[x] = 0.f;
#pragma unroll
  for (int x = 0; x < 32; ++x) sc[x] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, linv[2] = {0.f, 0.f};
  const float inv_qw = 1.f / KW;
  const unsigned char* sQg = sQ + g * G_BOX;  // this warpgroup's rows of each q box
  const unsigned char* sQig = reinterpret_cast<const unsigned char*>(sQi) + g * G_BOX;
  int stage = 0, phase = 0;

  for (int pass = 0; pass < NPASS; ++pass) {
    const bool stats = NPASS == 2 && pass == 0;  // the row max and sum, no product
    for (int kt = 0; kt < NKT; ++kt) {
      mbar_wait(&full[stage], phase);
      const unsigned char* sK = ring + stage * L.stage;
      const unsigned char* sV = sK + L.kbytes;

      if (INT8) {
        int si[32];
#pragma unroll
        for (int x = 0; x < 32; ++x) si[x] = 0;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KSTEPS8; ++kk)
          wgmma_qk_s8(si, desc_kmajor(sQig + 2 * kk * G_BOX), desc_kmajor(sK + kk * G_BOX),
                      kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(si);
#pragma unroll
        for (int x = 0; x < 32; ++x) sc[x] = (float)si[x];  // * sq in the logit's fma
      } else {
        fence_regs(sc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk)
          wgmma_qk_bf16(sc, desc_kmajor(sQg + 2 * kk * G_BOX), desc_kmajor(sK + kk * G_BOX),
                        kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);
      }

      // sc[4t + e]: row rl[e >> 1], key kt * 64 + 8t + 2 (lane % 4) + (e & 1)
      float mx[2] = {-INFINITY, -INFINITY};
      if (row64) {
        const float rh[2] = {__bfloat162float(rel0[kt]), __bfloat162float(rel1[kt])};
#pragma unroll
        for (int x = 0; x < 32; ++x) {
          const int t = x >> 2, i = (x >> 1) & 1;
          const float rw = (x & 1) ? bf16_hi(rwp[i][t]) : bf16_lo(rwp[i][t]);
          const float v = INT8 ? __fmaf_rn(sc[x], sq[i], rh[i] + rw) * scale
                               : (sc[x] + rh[i] + rw) * scale;
          sc[x] = v;
          mx[i] = fmaxf(mx[i], v);
        }
      } else {
#pragma unroll
        for (int x = 0; x < 32; ++x) {
          const int t = x >> 2, i = (x >> 1) & 1;
          const int j = kt * BKV + t * 8 + (lane & 3) * 2 + (x & 1);
          float v = -INFINITY;
          if (j < nrows) {
            const int kh = __float2int_rz((j + 0.5f) * inv_qw);
            const int kw = j - kh * KW;
            const bf16* rel = i ? rel1 : rel0;
            const float rh = __bfloat162float(rel[kh]), rw = __bfloat162float(rel[KH + kw]);
            v = INT8 ? __fmaf_rn(sc[x], sq[i], rh + rw) * scale : (sc[x] + rh + rw) * scale;
          }
          sc[x] = v;
          mx[i] = fmaxf(mx[i], v);
        }
      }

      float ls[2] = {0.f, 0.f};
      if (SM == SM_ONLINE || stats) {  // the online softmax: running max, rescaled sum
        float alpha[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
          const float mn = fmaxf(m[i], mx[i]);  // finite: key 0 is always live
          alpha[i] = exp2f((m[i] - mn) * LOG2E);
          m[i] = mn;
        }
#pragma unroll
        for (int x = 0; x < 32; ++x) {
          const int i = (x >> 1) & 1;
          const float p = exp2f((sc[x] - m[i]) * LOG2E);
          sc[x] = p;
          ls[i] += p;
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + ls[i];
        if (NPASS == 1)
#pragma unroll
          for (int x = 0; x < HD / 2; ++x) o[x] *= alpha[(x >> 1) & 1];
      } else {  // the product pass of a two-pass form: m (and, for v1, l) are final
#pragma unroll
        for (int x = 0; x < 32; ++x) {
          const int i = (x >> 1) & 1;
          float p;
          if (SM == SM_V1)
            p = div_rn_by(exp2f((sc[x] - m[i]) * LOG2E), l[i], linv[i]);
          else  // SM_V3
            p = __bfloat162float(__float2bfloat16(
                expf(__bfloat162float(__float2bfloat16(sc[x] - m[i])))));
          sc[x] = p;
          ls[i] += p;
        }
        if (SM != SM_V1)
#pragma unroll
          for (int i = 0; i < 2; ++i) l[i] += ls[i];
      }

      if (!stats) {  // O += P . V, P from the S fragment as bf16 A fragments
        uint32_t a[BKV / 16][4];
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            a[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
        fence_regs(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk) wgmma_pv<HD>(o, a[kk], desc_v(sV + kk * 16 * 32));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(o);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);  // this warp is done with the stage
      if (++stage == G_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    if (stats)  // the rows' sums, whole, before the first product
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        linv[i] = __frcp_rn(l[i]);
        if (SM == SM_V3) l[i] = 0.f;  // summed again over the p used
      }
  }

  if (SM != SM_V1)  // v1's probabilities are normalised already
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + rl[i];
    if (row >= nrows) continue;
    const float inv = SM == SM_V1 ? 1.f : 1.f / l[i];
    bf16* dst = out + ((size_t)(s * nrows + row) * heads + h) * HD + (lane & 3) * 2;
#pragma unroll
    for (int d = 0; d < DT; ++d)
      *reinterpret_cast<__nv_bfloat162*>(dst + d * 8) =
          __floats2bfloat162_rn(o[4 * d + 2 * i] * inv, o[4 * d + 2 * i + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// the launch: tensor maps, pre-passes, checks
// ---------------------------------------------------------------------------

// A 3-D map over (seqs, rows, cols) elements of `elem` bytes, rows `cols`
// elements apart, boxes of box_cols x box_rows, 32-byte swizzled; rows past
// `rows` read zeros.  False where TMA cannot take the operand (a base or a
// row pitch not 16-byte aligned).
bool encode_map(CUtensorMap* map, const void* base, CUtensorMapDataType type, int elem, int cols,
                int rows, int seqs, int box_cols, int box_rows = 64) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr || reinterpret_cast<uintptr_t>(base) % 16 || (size_t)cols * elem % 16)
    return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)seqs};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * elem, (cuuint64_t)cols * elem * rows};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t estride[3] = {1, 1, 1};
  return fn(map, type, 3, const_cast<void*>(base), dims, strides, box, estride,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the dynamic shared memory of a launch: the layout and the slack that aligns
// its base to 1024 bytes
template <int HD, bool INT8>
size_t global_launch_smem(int kh, int kw) {
  return global_smem<HD, INT8>(kh, kw).bytes + 1024;
}

// op (Operands, rel_attention.cuh), a sequence
// seq_stride = nrows * stride elements long: q, k and v each become a 3-D
// tensor map of (nseq, nrows, stride) elements from its own base.
template <int HD, bool INT8, bool PRE, int SM>
cudaError_t launch_global(const Operands& op, bf16* out, int nseq, int nrows, int heads, int kh,
                          int kw, float scale, float inv_scale, cudaStream_t stream) {
  const int nt = 2 * kh - 1 + 2 * kw - 1;
  if (kh < 1 || kw < 1 || nrows != kh * kw || (nt + 15) / 16 * 16 > 4 * BKV ||
      op.seq_stride != (size_t)nrows * op.stride)
    return cudaErrorInvalidValue;
  if (PRE ? (op.rel_h == nullptr || op.rel_w == nullptr) : op.tab == nullptr)
    return cudaErrorInvalidValue;
  const GlobalSmem L = global_smem<HD, INT8>(kh, kw);
  if ((nt + 15) / 16 * 16 * (HD + 8) * 2 > G_STAGES * L.stage) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, tkq;
  const CUtensorMapDataType BF = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!encode_map(&tq, op.q, BF, 2, op.stride, nrows, nseq, 16) ||
      !encode_map(&tk, op.k, BF, 2, op.stride, nrows, nseq, 16) ||
      !encode_map(&tv, op.v, BF, 2, op.stride, nrows, nseq, 16))
    return cudaErrorInvalidValue;
  tkq = tk;
  cudaError_t err;
  if (INT8) {
    if (op.kq == nullptr || op.kmax == nullptr) return cudaErrorInvalidValue;
    err = column_absmax<HD>(op.q, op.kmax, nseq, nrows, heads, HD, stream);
    if (err != cudaSuccess) return err;
    const int chunks = nrows * (padded_hd(HD) / 8);
    k_quant_kernel<HD><<<dim3((chunks + 255) / 256, heads, nseq), 256, 0, stream>>>(
        op.q, op.kmax, op.kq, nrows, heads);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    if (!encode_map(&tkq, op.kq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, padded_hd(HD), nrows,
                    nseq * heads, 32))
      return cudaErrorInvalidValue;
  }
  const size_t smem = global_launch_smem<HD, INT8>(kh, kw);
  auto kernel = global_attention_kernel<HD, INT8, PRE, SM>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((nrows + G_BQ - 1) / G_BQ, heads, nseq);
  kernel<<<grid, G_THREADS, smem, stream>>>(tq, tk, tv, tkq, op.head_stride, op.tab, op.rel_h,
                                            op.rel_w, op.kmax, out, nrows, heads, kh, kw, scale,
                                            inv_scale);
  return cudaGetLastError();
}

template <bool INT8, bool PRE, int SM = SM_ONLINE>
int dispatch_global(int hd, const Operands& op, void* out, int nseq, int nrows, int heads, int kh,
                    int kw, float scale, float inv_scale, void* stream) {
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return launch_global<16, INT8, PRE, SM>(op, o, nseq, nrows, heads, kh, kw, scale,
                                              inv_scale, st);
    case 32:
      return launch_global<32, INT8, PRE, SM>(op, o, nseq, nrows, heads, kh, kw, scale,
                                              inv_scale, st);
    case 64:
      return launch_global<64, INT8, PRE, SM>(op, o, nseq, nrows, heads, kh, kw, scale,
                                              inv_scale, st);
    case 80:
      return launch_global<80, INT8, PRE, SM>(op, o, nseq, nrows, heads, kh, kw, scale,
                                              inv_scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
