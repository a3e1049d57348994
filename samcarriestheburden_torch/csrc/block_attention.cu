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
//    out          = bf16(sum over h of o_h . Wp_h^T)   Wp_h: columns h*HD.. of proj_w (E, E)
// every product and the sum over heads in fp32.  The attention is K5's
// (window_attention.cuh) on q, k, v that never leave shared memory.  The TPU
// body keeps q and k in fp32 up to the logits and rounds its output after
// every head, because its grid walks the heads in order; the tensor cores
// take bf16 operands, so here q and k are rounded once, and the sum over
// heads is one fp32 product over K = E in head order, rounded once.  Its
// expanded tables and mask-and-select products were a TPU device for the
// table gather and are not carried over: the stacked [Rh; Rw] tables enter
// as K5's selector columns.
//
// What bounds it: 2 * n * E * 4 * E operations per window for the two
// projections (~2.6 GFLOP at n = 196, E = 1280) on 0.5 MB of tokens in and
// out, far above the card's ~295 ops/byte ridge: the tensor cores bound it.
// In practice the tiles of phase A, which each block streams from L2 into
// its SM, take most of its time.
//
// Design: one thread-block cluster of C blocks per window (C the largest
// divisor of the head count up to 8: 8 at ViT-H and ViT-L, 6 at ViT-B, 2 at
// vit_t); block r owns heads r * HB .. r * HB + HB - 1 (HB = heads / C) and
// output columns r * NC .. r * NC + NC - 1 (NC = HB * HD).  Two warpgroups;
// warpgroup g owns the 64-row slabs 2g and 2g + 1 of the window's rows
// (four slabs of 64 hold the 208 rows kept; rows past n are zero tokens).
//   A. per owned head two wgmma chains m64n{2 HD}k16 over K = E: [k | v],
//      then [q | k] (the per-head-grouped weight rows are [q | k | v], so
//      each pair is one box; the second chain's k is not kept).  Their
//      operands stream through a ring of B_STAGES stages of 64-column
//      k-tiles, [xn (208 rows) | the pair's 2 HD weight rows], 128-byte
//      swizzled, one TMA box each; every warp arrives on the stage's empty
//      barrier when its products are done, and warp 0, a consumer too,
//      issues each tile: it waits for a stage only when the tile is due, and
//      otherwise issues ahead while stages are free.  The bias is added and
//      each result rounded to bf16 into shared memory; q, the last, goes where
//      the ring was.  (Multicasting the window's xn tile to the cluster from
//      shares of the blocks, with a cluster-wide empty barrier, was slower
//      than these local loads at ViT-H: the handshake cost more than the L2
//      traffic it saved.)
//   B. K5's attention on the resident q, k, v (window_attention.cuh's form):
//      S = Q . K^T + R . E^T as wgmma m64n208k16 per slab, the rel terms
//      q . [Rh; Rw] scattered at 1 / scale into R, the softmax over whole
//      rows in registers, P . V with P in registers; o_h = bf16(o / l) goes
//      into the block's O buffer, laid out so that a thread's A fragment of
//      a 16-column step of phase C is 16 contiguous bytes.  The tables, the
//      selectors and R take the ring's place too, so the next head's tiles
//      are issued only after this phase: the last B_STAGES tiles of a head
//      are released after it.
//   C. once every block of the cluster holds its heads' O (a cluster
//      barrier), block r computes its NC output columns as one fp32 wgmma
//      chain m64n{NC}k16 over K = E: the A fragments are the heads' O, read
//      from the owning block's shared memory through distributed shared
//      memory (mapa, ld.shared::cluster) one k-tile ahead, the B tiles the
//      matching proj_w rows by TMA through the ring (C_STAGES stages).  The
//      chain of block r starts at its own heads' columns and wraps round, so
//      that at each step the blocks read different blocks' O (all reading
//      one block's was markedly slower).  The result is rounded once to
//      bf16 and stored; a last cluster barrier keeps every block's O alive
//      until its peers have read it.
// The sum over heads is the fixed K order of one chain per output column:
// the same bits on every call, with no atomics, no scratch buffer and no
// second kernel.  Every wgmma sits outside branches, none is in flight while
// a warp waits in a branch (ptxas would serialize all of them, C7518: the
// products of phase A are drained before each release), and the kernel holds
// no call (1 / l is rcp_nr).
#include "window_attention.cuh"

namespace {

constexpr int B_THREADS = 256;            // two warpgroups
constexpr int B_ROWS = W_NK;              // 208 rows of xn, q, k, v and O kept per window
constexpr int B_BK = 64;                  // phase A's k-tile: one 128-byte swizzle row
constexpr int B_STAGES = 2;
constexpr int C_BK = 32;                  // phase C's k-tile: one 64-byte swizzle row
constexpr int C_STAGES = 4;
constexpr int B_NTP = 64;                 // table rows: 2 (2 WS - 1) <= 54, one 64-row product
constexpr int B_KRP = 32;                 // rel slots: 2 WS <= 28, padded to two k-steps
constexpr int B_MAX_CLUSTER = 8;

// ---------------------------------------------------------------------------
// wgmma: D (64 x N, fp32) += A (64 x 16) . B (N x 16)^T, bf16, B K-major from
// shared memory; A from shared memory (ss) or from registers (rs)
// ---------------------------------------------------------------------------

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db) {
  static_assert(N == 32 || N == 128 || N == 160, "an instance K12 has no product for");
  if constexpr (N == 32)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(1));
  if constexpr (N == 128)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
          "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
          "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1));
  if constexpr (N == 160)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
        "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79},"
        "%80, %81, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
          "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
          "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
          "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
        : "l"(da), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  static_assert(N == 16 || N == 128 || N == 160, "an instance K12 has no product for");
  if constexpr (N == 16)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7},"
        "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  if constexpr (N == 128)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
          "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
          "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  if constexpr (N == 160)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
        "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79},"
        "{%80, %81, %82, %83}, %84, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
          "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
          "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
          "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The wgmma descriptor of a K-major operand in the 64-byte swizzle: rows of
// 64 bytes, 8-row groups 512 bytes apart, at a 512-byte boundary; a k-step
// of 32 bytes inside the row adds 2.
__device__ __forceinline__ uint64_t desc_sw64(const void* p) {
  return (uint64_t)((smem_addr(p) >> 4) & 0x3FFF) | (1ull << 16) | ((uint64_t)(512 >> 4) << 32) |
         (2ull << 62);
}

// ---------------------------------------------------------------------------
// the cluster: rank, barrier, distributed shared memory
// ---------------------------------------------------------------------------

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}
// every thread of every block of the cluster: writes before it are seen after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the address of the same shared-memory byte in block `rank` of the cluster
__device__ __forceinline__ uint32_t mapa(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
// whether the phase of the given parity has completed, without waiting
__device__ __forceinline__ bool mbar_test(uint64_t* bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  return done != 0;
}
// an A fragment (16 bytes: a0, a2 of row r, then a1, a3 of row r + 8) from
// distributed shared memory where p holds; where not, a keeps its values
__device__ __forceinline__ void ld_fragment_if(bool p, uint32_t (&a)[4], uint32_t addr) {
  asm volatile("{\n.reg .pred q;\nsetp.ne.b32 q, %4, 0;\n"
               "@q ld.shared::cluster.v4.b32 {%0, %1, %2, %3}, [%5];\n}\n"
               : "+r"(a[0]), "+r"(a[2]), "+r"(a[1]), "+r"(a[3]) : "r"((int)p), "r"(addr)
               : "memory");
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// A block's shared memory, in bytes from a 1024-byte boundary: the ring
// (B_STAGES stages of [xn | W], phase C's proj_w tiles later), over which
// phase B lays q (HD / 16 groups of B_ROWS rows), the stacked tables (B_NTP
// rows), the selectors E and each warpgroup's R tile, all 32-byte swizzled;
// k and v (as q); O (see phase B); the mbarriers full and
// empty (one each per stage of phase A), full_c and empty_c (phase C's).
struct BlockSmem {
  int stage, q, tab, e, r, k, v, o, bar, bytes;
};

template <int HD, int HB>
__host__ __device__ constexpr BlockSmem block_smem() {
  BlockSmem l{};
  l.stage = (B_ROWS + 2 * HD) * 128;
  l.q = 0;
  l.tab = l.q + HD / 16 * B_ROWS * 32;
  l.e = l.tab + HD / 16 * B_NTP * 32;
  l.r = l.e + B_KRP / 16 * B_ROWS * 32;
  const int ring = B_STAGES * l.stage, over = l.r + 2 * (B_KRP / 16) * 64 * 32;
  l.k = ((ring > over ? ring : over) + 1023) / 1024 * 1024;
  l.v = l.k + HD / 16 * B_ROWS * 32;
  l.o = l.v + HD / 16 * B_ROWS * 32;
  l.bar = l.o + B_ROWS * HB * HD * 2;
  l.bytes = l.bar + 2 * (B_STAGES + C_STAGES) * 8;
  return l;
}

// The launch: grid (C, nwin), clusters of C blocks along x.  tm_x maps xn as
// (nwin, n, E) in boxes of 64 columns x B_ROWS rows and tm_w the qkv weight
// (3E, E) in boxes of 64 x 2 HD, 128-byte swizzled; tm_p proj_w (E, E) in
// boxes of 32 x NC, 64-byte swizzled; rows and columns past n, 3E, E read zeros.
template <int HD, int HB>
__global__ void __launch_bounds__(B_THREADS, 1)
block_attention_kernel(const __grid_constant__ CUtensorMap tm_x,
                       const __grid_constant__ CUtensorMap tm_w,
                       const __grid_constant__ CUtensorMap tm_p, const float* __restrict__ bqkv,
                       const bf16* __restrict__ tab, bf16* __restrict__ out, int n, int E, int WS,
                       float scale, float inv_scale) {
  constexpr int NC = HB * HD, KSTEPS = HD / 16, NT8 = W_NK / 8, PV_STEPS = W_NK / 16;
  constexpr float LOG2E = 1.4426950408889634f;
  constexpr BlockSmem L = block_smem<HD, HB>();
  static_assert(L.bytes + 1024 <= 232448, "the block does not fit one SM");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar);
  uint64_t* empty = full + B_STAGES;
  uint64_t* full_c = empty + B_STAGES;
  uint64_t* empty_c = full_c + C_STAGES;
  unsigned char* sQ = smem + L.q;
  unsigned char* sTab = smem + L.tab;
  unsigned char* sE = smem + L.e;
  unsigned char* sK = smem + L.k;
  unsigned char* sV = smem + L.v;
  unsigned char* sO = smem + L.o;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // warpgroup g; the thread's rows lr and lr + 8 of each of its slabs
  const int g = warp / 4, lr = (warp % 4) * 16 + (lane >> 2);
  const int rank = cluster_rank(), w = blockIdx.y;
  // k-tiles: per product (a last one past E reads zeros), head, block
  const int KT = (E + B_BK - 1) / B_BK, TPH = 2 * KT, T = HB * TPH;
  unsigned char* sR = smem + L.r + g * (B_KRP / 16) * 2048;  // the warpgroup's R tile

  // 0. zeros everywhere, then the barriers
  for (int i = tid; i < L.bytes / 16; i += B_THREADS)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  if (tid == 0) {
    for (int s = 0; s < B_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    for (int s = 0; s < C_STAGES; ++s) {
      mbar_init(&full_c[s], 1);
      mbar_init(&empty_c[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // tile t of the block's sequence (head t / TPH; [k | v], then [q | k];
  // k-tile t % KT) into stage t % B_STAGES: xn's box and the weight rows' box
  auto issue = [&](int t) {
    const int s = t % B_STAGES, hl = t / TPH, first = (t / KT) % 2 == 0 ? 1 : 0, kt = t % KT;
    unsigned char* base = smem + s * L.stage;
    if (lane == 0) {
      mbar_expect_tx(&full[s], L.stage);
      tma_load(base, &tm_x, &full[s], kt * B_BK, 0, w);
      tma_load_2d(base + B_ROWS * 128, &tm_w, &full[s], kt * B_BK,
                  ((rank * HB + hl) * 3 + first) * HD);
    }
  };
  // every warp once it is done with tile t
  auto release = [&](int t) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[t % B_STAGES]);
  };
  // Warp 0 is the producer besides its share of the products: it issues tile
  // `issued` once every warp is done with tile issued - B_STAGES, which it
  // waits for only when the tile is due (`need`); past that it issues ahead
  // while the stages are free and stops at the first that is not.  No other
  // warp waits for a stage.
  int issued = 0;
  auto produce = [&](int need) {
    for (; issued < T; ++issued) {
      const int t = issued - B_STAGES;
      if (t >= 0) {
        const int s = t % B_STAGES, parity = (t / B_STAGES) & 1;
        if (issued <= need) mbar_wait(&empty[s], parity);
        else if (!mbar_test(&empty[s], parity)) break;
      }
      issue(issued);
    }
  };
  // the last B_STAGES tiles of a head: phase B lays its operands over the ring,
  // so they are released after it (the last head's never: no tile follows)
  auto held = [&](int t) { return t % TPH + B_STAGES >= TPH; };
  if (warp == 0) produce(B_STAGES - 1);

  const int RH = 2 * WS - 1, NT = 2 * RH;
  // the loops over heads, passes and slabs stay loops (#pragma unroll 1): two
  // copies of a phase side by side would share the registers of products in flight
#pragma unroll 1
  for (int hl = 0; hl < HB; ++hl) {
    const int hg = rank * HB + hl;

    // A. [k | v], then [q | k] = xn . W^T + b of head hg for the warpgroup's
    //    two slabs, two products of 2 HD columns (the per-head-grouped weight
    //    rows are [q | k | v]: each pair is one box); the second pass keeps q
#pragma unroll 1
    for (int pi = 0; pi < 2; ++pi) {
      float acc[2][HD];
#pragma unroll
      for (int sl = 0; sl < 2; ++sl)
#pragma unroll
        for (int x = 0; x < HD; ++x) acc[sl][x] = 0.f;
      const int t0 = hl * TPH + pi * KT;
      for (int kt = 0; kt < KT; ++kt) {
        const int t = t0 + kt, s = t % B_STAGES;
        if (warp == 0) produce(t);
        mbar_wait(&full[s], (t / B_STAGES) & 1);
        const unsigned char* xs = smem + s * L.stage;
        const uint64_t dx0 = desc_sw128(xs + 2 * g * 64 * 128);
        const uint64_t dx1 = desc_sw128(xs + (2 * g + 1) * 64 * 128);
        const uint64_t dw = desc_sw128(xs + B_ROWS * 128);
        fence_regs(acc[0]);
        fence_regs(acc[1]);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < B_BK / 16; ++ks) {
          wgmma_ss<2 * HD>(acc[0], dx0 + 2 * ks, dw + 2 * ks);
          wgmma_ss<2 * HD>(acc[1], dx1 + 2 * ks, dw + 2 * ks);
        }
        wgmma_commit();
        // drained before the release: a wait in a branch while a product is
        // in flight (the producer's) makes ptxas serialize every wgmma (C7518)
        wgmma_wait<0>();
        fence_regs(acc[0]);
        fence_regs(acc[1]);
        if (!held(t)) release(t);
      }

      if (pi == 1) {
        // q goes over the ring, with the tables, the selectors and R: every
        // warp is done with the ring, and no copy into it is in flight
        __syncthreads();
        for (int i = tid; i < (L.r + 2 * (B_KRP / 16) * 2048 - L.tab) / 16; i += B_THREADS)
          reinterpret_cast<uint4*>(sTab)[i] = make_uint4(0u, 0u, 0u, 0u);
        __syncthreads();  // the zeros before the ones and the tables written over them
        // E[c]: ones at slot kh(c) and WS + kw(c) of key c's window cell
        const bf16 one = __float2bfloat16(1.f);
        for (int c = tid; c < n; c += B_THREADS) {
          const int s0 = c / WS, s1 = WS + c - s0 * WS;
          *reinterpret_cast<bf16*>(sE + s0 / 16 * (W_NK * 32) + sw32(c, s0 % 16 * 2)) = one;
          *reinterpret_cast<bf16*>(sE + s1 / 16 * (W_NK * 32) + sw32(c, s1 % 16 * 2)) = one;
        }
        for (int x = tid; x < NT * (HD / 8); x += B_THREADS) {
          const int r = x / (HD / 8), c = x % (HD / 8) * 8;
          *reinterpret_cast<uint4*>(sTab + c / 16 * (B_NTP * 32) + sw32(r, c % 16 * 2)) =
              *reinterpret_cast<const uint4*>(tab + (size_t)r * HD + c);
        }
      }
      // the accumulator of slab 2g + sl: acc[sl][4 j + 2 hh + e] at row
      // lr + 8 hh, column 8 j + 2 (lane % 4) + e (gemm_sm90.cuh): k into sK
      // and v into sV, then q into sQ (the second pass's k is not kept)
      const float* bias = bqkv + (hg * 3 + (pi == 0 ? 1 : 0)) * HD;
      // (unrolled: an accumulator indexed by a loop's counter goes to the stack)
      unsigned char* first = pi == 0 ? sK : sQ;
#pragma unroll
      for (int sl = 0; sl < 2; ++sl)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = (2 * g + sl) * 64 + lr + 8 * hh;
          if (row >= B_ROWS) continue;
#pragma unroll
          for (int j = 0; j < HD / 4; ++j) {
            const int col = 8 * j + 2 * (lane & 3), c = col % HD;
            if (j >= HD / 8 && pi == 1) break;
            *reinterpret_cast<__nv_bfloat162*>((j < HD / 8 ? first : sV) + c / 16 * (B_ROWS * 32) +
                                               sw32(row, c % 16 * 2)) =
                __floats2bfloat162_rn(acc[sl][4 * j + 2 * hh] + bias[col],
                                      acc[sl][4 * j + 2 * hh + 1] + bias[col + 1]);
          }
        }
    }
    fence_async_shared();  // q, k, v, E and the tables for wgmma
    __syncthreads();

    // B. the attention of head hg on the warpgroup's slabs (window_attention.cuh)
#pragma unroll 1
    for (int sl = 0; sl < 2; ++sl) {
      const int slab = 2 * g + sl;
      const unsigned char* sQs = sQ + slab * 64 * 32;  // the slab's rows of each q group
      int rows[2], ph[2], pw[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        rows[i] = slab * 64 + lr + 8 * i;
        ph[i] = min(rows[i] / WS, WS - 1);  // dead rows clamp, as K5's do
        pw[i] = rows[i] % WS;
      }

      // 1. the table product q . [Rh; Rw], then S = q . k^T behind it: the
      //    rel terms are scattered into R while S runs
      float sc[4 * NT8], gg[32];
#pragma unroll
      for (int x = 0; x < 4 * NT8; ++x) sc[x] = 0.f;
#pragma unroll
      for (int x = 0; x < 32; ++x) gg[x] = 0.f;
      fence_regs(sc);
      fence_regs(gg);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        wgmma_qk_bf16(gg, desc_kmajor(sQs + kk * B_ROWS * 32), desc_kmajor(sTab + kk * B_NTP * 32),
                      kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        wgmma_s208(sc, desc_kmajor(sQs + kk * B_ROWS * 32), desc_kmajor(sK + kk * B_ROWS * 32),
                   kk > 0);
      wgmma_commit();
      wgmma_wait<1>();  // the table product; q . k^T may still run
      fence_regs(gg);
      // g = q . table_row, scattered to the (row, kh) and (row, WS + kw)
      // entries each table row serves for this query; this thread's rows are
      // its warp's own 16 of R
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int i = (x >> 1) & 1;
        const int r = (x >> 2) * 8 + (lane & 3) * 2 + (x & 1);
        const int kh = ph[i] + WS - 1 - r, kw = pw[i] + WS - 1 - (r - RH);
        const bool hpart = r < RH;
        const int slot = hpart ? kh : WS + kw;
        sts_bf16_if(hpart ? (unsigned)kh < (unsigned)WS : (r < NT && (unsigned)kw < (unsigned)WS),
                    sR + (slot >> 4) * 2048 + sw32(lr + 8 * i, (slot & 15) * 2), gg[x] * inv_scale);
      }

      // 2. S += R . E^T (the rel slots past 2 WS are zeros in both)
      fence_async_shared();
      named_sync(2 + g, 128);  // every warp's rows of R are written
      wgmma_fence();
#pragma unroll
      for (int kr = 0; kr < B_KRP / 16; ++kr)
        wgmma_s208(sc, desc_kmajor(sR + kr * 2048), desc_kmajor(sE + kr * W_NK * 32), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // 3. the softmax over whole rows; sc[4t + e] is row rows[(e >> 1)], key
      //    column 8t + 2 (lane % 4) + (e & 1); the unscaled sums keep the max
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int x = 0; x < 4 * NT8; ++x) {
        const int i = (x >> 1) & 1;
        const int j = (x >> 2) * 8 + (lane & 3) * 2 + (x & 1);
        const float v = j < n ? sc[x] : -INFINITY;
        sc[x] = v;
        mx[i] = fmaxf(mx[i], v);
      }
      float l[2] = {0.f, 0.f}, mc[2];
      const float c = scale * LOG2E;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        mc[i] = -mx[i] * c;
      }
#pragma unroll
      for (int x = 0; x < 4 * NT8; ++x) {
        const int i = (x >> 1) & 1;
        const float p = ex2_ftz(__fmaf_rn(sc[x], c, mc[i]));
        l[i] += p;
        sc[x] = p;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      }

      // 4. O = P . V over all 208 key rows (the dead ones weigh 0; their v
      //    rows are the bias), P from the S fragment as bf16 A fragments
      uint32_t a[PV_STEPS][4];
#pragma unroll
      for (int kk = 0; kk < PV_STEPS; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          a[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
      float o[HD / 2];
#pragma unroll
      for (int x = 0; x < HD / 2; ++x) o[x] = 0.f;
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < PV_STEPS; ++kk)
        wgmma_pv<HD>(o, a[kk], desc_sw32(sV + kk * 16 * 32, W_NK * 32, 256));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);

      // o_h = bf16(o / l) into O, in 512-byte blocks of 16 rows x 16
      // columns, band-major: in the block, lane (r % 8) * 4 + t of a warp
      // (quad lane t holds columns 2t, 2t + 1 and 2t + 8, 2t + 9) finds row
      // r's four values and then row r + 8's at byte 16 lane, so an A
      // fragment of phase C is one 16-byte load and a warp's are 512
      // contiguous bytes
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (rows[i] >= B_ROWS) continue;
        const float inv = rcp_nr(l[i]);
        unsigned char* dst =
            sO + (rows[i] / 16 * (NC / 16) + hl * KSTEPS) * 512 + lane * 16 + i * 8;
#pragma unroll
        for (int d = 0; d < HD / 8; ++d)
          *reinterpret_cast<__nv_bfloat162*>(dst + (d >> 1) * 512 + (d & 1) * 4) =
              __floats2bfloat162_rn(o[4 * d + 2 * i] * inv, o[4 * d + 2 * i + 1] * inv);
      }
    }
    fence_async_shared();  // the ring's generic writes before its next copies
    if (hl + 1 < HB)
      for (int t = (hl + 1) * TPH - B_STAGES; t < (hl + 1) * TPH; ++t) release(t);
  }

  // C. out[:, rank * NC .. + NC] = bf16(O . proj_w[rank * NC .. + NC]^T), one
  //    chain over K = E in 32-column k-tiles, an even number of them (a last
  //    one past E reads zeros); proj_w's tiles through the ring
  __syncthreads();  // every warp is done with the ring
  const int KTC = (E / C_BK + 1) / 2 * 2;
  // block r's chain starts at its own heads' columns and wraps round: at each
  // step the blocks read different blocks' O, not all the same one
  const int start = rank * NC / C_BK;
  // warp 0 produces as in phase A, the stage free once the block's 8 warps are done
  int issued_c = 0;
  auto produce_c = [&](int need) {
    for (; issued_c < KTC; ++issued_c) {
      const int t = issued_c - C_STAGES, s = issued_c % C_STAGES;
      if (t >= 0) {
        const int parity = (t / C_STAGES) & 1;
        if (issued_c <= need) mbar_wait(&empty_c[s], parity);
        else if (!mbar_test(&empty_c[s], parity)) break;
      }
      if (lane == 0) {
        mbar_expect_tx(&full_c[s], NC * 64);
        tma_load_2d(smem + s * NC * 64, &tm_p, &full_c[s], (issued_c + start) % KTC * C_BK,
                    rank * NC);
      }
    }
  };
  if (warp == 0) produce_c(C_STAGES - 1);
  cluster_sync();  // every block's O is whole

  // the A fragments of k-tile kt for both slabs: k-step ks is 16 columns c of
  // head h = c / HD, held by block h / HB (columns past E read the last
  // head's, whose proj_w tile is zeros; the warps of rows past B_ROWS load
  // nothing: their rows are not stored)
  const uint32_t o_addr = smem_addr(sO);
  auto load_a = [&](uint32_t (&fr)[2][2][4], int kt) {
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int c = min((kt + start) % KTC * C_BK + ks * 16, E - 16), h = c / HD;
      const uint32_t base = mapa(o_addr, h / HB) + ((h % HB) * HD + c % HD) / 16 * 512 + lane * 16;
#pragma unroll
      for (int sl = 0; sl < 2; ++sl) {
        const int band = (2 * g + sl) * 4 + warp % 4;  // the warp's 16 rows
        ld_fragment_if(band < B_ROWS / 16, fr[ks][sl],
                       base + min(band, B_ROWS / 16 - 1) * (NC / 16) * 512);
      }
    }
  };
  float acc[2][NC / 2];
#pragma unroll
  for (int sl = 0; sl < 2; ++sl)
#pragma unroll
    for (int x = 0; x < NC / 2; ++x) acc[sl][x] = 0.f;
  // k-tile kt on the fragments fr, the next one's fetched into nx meanwhile;
  // the two sets alternate, so no register an in-flight wgmma reads is written
  auto step = [&](const uint32_t (&fr)[2][2][4], uint32_t (&nx)[2][2][4], int kt) {
    const int s = kt % C_STAGES;
    if (warp == 0) produce_c(kt);
    mbar_wait(&full_c[s], (kt / C_STAGES) & 1);
    const uint64_t db = desc_sw64(smem + s * NC * 64);
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      wgmma_rs<NC>(acc[0], fr[ks][0], db + 2 * ks);
      wgmma_rs<NC>(acc[1], fr[ks][1], db + 2 * ks);
    }
    wgmma_commit();
    load_a(nx, min(kt + 1, KTC - 1));
    wgmma_wait<0>();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty_c[s]);
  };
  uint32_t fa[2][2][4] = {}, fb[2][2][4] = {};
  load_a(fa, 0);
  for (int kt = 0; kt < KTC; kt += 2) {
    step(fa, fb, kt);
    step(fb, fa, kt + 1);
  }
#pragma unroll
  for (int sl = 0; sl < 2; ++sl)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = (2 * g + sl) * 64 + lr + 8 * hh;
      if (row >= n) continue;
      bf16* dst = out + ((size_t)w * n + row) * E + rank * NC + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < NC / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(acc[sl][4 * j + 2 * hh], acc[sl][4 * j + 2 * hh + 1]);
    }
  cluster_sync();  // no block leaves while a peer may still read its O
}

// ---------------------------------------------------------------------------
// the launch
// ---------------------------------------------------------------------------

// the cluster of a window: the largest divisor of the head count up to 8
int block_cluster(int heads) {
  for (int c = heads < B_MAX_CLUSTER ? heads : B_MAX_CLUSTER; c > 1; --c)
    if (heads % c == 0) return c;
  return 1;
}

// a map of bf16 elements, dims[0] contiguous, boxes of 32 columns (64 bytes)
// x box_rows, 64-byte swizzled; elements past dims read zeros
bool encode_swizzled(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                     const cuuint64_t* strides, int box_cols, int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr || reinterpret_cast<uintptr_t>(base) % 16) return false;
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t estride[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims, strides,
            box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
            box_cols * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, int HB>
cudaError_t set_smem() {
  return cudaFuncSetAttribute(block_attention_kernel<HD, HB>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              block_smem<HD, HB>().bytes + 1024);
}

template <int HD, int HB>
cudaError_t launch(const bf16* xn, const bf16* wqkv, const float* bqkv, const bf16* wp,
                   const bf16* tab, bf16* out, int nwin, int n, int E, int ws, int C, float scale,
                   float inv_scale, cudaStream_t stream) {
  const size_t bytes = (size_t)E * 2;
  const cuuint64_t dx[3] = {(cuuint64_t)E, (cuuint64_t)n, (cuuint64_t)nwin},
                   sx[2] = {bytes, bytes * n};
  const cuuint64_t dw[2] = {(cuuint64_t)E, (cuuint64_t)3 * E};
  const cuuint64_t dp[2] = {(cuuint64_t)E, (cuuint64_t)E};
  CUtensorMap tx, tw, tp;
  if (!encode_swizzled(&tx, xn, 3, dx, sx, B_BK, B_ROWS) ||
      !encode_swizzled(&tw, wqkv, 2, dw, sx, B_BK, 2 * HD) ||
      !encode_swizzled(&tp, wp, 2, dp, sx, C_BK, HB * HD))
    return cudaErrorInvalidValue;
  cudaError_t err = set_smem<HD, HB>();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, nwin);
  cfg.blockDim = dim3(B_THREADS);
  cfg.dynamicSmemBytes = block_smem<HD, HB>().bytes + 1024;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, block_attention_kernel<HD, HB>, tx, tw, tp, bqkv, tab, out, n, E,
                           ws, scale, inv_scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// the clusters of C blocks of an instance that fit the card at once
template <int HD, int HB>
cudaError_t active_clusters(int C, int* clusters) {
  cudaError_t err = set_smem<HD, HB>();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 64);
  cfg.blockDim = dim3(B_THREADS);
  cfg.dynamicSmemBytes = block_smem<HD, HB>().bytes + 1024;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(clusters, block_attention_kernel<HD, HB>, &cfg);
}

}  // namespace

// xn, out (nwin, n, E) bf16 with n = ws * ws <= 208; wqkv (heads*3*hd, E) bf16
// and bqkv (heads*3*hd) fp32 grouped per head ([q | k | v] rows of each head
// together); wp (E, E) bf16, the projection as nn.Linear holds it; tab
// (2 * (2*ws-1), hd) bf16 rows [Rh; Rw].  E = heads * hd, a multiple of 32;
// cluster = block_cluster(heads) (kernels/attention.py:window_block_geometry);
// (hd, heads / cluster) one of the instances (16, 1), (64, 2), (80, 2).
extern "C" int k12_window_block_attention(const void* xn, const void* wqkv, const void* bqkv,
                                          const void* wp, const void* tab, void* out, int nwin,
                                          int n, int E, int heads, int ws, int cluster,
                                          float scale, float inv_scale, void* stream) {
  if (heads < 1 || E % heads || E % C_BK || n != ws * ws || n < 1 || n > B_ROWS || nwin < 1 ||
      nwin > 65535 || cluster != block_cluster(heads))
    return cudaErrorInvalidValue;
  const int hd = E / heads, hb = heads / cluster;
  const bf16* x = static_cast<const bf16*>(xn);
  const bf16* wq = static_cast<const bf16*>(wqkv);
  const float* bq = static_cast<const float*>(bqkv);
  const bf16* w = static_cast<const bf16*>(wp);
  const bf16* t = static_cast<const bf16*>(tab);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 16 && hb == 1)
    return launch<16, 1>(x, wq, bq, w, t, o, nwin, n, E, ws, cluster, scale, inv_scale, s);
  if (hd == 64 && hb == 2)
    return launch<64, 2>(x, wq, bq, w, t, o, nwin, n, E, ws, cluster, scale, inv_scale, s);
  if (hd == 80 && hb == 2)
    return launch<80, 2>(x, wq, bq, w, t, o, nwin, n, E, ws, cluster, scale, inv_scale, s);
  return cudaErrorInvalidValue;
}

// The dynamic shared memory of the instance for (hd, heads) and the clusters
// of it that fit the card at once (cudaOccupancyMaxActiveClusters).
extern "C" int k12_block_info(int hd, int heads, int* smem, int* clusters) {
  const int C = block_cluster(heads), hb = heads / C;
  if (hd == 16 && hb == 1) {
    *smem = block_smem<16, 1>().bytes + 1024;
    return active_clusters<16, 1>(C, clusters);
  }
  if (hd == 64 && hb == 2) {
    *smem = block_smem<64, 2>().bytes + 1024;
    return active_clusters<64, 2>(C, clusters);
  }
  if (hd == 80 && hb == 2) {
    *smem = block_smem<80, 2>().bytes + 1024;
    return active_clusters<80, 2>(C, clusters);
  }
  return cudaErrorInvalidValue;
}
