// The GEMM mainloop of the port's int8 and bf16 matrix products on Hopper
// (sm_90a): TMA, mbarriers and wgmma.  One block of 256 threads computes the
// 128 x BN tile at (blockIdx.y, blockIdx.x) of A[M, K] @ W[N, K]^T into
// registers, A and W both K-contiguous, and leaves the epilogue to its kernel:
// K14 (gemm.cu: 128 x 256 tiles, one block per SM), K2, K4 and K15's GEMMs
// (quant.cu: 128 x 128 tiles, two blocks per SM, so that one block's
// epilogue runs beside the other's products) and K1 and K3's bf16 GEMMs
// (mlp.cu: 128 x 128 tiles for the qkv product and lin1, 128 x 256 for lin2).
//
//   * A stage is one 128-byte swizzle atom of the contraction per row (64 bf16
//     or 128 int8): a (128 x 128-byte) box of A and a (BN x 128-byte) box of
//     W, each one TMA copy from a 2-D tensor map with CU_TENSOR_MAP_SWIZZLE_128B.
//     Rows past M or N and k past K read zeros (TMA's out-of-bounds fill), so
//     the ragged edges need no code here; the epilogues mask their stores.
//   * A ring of four stages (three at two blocks per SM), each with a full
//     mbarrier that its TMA copies complete.  There is no producer warp:
//     thread 0 issues the first stages, and each later one is issued by the
//     last of the 8 warps done with the stage it refills (a counter per stage
//     in shared memory), as the window attention kernel refills its items.
//     So all 256 threads hold accumulators (BN / 2 each).
//   * Two consumer warpgroups, each 64 rows of the tile: per stage four
//     wgmma.mma_async m64nBNk16 (bf16 -> fp32) or m64nBNk32 (s8 -> s32), both
//     operands K-major from shared-memory descriptors (8-bit wgmma takes no
//     other layout).  A stage's products are committed as one group and the
//     previous stage's group awaited (wgmma.wait_group 1) before that stage
//     is handed back, so one group is always queued behind the running one.
//   * A hook after every `every` k-tiles, with the products drained: K15's
//     flush of its int32 partials at chunk boundaries.  The k-loop is nested
//     in the hook's loop, so no wgmma sits in a conditional branch; ptxas
//     would otherwise serialize every wgmma (warning C7520), as it does when
//     the kernel holds a call anywhere (see div_rn_inline in quant.cu).
//
// What bounds it: at the tools' shape (19600 x 1280 x 5120) the products, at
// 989 TFLOP/s bf16 and 1979 TOP/s int8; at one block per SM a tile's epilogue
// does not overlap the next tile's products, which costs K14 most of the gap
// to that bound (its 128 x 256 fp32 tile takes about as long to store as to
// compute at K = 1280).
//
// The accumulator layout of wgmma m64nN, fp32 or s32: thread lane of warp w
// (warpgroup g = w / 4) holds acc[4 j + 2 hh + e] for each 8-column group
// j < BN / 8, at row g * 64 + 16 * (w % 4) + lane / 4 + 8 hh and column
// 8 j + 2 (lane % 4) + e of the tile (hh, e in {0, 1}): per 8-column group
// mma.sync's rows lane/4 (+8) and columns 2 (lane%4) (+1).  tile_row and
// tile_col give them.
#pragma once

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// wgmma: D (64 x N) += A (64 x 16 bf16 | 32 int8) . B (N x the same)^T, both
// K-major from shared memory (scale_d = 0 overwrites D)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_m64n256k16_bf16(float (&d)[128], uint64_t da, uint64_t db,
                                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, "
      "%87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
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
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n128k16_bf16(float (&d)[64], uint64_t da, uint64_t db,
                                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
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
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n256k32_s8(int (&d)[128], uint64_t da, uint64_t db,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, "
      "%87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      "%128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]),
        "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]),
        "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), "+r"(d[96]), "+r"(d[97]),
        "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), "+r"(d[120]), "+r"(d[121]),
        "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t da, uint64_t db,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <class T>
struct Sm90Elem;
template <>
struct Sm90Elem<bf16> {
  using Acc = float;
  static constexpr CUtensorMapDataType TMA = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <>
struct Sm90Elem<int8_t> {
  using Acc = int;
  static constexpr CUtensorMapDataType TMA = CU_TENSOR_MAP_DATA_TYPE_UINT8;
};

// The tile and ring of one configuration: BM x BN tiles of elements T, sized
// for BLOCKS blocks per SM (four stages for one block, three for two).
template <class T, int BN_, int BLOCKS_ = 1>
struct GemmSm90 {
  static_assert(BN_ == 128 || BN_ == 256, "the tile is 128 x 128 or 128 x 256");
  using Elem = T;
  using Acc = typename Sm90Elem<T>::Acc;
  static constexpr int BM = 128, BN = BN_, BK = 128 / (int)sizeof(T);  // one swizzle atom a row
  static constexpr int BLOCKS = BLOCKS_, STAGES = BLOCKS_ == 1 ? 4 : 3, THREADS = 256;
  static constexpr int A_BYTES = BM * 128, STAGE_BYTES = (BM + BN) * 128;
  // the ring, the barriers and counters, and the slack that aligns the base to 1024
  static constexpr int SMEM = STAGES * STAGE_BYTES + STAGES * 16 + 1024;
  static_assert(BLOCKS * (SMEM + 1024) <= 232448, "the blocks do not fit one SM");
};

// the four products of one stage (four k-steps of 32 bytes)
template <class T, int BN>
__device__ __forceinline__ void wgmma_stage(typename Sm90Elem<T>::Acc (&acc)[BN / 2], uint64_t da,
                                            uint64_t db) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if constexpr (sizeof(T) == 2 && BN == 256)
      wgmma_m64n256k16_bf16(acc, da + 2 * k, db + 2 * k, 1);
    else if constexpr (sizeof(T) == 2) wgmma_m64n128k16_bf16(acc, da + 2 * k, db + 2 * k, 1);
    else if constexpr (BN == 256) wgmma_m64n256k32_s8(acc, da + 2 * k, db + 2 * k, 1);
    else wgmma_m64n128k32_s8(acc, da + 2 * k, db + 2 * k, 1);
  }
}

// the tile row of accumulators acc[4 j + 2 hh + e] (hh = 0, 1), and the tile
// column of acc[4 j] (layout above)
__device__ __forceinline__ int tile_row(int hh) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return (warp / 4) * 64 + (warp % 4) * 16 + (lane >> 2) + 8 * hh;
}
__device__ __forceinline__ int tile_col(int j) { return 8 * j + 2 * (threadIdx.x & 3); }

struct NoChunks {
  __device__ __forceinline__ void operator()(int) const {}
};

// The block's tile of A @ W^T into acc (zeroed first), configuration G
// (GemmSm90); tmA maps A as (K columns, M rows) in boxes of 128 bytes x BM
// rows, tmW maps W as (K, N) in boxes of 128 bytes x BN rows (encode_map_2d).
// After every `every` k-tiles (0: all of them) hook(c) runs with the products
// of chunk c complete.
template <class G, class Hook = NoChunks>
__device__ __forceinline__ void gemm_sm90_mainloop(const CUtensorMap* tmA, const CUtensorMap* tmW,
                                                   int K, unsigned char* smem_raw,
                                                   typename G::Acc (&acc)[G::BN / 2],
                                                   int every = 0, Hook hook = Hook()) {
  using T = typename G::Elem;
  constexpr int BN = G::BN;
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::STAGES * G::STAGE_BYTES);
  unsigned* done = reinterpret_cast<unsigned*>(full + G::STAGES);
  const int tid = threadIdx.x, lane = tid % 32, g = tid / 128;
  const int m0 = blockIdx.y * G::BM, n0 = blockIdx.x * BN;
  const int KT = (K + G::BK - 1) / G::BK;

  if (tid == 0) {
    for (int s = 0; s < G::STAGES; ++s) {
      mbar_init(&full[s], 1);
      done[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto load = [&](int kt) {
    const int s = kt % G::STAGES;
    unsigned char* base = smem + s * G::STAGE_BYTES;
    mbar_expect_tx(&full[s], G::STAGE_BYTES);
    tma_load_2d(base, tmA, &full[s], kt * G::BK, m0);
    tma_load_2d(base + G::A_BYTES, tmW, &full[s], kt * G::BK, n0);
  };
  if (tid == 0)
    for (int kt = 0; kt < G::STAGES && kt < KT; ++kt) load(kt);

#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  const uint64_t da = desc_sw128(smem + g * 64 * 128), db = desc_sw128(smem + G::A_BYTES);
  const int chunk = every > 0 ? every : KT;
  int kt = 0;
  for (int c = 0; kt < KT; ++c) {
    for (const int ke = min(kt + chunk, KT); kt < ke; ++kt) {
      const int s = kt % G::STAGES;
      mbar_wait(&full[s], (kt / G::STAGES) & 1);
      fence_regs(acc);
      wgmma_fence();
      const uint64_t off = (uint64_t)(s * G::STAGE_BYTES) >> 4;
      wgmma_stage<T, BN>(acc, da + off, db + off);
      wgmma_commit();
      wgmma_wait<1>();  // k-tile kt - 1's products are done: its stage is free
      fence_regs(acc);
      if (kt > 0 && lane == 0 && atomicAdd(&done[(kt - 1) % G::STAGES], 1u) % 8 == 7 &&
          kt - 1 + G::STAGES < KT)
        load(kt - 1 + G::STAGES);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    hook(c);
  }
}

}  // namespace
