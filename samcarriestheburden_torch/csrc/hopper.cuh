// The Hopper (sm_90a) building blocks of the port's TMA + wgmma kernels:
// mbarriers, TMA copies and their tensor maps, the async-proxy fence, named
// barriers and the wgmma fence / commit / wait, and the shared-memory
// descriptors of swizzled operands.  Included by global_attention.cuh (and
// through it window_attention.cuh) and by gemm_sm90.cuh, whose mainloop runs on
// the last section's 2-D maps and 128-byte swizzle.
#pragma once

#include <cuda.h>

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// mbarriers, TMA and wgmma (PTX ISA 8.0, sm_90a)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_addr(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_addr(bar)) : "memory");
}
// returns once the phase of the given parity has completed; a phase that
// never completes (a copy that never lands) traps after 2^28 polls, seconds,
// and the launch fails, where it would otherwise hang the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    if (done) return;
    if (polls == (1u << 28)) __trap();
  }
}

// one box of a 3-D tensor map at (column, row, sequence) into shared memory,
// its bytes counted on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int col, int row, int seq) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)),
         "r"(col), "r"(row), "r"(seq)
      : "memory");
}

// shared-memory writes of the generic proxy (threads' stores) made visible to
// the async proxy (wgmma's and TMA's accesses)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// a barrier among `count` threads (a multiple of 32) on hardware barrier `id`
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// wait until at most N committed wgmma groups of this warp are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keep the compiler from moving accesses of an accumulator across a wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// The wgmma descriptor of a 32-byte-swizzled operand in shared memory:
// lbo / sbo the byte strides between 32-byte column groups (MN-major only)
// and between 8-row groups.  The tiles sit at 1024-byte boundaries, so the
// swizzle's base offset is 0.
__device__ __forceinline__ uint64_t desc_sw32(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr(p) >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (3ull << 62);
}
// a K-major box (rows of 32 bytes): 8-row groups 256 bytes apart
__device__ __forceinline__ uint64_t desc_kmajor(const void* p) { return desc_sw32(p, 16, 256); }

// byte offset of (row, byte b < 32) in a 32-byte-swizzled tile of 32-byte rows:
// the 16-byte half flips on row bit 2 (TMA's CU_TENSOR_MAP_SWIZZLE_32B)
__device__ __forceinline__ int sw32(int row, int b) { return row * 32 + (b ^ ((row & 4) << 2)); }

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime's
// entry-point query, so that the library needs no link against libcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// ---------------------------------------------------------------------------
// 2-D tiles in the 128-byte swizzle (the GEMM mainloop, gemm_sm90.cuh)
// ---------------------------------------------------------------------------

// one box of a 2-D tensor map at (column, row) into shared memory, its bytes
// counted on bar
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)),
         "r"(col), "r"(row)
      : "memory");
}

// The wgmma descriptor of a K-major operand in the 128-byte swizzle: rows of
// 128 bytes, 8-row groups 1024 bytes apart (the leading offset is unused in
// this layout).  The tile sits at a 1024-byte boundary, so the swizzle's base
// offset is 0; a k-step of 32 bytes inside the row adds 2 to the descriptor.
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return (uint64_t)((smem_addr(p) >> 4) & 0x3FFF) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

// A 2-D map over a row-major (rows, cols) matrix of `elem`-byte elements,
// boxes of 128 bytes x box_rows, 128-byte swizzled; rows past `rows` and
// columns past `cols` read zeros.  False where TMA cannot take the operand (a
// base or a row pitch not 16-byte aligned).
bool encode_map_2d(CUtensorMap* map, const void* base, CUtensorMapDataType type, int elem,
                   int cols, int rows, int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr || reinterpret_cast<uintptr_t>(base) % 16 || (size_t)cols * elem % 16)
    return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / elem), (cuuint32_t)box_rows};
  const cuuint32_t estride[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, estride,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
