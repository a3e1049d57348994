// Warp-level building blocks shared by the port's kernels: cp.async copies
// into shared memory, ldmatrix fragment loads and the m16n8k16 bf16 tensor
// core product (mma.sync, fp32 accumulate).  Fragment layouts follow the
// PTX ISA for mma.m16n8k16 with .row.col operands:
//   A (16x16): a0 = (r, c..c+1), a1 = (r+8, c..), a2 = (r, c+8..), a3 = (r+8, c+8..)
//   B (16x8):  b0 = (k..k+1, n), b1 = (k+8.., n)
//   C (16x8):  c0,c1 = (r, c..c+1), c2,c3 = (r+8, c..c+1)
// with r = lane/4, c = k = 2*(lane%4), n = lane/4.  (The int8 products run on
// wgmma: hopper.cuh, gemm_sm90.cuh, global_attention.cuh.)
//
// Below them, the bf16 GEMM mainloop of K1 and K3 (csrc/mlp.cu): one block's
// 128 x 128 tile of A[M, K] @ W[N, K]^T into registers, the epilogue left to
// its kernel.  K2, K4, K14 and K15 run the TMA + wgmma mainloop of
// gemm_sm90.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_bytes = 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats -> one register of two bf16, the lower column in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---------------------------------------------------------------------------
// The tiled tensor-core GEMM mainloop.  A block of 256 threads (8 warps in a
// 2 x 4 grid, each owning 64 x 32 of the output) computes the 128 x 128 tile
// at (blockIdx.y, blockIdx.x) of A[M, K] @ W[N, K]^T, rows of A and W
// K-contiguous, through a three-stage cp.async ring of k-tiles; rows past M or
// N and k past K load as zeros (K must be a multiple of 16 bytes).  The
// accumulator fragment of warp (wm, wn) = (warp / 4, warp % 4): acc[mi][ni][e]
// is row wm*64 + mi*16 + lane/4 + 8*(e/2), column wn*32 + ni*8 + 2*(lane%4) +
// e%2 of the tile.
// ---------------------------------------------------------------------------

namespace gemm_bf16 {  // 32 contracted bf16 per stage, rows padded to 80 bytes
constexpr int BM = 128, BN = 128, BK = 32, STAGES = 3, LDS = BK + 8;
constexpr int THREADS = 256;
constexpr int SMEM = STAGES * (BM + BN) * LDS * (int)sizeof(bf16);
}  // namespace gemm_bf16

__device__ __forceinline__ void gemm_bf16_mainloop(const bf16* __restrict__ A,
                                                   const bf16* __restrict__ W, int M, int N,
                                                   int K, unsigned char* smem,
                                                   float (&acc)[4][4][4]) {
  using namespace gemm_bf16;
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = sA + STAGES * BM * LDS;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;  // 2 x 4 warps, 64 x 32 each
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int KT = (K + BK - 1) / BK;

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < (BM * BK / 8) / THREADS; ++i) {
      const int c = tid + i * THREADS;
      const int r = c >> 2, kc = (c & 3) * 8;
      const int gk = k0 + kc;
      const bool oka = m0 + r < M && gk < K;
      cp_async16(sA + (stage * BM + r) * LDS + kc,
                 oka ? A + (size_t)(m0 + r) * K + gk : A, oka ? 16 : 0);
      const bool okb = n0 + r < N && gk < K;
      cp_async16(sB + (stage * BN + r) * LDS + kc,
                 okb ? W + (size_t)(n0 + r) * K + gk : W, okb ? 16 : 0);
    }
  };

#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

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

    const bf16* a_s = sA + (kt % STAGES) * BM * LDS;
    const bf16* b_s = sB + (kt % STAGES) * BN * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(af[mi], a_s + (wm * 64 + mi * 16 + (lane & 15)) * LDS + kk + (lane >> 4) * 8);
      uint32_t bfr[4][2];
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t r[4];
        ldmatrix_x4(r, b_s + (wn * 32 + nj * 16 + (lane & 7) + (lane >> 4) * 8) * LDS + kk +
                           ((lane >> 3) & 1) * 8);
        bfr[2 * nj][0] = r[0];
        bfr[2 * nj][1] = r[1];
        bfr[2 * nj + 1][0] = r[2];
        bfr[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
    }
  }
  cp_async_wait<0>();
}
