// K8: 8-connected connected-component labelling by max-label propagation,
// one map per thread-block cluster, on sm_90a.
//
// Replaces samcarriestheburden_tpu/ops/ccl.py:connected_components_pallas
// (_ccl_prop_kernel).  Per (H, W) map:
//    init[p]   = (row * W + col + 1) * (mask[p] > 0.5)
//    step(L)[p] = L[p] > 0 ? max of L over the 3x3 window around p : 0
// run in chunks of n = min(check_every, num_iterations - i) steps, stopping
// at the cap or after a chunk that changed nothing.  Labels only grow and the
// background stays 0, so the foreground is exactly L > 0 at every step (no
// mask buffer), and "the chunk changed nothing" is "no step of the chunk
// changed a pixel".  Steps are Jacobi (each reads only the previous step's
// labels): truncated results depend on it.  Outputs: int32 labels (M, H, W),
// and per map the converged flag and the number of steps run.
//
// What bounds it on the card: each step takes a 3x3 max of every label of
// the map, so at ~150 steps per map the work is ~10^3 operations per byte of
// mask read and label written: the INT32 pipes bound it, provided the labels
// never leave the chip between steps.  The TPU kernel keeps one map in VMEM;
// a (384, 224) int32 map is 344 KB, more than one block's 227 KB of shared
// memory, so a cluster of CS blocks owns one map and block k owns its band of
// R = ceil(H / CS) rows.  Two kernels, chosen by (H, W) alone
// (kernels/ccl.py:geometry mirrors the choice):
//
// ccl_reg_kernel, the main path's (maps of up to 256 columns and 8 x 96 rows):
//   * labels live in registers.  16 warps each hold 8 rows of the band's
//     extended rows (its R <= 96 rows and kHalo rows above and below); each
//     lane holds COLS = ceil(W / 32) neighbouring columns of those rows.  A
//     step's 3 x 3 max is a horizontal 3-max (the lanes' edge columns by
//     __shfl) then a vertical 3-max down the warp's rows; a warp's first and
//     last rows meet the warps above and below through one shared-memory
//     row each (double-buffered, one __syncthreads per step).
//   * temporal blocking: the cluster meets once per group of up to kDepth
//     steps, not once per step.  At that barrier every block publishes its
//     own top and bottom kHalo rows in shared memory and then reads its
//     neighbours' (distributed shared memory) into its halo rows; it then
//     runs the group's steps with no cluster barrier, recomputing the halo
//     redundantly.  After step j only rows at least j rows inside the halo's
//     outer edge are exact, so kHalo >= kDepth keeps the band's own rows exact.
//     A group never crosses a chunk's end (a chunk of n steps runs groups of
//     kDepth and then n mod kDepth), and the chunk's "changed" bit is taken
//     over the band's own rows only: labels only grow, so a row's sum grows
//     iff one of its labels changed.
// ccl_prop_kernel, every other map the parent kernel took (wide or tall maps):
//   the band in two shared-memory buffers, one cluster barrier per step.
//
// Both end a chunk with one cluster-wide OR: every block writes its
// "changed" bit into a slot of every block's flag array, double-buffered by
// chunk parity, before the chunk's last barrier, so every thread of the
// cluster takes the same decision.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxCluster = 8;

// The band's view of one step's labels: its own rows in shared memory, the
// neighbours' edge rows through distributed shared memory, 0 beyond the map.
struct Band {
  const int* own;    // [nrows][W]
  const int* above;  // the row above the band (neighbour's last row), or nullptr
  const int* below;  // the row below the band (neighbour's first row), or nullptr
  int nrows, W;

  __device__ __forceinline__ const int* row(int r) const {
    if (r < 0) return above;
    if (r >= nrows) return below;
    return own + r * W;
  }
  // max of row r over columns c-1..c+1; *center = row r at column c
  __device__ __forceinline__ int hmax(int r, int c, int* center) const {
    const int* p = row(r);
    if (p == nullptr) {
      *center = 0;
      return 0;
    }
    int v = p[c];
    *center = v;
    if (c > 0) v = max(v, p[c - 1]);
    if (c + 1 < W) v = max(v, p[c + 1]);
    return v;
  }
};

__global__ void __launch_bounds__(kThreads, 1)
ccl_prop_kernel(const float* __restrict__ mask, int* __restrict__ labels,
                int* __restrict__ converged, int* __restrict__ steps, int H, int W, int R,
                int num_iterations, int check_every) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int map = blockIdx.x / cs;
  const int row0 = rank * R;
  const int nrows = max(0, min(R, H - row0));
  const int tid = threadIdx.x;

  extern __shared__ int smem[];                // two label buffers of R x W
  __shared__ int flags[2][kMaxCluster];        // per chunk parity, per rank

  const size_t base = (size_t)map * H * W + (size_t)row0 * W;
  for (int i = tid; i < nrows * W; i += blockDim.x)
    smem[i] = mask[base + i] > 0.5f ? row0 * W + i + 1 : 0;

  // A band with rows has full bands above it; the band below has rows iff
  // the map goes on past this band's R rows.
  const bool has_above = rank > 0 && row0 < H;
  const bool has_below = row0 + R < H;

  // Work items: column c, segment s of the band's rows; each thread walks
  // its segment down the column, keeping the row maxima above and at the
  // current row in registers (3 shared-memory reads and 1 write per pixel).
  const int nseg = max(1, min((int)blockDim.x / W, nrows));
  const int seg_len = nrows > 0 ? (nrows + nseg - 1) / nseg : 0;

  cluster.sync();  // every band initialised before any neighbour reads it

  int cur = 0, i = 0, chunk = 0;
  bool done = false;
  while (i < num_iterations && !done) {
    const int n = min(check_every, num_iterations - i);
    bool changed = false;
    for (int s = 0; s < n; ++s) {
      int* src = smem + cur * R * W;
      int* out = smem + (cur ^ 1) * R * W;
      const Band band{src,
                      has_above ? cluster.map_shared_rank(src, rank - 1) + (R - 1) * W : nullptr,
                      has_below ? cluster.map_shared_rank(src, rank + 1) : nullptr, nrows, W};
      for (int it = tid; it < W * nseg; it += blockDim.x) {
        const int c = it % W, r0 = (it / W) * seg_len;
        const int r1 = min(r0 + seg_len, nrows);
        if (r0 >= r1) continue;
        int old, unused;
        int hp = band.hmax(r0 - 1, c, &unused);
        int hc = band.hmax(r0, c, &old);
        for (int r = r0; r < r1; ++r) {
          int next_center;
          const int hn = band.hmax(r + 1, c, &next_center);
          const int v = old > 0 ? max(max(hp, hc), hn) : 0;
          out[r * W + c] = v;
          changed |= v != old;
          hp = hc;
          hc = hn;
          old = next_center;
        }
      }
      cur ^= 1;
      if (s == n - 1) {
        const int any = __syncthreads_or(changed);
        if (tid < cs) *cluster.map_shared_rank(&flags[chunk & 1][rank], tid) = any;
      }
      cluster.sync();  // the step (and the chunk's flags) visible cluster-wide
    }
    int any = 0;
    for (int k = 0; k < cs; ++k) any |= flags[chunk & 1][k];
    done = any == 0;
    i += n;
    ++chunk;
  }

  for (int k = tid; k < nrows * W; k += blockDim.x) labels[base + k] = smem[cur * R * W + k];
  if (rank == 0 && tid == 0) {
    converged[map] = done ? 1 : 0;
    steps[map] = i;
  }
}

// ---------------------------------------------------------------------------
// ccl_reg_kernel: labels in registers, up to kDepth steps per cluster barrier
// ---------------------------------------------------------------------------

constexpr int kRegWarps = 16;
constexpr int kRegThreads = 32 * kRegWarps;
constexpr int kRowsPerWarp = 8;
constexpr int kExtRows = kRegWarps * kRowsPerWarp;   // a band's rows and its two halos
constexpr int kHalo = 16;                            // halo rows above and below a band
constexpr int kDepth = 16;                           // steps per cluster barrier
constexpr int kMaxBand = kExtRows - 2 * kHalo;       // 96 rows
constexpr int kMaxCols = 8;                          // columns per lane: W <= 256
static_assert(kHalo >= kDepth, "a group of kDepth steps needs a halo of kDepth rows");

__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait_acquire() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Dynamic shared memory of one block, in ints: the published edge rows
// [parity][top, bottom][kHalo][COLS][32] and the warps' boundary rows of the
// horizontal max [parity][warp][first, last][COLS][32]; both lane-minor, so
// a warp's 32 lanes touch 32 consecutive words.
constexpr size_t reg_smem_ints(int cols) {
  return (size_t)2 * 2 * kHalo * cols * 32 + (size_t)2 * kRegWarps * 2 * cols * 32;
}

// In registers a foreground label l is kept as l | kFg and the background as
// 0: the order of labels is unchanged, and the gate "L > 0 ? m : 0" becomes
// one unsigned min(L + L, m) (VIADDMNMX): 2 L >= 2^31 > m for the
// foreground (l < 2^18), 0 for the background.
constexpr unsigned kFg = 1u << 30;

// h = the horizontal 3-max of one row held as COLS columns per lane; the
// columns beyond the lanes' 32 * COLS count as 0 (background)
template <int COLS>
__device__ __forceinline__ void hmax_row(const unsigned (&row)[COLS], unsigned (&h)[COLS],
                                         int lane) {
  unsigned left = __shfl_up_sync(0xffffffffu, row[COLS - 1], 1);
  unsigned right = __shfl_down_sync(0xffffffffu, row[0], 1);
  if (lane == 0) left = 0;
  if (lane == 31) right = 0;
#pragma unroll
  for (int j = 0; j < COLS; ++j)
    h[j] = __vimax3_u32(j > 0 ? row[j - 1] : left, row[j], j + 1 < COLS ? row[j + 1] : right);
}

template <int COLS>
__global__ void __launch_bounds__(kRegThreads, 1)
ccl_reg_kernel(const float* __restrict__ mask, int* __restrict__ labels,
               int* __restrict__ converged, int* __restrict__ steps, int H, int W, int R,
               int num_iterations, int check_every) {
  constexpr int kRowInts = COLS * 32;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int map = blockIdx.x / cs;
  const int row0 = rank * R;
  const int nrows = max(0, min(R, H - row0));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int e0 = warp * kRowsPerWarp;   // extended row e is the map's row row0 - kHalo + e
  const int below_rows = max(0, min(R, H - row0 - R));   // the neighbour below's own rows
  const bool has_above = rank > 0 && nrows > 0;
  const bool has_below = rank + 1 < cs && below_rows > 0;

  extern __shared__ unsigned usmem[];
  unsigned* const pub = usmem;                             // [2][2][kHalo][kRowInts]
  unsigned* const hb = usmem + 2 * 2 * kHalo * kRowInts;   // [2][kRegWarps][2][kRowInts]
  __shared__ int flags[2][kMaxCluster];                    // per chunk parity, per rank

  // Bit r of `own` is set if the warp's row e0 + r is one of the band's own
  // rows; of `top` / `bottom` if it is one of the kHalo own rows that the
  // neighbour above / below reads; of `up` / `down` if it is a halo row
  // filled from the neighbour above / below.  Every other row is 0 for good.
  unsigned own = 0, top = 0, bottom = 0, up = 0, down = 0;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int e = e0 + r;
    const bool mine = e >= kHalo && e < kHalo + nrows;
    own |= (unsigned)mine << r;
    top |= (unsigned)(mine && e < 2 * kHalo) << r;
    bottom |= (unsigned)(mine && e >= nrows) << r;
    up |= (unsigned)(has_above && e < kHalo) << r;
    down |= (unsigned)(has_below && e >= kHalo + nrows &&
                       e < kHalo + nrows + min(kHalo, below_rows)) << r;
  }

  unsigned L[kRowsPerWarp][COLS];
  const float* const mmap = mask + (size_t)map * H * W;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int g = row0 - kHalo + e0 + r;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int c = lane * COLS + j;
      const bool fg = ((own >> r) & 1) && c < W && mmap[(size_t)g * W + c] > 0.5f;
      L[r][j] = fg ? (unsigned)(g * W + c + 1) | kFg : 0u;
    }
  }

  // own top rows -> pub[par][0], own bottom rows -> pub[par][1]
  auto publish = [&](int par) {
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int e = e0 + r;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        if ((top >> r) & 1)
          pub[((par * 2 + 0) * kHalo + e - kHalo) * kRowInts + j * 32 + lane] = L[r][j];
        if ((bottom >> r) & 1)
          pub[((par * 2 + 1) * kHalo + e - nrows) * kRowInts + j * 32 + lane] = L[r][j];
      }
    }
  };
  // halo rows <- the neighbours' rows published with parity par
  auto pull = [&](int par) {
    const unsigned* above = cluster.map_shared_rank(pub, has_above ? rank - 1 : rank) +
                            (par * 2 + 1) * kHalo * kRowInts;
    const unsigned* below = cluster.map_shared_rank(pub, has_below ? rank + 1 : rank) +
                            (par * 2 + 0) * kHalo * kRowInts;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int e = e0 + r;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        if ((up >> r) & 1) L[r][j] = above[e * kRowInts + j * 32 + lane];
        if ((down >> r) & 1) L[r][j] = below[(e - kHalo - nrows) * kRowInts + j * 32 + lane];
      }
    }
  };
  // the sum of this thread's own labels, mod 2^32: a chunk raises it by
  // less than 2^32 (64 labels below 2^18 each), and by more than 0 iff a
  // label changed
  auto own_sum = [&]() {
    unsigned sum = 0;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int j = 0; j < COLS; ++j) sum += ((own >> r) & 1) ? L[r][j] : 0u;
    return sum;
  };
  // one Jacobi step of the extended band, rolling down the warp's rows: the
  // horizontal 3-max of rows r - 1, r, r + 1, then their vertical 3-max
  int hpar = 0;
  auto step = [&]() {
    unsigned first[COLS], last[COLS], prev[COLS], cur[COLS], next[COLS];
    hmax_row<COLS>(L[0], first, lane);
    hmax_row<COLS>(L[kRowsPerWarp - 1], last, lane);
    unsigned* const hw = hb + hpar * kRegWarps * 2 * kRowInts;
    hpar ^= 1;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      hw[(warp * 2 + 0) * kRowInts + j * 32 + lane] = first[j];
      hw[(warp * 2 + 1) * kRowInts + j * 32 + lane] = last[j];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      prev[j] = warp > 0 ? hw[((warp - 1) * 2 + 1) * kRowInts + j * 32 + lane] : 0u;
      cur[j] = first[j];
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      if (r + 1 == kRowsPerWarp) {
#pragma unroll
        for (int j = 0; j < COLS; ++j)
          next[j] = warp + 1 < kRegWarps ? hw[((warp + 1) * 2 + 0) * kRowInts + j * 32 + lane] : 0u;
      } else if (r + 2 == kRowsPerWarp) {
#pragma unroll
        for (int j = 0; j < COLS; ++j) next[j] = last[j];
      } else {
        hmax_row<COLS>(L[r + 1], next, lane);
      }
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        L[r][j] = __viaddmin_u32(L[r][j], L[r][j], __vimax3_u32(prev[j], cur[j], next[j]));
        prev[j] = cur[j];
        cur[j] = next[j];
      }
    }
  };

  int par = 0;
  if (cs > 1) publish(par);
  cluster_arrive_release();
  cluster_wait_acquire();

  int i = 0, chunk = 0;
  unsigned sum0 = own_sum();
  bool done = false;
  while (i < num_iterations && !done) {
    const int n = min(check_every, num_iterations - i);
    for (int s = 0, g; s < n; s += g) {     // groups of kDepth steps, the last one shorter
      g = min(kDepth, n - s);
      if (cs > 1) pull(par);
      par ^= 1;
      for (int t = 0; t < g; ++t) step();
      if (s + g == n) {                     // the chunk's end: its "changed" bit, cluster-wide
        const unsigned sum1 = own_sum();
        const int any = __syncthreads_or(sum1 != sum0);
        sum0 = sum1;
        if (threadIdx.x < cs) *cluster.map_shared_rank(&flags[chunk & 1][rank], threadIdx.x) = any;
      }
      if (cs > 1) publish(par);
      cluster_arrive_release();   // the next group's edge rows (and the chunk's flags) visible
      cluster_wait_acquire();
    }
    int any = 0;
    for (int k = 0; k < cs; ++k) any |= flags[chunk & 1][k];
    done = any == 0;
    i += n;
    ++chunk;
  }

  int* const lmap = labels + (size_t)map * H * W;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int g = row0 - kHalo + e0 + r;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int c = lane * COLS + j;
      if (((own >> r) & 1) && c < W) lmap[(size_t)g * W + c] = (int)(L[r][j] & (kFg - 1));
    }
  }
  if (rank == 0 && threadIdx.x == 0) {
    converged[map] = done ? 1 : 0;
    steps[map] = i;
  }
}

// One map per cluster of cluster_size blocks of `threads` threads.
template <typename Kernel>
cudaError_t launch(Kernel kernel, int threads, size_t smem, int maps, int cluster_size,
                   cudaStream_t stream, const float* mask, int* labels, int* converged,
                   int* steps, int H, int W, int R, int num_iterations, int check_every) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(maps * cluster_size);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster_size;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, mask, labels, converged, steps, H, W, R,
                            num_iterations, check_every);
}

}  // namespace

// mask (maps, H, W) fp32; labels (maps, H, W) int32; converged, steps (maps,)
// int32.  cluster_size in {1, 2, 4, 8}.  cols_per_lane 0 runs ccl_prop_kernel
// (the band's two R x W int32 buffers, R = ceil(H / cluster_size), must fit
// one block's shared memory); 1..kMaxCols runs ccl_reg_kernel, which needs
// W <= 32 * cols_per_lane and R <= kMaxBand.  kernels/ccl.py:geometry picks
// both from (H, W).
extern "C" int k8_ccl_propagate(const void* mask, void* labels, void* converged, void* steps,
                                int maps, int H, int W, int num_iterations, int check_every,
                                int cluster_size, int cols_per_lane, void* stream) {
  if (maps < 1 || H < 1 || W < 1 || check_every < 1 || cluster_size < 1 ||
      cluster_size > kMaxCluster || (cluster_size & (cluster_size - 1)) || cols_per_lane < 0 ||
      cols_per_lane > kMaxCols)
    return cudaErrorInvalidValue;
  const int R = (H + cluster_size - 1) / cluster_size;
  // the register kernel's halo comes from the neighbours' own rows: R >= kHalo
  if (cols_per_lane > 0 &&
      (W > 32 * cols_per_lane || R > kMaxBand || (cluster_size > 1 && R < kHalo)))
    return cudaErrorInvalidValue;
  const float* m = static_cast<const float*>(mask);
  int *l = static_cast<int*>(labels), *c = static_cast<int*>(converged);
  int* s = static_cast<int*>(steps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (cols_per_lane) {
    case 0:
      err = launch(ccl_prop_kernel, kThreads, 2 * (size_t)R * W * sizeof(int), maps,
                   cluster_size, st, m, l, c, s, H, W, R, num_iterations, check_every);
      break;
#define K8_REG(N)                                                                          \
    case N:                                                                                \
      err = launch(ccl_reg_kernel<N>, kRegThreads, reg_smem_ints(N) * sizeof(int), maps,   \
                   cluster_size, st, m, l, c, s, H, W, R, num_iterations, check_every);    \
      break;
    K8_REG(1) K8_REG(2) K8_REG(3) K8_REG(4) K8_REG(5) K8_REG(6) K8_REG(7) K8_REG(8)
#undef K8_REG
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
