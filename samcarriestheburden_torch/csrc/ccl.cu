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
// What bounds it on the card: each step reads every label of the map 3 times
// (a separable 3x3 max down each column) and writes it once, so at ~200
// steps per map the work is ~10^3 operations per byte of mask read and label
// written: the INT32 pipes bound it, provided the labels never leave the
// chip between steps.  The TPU kernel keeps one map in VMEM; a (384, 224)
// int32 map is 344 KB, and Jacobi needs two of them, more than one block's
// 227 KB of shared memory.  So a cluster of CS blocks (CS = 1, 2, 4 or 8,
// the smallest that fits) owns one map: block k keeps rows [k R, k R + R) in
// two shared-memory buffers, reads the row above and the row below its band
// from its neighbours' shared memory (distributed shared memory), and the
// cluster meets at one barrier per step.  The chunk's exit is one
// cluster-wide OR: every block writes its "changed" bit into a slot of every
// block's flag array, double-buffered by chunk parity, before the chunk's
// last barrier, so every thread of the cluster takes the same decision.
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

}  // namespace

// mask (maps, H, W) fp32; labels (maps, H, W) int32; converged, steps (maps,)
// int32.  cluster_size in {1, 2, 4, 8}: the band is R = ceil(H / cluster_size)
// rows, and its two R x W int32 buffers must fit one block's shared memory.
extern "C" int k8_ccl_propagate(const void* mask, void* labels, void* converged, void* steps,
                                int maps, int H, int W, int num_iterations, int check_every,
                                int cluster_size, void* stream) {
  if (maps < 1 || H < 1 || W < 1 || check_every < 1 || cluster_size < 1 ||
      cluster_size > kMaxCluster || (cluster_size & (cluster_size - 1)))
    return cudaErrorInvalidValue;
  const int R = (H + cluster_size - 1) / cluster_size;
  const size_t smem = 2 * (size_t)R * W * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(ccl_prop_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(maps * cluster_size);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster_size;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ccl_prop_kernel, static_cast<const float*>(mask),
                           static_cast<int*>(labels), static_cast<int*>(converged),
                           static_cast<int*>(steps), H, W, R, num_iterations, check_every);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
