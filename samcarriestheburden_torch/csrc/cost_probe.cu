// K13: the bench's cost probe, o = x * 2.0 over a bf16 tensor, on sm_90a.
//
// Replaces bench.py:104 (the pallas_call of `pf`/`kern` inside
// flops_convention_check): a custom kernel launched with a declared cost, so
// the bench can check that the declared cost reaches the program's counted
// total.  On this side the declaration is the flop formula of the custom op
// that wraps this kernel (kernels/cost_probe.py); the kernel itself is the
// probe's function.
//
// What bounds it: one read and one write of every element and one multiply,
// far below the card's ops-per-byte ridge, so memory bounds it.  Each thread
// moves 16 bytes (8 bf16) each way in a grid-stride loop; the few elements
// past the last whole 16-byte chunk are taken one by one.  Doubling a bf16
// value in fp32 and rounding back is exact (inf and NaN stay), so the result
// is bit for bit PyTorch's x * 2.0.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(256)
cost_probe_kernel(const bf16* __restrict__ x, bf16* __restrict__ out, long long n) {
  const long long nvec = n / 8;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < nvec; i += step) {
    uint4 raw = reinterpret_cast<const uint4*>(x)[i];
    __nv_bfloat162* v = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(v[e]);
      v[e] = __floats2bfloat162_rn(f.x * 2.f, f.y * 2.f);
    }
    reinterpret_cast<uint4*>(out)[i] = raw;
  }
  if (blockIdx.x == 0)
    for (long long j = nvec * 8 + threadIdx.x; j < n; j += blockDim.x)
      out[j] = __float2bfloat16(__bfloat162float(x[j]) * 2.f);
}

}  // namespace

// x, out: n bf16 values, 16-byte aligned.
extern "C" int k13_cost_probe(const void* x, void* out, long long n, void* stream) {
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const long long nvec = n / 8;
  const int blocks = (int)(nvec / 256 + 1 < 132 * 8 ? nvec / 256 + 1 : 132 * 8);
  cost_probe_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(out), n);
  return cudaGetLastError();
}
