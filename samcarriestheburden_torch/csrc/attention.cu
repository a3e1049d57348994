// K5, K6, K7, K7-int8, K9, K10 and K11: attention with the decomposed
// relative-position bias of SAM's ViT encoder, on sm_90a.
//
// K5 replaces samcarriestheburden_tpu/kernels/attention.py:fused_rel_attention_window3d
//    (one 14x14 window per sequence, 200 slots of which 196 are live keys),
// K6 replaces samcarriestheburden_tpu/kernels/attention.py:fused_rel_attention_window_rect
//    (an edge window of the compact layout: only its QH x QW image cells are
//    carried; the other cells of the 14x14 window are zero-pad tokens; below),
// K7 replaces samcarriestheburden_tpu/kernels/attention.py:fused_rel_attention_global3d
//    with int8_qk=False (the whole 64x64 grid, 4096 keys),
// K7-int8 the same TPU kernel with int8_qk=True (below).
// Both compute, per sequence s, head h and query i at grid cell (ph, pw):
//    rel_h[i, kh] = bf16(q_i . Rh[ph - kh + KH - 1] / scale)      (same for w)
//    logit[i, j] = scale * (q_i . k_j + rel_h[i, kh(j)] + rel_w[i, kw(j)])
//    out_i       = softmax_j(logit) . v
// over the live keys j < nkeys (dead slots get no weight).  The bf16
// rounding of the rel terms at 1/scale is the TPU kernel's own.  Input qkv is
// (nseq, nrows, heads * 3 * HD) with each head's [q | k | v] columns side by
// side (the port's per-head grouping); output is token-major
// (nseq, nrows, heads, HD), ready for the output projection.
//
// What bounds them on the card: K7 does 2 x 4096 x 4096 x 80 x 2 operations
// per (image, head) on 1.3 MB of q/k/v, so tensor-core throughput bounds it.
// K5's 14x14 windows do ~110 operations per byte of qkv read and output
// written, below the card's ~295 ops/byte ridge, so memory bounds it: each
// window's q/k/v must be read once.  Two kernels, both flash-attention loops
// that keep an online softmax, so no logit row ever leaves the registers (a
// 4096-wide fp32 row per query would not fit in shared memory):
//   * the windows (K5, K6, K9 on windows, K10) and K7's int8 p . v pair run
//     rel_attention_kernel (rel_attention.cuh) on mma.sync: a block owns NW x
//     16 query rows of one (sequence, head), keeps its q fragments in
//     registers and streams 64-key K/V tiles through a two-stage cp.async
//     ring.  K5 runs 13 warps so one block holds all 200 rows of a window and
//     reads its q/k/v once.
//   * the global grid (K7, K7-int8, K9 on a sequence longer than 208 rows,
//     K11) runs global_attention_kernel (global_attention.cuh): 128 query rows
//     per block in two warpgroups, K/V tiles by TMA through an mbarrier ring,
//     both products on wgmma.
// In both the rel-pos terms are one small product of q against the packed
// tables at block start, scattered to a per-row (KH + KW)-entry table in
// shared memory, padded so that no rel-term load is a bank conflict; the TPU
// kernel's lane rolls and reversed key index were a TPU layout device and are
// not carried over.
//
// K6 is the same kernel with a query grid of (QH, QW) inside the key grid of
// (KH, KW): carried slot t sits at window cell (min(t / QW, QH - 1), t % QW),
// as a query and as a key, and the rel tables are the full window's.  The
// KH*KW - QH*QW cells outside the rectangle are pad keys, whose k and v are
// the qkv bias b_k, b_v of the head (rounded to bf16, as the flat layout's
// K1/K2 writes them for a zero-masked row).  They never touch the tensor
// cores: after the real tiles each row takes one fp32 dot q_i . b_k and, per
// pad cell, its two rel terms from the same per-row table, folds those logits
// into the running maximum and sum of the online softmax, and adds
// (sum of pad weights) * b_v to its accumulator, in fp32.  7 warps hold a
// whole 112-slot window (14x8 or 8x14).  Its bound is bytes, ~3 us per group
// of the compact ViT-H layout: launch latency, not the bound, sets its time.
//
// K7-int8 computes q . k on the int8 tensor cores (wgmma m64n64k32 s8):
//    sk[c]  = absmax_j |k[j, c]| / 127 + 1e-12       per (sequence, head, channel)
//    ki     = rint(k / sk)                            int8
//    qs     = q * sk;  sq[i] = absmax_c |qs[i, c]| / 127 + 1e-12;  qi = rint(qs / sq)
//    logit[i, j] = scale * (int32(qi . ki_j) * sq[i] + (rel_h[i, kh(j)] + rel_w[i, kw(j)]))
// with the rel terms from the unquantized q as above, and the softmax and
// p . v of K7 in bf16.  sk needs every key before the first tile, so two
// small passes run first: a column absmax over the keys (atomicMax on the
// float bits, which order as integers for non-negative values) and the
// quantization of k to int8 rows zero-padded from hd to a multiple of the
// 32-wide int8 k-step (80 -> 96), written once per (sequence, head) and then
// streamed by every query block in place of the bf16 keys.  The accumulant
// stays below 127^2 * 96 < 2^24, so its fp32 conversion is exact.
//
// K7-pv and K7-int8pv are K7 and K7-int8 with int8_pv=True (the same TPU
// kernel, _attn_kernel_global3d lines 615-629; opt-in, never a serving
// default): the softmax is normalised FIRST and its probabilities, and v, go
// to int8 for the p . v product:
//    sv[c] = absmax_j |v[j, c]| / 127 + 1e-12      per (sequence, head, channel)
//    vi    = rint(v / sv);   pi[i, j] = rint(127 * exp(logit[i, j] - max_i) / sum_i)
//    out_i = int32(pi_i . vi) * (sv / 127)
// pi needs each row's final max and sum before its first product, which the
// online softmax's running rescale cannot give (16 rows x 4096 fp32 logits
// are 256 KB, more than a block's shared memory).  So the block makes two
// passes over the keys: pass 1 recomputes nothing but the row max and sum,
// pass 2 recomputes the logits, forms pi and accumulates pi . vi with
// mma.sync m16n8k32 s8 -> s32.  Two small passes run first, as for K7-int8's
// keys: a column absmax of v and the quantization of v to int8, written
// channel-major (nseq, heads, hd, keys padded to 64) with the keys of each
// 32-key chunk in the order in which a thread's score fragments hold them
// (keys 2q, 2q+1, 8+2q, 9+2q, then +16), so that four int8 probabilities of a
// row pack into one A register with no shuffle and one ldmatrix takes the
// matching B fragment.  The second q . k pass is this kernel's own overhead:
// its bound counts both products once.  |acc| <= 127 * sum_j pi[i, j] <= 127 *
// (127 + nkeys / 2) < 2^24 for 4096 keys, so its fp32 conversion is exact.
//
// K9 replaces samcarriestheburden_tpu/kernels/attention.py:fused_rel_attention
//    (q, k, v split per head, (G, N, HD) each; rel_h (G, N, KH), rel_w (G, N, KW)),
// K10 replaces samcarriestheburden_tpu/kernels/attention.py:fused_rel_attention_headmajor
//    (the head-grouped qkv of K5, N = KH*KW rows and no dead slot; rel_h
//    (heads, nseq, N, KH), rel_w (heads, nseq, N, KW)),
// K11 replaces samcarriestheburden_tpu/kernels/attention.py:fused_rel_attention_headmajor_global
//    (K10 on a grid too large for one block).
// They are the same kernel with PRE set: the per-query rel terms arrive from
// device memory and are not made from q and the tables.  Step 1 fills the
// per-row table sRel with bf16(rel / scale), the rounding of the TPU kernels'
// default body, by plain 2-byte loads (a 14-entry row is 28 bytes, which
// cp.async's 16-byte alignment does not take), step 2 is skipped, and the
// flash loop is K5's and K7's.  q, k and v come through a base pointer each
// and a common row stride (a tensor map each, on the global kernel), so one
// kernel reads three (G, N, HD) tensors (K9: stride HD, one "head" per
// sequence) or one head-grouped tensor (K10, K11: stride heads * 3 * HD).
// Bounds: K9 on windows and K10 move ~100 operations per byte (q, k, v, the
// rel terms, the output) and are bound by bytes; K9 on the global grid and K11
// are K7's work without its table product and are bound by the tensor cores.
// 13 warps hold a sequence of up to 208 rows (K10; K9 on windows); the global
// kernel runs a longer one (K9) and K11 on any grid.
#include "global_attention.cuh"
#include "rel_attention.cuh"

// qkv (nseq, nrows, heads*3*hd) bf16; tab (2*kh-1 + 2*kw-1, hd) bf16 rows [Rh; Rw];
// out (nseq, nrows, heads, hd) bf16.  hd in {16, 32, 64, 80}.
extern "C" int k5_rel_attention_window(const void* qkv, const void* tab, void* out, int nseq,
                                       int nrows, int nkeys, int heads, int hd, int ws,
                                       float scale, float inv_scale, void* stream) {
  Operands op = grouped(qkv, nrows, heads, hd);
  op.tab = static_cast<const bf16*>(tab);
  return dispatch<13, false, false, false>(hd, op, out, nseq, nrows, nkeys, heads, ws, ws, ws, ws,
                                           scale, inv_scale, stream);
}

// K6: qkv (nseq, nrows, heads*3*hd) bf16 windows of rh*rw carried slots (nrows
// >= rh*rw) of a ws x ws window; tab as K5's, for the full window; bias
// (heads*3*hd) fp32, the qkv bias grouped per head like qkv's columns.
extern "C" int k6_rel_attention_window_rect(const void* qkv, const void* tab, const void* bias,
                                            void* out, int nseq, int nrows, int heads, int hd,
                                            int ws, int rh, int rw, float scale, float inv_scale,
                                            void* stream) {
  Operands op = grouped(qkv, nrows, heads, hd);
  op.tab = static_cast<const bf16*>(tab);
  op.bias = static_cast<const float*>(bias);
  return dispatch<7, false, true, false>(hd, op, out, nseq, nrows, rh * rw, heads, ws, ws, rh, rw,
                                         scale, inv_scale, stream);
}

extern "C" int k7_rel_attention_global(const void* qkv, const void* tab, void* out, int nseq,
                                       int nrows, int heads, int hd, int kh, int kw, float scale,
                                       float inv_scale, void* stream) {
  Operands op = grouped(qkv, nrows, heads, hd);
  op.tab = static_cast<const bf16*>(tab);
  return dispatch_global<false, false>(hd, op, out, nseq, nrows, heads, kh, kw, scale, inv_scale,
                                       stream);
}

// As K7, with the q . k product in int8.  Scratch: kq (nseq, nrows-major per
// head: nseq, heads, nrows, hd padded to a multiple of 32) int8 and kmax
// (nseq, heads, hd) fp32, both written here.
extern "C" int k7_rel_attention_global_int8(const void* qkv, const void* tab, void* kq,
                                            void* kmax, void* out, int nseq, int nrows,
                                            int heads, int hd, int kh, int kw, float scale,
                                            float inv_scale, void* stream) {
  Operands op = grouped(qkv, nrows, heads, hd);
  op.tab = static_cast<const bf16*>(tab);
  op.kq = static_cast<int8_t*>(kq);
  op.kmax = static_cast<float*>(kmax);
  return dispatch_global<true, false>(hd, op, out, nseq, nrows, heads, kh, kw, scale, inv_scale,
                                      stream);
}

// K7-pv (int8_qk = 0) and K7-int8pv (int8_qk = 1): K7 and K7-int8 with the
// normalised probabilities and v in int8 for p . v.  Scratch written here: vq
// (nseq, heads, hd, nrows rounded up to 64) int8 and vmax (nseq, heads, hd)
// fp32; with int8_qk also K7-int8's kq and kmax.
extern "C" int k7_rel_attention_global_pv(const void* qkv, const void* tab, void* kq, void* kmax,
                                          void* vq, void* vmax, void* out, int nseq, int nrows,
                                          int heads, int hd, int kh, int kw, int int8_qk,
                                          float scale, float inv_scale, void* stream) {
  Operands op = grouped(qkv, nrows, heads, hd);
  op.tab = static_cast<const bf16*>(tab);
  op.kq = static_cast<int8_t*>(kq);
  op.kmax = static_cast<float*>(kmax);
  op.vq = static_cast<int8_t*>(vq);
  op.vmax = static_cast<float*>(vmax);
  if (int8_qk)
    return dispatch<8, true, false, false, true>(hd, op, out, nseq, nrows, nrows, heads, kh, kw,
                                                 kh, kw, scale, inv_scale, stream);
  return dispatch<8, false, false, false, true>(hd, op, out, nseq, nrows, nrows, heads, kh, kw, kh,
                                                kw, scale, inv_scale, stream);
}

// K9: q, k, v, out (nseq, nrows, hd) bf16, one head per sequence; rel_h (nseq,
// nrows, kh) and rel_w (nseq, nrows, kw) bf16; nrows = kh * kw, every row a key.
extern "C" int k9_rel_attention_pre(const void* q, const void* k, const void* v,
                                    const void* rel_h, const void* rel_w, void* out, int nseq,
                                    int nrows, int hd, int kh, int kw, float scale,
                                    float inv_scale, void* stream) {
  Operands op = {};
  op.q = static_cast<const bf16*>(q);
  op.k = static_cast<const bf16*>(k);
  op.v = static_cast<const bf16*>(v);
  op.stride = hd;
  op.seq_stride = (size_t)nrows * hd;
  op.rel_h = static_cast<const bf16*>(rel_h);
  op.rel_w = static_cast<const bf16*>(rel_w);
  if (nrows > 13 * 16)  // the global grid
    return dispatch_global<false, true>(hd, op, out, nseq, nrows, 1, kh, kw, scale, inv_scale,
                                        stream);
  return dispatch<13, false, false, true>(hd, op, out, nseq, nrows, nrows, 1, kh, kw, kh, kw,
                                          scale, inv_scale, stream);
}

// K10: qkv (nseq, nrows, heads*3*hd) bf16 grouped per head, nrows = kh * kw <=
// 208; rel_h (heads, nseq, nrows, kh), rel_w (heads, nseq, nrows, kw) bf16;
// out (nseq, nrows, heads, hd) bf16.
extern "C" int k10_rel_attention_headmajor(const void* qkv, const void* rel_h, const void* rel_w,
                                           void* out, int nseq, int nrows, int heads, int hd,
                                           int kh, int kw, float scale, float inv_scale,
                                           void* stream) {
  if (nrows > 13 * 16) return cudaErrorInvalidValue;
  Operands op = grouped(qkv, nrows, heads, hd);
  op.rel_h = static_cast<const bf16*>(rel_h);
  op.rel_w = static_cast<const bf16*>(rel_w);
  return dispatch<13, false, false, true>(hd, op, out, nseq, nrows, nrows, heads, kh, kw, kh, kw,
                                          scale, inv_scale, stream);
}

// K11: as K10 for any nrows = kh * kw, on the global kernel.
extern "C" int k11_rel_attention_headmajor_global(const void* qkv, const void* rel_h,
                                                  const void* rel_w, void* out, int nseq,
                                                  int nrows, int heads, int hd, int kh, int kw,
                                                  float scale, float inv_scale, void* stream) {
  Operands op = grouped(qkv, nrows, heads, hd);
  op.rel_h = static_cast<const bf16*>(rel_h);
  op.rel_w = static_cast<const bf16*>(rel_w);
  return dispatch_global<false, true>(hd, op, out, nseq, nrows, heads, kh, kw, scale, inv_scale,
                                      stream);
}

// The dynamic shared memory (bytes) of the global kernel's launch at head dim
// hd, with K7-int8's int8 q . k or without, on a kh x kw grid; -1 for a head
// dim it has no instance of.
extern "C" int global_attention_smem(int hd, int int8_qk, int kh, int kw) {
  switch (hd) {
    case 16:
      return (int)(int8_qk ? global_launch_smem<16, true>(kh, kw)
                           : global_launch_smem<16, false>(kh, kw));
    case 32:
      return (int)(int8_qk ? global_launch_smem<32, true>(kh, kw)
                           : global_launch_smem<32, false>(kh, kw));
    case 64:
      return (int)(int8_qk ? global_launch_smem<64, true>(kh, kw)
                           : global_launch_smem<64, false>(kh, kw));
    case 80:
      return (int)(int8_qk ? global_launch_smem<80, true>(kh, kw)
                           : global_launch_smem<80, false>(kh, kw));
    default: return -1;
  }
}
