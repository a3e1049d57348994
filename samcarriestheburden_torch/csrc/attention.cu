// K5, K6, K7, K7-int8, K7-pv, K7-int8pv, K9, K10 and K11: attention with the
// decomposed relative-position bias of SAM's ViT encoder, on sm_90a.
//
// The TPU kernels they replace (samcarriestheburden_tpu/kernels/attention.py):
//   K5   fused_rel_attention_window3d: one 14x14 window per sequence, 200
//        slots of which 196 are live keys;
//   K6   fused_rel_attention_window_rect: an edge window of the compact
//        layout, which carries only its QH x QW image cells; the window's
//        other cells are zero-pad tokens, whose k and v are the qkv bias b_k,
//        b_v of the head (rounded to bf16, as K1/K2 write them for a masked row);
//   K7   fused_rel_attention_global3d with int8_qk=False (the 64x64 grid);
//   K7-int8 the same with int8_qk=True; K7-pv and K7-int8pv with int8_pv=True
//        (lines 615-629; an opt-in A/B mode, never a serving default);
//   K9   fused_rel_attention: q, k, v split per head, (G, N, HD) each, with
//        rel_h (G, N, KH) and rel_w (G, N, KW) given;
//   K10  fused_rel_attention_headmajor: K9 on K5's head-grouped qkv, rel_h
//        (heads, nseq, N, KH), rel_w (heads, nseq, N, KW);
//   K11  fused_rel_attention_headmajor_global: K10 on the global grid.
// Per sequence s, head h and query i at grid cell (ph, pw):
//    rel_h[i, kh] = bf16(q_i . Rh[ph - kh + KH - 1] / scale)      (same for w)
//    logit[i, j] = scale * (q_i . k_j + rel_h[i, kh(j)] + rel_w[i, kw(j)])
//    out_i       = softmax_j(logit) . v
// over the live keys j < nkeys (dead slots get no weight); K9-K11 take the
// rel terms from the caller and round them at 1 / scale, as the TPU kernels'
// default body does.  K6's pad keys add scale * (q_i . b_k + rel terms) to the
// softmax and (sum of their weights) * b_v to the output.  K7-int8 runs q . k
// on int8 keys quantized per channel and q per row (kq, kmax; kernels/
// attention.py has the formulas); K7-pv quantizes the normalised
// probabilities at 127 and v per channel for p . v.  Input qkv is (nseq,
// nrows, heads * 3 * HD) with each head's [q | k | v] columns side by side;
// output is token-major (nseq, nrows, heads, HD), ready for the projection.
//
// Two kernels compute them:
//   * the windows (K5, K6, K9 on a sequence of at most 208 rows, K10) run
//     window_attention_kernel (window_attention.cuh): persistent blocks of
//     two warpgroups, TMA-fed item stages, a whole 208-column row of S in one
//     wgmma product with the rel terms as the selector product R . E^T, the
//     TPU kernel's own formulation.  Bytes bound it (~100 operations per byte).
//   * the global grid (K7, K7-int8, K7-pv, K7-int8pv, K9 longer than 208
//     rows, K11) runs global_attention_kernel (global_attention.cuh): 128
//     query rows per block in two warpgroups, K/V tiles by TMA through an
//     mbarrier ring, both products on wgmma.  The tensor cores bound it.
//     K7-pv and K7-int8pv are its SM_PV instances: two key passes (the row
//     max and sum, then the int8 p . v on s8 wgmma), after the pre-passes that
//     quantize v (rel_attention.cuh:v_quant_kernel) and, for K7-int8pv, k.
#include "global_attention.cuh"
#include "rel_attention.cuh"
#include "window_attention.cuh"

// qkv (nseq, nrows, heads*3*hd) bf16; tab (2*kh-1 + 2*kw-1, hd) bf16 rows [Rh; Rw];
// out (nseq, nrows, heads, hd) bf16.  hd in {16, 32, 64, 80}.
extern "C" int k5_rel_attention_window(const void* qkv, const void* tab, void* out, int nseq,
                                       int nrows, int nkeys, int heads, int hd, int ws,
                                       float scale, float inv_scale, void* stream) {
  Operands op = grouped(qkv, nrows, heads, hd);
  op.tab = static_cast<const bf16*>(tab);
  return dispatch_window<SM_ONLINE, REL_FULL, false, false>(hd, op, out, nseq, nrows, nkeys, heads,
                                                            ws, ws, ws, ws, scale, inv_scale,
                                                            stream);
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
  return dispatch_window<SM_ONLINE, REL_FULL, true, false>(hd, op, out, nseq, nrows, rh * rw, heads,
                                                           ws, ws, rh, rw, scale, inv_scale,
                                                           stream);
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
    return dispatch_global<true, false, SM_PV>(hd, op, out, nseq, nrows, heads, kh, kw, scale,
                                               inv_scale, stream);
  return dispatch_global<false, false, SM_PV>(hd, op, out, nseq, nrows, heads, kh, kw, scale,
                                              inv_scale, stream);
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
  if (nrows > W_NK)  // the global grid
    return dispatch_global<false, true>(hd, op, out, nseq, nrows, 1, kh, kw, scale, inv_scale,
                                        stream);
  return dispatch_window<SM_ONLINE, REL_FULL, false, true>(hd, op, out, nseq, nrows, nrows, 1, kh,
                                                           kw, kh, kw, scale, inv_scale, stream);
}

// K10: qkv (nseq, nrows, heads*3*hd) bf16 grouped per head, nrows = kh * kw <=
// 208; rel_h (heads, nseq, nrows, kh), rel_w (heads, nseq, nrows, kw) bf16;
// out (nseq, nrows, heads, hd) bf16.
extern "C" int k10_rel_attention_headmajor(const void* qkv, const void* rel_h, const void* rel_w,
                                           void* out, int nseq, int nrows, int heads, int hd,
                                           int kh, int kw, float scale, float inv_scale,
                                           void* stream) {
  if (nrows > W_NK) return cudaErrorInvalidValue;
  Operands op = grouped(qkv, nrows, heads, hd);
  op.rel_h = static_cast<const bf16*>(rel_h);
  op.rel_w = static_cast<const bf16*>(rel_w);
  return dispatch_window<SM_ONLINE, REL_FULL, false, true>(hd, op, out, nseq, nrows, nrows, heads,
                                                           kh, kw, kh, kw, scale, inv_scale,
                                                           stream);
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

// The dynamic shared memory (bytes) of the window kernel's launch at head dim
// hd over sequences of nrows rows on a kh x kw key grid, with the table
// product (tables = 1: K5, K6, K16) or the caller's rel terms (K9, K10).
extern "C" int window_attention_smem(int hd, int nrows, int kh, int kw, int tables) {
  return window_smem(hd, nrows, kh, kw, tables != 0);
}

// The persistent grid (blocks per SM x SMs) of K5's (tables = 1) or K10's
// (tables = 0) window instance at head dim hd over nrows rows of a kh x kw
// grid: a launch over more items walks them in strides of this; a negative
// cudaError_t where the card cannot run the instance.
extern "C" int window_attention_grid(int hd, int nrows, int kh, int kw, int tables) {
  switch (hd) {
    case 16:
      return tables ? window_grid<16, SM_ONLINE, REL_FULL, false, false>(nrows, kh, kw)
                    : window_grid<16, SM_ONLINE, REL_FULL, false, true>(nrows, kh, kw);
    case 32:
      return tables ? window_grid<32, SM_ONLINE, REL_FULL, false, false>(nrows, kh, kw)
                    : window_grid<32, SM_ONLINE, REL_FULL, false, true>(nrows, kh, kw);
    case 64:
      return tables ? window_grid<64, SM_ONLINE, REL_FULL, false, false>(nrows, kh, kw)
                    : window_grid<64, SM_ONLINE, REL_FULL, false, true>(nrows, kh, kw);
    case 80:
      return tables ? window_grid<80, SM_ONLINE, REL_FULL, false, false>(nrows, kh, kw)
                    : window_grid<80, SM_ONLINE, REL_FULL, false, true>(nrows, kh, kw);
    default: return -(int)cudaErrorInvalidValue;
  }
}
