// K16: the softmax forms and ablations of K5's and K7's attention that the
// attention experiment tools time, on sm_90a.  It replaces
//    tools/exp_attn.py:mk_window  (call :147) in its forms v1 and v3,
//    tools/exp_attn.py:mk_global  (call :217) in its forms v1 and v3,
//    tools/exp_attn2.py:mk_window_ablate (call :228) in its modes norel,
//    noroll and noexp;
// the forms v2 and split and the mode full are K5's and K7's own function
// (tools/exp_attn2.py:mk_global_split, call :134, is K7 with its rel bias
// summed in another order), which the port runs on K5 and K7.
//
// On a window (at most 208 rows) each is window_attention_kernel
// (window_attention.cuh) with one compile-time form; v1 and v3 on the grid
// are global_attention_kernel (global_attention.cuh) with theirs.  With scale =
// hd^-0.5, the rel terms as K5's and m, l the row's final max and sum, per
// head and query i:
//    v1      p = bf16(exp(logit - m) / l);                 out = p . v
//    v3      p = bf16(exp(bf16(logit - m))), l = sum p;    out = (p . v) / l
//    norel   logit = scale * q . k, no rel term;           out as K5 (v2)
//    noroll  every query's rel terms at cell (0, 0):
//            rel_h[i, kh] = bf16(q_i . Rh[KH - 1 - kh] / scale) (rel_w alike)
//    noexp   p = logit - m in place of exp, l = sum p;     out = (bf16(p) . v) / l
// with (v2, v3, noexp) 1 / l applied after the product, as the tools apply it.
// noexp gives the window's dead slots (nkeys <= j < nrows) their logit of
// -1e30 and their v rows, as the TPU kernel does: they then carry almost all
// of the numerator and denominator.  On a window every form takes one pass:
// the window kernel holds whole rows of logits in registers.  On the grid v1
// and v3 need each row's final max (v1 also its sum) before its first
// probability, so the global kernel makes two passes over the keys.
//
// What bounds them: the window instances read each window's q, k, v once and
// write its output, ~110 operations per byte, so bytes bound them as they
// bound K5; the global ones do K7's products and are bound by the tensor
// cores (the second pass's q . k product is the two-pass forms' overhead).
#include "global_attention.cuh"
#include "rel_attention.cuh"
#include "window_attention.cuh"

namespace {

// the forms, as the Python wrapper names them (kernels/attention.py:FORMS)
enum : int { FORM_V1 = 1, FORM_V3 = 3, FORM_NOREL = 4, FORM_NOROLL = 5, FORM_NOEXP = 6 };

template <int SM, int REL>
int dispatch_form(int hd, const Operands& op, void* out, int nseq, int nrows, int nkeys,
                  int heads, int kh, int kw, float scale, float inv_scale, void* stream) {
  return dispatch_window<SM, REL, false, false>(hd, op, out, nseq, nrows, nkeys, heads, kh, kw, kh,
                                                kw, scale, inv_scale, stream);
}

// v1 and v3 on a whole grid (every row a key): the global kernel's two passes
template <int SM>
int dispatch_global_form(int hd, const void* qkv, const void* tab, void* out, int nseq, int nrows,
                         int nkeys, int heads, int kh, int kw, float scale, float inv_scale,
                         void* stream) {
  if (nkeys != nrows) return cudaErrorInvalidValue;
  Operands op = grouped(qkv, nrows, heads, hd);
  op.tab = static_cast<const bf16*>(tab);
  return dispatch_global<false, false, SM>(hd, op, out, nseq, nrows, heads, kh, kw, scale,
                                           inv_scale, stream);
}

}  // namespace

// qkv (nseq, nrows, heads*3*hd) bf16 grouped per head; tab (2*kh-1 + 2*kw-1,
// hd) bf16 rows [Rh; Rw] (not read by norel); out (nseq, nrows, heads, hd)
// bf16.  A sequence of up to 208 rows (a window) runs on the window kernel, a
// longer one on the global kernel (v1 and v3 only).
extern "C" int k16_rel_attention_forms(const void* qkv, const void* tab, void* out, int nseq,
                                       int nrows, int nkeys, int heads, int hd, int kh, int kw,
                                       int form, float scale, float inv_scale, void* stream) {
  Operands op = grouped(qkv, nrows, heads, hd);
  op.tab = static_cast<const bf16*>(tab);
  const bool window = nrows <= W_NK;
  switch (form) {
    case FORM_V1:
      return window ? dispatch_form<SM_V1, REL_FULL>(hd, op, out, nseq, nrows, nkeys, heads,
                                                         kh, kw, scale, inv_scale, stream)
                    : dispatch_global_form<SM_V1>(hd, qkv, tab, out, nseq, nrows, nkeys, heads,
                                                  kh, kw, scale, inv_scale, stream);
    case FORM_V3:
      return window ? dispatch_form<SM_V3, REL_FULL>(hd, op, out, nseq, nrows, nkeys, heads,
                                                         kh, kw, scale, inv_scale, stream)
                    : dispatch_global_form<SM_V3>(hd, qkv, tab, out, nseq, nrows, nkeys, heads,
                                                  kh, kw, scale, inv_scale, stream);
    case FORM_NOREL:
      if (!window) return cudaErrorInvalidValue;
      return dispatch_form<SM_ONLINE, REL_NONE>(hd, op, out, nseq, nrows, nkeys, heads, kh,
                                                    kw, scale, inv_scale, stream);
    case FORM_NOROLL:
      if (!window) return cudaErrorInvalidValue;
      return dispatch_form<SM_ONLINE, REL_BASE0>(hd, op, out, nseq, nrows, nkeys, heads, kh,
                                                     kw, scale, inv_scale, stream);
    case FORM_NOEXP:
      if (!window) return cudaErrorInvalidValue;
      return dispatch_form<SM_NOEXP, REL_FULL>(hd, op, out, nseq, nrows, nkeys, heads, kh,
                                                   kw, scale, inv_scale, stream);
    default: return cudaErrorInvalidValue;
  }
}
