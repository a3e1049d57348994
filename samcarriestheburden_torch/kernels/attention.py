"""K5, K6, K7 (with K7-int8, K7-pv, K7-int8pv), K9-K12 and K16: attention with
SAM's decomposed relative-position bias.

K5 ``rel_attention_window`` runs one window per sequence (JAX
``kernels/attention.py:fused_rel_attention_window3d``); K6
``rel_attention_window_rect`` an edge window of the compact layout, which
carries only its image cells (JAX ``fused_rel_attention_window_rect``); K7
``rel_attention_global`` the whole token grid (JAX
``fused_rel_attention_global3d``), with ``int8_qk=True`` as K7-int8.  All take qkv
activations whose columns are grouped per head (:func:`group_qkv_per_head`)
and the stacked rel-pos tables of :func:`prepare_rel_tables`, and return the
attention output token-major, (S, n, heads * hd), ready for the output
projection.

The function, per head, for query i at grid cell (ph, pw) and live key j at
(kh, kw), with scale = hd ** -0.5:

    rel_h[i, kh] = round_dt(q_i . Rh[ph - kh + KH - 1] / scale)   (rel_w alike)
    logit[i, j]  = scale * (q_i . k_j + rel_h[i, kh] + rel_w[i, kw])
    out_i        = round_dt(softmax_j(logit)) . v       (fp32 accumulate)

Only the first ``nkeys`` slots are keys (K5's 8-alignment dead slots are
not); dead query rows clamp their grid row as the JAX kernels do.

K7-int8 replaces ``q_i . k_j`` by a dynamically quantized product: the keys
are quantized per (sequence, head, channel), that scale is folded into q
before q's per-row quantization, the product accumulates in int32, and the
rel terms (from the unquantized q) are added in floating point:

    sk[c] = max_j |k[j, c]| / 127 + 1e-12;  ki = round(k / sk)
    qs = q * sk;  sq[i] = max_c |qs[i, c]| / 127 + 1e-12;  qi = round(qs / sq)
    logit[i, j] = scale * ((qi_i . ki_j) * sq[i] + (rel_h[i, kh] + rel_w[i, kw]))

(rounding half to even; the accumulant stays below 2^24, so the plain
version's fp32 product of the integer values is exact).

``int8_pv=True`` (K7-pv, and K7-int8pv with ``int8_qk``; JAX
``fused_rel_attention_global3d(int8_pv=True)``, an opt-in A/B mode that no
encoder path sets) takes the softmax normalised first and runs p . v in int8:

    sv[c] = max_j |v[j, c]| / 127 + 1e-12;  vi = round(v / sv)
    pi = round(127 * softmax_j(logit));  out_i = (pi_i . vi) * (sv / 127)

with one fixed probability scale, so probabilities below 1/254 round to zero.

K6 is K5 on a ws x ws window of which only the top-left rh x rw cells are
carried, np = rh*rw rounded up to 8 slots, laid out rw wide: slot t sits at
window cell (min(t // rw, rh - 1), t % rw) as a query and, for t < rh*rw, as
a key (slots beyond rh*rw are dead: no weight).  The other ws^2 - rh*rw cells
are the reference's zero-pad tokens, whose k and v are the qkv bias of the
head, b_k and b_v, rounded to the compute type; the kernel makes them itself:

    logit[i, pad cell (pp, qq)] = scale * (q_i . b_k + rel_h[i, pp] + rel_w[i, qq])
    out_i = round_dt(p_real) . v + (sum of p_pad) * b_v

with rel_h, rel_w from the full window's tables as above, ``q_i . b_k``
summed in fp32, one softmax over the real and the pad keys together (always
ws^2 live keys: what K5 sees on the materialised padded window, reordered),
and the pad weights' sum and its product with b_v left in fp32, unrounded, as
the JAX body leaves them.  Slots of a window that lie beyond the image (the
bottom strip's last window) are carried slots like any other: their rows are
zero-masked before the projection, so their k and v are the bias too.  With
rh = rw = ws there is no pad key and K6 equals K5.

K9, K10 and K11 are the same attention with the rel terms made by the caller
(the encoder's other block formulations: ``models/image_encoder.py``).  K9
``rel_attention_pre`` takes q, k, v split per head, (G, N, hd), and
rel_h (G, N, kh), rel_w (G, N, kw) (JAX ``fused_rel_attention``); K10
``rel_attention_headmajor`` the per-head-grouped qkv of K5 with no dead slot
and rel_h (heads, S, N, kh), rel_w (heads, S, N, kw) (JAX
``fused_rel_attention_headmajor``); K11 ``rel_attention_headmajor_global``
is K10 for a grid too large for one block (JAX
``fused_rel_attention_headmajor_global``).  Their function, the arithmetic
of the JAX kernels' default ("phased") body:

    logit[i, j] = scale * (q_i . k_j + round_dt(rel_h[i, kh] / scale)
                                     + round_dt(rel_w[i, kw] / scale))
    out_i       = round_dt(softmax_j(logit)) . v       (fp32 accumulate)

The caller has rounded rel_h and rel_w to the compute type already, so a rel
term is rounded twice where K5 and K7 round it once; in fp32 neither bites.
K10 and K11 return the output token-major like K5 and K7 (the JAX kernels'
head-major output was a TPU layout choice; its only reader is the projection).

K12 ``window_block_attention`` is a whole windowed attention on LayerNormed,
pad-masked window tokens xn (Wb, ws^2, E) (JAX
``fused_window_block_attention``): per head

    q, k, v = round_dt(xn . W_h^T + b_h)      the per-head-grouped qkv weights
    o_h     = K5's attention of q, k, v       rel terms from q and the tables
    out     = round_dt(sum_h round_dt(o_h) . Wp_h^T)

with every product accumulated in fp32 and the sum over heads kept in fp32
and rounded once (the JAX body keeps q and k in fp32 up to the logits and
rounds its output after every head; both differ from this only in bf16:
``round_qk=False`` in the plain version keeps q and k unrounded).  The
projection's bias and the residual stay with the caller.

K16 ``rel_attention_forms`` is K5's or K7's attention in a form of the JAX
package's attention experiment tools (``tools/exp_attn.py``, ``exp_attn2.py``;
:func:`rel_attention_plain`'s ``softmax``, ``rel`` and ``exp``): the
normalisation before p . v (v1) or with bf16 exp (v3), no rel term, every
query's rel terms at cell (0, 0), ``logits - max`` in place of exp.  The
tools' v2 form is K5's and K7's own online softmax (1/sum after p . v), so
the wrapper launches them for it.

On the card three kernels compute all of these.  The windows (K5, K6, K9 on a
sequence of at most 208 rows, K10, K16 on windows) run
``csrc/window_attention.cuh``: persistent blocks walk the (sequence, head)
items (:func:`window_items`), TMA feeds a ring of item stages, and one wgmma
product per 64-row slab gives whole rows of logits in the TPU kernel's own
selector form, ``q . k + R . E^T`` (:func:`window_selectors`,
:func:`window_rel_terms`), so every softmax form takes one pass.  The global
attentions (K7, K7-int8, K7-pv, K7-int8pv, K9 on a longer sequence, K11, and
K16's v1 and v3 on the grid) run ``csrc/global_attention.cuh``: TMA copies and
mbarriers feed wgmma for both products (:func:`global_smem_bytes`; what it
takes: :func:`_check_global`).  K7's int8 p.v pair is its two-pass form whose
p.v is an s8 wgmma with the quantized probabilities as the A operand in
registers, over int8 values stored in the key order of those registers
(:func:`pv_key_order`, :func:`pv_fragment_entries`).  K12 runs
``csrc/block_attention.cu``: one thread-block cluster per window
(:func:`window_block_geometry`), the projections and the window kernel's
attention on wgmma, the heads' outputs exchanged through distributed shared
memory for the output projection.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from samcarriestheburden_torch.kernels import (LAUNCHES, build, check_cuda, ptr,
                                               raise_on_error, stream)

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib():
    lib = build.load("attention")
    if not getattr(lib, "_typed", False):
        lib.k5_rel_attention_window.argtypes = [_VP] * 3 + [_I] * 6 + [_F, _F, _VP]
        lib.k5_rel_attention_window.restype = _I
        lib.k6_rel_attention_window_rect.argtypes = [_VP] * 4 + [_I] * 7 + [_F, _F, _VP]
        lib.k6_rel_attention_window_rect.restype = _I
        lib.k7_rel_attention_global.argtypes = [_VP] * 3 + [_I] * 6 + [_F, _F, _VP]
        lib.k7_rel_attention_global.restype = _I
        lib.k7_rel_attention_global_int8.argtypes = [_VP] * 5 + [_I] * 6 + [_F, _F, _VP]
        lib.k7_rel_attention_global_int8.restype = _I
        lib.k7_rel_attention_global_pv.argtypes = [_VP] * 7 + [_I] * 7 + [_F, _F, _VP]
        lib.k7_rel_attention_global_pv.restype = _I
        lib.k9_rel_attention_pre.argtypes = [_VP] * 6 + [_I] * 5 + [_F, _F, _VP]
        lib.k9_rel_attention_pre.restype = _I
        for fn in (lib.k10_rel_attention_headmajor, lib.k11_rel_attention_headmajor_global):
            fn.argtypes = [_VP] * 4 + [_I] * 6 + [_F, _F, _VP]
            fn.restype = _I
        lib.global_attention_smem.argtypes = [_I] * 4
        lib.global_attention_smem.restype = _I
        for fn in (lib.window_attention_smem, lib.window_attention_grid):
            fn.argtypes = [_I] * 5
            fn.restype = _I
        lib._typed = True
    return lib


def _forms_lib():
    lib = build.load("attention_forms")
    if not getattr(lib, "_typed", False):
        lib.k16_rel_attention_forms.argtypes = [_VP] * 3 + [_I] * 8 + [_F, _F, _VP]
        lib.k16_rel_attention_forms.restype = _I
        lib._typed = True
    return lib


def _block_lib():
    lib = build.load("block_attention")
    if not getattr(lib, "_typed", False):
        lib.k12_window_block_attention.argtypes = [_VP] * 6 + [_I] * 6 + [_F, _F, _VP]
        lib.k12_window_block_attention.restype = _I
        lib.k12_block_info.argtypes = [_I, _I, _VP, _VP]
        lib.k12_block_info.restype = _I
        lib._typed = True
    return lib


# ---------------------------------------------------------------------------
# weight preparation
# ---------------------------------------------------------------------------


def group_qkv_per_head(w: torch.Tensor, b: torch.Tensor, heads: int):
    """Reorder the qkv projection's output features from (3, heads, hd) to
    (heads, 3, hd), so each head's [q | k | v] columns sit side by side
    (JAX ``prepare_qkv_headmajor``, without its 128-lane padding).
    w (3E, E) -> (3E, E); b (3E,) -> (3E,)."""
    e = w.shape[1]
    hd = e // heads
    w = w.reshape(3, heads, hd, e).transpose(0, 1).reshape(3 * e, e)
    b = b.reshape(3, heads, hd).transpose(0, 1).reshape(3 * e)
    return w.contiguous(), b.contiguous()


def prepare_rel_tables(rel_pos_h: torch.Tensor, rel_pos_w: torch.Tensor,
                       kh: int, kw: int, dtype) -> torch.Tensor:
    """The kernels' rel-pos operand: [Rh; Rw] stacked, (2kh-1 + 2kw-1, hd)
    (JAX ``prepare_rel_tables_window3d``).  The encoder's parameters are
    sized 2S-1 for their window or grid, so the JAX package's table
    resampling never applies."""
    if rel_pos_h.shape[0] != 2 * kh - 1 or rel_pos_w.shape[0] != 2 * kw - 1:
        raise ValueError(f"rel-pos tables of {rel_pos_h.shape[0]}, {rel_pos_w.shape[0]} "
                         f"rows do not fit a {kh}x{kw} grid")
    return torch.cat([rel_pos_h, rel_pos_w], 0).to(dtype).contiguous()


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def int8_qk_plain(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """K7-int8's stand-in for ``q @ k^T``: fp32 q (S, n, hd), k (S, m, hd)
    -> (S, n, m), through per-channel int8 keys and per-row int8 queries."""
    sk = k.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
    ki = torch.round(k / sk)
    qs = q * sk
    sq = qs.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-12
    qi = torch.round(qs / sq)
    return (qi @ ki.transpose(1, 2)) * sq


def int8_pv_plain(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K7-pv's stand-in for ``p @ v``: normalised fp32 probabilities p (S, n,
    m) at the fixed int8 scale 127, v (S, m, hd) per channel, the product of
    the integers exact in fp32, dequantized by ``sv / 127``."""
    sv = v.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
    vi = torch.round(v / sv)
    pi = torch.round(p * 127.0)
    return (pi @ vi) * (sv / 127.0)


#: the softmax forms of the attention experiment tools (``tools/exp_attn.py:
#: _softmax_av``) and the rel-term modes of ``tools/exp_attn2.py:mk_window_ablate``
SOFTMAX_FORMS = ("v1", "v2", "v3")
REL_MODES = ("full", "none", "base0")


def _softmax_pv(logits, v, dt, softmax: str, exp: bool) -> torch.Tensor:
    """One head's output from fp32 logits (S, n, m) and v (S, m, hd) in a
    softmax form of the tools: ``v1`` exp, divide, then p . v; ``v2`` exp,
    p . v, then x 1/sum; ``v3`` the logits rounded to bf16 before exp and the
    probabilities to bf16 after it, summed in fp32, then as v2; ``exp=False``
    takes ``logits - max`` itself for the probabilities (v2's order)."""
    d = logits - logits.amax(-1, keepdim=True)
    if not exp:
        p = d
    elif softmax == "v3":
        p = torch.exp(d.to(torch.bfloat16).float()).to(torch.bfloat16).float()
    else:
        p = torch.exp(d)
    denom = p.sum(-1, keepdim=True)
    if exp and softmax == "v1":
        return (p / denom).to(dt).float() @ v
    return (p.to(dt).float() @ v) * (1.0 / denom)


def rel_attention_plain(qkv, tables, *, heads: int, hd: int, kh: int, kw: int,
                        nkeys: int, int8_qk: bool = False, int8_pv: bool = False,
                        softmax: str = "v1", rel: str = "full",
                        exp: bool = True) -> torch.Tensor:
    """Plain version of K5, K7, (``int8_qk``) K7-int8 and (``int8_pv``)
    K7-pv and K7-int8pv, and of K16's forms: ``softmax`` (v1, v2, v3: the
    tools' three placements of the normalisation), ``rel`` (``none``: no rel
    term; ``base0``: every query's rel terms at cell (0, 0)) and ``exp=False``
    (``logits - max`` in place of exp; the dead slots nkeys <= j < n take part
    with their logit of -1e30 and their v rows, as the TPU kernel's).  The
    defaults are K5's and K7's reference arithmetic.  qkv (S, n, heads*3*hd) ->
    (S, n, heads*hd)."""
    if softmax not in SOFTMAX_FORMS or rel not in REL_MODES:
        raise ValueError(f"softmax {softmax!r} / rel {rel!r}: expected one of "
                         f"{SOFTMAX_FORMS} / {REL_MODES}")
    forms = (softmax, rel, exp) != ("v1", "full", True)
    if forms and (int8_qk or int8_pv):
        raise ValueError("the softmax forms and rel modes are K5's and K7's, not the int8 modes'")
    s, n, _ = qkv.shape
    dt, dev = qkv.dtype, qkv.device
    scale = hd ** -0.5
    nk = nkeys if exp else n
    x = qkv.reshape(s, n, heads, 3 * hd).float()
    tab = tables.float()
    tok = torch.arange(n, device=dev)
    ph = (tok // kw).clamp(max=kh - 1)
    pw = tok % kw
    if rel == "base0":
        ph, pw = torch.zeros_like(ph), torch.zeros_like(pw)
    key = torch.arange(nk, device=dev)
    idx_h = (ph[:, None] - (key // kw).clamp(max=kh - 1)[None] + kh - 1).expand(s, n, nk)
    idx_w = (pw[:, None] - (key % kw)[None] + kw - 1 + 2 * kh - 1).expand(s, n, nk)
    out = torch.empty((s, n, heads, hd), dtype=dt, device=dev)
    for h in range(heads):
        q = x[:, :, h, :hd]
        k = x[:, :nk, h, hd:2 * hd]
        v = x[:, :nk, h, 2 * hd:]
        if rel == "none":
            bias = 0.0
        else:
            g = (q @ tab.T * (1.0 / scale)).to(dt).float()          # (S, n, Rh+Rw)
            bias = g.gather(2, idx_h) + g.gather(2, idx_w)
        qk = int8_qk_plain(q, k) if int8_qk else q @ k.transpose(1, 2)
        logits = (qk + bias) * scale
        if not forms:
            p = torch.softmax(logits, dim=-1)
            out[:, :, h] = (int8_pv_plain(p, v) if int8_pv else p.to(dt).float() @ v).to(dt)
            continue
        if nk > nkeys:      # the dead slots: no rel term, -1e30 added (exp=False only)
            logits[..., nkeys:] = qk[..., nkeys:] * scale - 1e30
        out[:, :, h] = _softmax_pv(logits, v, dt, softmax, exp).to(dt)
    return out.reshape(s, n, heads * hd)


def _into(out: Optional[torch.Tensor], result: torch.Tensor) -> torch.Tensor:
    """A plain version's result, copied into the caller's ``out`` if it gave one."""
    return result if out is None else out.copy_(result)


def rel_attention_window_plain(qkv, tables, *, ws: int, heads: int, hd: int, out=None):
    """Plain version of K5."""
    return _into(out, rel_attention_plain(qkv, tables, heads=heads, hd=hd, kh=ws, kw=ws,
                                          nkeys=ws * ws))


def rect_pad_cells(ws: int, rh: int, rw: int):
    """The cells (pp, qq) of a ws x ws window outside its carried rh x rw
    rectangle, row-major: K6's pad keys."""
    return [(pp, qq) for pp in range(ws) for qq in range(ws) if not (pp < rh and qq < rw)]


def rel_attention_window_rect_plain(qkv, tables, qkv_bias, *, ws: int, rh: int, rw: int,
                                    heads: int, hd: int, out=None) -> torch.Tensor:
    """Plain version of K6.  qkv (Wb, np, heads*3*hd), tables for the full
    ws x ws window, qkv_bias (heads*3*hd) grouped per head -> (Wb, np, heads*hd)."""
    s, n, _ = qkv.shape
    dt, dev = qkv.dtype, qkv.device
    scale = hd ** -0.5
    nreal = rh * rw
    x = qkv.reshape(s, n, heads, 3 * hd).float()
    bias = qkv_bias.to(dt).float().reshape(heads, 3, hd)
    tab = tables.float()
    tok = torch.arange(n, device=dev)
    ph = (tok // rw).clamp(max=rh - 1)
    pw = tok % rw
    pad = torch.tensor(rect_pad_cells(ws, rh, rw), dtype=torch.long,
                       device=dev).reshape(-1, 2)
    key_h = torch.cat([tok[:nreal] // rw, pad[:, 0]])
    key_w = torch.cat([tok[:nreal] % rw, pad[:, 1]])
    nk = key_h.numel()                                     # ws * ws
    idx_h = (ph[:, None] - key_h[None] + ws - 1).expand(s, n, nk)
    idx_w = (pw[:, None] - key_w[None] + ws - 1 + 2 * ws - 1).expand(s, n, nk)
    res = torch.empty((s, n, heads, hd), dtype=dt, device=dev)
    for h in range(heads):
        q = x[:, :, h, :hd]
        k = x[:, :nreal, h, hd:2 * hd]
        v = x[:, :nreal, h, 2 * hd:]
        g = (q @ tab.T * (1.0 / scale)).to(dt).float()
        qk = torch.cat([q @ k.transpose(1, 2),
                        (q @ bias[h, 1]).unsqueeze(-1).expand(s, n, nk - nreal)], -1)
        p = torch.softmax((qk + g.gather(2, idx_h) + g.gather(2, idx_w)) * scale, dim=-1)
        o = p[..., :nreal].to(dt).float() @ v
        res[:, :, h] = (o + p[..., nreal:].sum(-1, keepdim=True) * bias[h, 2]).to(dt)
    return _into(out, res.reshape(s, n, heads * hd))


def rel_attention_global_plain(qkv, tables, *, kh: int, kw: int, heads: int,
                               hd: int, int8_qk: bool = False, int8_pv: bool = False):
    """Plain version of K7 and of K7-int8 (``int8_qk``), K7-pv (``int8_pv``)
    and K7-int8pv (both)."""
    return rel_attention_plain(qkv, tables, heads=heads, hd=hd, kh=kh, kw=kw,
                               nkeys=kh * kw, int8_qk=int8_qk, int8_pv=int8_pv)


# ---------------------------------------------------------------------------
# K5, K6, K7, K7-int8
# ---------------------------------------------------------------------------


def _check_hd(hd: int) -> None:
    if hd not in (16, 32, 64, 80):
        raise ValueError(f"head dim {hd} has no kernel instance (16, 32, 64, 80)")


def _check_global(kh: int, kw: int, **operands) -> None:
    """What the global kernel (``csrc/global_attention.cuh``: K7, K7-int8, K7-pv,
    K7-int8pv, K9 on a sequence longer than one block, K11, K16's v1 and v3 on
    the grid) takes
    beyond the head dims: a kh x kw grid whose stacked tables (2kh-1 + 2kw-1
    rows) fit its 256-row table product, and operands whose base and row pitch
    its TMA copies can address (16 bytes)."""
    if kh < 1 or kw < 1 or (2 * kh - 1) + (2 * kw - 1) > 256:
        raise ValueError(f"the global kernel takes grids with (2kh-1) + (2kw-1) <= 256, "
                         f"got {kh}x{kw}")
    for name, t in operands.items():
        if t.data_ptr() % 16 or t.shape[-1] * t.element_size() % 16:
            raise ValueError(f"{name}: the global kernel's TMA copies need a 16-byte aligned "
                             f"base and row pitch")


def global_smem_bytes(hd: int, int8_qk: bool, kh: int, kw: int) -> int:
    """The dynamic shared memory of the global kernel's launch at head dim hd
    on a kh x kw grid (with K7-int8's int8 q . k or without; K7-pv and
    K7-int8pv take as much as K7 and K7-int8)."""
    _check_hd(hd)
    return _lib().global_attention_smem(hd, int(int8_qk), kh, kw)


def pv_key_order() -> torch.Tensor:
    """The key each position of a 32-key chunk of ``vq`` holds (K7-pv's and
    K7-int8pv's int8 values, (S, heads, hd, keys padded to 64)), as
    ``csrc/rel_attention.cuh:pv_key`` writes it: position 16 h + 4 q + e holds
    key 16 h + 8 (e >> 1) + 2 q + (e & 1).  Lane q of a quad holds A-fragment
    columns 4 q .. 4 q + 3 (and 16 + 4 q ..) of wgmma m64nNk32's 8-bit A
    operand, and keys 2 q, 2 q + 1 of every 8-key group in the S accumulator
    (:func:`pv_fragment_entries` packs the one from the other)."""
    kp = torch.arange(32)
    half, q, e = kp >> 4, (kp & 15) >> 2, kp & 3
    return half * 16 + (e >> 1) * 8 + 2 * q + (e & 1)


def pv_fragment_entries() -> torch.Tensor:
    """(2, 4, 4) long: the entry x (0..31) of a thread's S accumulator (one
    64-key tile of its two rows, ``sc`` in ``csrc/global_attention.cuh``) that
    the SM_PV instance quantizes into byte b of A register r of k-step kk
    (keys 32 kk .. 32 kk + 31 of the tile): register r holds row r & 1's keys
    of the 8-key groups t and t + 1, t = 4 kk + 2 (r >> 1)."""
    kk, r, b = torch.meshgrid(torch.arange(2), torch.arange(4), torch.arange(4), indexing="ij")
    return 4 * (4 * kk + 2 * (r >> 1) + (b >> 1)) + 2 * (r & 1) + (b & 1)


#: key columns of the window kernel's one S product (its wgmma N): a window's
#: slots, and K6's pad cells after them, must fit
W_NK = 208


def window_selectors(kh: int, kw: int, *, nslots: int, nkeys: Optional[int] = None,
                     qh: Optional[int] = None, qw: Optional[int] = None):
    """The window kernel's key selectors, as ``csrc/window_attention.cuh``
    builds them in shared memory: ``(E, live)`` with E (columns, kh + kw)
    float32, key column j's ones at slot kh(j) and kh + kw(j) of its window
    cell, and ``live`` (columns,) bool, the columns that are keys.

    K5 and K16 (``qh``, ``qw`` None): the first ``nkeys`` (default kh*kw) of
    ``nslots`` slots, column j at cell (j // kw, j % kw).  K6 (a qh x qw
    rectangle carried of the kh x kw window): the carried slots, column t <
    qh*qw at (t // qw, t % qw), dead slots up to ``nslots``, then the window's
    other cells row-major (:func:`rect_pad_cells`), the TPU kernel's ``coords``
    order (JAX ``fused_rel_attention_window_rect``).  JAX's ``ehT``/``ewT`` and
    ``sel`` hold the same ones with each zone's columns reversed."""
    rect = qh is not None
    qh, qw = (qh, qw) if rect else (kh, kw)
    nreal = qh * qw if rect else (kh * kw if nkeys is None else nkeys)
    cells = [(t // qw, t % qw) if t < nreal else None for t in range(nslots)]
    if rect:
        cells += rect_pad_cells(kh, qh, qw)
    e = torch.zeros((len(cells), kh + kw), dtype=torch.float32)
    live = torch.zeros(len(cells), dtype=torch.bool)
    for j, cell in enumerate(cells):
        if cell is not None:
            e[j, cell[0]] = 1.0
            e[j, kh + cell[1]] = 1.0
            live[j] = True
    return e, live


def window_rel_terms(q: torch.Tensor, tables: torch.Tensor, *, kh: int, kw: int,
                     qh: Optional[int] = None, qw: Optional[int] = None,
                     rel: str = "full") -> torch.Tensor:
    """The window kernel's R: each query row's kh + kw rel terms, q (..., n,
    hd) against the stacked tables, shifted to the row's cell (clamped for dead
    rows; ``rel="base0"``: every row at (0, 0)) and rounded to q's type at
    1 / scale, (..., n, kh + kw).  ``q . k + R . E^T`` (:func:`window_selectors`)
    is the gather form of the plain versions, summed in another order."""
    n, hd = q.shape[-2:]
    qh, qw = (kh, kw) if qh is None else (qh, qw)
    scale = hd ** -0.5
    g = (q.float() @ tables.float().T * (1.0 / scale)).to(q.dtype).float()
    tok = torch.arange(n, device=q.device)
    ph, pw = (tok // qw).clamp(max=qh - 1), tok % qw
    if rel == "base0":
        ph, pw = torch.zeros_like(ph), torch.zeros_like(pw)
    idx_h = ph[:, None] + kh - 1 - torch.arange(kh, device=q.device)[None]
    idx_w = pw[:, None] + kw - 1 - torch.arange(kw, device=q.device)[None] + 2 * kh - 1
    idx = torch.cat([idx_h, idx_w], 1).expand(*g.shape[:-1], kh + kw)
    return g.gather(-1, idx)


def window_items(nitems: int, grid: int):
    """The (sequence, head) items each persistent block of the window kernel
    walks: block b takes b, b + grid, b + 2 grid, ... of ``nitems``, on
    ``min(grid, nitems)`` blocks (:func:`window_grid` gives the card's grid)."""
    return [list(range(b, nitems, grid)) for b in range(min(grid, nitems))]


def window_smem_bytes(hd: int, nrows: int, kh: int, kw: int, tables: bool = True) -> int:
    """The dynamic shared memory of the window kernel's launch at head dim hd
    over nrows rows of a kh x kw grid, with the table product (K5, K6, K16) or
    the caller's rel terms (``tables=False``: K9, K10)."""
    _check_hd(hd)
    return _lib().window_attention_smem(hd, nrows, kh, kw, int(tables))


def window_grid(hd: int, nrows: int, kh: int, kw: int, tables: bool = True) -> int:
    """The window kernel's persistent grid on this card (blocks per SM x SMs)
    for K5's (``tables``) or K10's instance at these shapes."""
    _check_hd(hd)
    grid = _lib().window_attention_grid(hd, nrows, kh, kw, int(tables))
    raise_on_error("window_attention_grid", max(0, -grid))
    return grid


def _check(qkv, tables, heads, hd, kh, kw):
    s, n, c = qkv.shape
    check_cuda("qkv", qkv, (s, n, heads * 3 * hd), torch.bfloat16)
    check_cuda("tables", tables, (2 * kh - 1 + 2 * kw - 1, hd), torch.bfloat16)
    _check_hd(hd)
    return s, n


def _out(out: Optional[torch.Tensor], qkv, s: int, n: int, width: int) -> torch.Tensor:
    """The output buffer of a launch: the caller's (checked) or a new one."""
    if out is None:
        return torch.empty((s, n, width), dtype=qkv.dtype, device=qkv.device)
    check_cuda("out", out, (s, n, width), qkv.dtype)
    return out


def rel_attention_window(qkv, tables, *, ws: int, heads: int, hd: int,
                         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K5 over (Wb, np, heads*3*hd) windows of ws*ws live tokens (np >= ws*ws).
    ``out`` (Wb, np, heads*hd), where given, takes the result (a view of a
    larger buffer, in the compact layout)."""
    nkeys = ws * ws
    if qkv.device.type == "cpu":
        return rel_attention_window_plain(qkv, tables, ws=ws, heads=heads, hd=hd, out=out)
    s, n = _check(qkv, tables, heads, hd, ws, ws)
    if n < nkeys or n > W_NK:
        raise ValueError(f"K5 takes one window of <= {W_NK} slots per sequence, got {n}")
    out = _out(out, qkv, s, n, heads * hd)
    scale = hd ** -0.5
    code = _lib().k5_rel_attention_window(
        ptr(qkv), ptr(tables), ptr(out), s, n, nkeys, heads, hd, ws,
        scale, 1.0 / scale, stream())
    raise_on_error("K5 rel_attention_window", code)
    LAUNCHES["K5"] += 1
    return out


def rel_attention_window_rect(qkv, tables, qkv_bias, *, ws: int, rh: int, rw: int, heads: int,
                              hd: int, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K6 over (Wb, np, heads*3*hd) edge windows that carry the rh*rw image
    cells of a ws x ws window (np >= rh*rw); ``tables`` are the full window's,
    ``qkv_bias`` (heads*3*hd) fp32 the projection's bias grouped per head, the
    pad keys' k and v.  ``out`` as for K5."""
    if qkv.device.type == "cpu":
        return rel_attention_window_rect_plain(qkv, tables, qkv_bias, ws=ws, rh=rh, rw=rw,
                                               heads=heads, hd=hd, out=out)
    s, n = _check(qkv, tables, heads, hd, ws, ws)
    check_cuda("qkv_bias", qkv_bias, (heads * 3 * hd,), torch.float32)
    if not (1 <= rh <= ws and 1 <= rw <= ws) or n < rh * rw or n + ws * ws - rh * rw > W_NK:
        raise ValueError(f"K6 expects {rh}x{rw} carried cells of a {ws}x{ws} window in "
                         f">= {rh * rw} slots, with the pad cells <= {W_NK} keys, got {n}")
    out = _out(out, qkv, s, n, heads * hd)
    scale = hd ** -0.5
    code = _lib().k6_rel_attention_window_rect(
        ptr(qkv), ptr(tables), ptr(qkv_bias), ptr(out), s, n, heads, hd, ws, rh, rw,
        scale, 1.0 / scale, stream())
    raise_on_error("K6 rel_attention_window_rect", code)
    LAUNCHES["K6"] += 1
    return out


def rel_attention_global(qkv, tables, *, kh: int, kw: int, heads: int,
                         hd: int, int8_qk: bool = False, int8_pv: bool = False) -> torch.Tensor:
    """K7 over (B, kh*kw, heads*3*hd) token grids; every token is a key.
    ``int8_qk`` runs K7-int8: the q.k product on the int8 tensor cores;
    ``int8_pv`` K7-pv (K7-int8pv with ``int8_qk``): p.v in int8 too."""
    if qkv.device.type == "cpu":
        return rel_attention_global_plain(qkv, tables, kh=kh, kw=kw, heads=heads, hd=hd,
                                          int8_qk=int8_qk, int8_pv=int8_pv)
    s, n = _check(qkv, tables, heads, hd, kh, kw)
    if n != kh * kw:
        raise ValueError(f"K7 expects {kh}x{kw} tokens, got {n}")
    _check_global(kh, kw, qkv=qkv)
    dev = qkv.device
    out = torch.empty((s, n, heads * hd), dtype=qkv.dtype, device=dev)
    scale = hd ** -0.5
    kq = kmax = None
    if int8_qk:
        hdp = -(-hd // 32) * 32                    # the int8 k-step is 32 wide
        kq = torch.empty((s, heads, n, hdp), dtype=torch.int8, device=dev)
        kmax = torch.empty((s, heads, hd), dtype=torch.float32, device=dev)
    if int8_pv:
        nkp = -(-n // 64) * 64                     # keys padded to the 64-key tile
        vq = torch.empty((s, heads, hd, nkp), dtype=torch.int8, device=dev)
        vmax = torch.empty((s, heads, hd), dtype=torch.float32, device=dev)
        _check_global(kh, kw, vq=vq)
        code = _lib().k7_rel_attention_global_pv(
            ptr(qkv), ptr(tables), ptr(kq), ptr(kmax), ptr(vq), ptr(vmax), ptr(out), s, n,
            heads, hd, kh, kw, int(int8_qk), scale, 1.0 / scale, stream())
        if int8_qk:
            raise_on_error("K7-int8pv rel_attention_global", code)
            LAUNCHES["K7-int8pv"] += 1
        else:
            raise_on_error("K7-pv rel_attention_global", code)
            LAUNCHES["K7-pv"] += 1
        return out
    if int8_qk:
        code = _lib().k7_rel_attention_global_int8(
            ptr(qkv), ptr(tables), ptr(kq), ptr(kmax), ptr(out), s, n, heads, hd,
            kh, kw, scale, 1.0 / scale, stream())
        raise_on_error("K7-int8 rel_attention_global", code)
        LAUNCHES["K7-int8"] += 1
        return out
    code = _lib().k7_rel_attention_global(
        ptr(qkv), ptr(tables), ptr(out), s, n, heads, hd, kh, kw, scale,
        1.0 / scale, stream())
    raise_on_error("K7 rel_attention_global", code)
    LAUNCHES["K7"] += 1
    return out


# ---------------------------------------------------------------------------
# K16: the softmax forms and ablations of the attention experiment tools
# ---------------------------------------------------------------------------

#: (softmax, rel, exp) -> (K16's form code in ``csrc/attention_forms.cu``, its
#: launch count); (v2, full, exp) is K5's and K7's own loop
FORMS = {("v1", "full", True): (1, "K16-v1"), ("v3", "full", True): (3, "K16-v3"),
         ("v2", "none", True): (4, "K16-norel"), ("v2", "base0", True): (5, "K16-noroll"),
         ("v2", "full", False): (6, "K16-noexp")}
#: the forms K16 runs on a window only (a sequence of <= 208 rows)
WINDOW_ONLY = ("K16-norel", "K16-noroll", "K16-noexp")


def forms_kernel(n: int, softmax: str = "v2", rel: str = "full", exp: bool = True) -> str:
    """The counted kernel that runs a form on sequences of n rows: K5 or K7
    for (v2, full, exp), else K16's instance."""
    if (softmax, rel, exp) == ("v2", "full", True):
        return "K5" if n <= 208 else "K7"
    if (softmax, rel, exp) not in FORMS:
        raise ValueError(f"no kernel computes softmax={softmax!r}, rel={rel!r}, exp={exp}: "
                         f"K16's forms are {sorted(FORMS)}")
    name = FORMS[softmax, rel, exp][1]
    if name in WINDOW_ONLY and n > 208:
        raise ValueError(f"{name} runs on windows of <= 208 rows, got {n}")
    return name


def rel_attention_forms(qkv, tables, *, kh: int, kw: int, heads: int, hd: int, nkeys: int,
                        softmax: str = "v2", rel: str = "full", exp: bool = True) -> torch.Tensor:
    """The attention of K5 (a window of <= 208 rows, the first ``nkeys`` of them
    keys) or K7 (a kh x kw grid, every token a key) in a form of the attention
    experiment tools (:func:`rel_attention_plain`'s ``softmax``, ``rel``,
    ``exp``).  (v2, full, exp) launches K5 or K7, whose online softmax applies
    1 / sum after p . v as v2 does; every other form launches K16's instance
    (:data:`FORMS`).  qkv (S, n, heads*3*hd) -> (S, n, heads*hd)."""
    if qkv.device.type == "cpu":
        return rel_attention_plain(qkv, tables, heads=heads, hd=hd, kh=kh, kw=kw, nkeys=nkeys,
                                   softmax=softmax, rel=rel, exp=exp)
    name = forms_kernel(qkv.shape[1], softmax, rel, exp)
    if name == "K5":
        if kh != kw or nkeys != kh * kw:
            raise ValueError(f"K5 runs square windows of ws*ws keys, got {kh}x{kw}, {nkeys}")
        return rel_attention_window(qkv, tables, ws=kh, heads=heads, hd=hd)
    if name == "K7":
        return rel_attention_global(qkv, tables, kh=kh, kw=kw, heads=heads, hd=hd)
    s, n = _check(qkv, tables, heads, hd, kh, kw)
    if nkeys != kh * kw or n < nkeys or (n > 208 and n != nkeys):
        raise ValueError(f"{name} expects a {kh}x{kw} grid of keys in a window of <= 208 rows "
                         f"or in the whole sequence, got {nkeys} keys in {n} rows")
    if n > 208:
        _check_global(kh, kw, qkv=qkv)
    out = torch.empty((s, n, heads * hd), dtype=qkv.dtype, device=qkv.device)
    scale = hd ** -0.5
    code = _forms_lib().k16_rel_attention_forms(
        ptr(qkv), ptr(tables), ptr(out), s, n, nkeys, heads, hd, kh, kw,
        FORMS[softmax, rel, exp][0], scale, 1.0 / scale, stream())
    raise_on_error(f"{name} rel_attention_forms", code)
    LAUNCHES[name] += 1
    return out


# ---------------------------------------------------------------------------
# K9, K10, K11: the rel terms come from the caller
# ---------------------------------------------------------------------------


def rel_attention_pre_plain(q, k, v, rel_h, rel_w, *, kh: int, kw: int) -> torch.Tensor:
    """Plain version of K9.  q, k, v (G, N, hd), N = kh*kw; rel_h (G, N, kh);
    rel_w (G, N, kw) -> (G, N, hd)."""
    dt = q.dtype
    g, n, _ = q.shape
    scale = q.shape[-1] ** -0.5
    inv = 1.0 / scale
    out = torch.empty_like(q)
    step = max(1, 2 ** 27 // (n * n))          # bounds the (step, n, n) fp32 temporaries
    for i in range(0, g, step):
        sl = slice(i, i + step)
        rh = (rel_h[sl].float() * inv).to(dt).float()
        rw = (rel_w[sl].float() * inv).to(dt).float()
        bias = rh.repeat_interleave(kw, dim=-1) + rw.repeat(1, 1, kh)
        logits = (q[sl].float() @ k[sl].float().transpose(1, 2) + bias) * scale
        p = torch.softmax(logits, dim=-1).to(dt).float()
        out[sl] = (p @ v[sl].float()).to(dt)
    return out


def rel_attention_headmajor_plain(qkv, rel_h, rel_w, *, kh: int, kw: int, heads: int,
                                  hd: int) -> torch.Tensor:
    """Plain version of K10 and K11.  qkv (S, N, heads*3*hd) grouped per head;
    rel_h (heads, S, N, kh); rel_w (heads, S, N, kw) -> (S, N, heads*hd)."""
    s, n, _ = qkv.shape
    x = qkv.reshape(s, n, heads, 3, hd).permute(3, 2, 0, 1, 4).reshape(3, heads * s, n, hd)
    out = rel_attention_pre_plain(x[0], x[1], x[2], rel_h.reshape(heads * s, n, kh),
                                  rel_w.reshape(heads * s, n, kw), kh=kh, kw=kw)
    return out.reshape(heads, s, n, hd).permute(1, 2, 0, 3).reshape(s, n, heads * hd)


def rel_attention_pre(q, k, v, rel_h, rel_w, *, kh: int, kw: int) -> torch.Tensor:
    """K9 over G = batch * heads sequences of N = kh*kw tokens, every token a
    key: a sequence of up to 208 tokens (a window) is one item of the window
    kernel, a longer one (the global grid) runs 128 queries per block."""
    if q.device.type == "cpu":
        return rel_attention_pre_plain(q, k, v, rel_h, rel_w, kh=kh, kw=kw)
    g, n, hd = q.shape
    bf = torch.bfloat16
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_cuda(name, t, (g, n, hd), bf)
    check_cuda("rel_h", rel_h, (g, n, kh), bf)
    check_cuda("rel_w", rel_w, (g, n, kw), bf)
    _check_hd(hd)
    if n != kh * kw:
        raise ValueError(f"K9 expects {kh}x{kw} tokens, got {n}")
    if n > 208:
        _check_global(kh, kw, q=q, k=k, v=v)
    out = torch.empty_like(q)
    scale = hd ** -0.5
    code = _lib().k9_rel_attention_pre(
        ptr(q), ptr(k), ptr(v), ptr(rel_h), ptr(rel_w), ptr(out), g, n, hd, kh, kw,
        scale, 1.0 / scale, stream())
    raise_on_error("K9 rel_attention_pre", code)
    LAUNCHES["K9"] += 1
    return out


def _check_headmajor(qkv, rel_h, rel_w, kh, kw, heads, hd):
    s, n, _ = qkv.shape
    bf = torch.bfloat16
    check_cuda("qkv", qkv, (s, n, heads * 3 * hd), bf)
    check_cuda("rel_h", rel_h, (heads, s, n, kh), bf)
    check_cuda("rel_w", rel_w, (heads, s, n, kw), bf)
    _check_hd(hd)
    if n != kh * kw:
        raise ValueError(f"expected {kh}x{kw} tokens, got {n}")
    return s, n


def rel_attention_headmajor(qkv, rel_h, rel_w, *, kh: int, kw: int, heads: int,
                            hd: int) -> torch.Tensor:
    """K10 over (Wb, kh*kw, heads*3*hd) windows of at most 208 tokens, one
    item of the window kernel per (window, head)."""
    if qkv.device.type == "cpu":
        return rel_attention_headmajor_plain(qkv, rel_h, rel_w, kh=kh, kw=kw, heads=heads,
                                             hd=hd)
    s, n = _check_headmajor(qkv, rel_h, rel_w, kh, kw, heads, hd)
    if n > W_NK:
        raise ValueError(f"K10 takes one window of <= {W_NK} tokens per sequence, got {n}")
    out = torch.empty((s, n, heads * hd), dtype=qkv.dtype, device=qkv.device)
    scale = hd ** -0.5
    code = _lib().k10_rel_attention_headmajor(
        ptr(qkv), ptr(rel_h), ptr(rel_w), ptr(out), s, n, heads, hd, kh, kw,
        scale, 1.0 / scale, stream())
    raise_on_error("K10 rel_attention_headmajor", code)
    LAUNCHES["K10"] += 1
    return out


def rel_attention_headmajor_global(qkv, rel_h, rel_w, *, kh: int, kw: int, heads: int,
                                   hd: int) -> torch.Tensor:
    """K11 over (B, kh*kw, heads*3*hd) token grids, 128 queries per block."""
    if qkv.device.type == "cpu":
        return rel_attention_headmajor_plain(qkv, rel_h, rel_w, kh=kh, kw=kw, heads=heads,
                                             hd=hd)
    s, n = _check_headmajor(qkv, rel_h, rel_w, kh, kw, heads, hd)
    _check_global(kh, kw, qkv=qkv)
    out = torch.empty((s, n, heads * hd), dtype=qkv.dtype, device=qkv.device)
    scale = hd ** -0.5
    code = _lib().k11_rel_attention_headmajor_global(
        ptr(qkv), ptr(rel_h), ptr(rel_w), ptr(out), s, n, heads, hd, kh, kw,
        scale, 1.0 / scale, stream())
    raise_on_error("K11 rel_attention_headmajor_global", code)
    LAUNCHES["K11"] += 1
    return out


# ---------------------------------------------------------------------------
# K12: a whole windowed attention, projections included
# ---------------------------------------------------------------------------


def window_block_attention_plain(xn, qkv_w, qkv_b, proj_w, tables, *, ws: int, heads: int,
                                 round_qk: bool = True) -> torch.Tensor:
    """Plain version of K12.  xn (Wb, ws*ws, E); qkv_w (heads*3*hd, E) and
    qkv_b (heads*3*hd) grouped per head; proj_w (E, E) as ``nn.Linear`` holds
    it; tables as K5's -> (Wb, ws*ws, E), before the projection's bias.
    ``round_qk=False`` keeps q and k in fp32 up to the logits, as the JAX body
    does (the tensor cores take them in the compute type)."""
    wb, n, e = xn.shape
    dt = xn.dtype
    hd = e // heads
    scale = hd ** -0.5
    tab = tables.float()
    tok = torch.arange(n, device=xn.device)
    idx_h = ((tok // ws)[:, None] - (tok // ws)[None] + ws - 1).expand(wb, n, n)
    idx_w = ((tok % ws)[:, None] - (tok % ws)[None] + ws - 1 + 2 * ws - 1).expand(wb, n, n)
    w = qkv_w.float().reshape(heads, 3, hd, e)
    b = qkv_b.float().reshape(heads, 3, hd)
    wp = proj_w.float().reshape(e, heads, hd)
    acc = torch.zeros((wb, n, e), dtype=torch.float32, device=xn.device)
    x = xn.float()
    for h in range(heads):
        q, k, v = (x @ w[h, i].T + b[h, i] for i in range(3))
        if round_qk:
            q, k = q.to(dt).float(), k.to(dt).float()
        v = v.to(dt).float()
        g = (q @ tab.T * (1.0 / scale)).to(dt).float()
        logits = (q @ k.transpose(1, 2) + g.gather(2, idx_h) + g.gather(2, idx_w)) * scale
        p = torch.softmax(logits, dim=-1).to(dt).float()
        acc += (p @ v).to(dt).float() @ wp[:, h].T
    return acc.to(dt)


#: K12's kernel instances: (head dim, heads per block)
BLOCK_INSTANCES = ((16, 1), (64, 2), (80, 2))


def window_block_geometry(e: int, heads: int):
    """K12's thread-block cluster for E = heads * hd: (C, heads per block,
    output columns per block).  C, the blocks of one window's cluster, is the
    largest divisor of ``heads`` up to 8 (``csrc/block_attention.cu:
    block_cluster``): 8 at ViT-H and ViT-L (16 heads), 6 at ViT-B (12), 2 at
    vit_t (2).  Block r owns heads r * HB .. (r + 1) * HB - 1 and computes the
    output columns r * E / C .. (r + 1) * E / C - 1, which are its heads'
    columns of O as wide (HB * hd)."""
    c = max(d for d in range(1, min(heads, 8) + 1) if heads % d == 0)
    return c, heads // c, e // c


def window_block_info(hd: int, heads: int):
    """(dynamic shared memory in bytes, clusters that fit the card at once) of
    K12's instance for a head dim and head count; on the card only."""
    smem, clusters = ctypes.c_int(), ctypes.c_int()
    code = _block_lib().k12_block_info(hd, heads, ctypes.addressof(smem),
                                       ctypes.addressof(clusters))
    raise_on_error("K12 block info", code)
    return smem.value, clusters.value


def window_block_attention(xn, qkv_w, qkv_b, proj_w, tables, *, ws: int,
                           heads: int) -> torch.Tensor:
    """K12 over (Wb, ws*ws, E) LayerNormed, pad-masked windows of at most 208
    tokens: one cluster of blocks per window (:func:`window_block_geometry`).
    Each block projects its heads' q, k, v, runs their attention into its
    shared memory, and then computes its share of the output columns as one
    fp32 product over all heads' outputs, read from the blocks that hold
    them, in a fixed order: the output is rounded once to the compute type
    and is the same on every call.  The call allocates only its output."""
    if xn.device.type == "cpu":
        return window_block_attention_plain(xn, qkv_w, qkv_b, proj_w, tables, ws=ws,
                                            heads=heads)
    wb, n, e = xn.shape
    hd = e // heads
    bf = torch.bfloat16
    check_cuda("xn", xn, (wb, n, e), bf)
    check_cuda("qkv_w", qkv_w, (3 * e, e), bf)
    check_cuda("qkv_b", qkv_b, (3 * e,), torch.float32)
    check_cuda("proj_w", proj_w, (e, e), bf)
    check_cuda("tables", tables, (2 * (2 * ws - 1), hd), bf)
    _check_hd(hd)
    if n != ws * ws or n > 208 or e != heads * hd or e % 32:
        raise ValueError(f"K12 expects windows of {ws}x{ws} <= 208 tokens and E = heads * hd "
                         f"divisible by 32, got {n} tokens, E {e}, {heads} heads")
    cluster, per_block, _ = window_block_geometry(e, heads)
    if (hd, per_block) not in BLOCK_INSTANCES:
        raise ValueError(f"K12 has no kernel for head dim {hd} at {per_block} heads per block "
                         f"({heads} heads); it has (head dim, heads per block) "
                         f"{BLOCK_INSTANCES}")
    out = torch.empty_like(xn)
    scale = hd ** -0.5
    code = _block_lib().k12_window_block_attention(
        ptr(xn), ptr(qkv_w), ptr(qkv_b), ptr(proj_w), ptr(tables), ptr(out),
        wb, n, e, heads, ws, cluster, scale, 1.0 / scale, stream())
    raise_on_error("K12 window_block_attention", code)
    LAUNCHES["K12"] += 1
    return out
