"""K5, K6, K7 and K7-int8: attention with SAM's decomposed relative-position bias.

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


def rel_attention_plain(qkv, tables, *, heads: int, hd: int, kh: int, kw: int,
                        nkeys: int, int8_qk: bool = False) -> torch.Tensor:
    """Plain version of K5, K7 and (``int8_qk``) K7-int8.
    qkv (S, n, heads*3*hd) -> (S, n, heads*hd)."""
    s, n, _ = qkv.shape
    dt, dev = qkv.dtype, qkv.device
    scale = hd ** -0.5
    x = qkv.reshape(s, n, heads, 3 * hd).float()
    tab = tables.float()
    tok = torch.arange(n, device=dev)
    ph = (tok // kw).clamp(max=kh - 1)
    pw = tok % kw
    key = torch.arange(nkeys, device=dev)
    idx_h = (ph[:, None] - (key // kw)[None] + kh - 1).expand(s, n, nkeys)
    idx_w = (pw[:, None] - (key % kw)[None] + kw - 1 + 2 * kh - 1).expand(s, n, nkeys)
    out = torch.empty((s, n, heads, hd), dtype=dt, device=dev)
    for h in range(heads):
        q = x[:, :, h, :hd]
        k = x[:, :nkeys, h, hd:2 * hd]
        v = x[:, :nkeys, h, 2 * hd:]
        g = (q @ tab.T * (1.0 / scale)).to(dt).float()          # (S, n, Rh+Rw)
        bias = g.gather(2, idx_h) + g.gather(2, idx_w)
        qk = int8_qk_plain(q, k) if int8_qk else q @ k.transpose(1, 2)
        logits = (qk + bias) * scale
        p = torch.softmax(logits, dim=-1).to(dt).float()
        out[:, :, h] = (p @ v).to(dt)
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
                               hd: int, int8_qk: bool = False):
    """Plain version of K7 and, with ``int8_qk``, of K7-int8."""
    return rel_attention_plain(qkv, tables, heads=heads, hd=hd, kh=kh, kw=kw,
                               nkeys=kh * kw, int8_qk=int8_qk)


# ---------------------------------------------------------------------------
# K5, K6, K7, K7-int8
# ---------------------------------------------------------------------------


def _check(qkv, tables, heads, hd, kh, kw):
    s, n, c = qkv.shape
    check_cuda("qkv", qkv, (s, n, heads * 3 * hd), torch.bfloat16)
    check_cuda("tables", tables, (2 * kh - 1 + 2 * kw - 1, hd), torch.bfloat16)
    if hd not in (16, 32, 64, 80):
        raise ValueError(f"head dim {hd} has no kernel instance (16, 32, 64, 80)")
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
    if n < nkeys or n > 208:
        raise ValueError(f"K5 holds one window of <= 208 slots per block, got {n}")
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
    if not (1 <= rh <= ws and 1 <= rw <= ws) or n < rh * rw:
        raise ValueError(f"K6 expects {rh}x{rw} carried cells of a {ws}x{ws} window in "
                         f">= {rh * rw} slots, got {n}")
    out = _out(out, qkv, s, n, heads * hd)
    scale = hd ** -0.5
    code = _lib().k6_rel_attention_window_rect(
        ptr(qkv), ptr(tables), ptr(qkv_bias), ptr(out), s, n, heads, hd, ws, rh, rw,
        scale, 1.0 / scale, stream())
    raise_on_error("K6 rel_attention_window_rect", code)
    LAUNCHES["K6"] += 1
    return out


def rel_attention_global(qkv, tables, *, kh: int, kw: int, heads: int,
                         hd: int, int8_qk: bool = False) -> torch.Tensor:
    """K7 over (B, kh*kw, heads*3*hd) token grids; every token is a key.
    ``int8_qk`` runs K7-int8: the q.k product on the int8 tensor cores."""
    if qkv.device.type == "cpu":
        return rel_attention_global_plain(qkv, tables, kh=kh, kw=kw,
                                          heads=heads, hd=hd, int8_qk=int8_qk)
    s, n = _check(qkv, tables, heads, hd, kh, kw)
    if n != kh * kw:
        raise ValueError(f"K7 expects {kh}x{kw} tokens, got {n}")
    out = torch.empty((s, n, heads * hd), dtype=qkv.dtype, device=qkv.device)
    scale = hd ** -0.5
    if int8_qk:
        hdp = -(-hd // 32) * 32                    # the int8 k-step is 32 wide
        kq = torch.empty((s, heads, n, hdp), dtype=torch.int8, device=qkv.device)
        kmax = torch.empty((s, heads, hd), dtype=torch.float32, device=qkv.device)
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
