"""K5, K7 and K7-int8: attention with SAM's decomposed relative-position bias.

K5 ``rel_attention_window`` runs one window per sequence (JAX
``kernels/attention.py:fused_rel_attention_window3d``); K7
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
"""

from __future__ import annotations

import ctypes

import torch

from samcarriestheburden_torch.kernels import (LAUNCHES, build, check_cuda, ptr,
                                               raise_on_error, stream)

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib():
    lib = build.load("attention")
    if not getattr(lib, "_typed", False):
        lib.k5_rel_attention_window.argtypes = [_VP] * 3 + [_I] * 6 + [_F, _F, _VP]
        lib.k5_rel_attention_window.restype = _I
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


def rel_attention_window_plain(qkv, tables, *, ws: int, heads: int, hd: int):
    """Plain version of K5."""
    return rel_attention_plain(qkv, tables, heads=heads, hd=hd, kh=ws, kw=ws,
                               nkeys=ws * ws)


def rel_attention_global_plain(qkv, tables, *, kh: int, kw: int, heads: int,
                               hd: int, int8_qk: bool = False):
    """Plain version of K7 and, with ``int8_qk``, of K7-int8."""
    return rel_attention_plain(qkv, tables, heads=heads, hd=hd, kh=kh, kw=kw,
                               nkeys=kh * kw, int8_qk=int8_qk)


# ---------------------------------------------------------------------------
# K5, K7, K7-int8
# ---------------------------------------------------------------------------


def _check(qkv, tables, heads, hd, kh, kw):
    s, n, c = qkv.shape
    check_cuda("qkv", qkv, (s, n, heads * 3 * hd), torch.bfloat16)
    check_cuda("tables", tables, (2 * kh - 1 + 2 * kw - 1, hd), torch.bfloat16)
    if hd not in (16, 32, 64, 80):
        raise ValueError(f"head dim {hd} has no kernel instance (16, 32, 64, 80)")
    return s, n


def rel_attention_window(qkv, tables, *, ws: int, heads: int, hd: int) -> torch.Tensor:
    """K5 over (Wb, np, heads*3*hd) windows of ws*ws live tokens (np >= ws*ws)."""
    nkeys = ws * ws
    if qkv.device.type == "cpu":
        return rel_attention_window_plain(qkv, tables, ws=ws, heads=heads, hd=hd)
    s, n = _check(qkv, tables, heads, hd, ws, ws)
    if n < nkeys or n > 208:
        raise ValueError(f"K5 holds one window of <= 208 slots per block, got {n}")
    out = torch.empty((s, n, heads * hd), dtype=qkv.dtype, device=qkv.device)
    scale = hd ** -0.5
    code = _lib().k5_rel_attention_window(
        ptr(qkv), ptr(tables), ptr(out), s, n, nkeys, heads, hd, ws,
        scale, 1.0 / scale, stream())
    raise_on_error("K5 rel_attention_window", code)
    LAUNCHES["K5"] += 1
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
