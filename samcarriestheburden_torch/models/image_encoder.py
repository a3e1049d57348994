"""ViTDet-style SAM image encoder (reference segment_anything/modeling/image_encoder.py).

Parameters carry the reference's names, so its state dicts load with
``load_state_dict``.  The forward runs the JAX package's flat-window
formulation (JAX ``image_encoder.py:apply`` with ``fused_qkv`` and
``fused_mlp``): windowed blocks carry (Wb, np, E) windows padded to
np = ceil(ws^2 / 8) * 8 slots, and every block is

    qkv = K1(x, pad mask)             LN1 + pad re-zeroing + qkv projection
    a   = proj(K5 or K7(qkv))          windowed or global rel-pos attention
    x   = K3(x, add=a)                 residual + LN2 + MLP + residual

in the compute dtype (bf16 on the card), then the neck in fp32.  The
re-zeroing of pad tokens after LN1 reproduces the reference's fresh zero
padding at every window partition: a pad token's k and v are the qkv bias.

The compact ragged-window layout (``compact_windows``, the serving default;
JAX ``apply(compact_windows=True)``) carries no pad token where the token
grid is no multiple of the window: the windows fall into the groups of
:func:`compact_window_groups`, full interior windows as above and edge
windows that hold only their image cells, whose attention (K6) makes the pad
keys from the qkv bias.  ViT-H carries 4208 slot-rows per image instead of
5000.  K1-K4 and the output projection are row-wise, so the groups live one
after the other in one (rows, E) stream and each of those runs once per
block over all of it; K5 and K6 read and write views of the groups' row
ranges (the JAX package keeps one carry per group, because a joint stream
cost it slices and concatenations; views cost nothing here).

The int8 serving mode (JAX ``quantize="int8"``) runs the same blocks over
prequantized weights (``models/quantize.py``):

    qkv = K2(x, pad mask)             LN1 + re-zeroing + per-row int8 + int8 product
    a   = proj(K5 or K7-int8(qkv))     K5 stays bf16; K7's q.k product runs in int8
    x   = K4(x, add=a)                 K3 with both products in int8

The JAX package's three other block formulations run too, chosen by JAX
``apply``'s own keywords (``forward``'s docstring) or called as block
functions.  All carry windows in the 4-D layout (Wb, ws, ws, E), pad tokens
re-zeroed after LN1:

    v1  attention_impl(LN1(x) * mask), x + a, then K3 or the plain MLP; with
        ``attention_apply_kernel`` the attention is K9 on q, k, v split per
        head and rel terms made by two einsums (JAX ``attention_apply_pallas``),
        with ``attention_apply`` plain PyTorch, the oracle of every other path
    v2  K12(LN1(x) * mask) + bias + x, then K3: the whole windowed attention,
        projections included, in one kernel (JAX ``_block_apply_windowed_fused``)
    v3  K1, rel terms from the head-grouped qkv (``rel_bias_headmajor``), K10
        (global: K11), projection, K3 (JAX ``_windowed_attention_headmajor``)
"""

from __future__ import annotations

from functools import partial
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from samcarriestheburden_torch.config import ImageEncoderConfig
from samcarriestheburden_torch.kernels import attention as attn_k
from samcarriestheburden_torch.kernels import mlp as mlp_k
from samcarriestheburden_torch.kernels import quant as quant_k
from samcarriestheburden_torch.models.common import LayerNorm2d, MLPBlock, gelu, layer_norm
from samcarriestheburden_torch.models.quantize import is_prequantized, quantize_block


class EncoderOps(NamedTuple):
    """The kernels a forward runs: the wrappers (:data:`KERNEL_OPS`,
    :data:`KERNEL_OPS_INT8`) or, to hold the kernels against them on the card,
    the plain versions.  ``int8`` says which weights the first two take: the
    floating-point pack (K1, K3) or the prequantized one (K2, K4).  The
    windowed attentions (K5, K6) are bf16 in both modes.  The last four (K10,
    K11, K12, K9) serve the v3, v2 and v1 block formulations only; K9 is what
    :func:`attention_apply_kernel` launches."""

    ln_masked_linear: object
    ln_mlp_residual: object
    rel_attention_window: object
    rel_attention_global: object
    rel_attention_window_rect: object
    int8: bool = False
    rel_attention_headmajor: object = attn_k.rel_attention_headmajor
    rel_attention_headmajor_global: object = attn_k.rel_attention_headmajor_global
    window_block_attention: object = attn_k.window_block_attention
    rel_attention_pre: object = attn_k.rel_attention_pre


KERNEL_OPS = EncoderOps(mlp_k.ln_masked_linear, mlp_k.ln_mlp_residual,
                        attn_k.rel_attention_window, attn_k.rel_attention_global,
                        attn_k.rel_attention_window_rect)
_PLAIN_VARIANTS = dict(rel_attention_headmajor=attn_k.rel_attention_headmajor_plain,
                       rel_attention_headmajor_global=attn_k.rel_attention_headmajor_plain,
                       window_block_attention=attn_k.window_block_attention_plain,
                       rel_attention_pre=attn_k.rel_attention_pre_plain)
PLAIN_OPS = EncoderOps(mlp_k.ln_masked_linear_plain, mlp_k.ln_mlp_residual_plain,
                       attn_k.rel_attention_window_plain,
                       attn_k.rel_attention_global_plain,
                       attn_k.rel_attention_window_rect_plain, **_PLAIN_VARIANTS)
KERNEL_OPS_INT8 = EncoderOps(quant_k.ln_masked_linear_int8, quant_k.ln_mlp_residual_int8,
                             attn_k.rel_attention_window,
                             partial(attn_k.rel_attention_global, int8_qk=True),
                             attn_k.rel_attention_window_rect, int8=True)
PLAIN_OPS_INT8 = EncoderOps(quant_k.ln_masked_linear_int8_plain,
                            quant_k.ln_mlp_residual_int8_plain,
                            attn_k.rel_attention_window_plain,
                            partial(attn_k.rel_attention_global_plain, int8_qk=True),
                            attn_k.rel_attention_window_rect_plain, int8=True, **_PLAIN_VARIANTS)


def default_ops(quantize: Optional[str]) -> EncoderOps:
    """The kernel wrappers of a serving mode: ``None`` (bf16) or ``"int8"``."""
    if quantize not in (None, "int8"):
        raise ValueError(f"quantize must be None or 'int8', got {quantize!r}")
    return KERNEL_OPS_INT8 if quantize == "int8" else KERNEL_OPS


# ---------------------------------------------------------------------------
# modules (reference parameter names)
# ---------------------------------------------------------------------------


class PatchEmbed(nn.Module):
    def __init__(self, cfg: ImageEncoderConfig):
        super().__init__()
        p = cfg.patch_size
        self.proj = nn.Conv2d(cfg.in_chans, cfg.embed_dim, kernel_size=p, stride=p)


class Attention(nn.Module):
    def __init__(self, cfg: ImageEncoderConfig, window_size: int):
        super().__init__()
        e = cfg.embed_dim
        self.qkv = nn.Linear(e, 3 * e, bias=cfg.qkv_bias)
        self.proj = nn.Linear(e, e)
        if cfg.use_rel_pos:
            s = window_size if window_size > 0 else cfg.grid_size
            self.rel_pos_h = nn.Parameter(torch.zeros(2 * s - 1, cfg.head_dim))
            self.rel_pos_w = nn.Parameter(torch.zeros(2 * s - 1, cfg.head_dim))


class Block(nn.Module):
    def __init__(self, cfg: ImageEncoderConfig, window_size: int):
        super().__init__()
        e = cfg.embed_dim
        self.window_size = window_size
        self.norm1 = nn.LayerNorm(e, eps=cfg.layer_norm_eps)
        self.attn = Attention(cfg, window_size)
        self.norm2 = nn.LayerNorm(e, eps=cfg.layer_norm_eps)
        self.mlp = MLPBlock(e, int(e * cfg.mlp_ratio))


# ---------------------------------------------------------------------------
# window partition (static shapes; reference image_encoder.py:243-289)
# ---------------------------------------------------------------------------


def window_partition(x: torch.Tensor, ws: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """(B, H, W, C) -> (B*nW, ws, ws, C) with bottom/right zero padding."""
    b, h, w, c = x.shape
    pad_h, pad_w = (ws - h % ws) % ws, (ws - w % ws) % ws
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.reshape(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, c), (hp, wp)


def window_unpartition(windows: torch.Tensor, ws: int, pad_hw: Tuple[int, int],
                       hw: Tuple[int, int]) -> torch.Tensor:
    hp, wp = pad_hw
    h, w = hw
    c = windows.shape[-1]
    b = windows.shape[0] // (hp * wp // ws // ws)
    x = windows.reshape(b, hp // ws, wp // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp, wp, c)[:, :h, :w].contiguous()


def window_partition_flat(x: torch.Tensor, ws: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """(B, H, W, C) -> (B*nW, np, C) flat windows, np = ws^2 rounded up to 8;
    the dead slots are zero (JAX ``window_partition_flat``)."""
    windows, pad_hw = window_partition(x, ws)
    n = ws * ws
    np_ = -(-n // 8) * 8
    flat = windows.reshape(windows.shape[0], n, x.shape[-1])
    if np_ != n:
        flat = F.pad(flat, (0, 0, 0, np_ - n))
    return flat.contiguous(), pad_hw


def window_unpartition_flat(flat: torch.Tensor, ws: int, pad_hw: Tuple[int, int],
                            hw: Tuple[int, int]) -> torch.Tensor:
    n = ws * ws
    windows = flat[:, :n].reshape(-1, ws, ws, flat.shape[-1])
    return window_unpartition(windows, ws, pad_hw, hw)


def pad_valid_flat(b: int, h: int, w: int, ws: int, dtype, device) -> torch.Tensor:
    """(B*nW, np, 1) mask: 1 on image tokens, 0 on pad tokens and dead slots."""
    ones = torch.ones((b, h, w, 1), dtype=dtype, device=device)
    return window_partition_flat(ones, ws)[0]


def pad_valid_mask(b: int, h: int, w: int, ws: int, dtype, device) -> torch.Tensor:
    """(B*nW, ws, ws, 1) mask of image (not padded) token positions (JAX
    ``_pad_valid_mask``)."""
    ones = torch.ones((b, h, w, 1), dtype=dtype, device=device)
    return window_partition(ones, ws)[0]


# ---------------------------------------------------------------------------
# compact ragged-window layout (JAX image_encoder.py:521-625)
# ---------------------------------------------------------------------------


def compact_window_groups(h: int, w: int, ws: int) -> List[Dict[str, int]]:
    """The compact layout of an (h, w) token grid: groups in stream order
    [interior | right edge | bottom strip], each with the carried window
    shape (rh, rw), the window counts (nh, nw), the region's origin (y0, x0)
    and the 8-aligned slot count np.  The bottom strip spans the full width:
    the slots of its last window that lie beyond the image ride as
    zero-masked slots, which is what the reference's zero-pad tokens are.
    Empty groups are dropped (JAX ``compact_window_groups``)."""
    h0, w0 = (h // ws) * ws, (w // ws) * ws
    groups = []

    def add(rh, rw, nh, nw, y0, x0):
        if nh and nw and rh and rw:
            groups.append(dict(rh=rh, rw=rw, nh=nh, nw=nw, y0=y0, x0=x0,
                               np=-(-(rh * rw) // 8) * 8))

    add(ws, ws, h0 // ws, w0 // ws, 0, 0)
    add(ws, w - w0, h0 // ws, 1, 0, w0)
    add(h - h0, ws, 1, -(-w // ws), h0, 0)
    return groups


def compact_group_mask(g: Dict[str, int], h: int, w: int, dtype, device) -> torch.Tensor:
    """(nh*nw*np, 1) mask of one group: 1 on image positions, 0 on the
    8-alignment dead slots and on the slots beyond the image."""
    rh, rw, nh, nw, np_ = g["rh"], g["rw"], g["nh"], g["nw"], g["np"]
    s = torch.arange(np_, device=device)
    y = g["y0"] + torch.arange(nh, device=device)[:, None, None] * rh + (s // rw)
    x = g["x0"] + torch.arange(nw, device=device)[None, :, None] * rw + (s % rw)
    ok = (s < rh * rw) & (y < h) & (x < w)
    return ok.to(dtype).reshape(nh * nw * np_, 1)


def window_partition_compact(x: torch.Tensor, groups) -> List[torch.Tensor]:
    """(B, H, W, C) -> per group (Wb, np, C), windows batch-major within a
    group (JAX ``window_partition_compact``; its masks are
    :func:`compact_group_mask`, tiled over the batch)."""
    b, _, _, c = x.shape
    parts = []
    for g in groups:
        rh, rw, nh, nw, np_ = g["rh"], g["rw"], g["nh"], g["nw"], g["np"]
        n = rh * rw
        blk = x[:, g["y0"]:g["y0"] + nh * rh, g["x0"]:g["x0"] + nw * rw]
        pad_h, pad_w = nh * rh - blk.shape[1], nw * rw - blk.shape[2]
        if pad_h or pad_w:           # bottom strip: beyond-image slots ride as zeros
            blk = F.pad(blk, (0, 0, 0, pad_w, 0, pad_h))
        blk = blk.reshape(b, nh, rh, nw, rw, c).permute(0, 1, 3, 2, 4, 5)
        blk = blk.reshape(b * nh * nw, n, c)
        if np_ != n:
            blk = F.pad(blk, (0, 0, 0, np_ - n))
        parts.append(blk.contiguous())
    return parts


def window_unpartition_compact(parts, groups, b: int, hw: Tuple[int, int]) -> torch.Tensor:
    """Inverse of :func:`window_partition_compact`: per-group (Wb, np, C)
    -> (B, H, W, C)."""
    h, w = hw
    c = parts[0].shape[-1]
    x = torch.empty((b, h, w, c), dtype=parts[0].dtype, device=parts[0].device)
    for g, blk in zip(groups, parts):
        rh, rw, nh, nw, np_ = g["rh"], g["rw"], g["nh"], g["nw"], g["np"]
        blk = blk.reshape(b, nh, nw, np_, c)[:, :, :, :rh * rw]
        blk = blk.reshape(b, nh, nw, rh, rw, c).permute(0, 1, 3, 2, 4, 5)
        blk = blk.reshape(b, nh * rh, nw * rw, c)
        y0, x0 = g["y0"], g["x0"]
        gh, gw = min(nh * rh, h - y0), min(nw * rw, w - x0)   # beyond-image slots dropped
        x[:, y0:y0 + gh, x0:x0 + gw] = blk[:, :gh, :gw]
    return x


def compact_spans(groups, b: int) -> List[Tuple[Dict[str, int], int, int]]:
    """(group, first row, end row) of each group in the joint (rows, E)
    stream of a batch of ``b`` images."""
    spans, r0 = [], 0
    for g in groups:
        r1 = r0 + b * g["nh"] * g["nw"] * g["np"]
        spans.append((g, r0, r1))
        r0 = r1
    return spans


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _weights(pk, name: str, ops) -> tuple:
    """The operands a matrix product of ``ops`` takes for ``name``: (w, b),
    or (wq, s, b) of the int8 pack."""
    if ops.int8:
        return pk[f"{name}_wq"], pk[f"{name}_s"], pk[f"{name}_b"]
    return pk[f"{name}_w"], pk[f"{name}_b"]


def _ln_qkv(pk, x2d, mask, cfg: ImageEncoderConfig, ops):
    """LN1 + pad re-zeroing + the per-head-grouped qkv projection (JAX ``_ln_qkv``)."""
    return ops.ln_masked_linear(x2d, mask, pk["norm1_w"], pk["norm1_b"],
                                *_weights(pk, "qkv", ops), cfg.layer_norm_eps)


def windowed_attention(pk, x3, pad3, cfg: ImageEncoderConfig, ops):
    """Attention of a windowed block over flat (Wb, np, E) windows
    (JAX ``_windowed_attention_headmajor3d``) -> (Wb*np, E)."""
    wb, np_, e = x3.shape
    t = wb * np_
    qkv = _ln_qkv(pk, x3.reshape(t, e), pad3.reshape(t, 1), cfg, ops)
    out = ops.rel_attention_window(qkv.reshape(wb, np_, -1), pk["tables"],
                                   ws=cfg.window_size, heads=cfg.num_heads,
                                   hd=cfg.head_dim)
    return F.linear(out.reshape(t, e), pk["proj_w"], pk["proj_b"])


def global_attention(pk, x, cfg: ImageEncoderConfig, ops):
    """Attention of a global block over (B, gh, gw, E)
    (JAX ``_global_attention_headmajor``) -> (B*gh*gw, E)."""
    b, gh, gw, e = x.shape
    t = b * gh * gw
    qkv = _ln_qkv(pk, x.reshape(t, e), None, cfg, ops)
    out = ops.rel_attention_global(qkv.reshape(b, gh * gw, -1), pk["tables"],
                                   kh=gh, kw=gw, heads=cfg.num_heads,
                                   hd=cfg.head_dim)
    return F.linear(out.reshape(t, e), pk["proj_w"], pk["proj_b"])


def _mlp_residual(pk, x2d, a, cfg: ImageEncoderConfig, ops, fused: bool = True):
    """``s + mlp(LN2(s))`` with ``s = x (+ a)``: K3 (K4) when ``fused``, else
    the plain composition in x's dtype (JAX ``_mlp_residual``)."""
    if fused:
        return ops.ln_mlp_residual(x2d, pk["norm2_w"], pk["norm2_b"],
                                   *_weights(pk, "lin1", ops), *_weights(pk, "lin2", ops),
                                   add=a, eps=cfg.layer_norm_eps)
    if a is not None:
        x2d = x2d + a
    dt = x2d.dtype
    hidden = gelu(F.linear(layer_norm(x2d, pk["norm2_w"], pk["norm2_b"], cfg.layer_norm_eps),
                           pk["lin1_w"], pk["lin1_b"].to(dt)))
    return x2d + F.linear(hidden, pk["lin2_w"], pk["lin2_b"].to(dt))


def block_windowed(pk, x3, pad3, cfg: ImageEncoderConfig, ops, fused_mlp: bool = True):
    """One windowed block over flat windows (JAX ``_block_apply_windowed3d``)."""
    a = windowed_attention(pk, x3, pad3, cfg, ops)
    return _mlp_residual(pk, x3.reshape(a.shape), a, cfg, ops, fused_mlp).reshape(x3.shape)


def block_windowed_compact(pk, x2d, mask, spans, cfg: ImageEncoderConfig, ops,
                           fused_mlp: bool = True):
    """One windowed block over the compact stream (rows, E) (JAX
    ``_block_apply_windowed_compact`` over every group at once): LN1 + qkv,
    the output projection and the MLP run over all rows; the full-window
    group goes through K5, each edge group through K6
    (JAX ``_windowed_attention_rect3d``), on views of their row ranges."""
    e = x2d.shape[1]
    ws, heads, hd = cfg.window_size, cfg.num_heads, cfg.head_dim
    qkv = _ln_qkv(pk, x2d, mask, cfg, ops)
    att = torch.empty_like(x2d)
    for g, r0, r1 in spans:
        q3 = qkv[r0:r1].view(-1, g["np"], qkv.shape[-1])
        o3 = att[r0:r1].view(-1, g["np"], e)
        if g["rh"] == ws and g["rw"] == ws:
            ops.rel_attention_window(q3, pk["tables"], ws=ws, heads=heads, hd=hd, out=o3)
        else:
            ops.rel_attention_window_rect(q3, pk["tables"], pk["qkv_b"], ws=ws, rh=g["rh"],
                                          rw=g["rw"], heads=heads, hd=hd, out=o3)
    a = F.linear(att, pk["proj_w"], pk["proj_b"])
    return _mlp_residual(pk, x2d, a, cfg, ops, fused_mlp)


def block_global(pk, x, cfg: ImageEncoderConfig, ops, fused_mlp: bool = True):
    """One global block over the (B, gh, gw, E) grid."""
    a = global_attention(pk, x, cfg, ops)
    return _mlp_residual(pk, x.reshape(a.shape), a, cfg, ops, fused_mlp).reshape(x.shape)


# ---------------------------------------------------------------------------
# the other block formulations: v1 (unfused; K9), v2 (K12), v3 (K10, K11)
# ---------------------------------------------------------------------------


def _rel_pos_indices(size: int, device) -> torch.Tensor:
    """(size, size) rows of a (2*size-1)-row rel-pos table: query - key + size - 1."""
    coords = torch.arange(size, device=device)
    return coords[:, None] - coords[None, :] + size - 1


def _rel_tables(pk, h: int, w: int):
    """A block's Rh (h, h, hd) and Rw (w, w, hd), gathered by relative offset
    from the stacked tables of its pack."""
    tables = pk["tables"]
    if tables.shape[0] != 2 * h - 1 + 2 * w - 1:
        raise ValueError(f"rel-pos tables of {tables.shape[0]} rows do not fit a {h}x{w} grid")
    rh, rw = tables[:2 * h - 1], tables[2 * h - 1:]
    return rh[_rel_pos_indices(h, tables.device)], rw[_rel_pos_indices(w, tables.device)]


def _rel_terms(q, rh, rw, h: int, w: int, dtype):
    """rel_h (G, h*w, h) and rel_w (G, h*w, w) of q (G, h*w, hd): q against the
    table row of each relative offset (both in q's dtype), accumulated in
    fp32, returned in ``dtype`` (q's, or fp32 for the unrounded sums)."""
    g, n, hd = q.shape
    r_q = q.reshape(g, h, w, hd).to(dtype)
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, rh.to(q.dtype).to(dtype)).reshape(g, n, h)
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, rw.to(q.dtype).to(dtype)).reshape(g, n, w)
    return rel_h, rel_w


def add_decomposed_rel_pos(attn, q, rh, rw, q_size: Tuple[int, int]) -> torch.Tensor:
    """attn (G, n, n) fp32 + the decomposed rel-pos bias of q (G, n, hd) on a
    ``q_size`` grid that is its own key grid; rh, rw from :func:`_rel_tables`
    (JAX ``add_decomposed_rel_pos``; the encoder's tables are sized for their
    grid, so that function's table resampling never applies)."""
    h, w = q_size
    rel_h, rel_w = _rel_terms(q, rh, rw, h, w, torch.float32)
    return attn + rel_h.repeat_interleave(w, dim=-1) + rel_w.repeat(1, 1, h)


def _linear(x, w, b):
    return F.linear(x, w, b.to(x.dtype))


def _qkv_heads(pk, x, heads: int):
    """The plain qkv projection of x (B, H, W, E), split per head: q, k, v
    (B*heads, H*W, hd).  The pack's per-head-grouped weight gives the values
    the reference's (3, heads, hd) column order gives."""
    b, h, w, e = x.shape
    qkv = _linear(x.reshape(-1, e), pk["qkv_w"], pk["qkv_b"])
    qkv = qkv.reshape(b, h * w, heads, 3, e // heads).permute(3, 0, 2, 1, 4)
    q, k, v = qkv.reshape(3, b * heads, h * w, e // heads)
    return q, k, v


def _merge_heads_and_project(pk, out, b: int, h: int, w: int, heads: int):
    """out (B*heads, H*W, hd) -> the output projection of (B, H, W, heads*hd)."""
    hd = out.shape[-1]
    out = out.reshape(b, heads, h, w, hd).permute(0, 2, 3, 1, 4).reshape(b, h, w, heads * hd)
    return _linear(out, pk["proj_w"], pk["proj_b"])


def attention_apply(pk, x, num_heads: int, use_rel_pos: bool = True,
                    ops: EncoderOps = KERNEL_OPS) -> torch.Tensor:
    """(B, H, W, E) -> (B, H, W, E) in plain PyTorch: fp32 logits and softmax
    (JAX ``models/image_encoder.py:attention_apply``, the path it runs where
    no kernel can: the oracle of the other formulations).  ``pk`` is a block
    of :meth:`ImageEncoderViT.pack` with floating-point weights; its
    per-head-grouped qkv weight gives the same q, k, v as the reference's.
    ``ops`` is handed to every ``attention_impl``; this one runs no kernel
    and does not read it."""
    b, h, w, e = x.shape
    scale = (e // num_heads) ** -0.5
    q, k, v = _qkv_heads(pk, x, num_heads)
    attn = (q * scale).float() @ k.float().transpose(1, 2)
    if use_rel_pos:
        attn = add_decomposed_rel_pos(attn, q, *_rel_tables(pk, h, w), (h, w))
    attn = torch.softmax(attn, dim=-1).to(v.dtype)
    return _merge_heads_and_project(pk, attn @ v, b, h, w, num_heads)


def attention_apply_kernel(pk, x, num_heads: int, use_rel_pos: bool = True,
                           ops: EncoderOps = KERNEL_OPS) -> torch.Tensor:
    """:func:`attention_apply` with the attention itself in K9
    (``ops.rel_attention_pre``; JAX ``kernels/attention.py:attention_apply_pallas``):
    the qkv projection, the head split, the two rel einsums and the output
    projection stay plain.  Without ``use_rel_pos`` K9 runs on zero rel terms
    (the JAX function leaves its kernel there)."""
    b, h, w, _ = x.shape
    q, k, v = _qkv_heads(pk, x, num_heads)
    if use_rel_pos:
        rel_h, rel_w = _rel_terms(q, *_rel_tables(pk, h, w), h, w, q.dtype)
    else:
        rel_h, rel_w = q.new_zeros((*q.shape[:2], h)), q.new_zeros((*q.shape[:2], w))
    out = ops.rel_attention_pre(q.contiguous(), k.contiguous(), v.contiguous(),
                                rel_h.contiguous(), rel_w.contiguous(), kh=h, kw=w)
    return _merge_heads_and_project(pk, out, b, h, w, num_heads)


def _check_float_weights(pk, what: str) -> None:
    if "qkv_w" not in pk:
        raise ValueError(f"{what} runs on floating-point weights only: the int8 serving mode "
                         "exists on the fused paths (fused_qkv and fused_mlp) alone")


def block_apply(pk, x, cfg: ImageEncoderConfig, window_size: int,
                attention_impl=attention_apply, fused_mlp: bool = False,
                fused_qkv: bool = False, ops: EncoderOps = KERNEL_OPS) -> torch.Tensor:
    """One block over the (B, H, W, E) grid, partitioning and unpartitioning
    its windows itself (JAX ``block_apply``).  A global block with
    ``fused_qkv`` is K1 + K7 + K3; every other runs ``attention_impl``."""
    if fused_qkv and window_size == 0:
        return block_global(pk, x, cfg, ops, fused_mlp)
    _check_float_weights(pk, "attention_impl")
    shortcut = x
    x = layer_norm(x, pk["norm1_w"], pk["norm1_b"], cfg.layer_norm_eps)
    if window_size > 0:
        h, w = x.shape[1], x.shape[2]
        x, pad_hw = window_partition(x, window_size)
    x = attention_impl(pk, x, cfg.num_heads, cfg.use_rel_pos, ops)
    if window_size > 0:
        x = window_unpartition(x, window_size, pad_hw, (h, w))
    x = shortcut + x
    e = x.shape[-1]
    return _mlp_residual(pk, x.reshape(-1, e), None, cfg, ops, fused_mlp).reshape(x.shape)


def rel_bias_headmajor(qkv2d, tables, *, heads: int, hd: int, b: int, gh: int, gw: int):
    """The rel terms of the head-grouped qkv activations (b*gh*gw, heads*3*hd):
    rel_h (heads, b, n, gh) and rel_w (heads, b, n, gw) in qkv's dtype (JAX
    ``_rel_bias_headmajor``).  One product of every q against the stacked
    tables, accumulated in fp32, then the row of each relative offset is
    picked; the rounding to the dtype commutes with the pick."""
    n = gh * gw
    q = qkv2d.reshape(b, gh, gw, heads, 3 * hd)[..., :hd]
    g = q @ tables.to(qkv2d.dtype).T                            # (b, gh, gw, heads, Rh+Rw)
    dev = qkv2d.device
    idx_h = _rel_pos_indices(gh, dev)[None, :, None, None, :].expand(b, gh, gw, heads, gh)
    idx_w = (_rel_pos_indices(gw, dev) + 2 * gh - 1)[None, None, :, None, :].expand(
        b, gh, gw, heads, gw)
    rel_h = g.gather(4, idx_h).permute(3, 0, 1, 2, 4).reshape(heads, b, n, gh)
    rel_w = g.gather(4, idx_w).permute(3, 0, 1, 2, 4).reshape(heads, b, n, gw)
    return rel_h.contiguous(), rel_w.contiguous()


def windowed_attention_headmajor(pk, xw, pad_valid, cfg: ImageEncoderConfig,
                                 ops: EncoderOps = KERNEL_OPS) -> torch.Tensor:
    """The v3 windowed attention over (Wb, ws, ws, E) windows: K1 (LN1, pad
    re-zeroing, head-grouped qkv), the rel terms outside the kernel, K10, the
    output projection (JAX ``_windowed_attention_headmajor``)."""
    wb, ws, _, e = xw.shape
    n, heads, hd = ws * ws, cfg.num_heads, cfg.head_dim
    t = wb * n
    qkv = _ln_qkv(pk, xw.reshape(t, e), pad_valid.reshape(t, 1), cfg, ops)
    rel_h, rel_w = rel_bias_headmajor(qkv, pk["tables"], heads=heads, hd=hd, b=wb, gh=ws, gw=ws)
    out = ops.rel_attention_headmajor(qkv.reshape(wb, n, -1), rel_h, rel_w, kh=ws, kw=ws,
                                      heads=heads, hd=hd)
    return F.linear(out.reshape(t, e), pk["proj_w"], pk["proj_b"]).reshape(xw.shape)


def global_attention_rel_outside(pk, x, cfg: ImageEncoderConfig,
                                 ops: EncoderOps = KERNEL_OPS) -> torch.Tensor:
    """:func:`global_attention` in the v3 formulation: K1, the rel terms
    outside the kernel, K11, the projection -> (B*gh*gw, E).  The JAX package
    wrote K11's kernel (``fused_rel_attention_headmajor_global``) and then
    moved its global blocks to K7; this is the caller it would have had."""
    b, gh, gw, e = x.shape
    t = b * gh * gw
    heads, hd = cfg.num_heads, cfg.head_dim
    qkv = _ln_qkv(pk, x.reshape(t, e), None, cfg, ops)
    rel_h, rel_w = rel_bias_headmajor(qkv, pk["tables"], heads=heads, hd=hd, b=b, gh=gh, gw=gw)
    out = ops.rel_attention_headmajor_global(qkv.reshape(b, gh * gw, -1), rel_h, rel_w,
                                             kh=gh, kw=gw, heads=heads, hd=hd)
    return F.linear(out.reshape(t, e), pk["proj_w"], pk["proj_b"])


def block_apply_windowed(pk, xw, pad_valid, cfg: ImageEncoderConfig,
                         attention_impl=attention_apply, fused_mlp: bool = False,
                         fused_qkv: bool = False, ops: EncoderOps = KERNEL_OPS) -> torch.Tensor:
    """One windowed block in window layout (Wb, ws, ws, E) (JAX
    ``_block_apply_windowed``): v3 with ``fused_qkv``, else v1.  Equal to
    partition -> :func:`block_apply` -> unpartition: the pad positions the
    reference makes from fresh zeros at every partition are re-zeroed after
    LN1, where their value could first reach an image token."""
    e = xw.shape[-1]
    if fused_qkv:
        a = windowed_attention_headmajor(pk, xw, pad_valid, cfg, ops)
        return _mlp_residual(pk, xw.reshape(-1, e), a.reshape(-1, e), cfg, ops,
                             fused_mlp).reshape(xw.shape)
    _check_float_weights(pk, "attention_impl")
    x = layer_norm(xw, pk["norm1_w"], pk["norm1_b"], cfg.layer_norm_eps) * pad_valid
    x = xw + attention_impl(pk, x, cfg.num_heads, cfg.use_rel_pos, ops)
    return _mlp_residual(pk, x.reshape(-1, e), None, cfg, ops, fused_mlp).reshape(xw.shape)


def block_apply_windowed_fused(pk, xw, pad_valid, cfg: ImageEncoderConfig,
                               ops: EncoderOps = KERNEL_OPS) -> torch.Tensor:
    """One windowed block through K12 (JAX ``_block_apply_windowed_fused``):
    plain LN1 and pad re-zeroing, the whole attention with both projections in
    the kernel, the projection's bias, the residual, then K3."""
    _check_float_weights(pk, "fused_window_blocks")
    wb, ws, _, e = xw.shape
    xn = layer_norm(xw, pk["norm1_w"], pk["norm1_b"], cfg.layer_norm_eps) * pad_valid
    a = ops.window_block_attention(xn.reshape(wb, ws * ws, e), pk["qkv_w"], pk["qkv_b"],
                                   pk["proj_w"], pk["tables"], ws=ws, heads=cfg.num_heads)
    x = xw + (a.reshape(xw.shape) + pk["proj_b"])
    return _mlp_residual(pk, x.reshape(-1, e), None, cfg, ops, True).reshape(xw.shape)


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------


class ImageEncoderViT(nn.Module):
    def __init__(self, cfg: ImageEncoderConfig):
        super().__init__()
        if not cfg.use_rel_pos or cfg.window_size <= 0:
            raise ValueError("the port runs SAM's windowed rel-pos encoder only")
        self.cfg = cfg
        self.patch_embed = PatchEmbed(cfg)
        if cfg.use_abs_pos:
            g = cfg.grid_size
            self.pos_embed = nn.Parameter(torch.zeros(1, g, g, cfg.embed_dim))
        self.blocks = nn.ModuleList(
            Block(cfg, 0 if i in cfg.global_attn_indexes else cfg.window_size)
            for i in range(cfg.depth))
        oc = cfg.out_chans
        self.neck = nn.Sequential(
            nn.Conv2d(cfg.embed_dim, oc, kernel_size=1, bias=False),
            LayerNorm2d(oc),
            nn.Conv2d(oc, oc, kernel_size=3, padding=1, bias=False),
            LayerNorm2d(oc),
        )

    @torch.no_grad()
    def pack(self, dtype=torch.float32, quantize: Optional[str] = None
             ) -> List[Dict[str, torch.Tensor]]:
        """Per-block weights in the layout and types the kernels take: matrices
        in ``dtype``, biases and LayerNorm affines fp32, qkv grouped per head,
        rel-pos tables stacked.  With ``quantize="int8"`` the qkv (after its
        regrouping), lin1 and lin2 matrices are int8 ``(out, in)`` with fp32
        per-output-channel scales (``models/quantize.py``).  A serving loop
        packs once and reuses."""
        if quantize not in (None, "int8"):
            raise ValueError(f"quantize must be None or 'int8', got {quantize!r}")
        cfg = self.cfg
        packed = []
        for blk in self.blocks:
            at = blk.attn
            qkv_b = at.qkv.bias if at.qkv.bias is not None else \
                torch.zeros(at.qkv.out_features, device=at.qkv.weight.device)
            w, b = attn_k.group_qkv_per_head(at.qkv.weight, qkv_b, cfg.num_heads)
            s = blk.window_size or cfg.grid_size
            mat = torch.float32 if quantize else dtype   # quantized from fp32
            pk = {
                "norm1_w": blk.norm1.weight.float(), "norm1_b": blk.norm1.bias.float(),
                "qkv_w": w.to(mat), "qkv_b": b.float(),
                "tables": attn_k.prepare_rel_tables(at.rel_pos_h, at.rel_pos_w, s, s, dtype),
                "proj_w": at.proj.weight.to(dtype).contiguous(),
                "proj_b": at.proj.bias.to(dtype),
                "norm2_w": blk.norm2.weight.float(), "norm2_b": blk.norm2.bias.float(),
                "lin1_w": blk.mlp.lin1.weight.to(mat).contiguous(),
                "lin1_b": blk.mlp.lin1.bias.float(),
                "lin2_w": blk.mlp.lin2.weight.to(mat).contiguous(),
                "lin2_b": blk.mlp.lin2.bias.float(),
            }
            pk = {k: v.detach() for k, v in pk.items()}      # a same-dtype .to() is the Parameter
            packed.append(quantize_block(pk) if quantize else pk)
        return packed

    @torch.no_grad()
    def embed_patches(self, x: torch.Tensor, dtype) -> torch.Tensor:
        """(B, 3, img, img) NCHW -> the (B, grid, grid, E) tokens the first
        block sees: the patch embedding plus the position embedding."""
        pe = self.patch_embed.proj
        x = F.conv2d(x.to(dtype), pe.weight.to(dtype), pe.bias.to(dtype),
                     stride=self.cfg.patch_size)
        x = x.permute(0, 2, 3, 1)
        if self.cfg.use_abs_pos:
            x = x + self.pos_embed.to(dtype)
        return x.contiguous()

    @torch.no_grad()
    def forward(self, x: torch.Tensor, *, dtype=None, packed=None,
                ops: EncoderOps = KERNEL_OPS, compact_windows: bool = False,
                attention_impl=attention_apply, persistent_windows: bool = True,
                fused_window_blocks: bool = False, fused_mlp: bool = True,
                fused_qkv: bool = True) -> torch.Tensor:
        """(B, 3, img, img) NCHW -> (B, out_chans, grid, grid) NCHW fp32.
        ``dtype`` is the compute type of the transformer stack (None: bf16
        on the card, the only type the kernels take, fp32 on the CPU);
        ``packed`` the output of :meth:`pack` for that dtype and for the
        mode of ``ops`` (packed here when None).  Int8 weights run only on
        int8 ops, floating-point weights only on the others.
        ``compact_windows`` runs the windowed blocks on the compact layout
        (as JAX ``apply``, off unless asked; the serving entry points ask);
        a token grid that is a window multiple has no pad token to drop and
        takes the flat layout either way.

        The last five keywords are JAX ``apply``'s own and choose the block
        formulation as it does.  ``fused_qkv`` and ``fused_mlp`` default to
        on here, the flat-window path through K1, K3, K5 and K7 that every
        serving entry point runs; JAX ``apply`` defaults them to off because
        it must also run where its kernels cannot, and the port's wrappers
        take their plain versions there by themselves.
        ``fused_qkv=False`` runs windowed and global blocks through
        ``attention_impl(pk, x, num_heads, use_rel_pos, ops)``
        (:func:`attention_apply`, or :func:`attention_apply_kernel` for K9) in
        the 4-D window layout, with K3 or, without ``fused_mlp``, the plain MLP;
        ``fused_window_blocks=True`` runs the windowed blocks through K12 and
        K3 (global blocks as ``fused_qkv`` says);
        ``persistent_windows=False`` partitions and unpartitions the windows
        in every block, and only global blocks take ``fused_qkv``.  The int8
        mode exists on the flat and compact paths alone, as in JAX."""
        cfg = self.cfg
        if dtype is None:
            dtype = torch.bfloat16 if x.device.type == "cuda" else torch.float32
        if packed is None:
            packed = self.pack(dtype, quantize="int8" if ops.int8 else None)
        if is_prequantized(packed) != ops.int8:
            raise ValueError(
                "prequantized int8 weights run only on the int8 ops (KERNEL_OPS_INT8, "
                "PLAIN_OPS_INT8) and floating-point weights only on the others: got "
                f"{'int8' if is_prequantized(packed) else 'floating-point'} weights with "
                f"{'int8' if ops.int8 else 'floating-point'} ops")
        flat3d = fused_qkv and not fused_window_blocks
        if ops.int8 and not (fused_mlp and flat3d and persistent_windows):
            raise ValueError("the int8 mode runs only on the fused flat-window path: "
                             "fused_qkv and fused_mlp on, fused_window_blocks off, "
                             "persistent_windows on")
        x = self.embed_patches(x, dtype)
        b, h, w, e = x.shape
        ws = cfg.window_size
        if not persistent_windows:
            for i in range(cfg.depth):
                is_global = i in cfg.global_attn_indexes
                x = block_apply(packed[i], x, cfg, 0 if is_global else ws, attention_impl,
                                fused_mlp, fused_qkv and is_global, ops)
            return self.neck(x.float().permute(0, 3, 1, 2))

        compact = bool(compact_windows) and flat3d and (h % ws != 0 or w % ws != 0)
        if compact:
            groups = compact_window_groups(h, w, ws)
            spans = compact_spans(groups, b)
            mask = torch.cat([compact_group_mask(g, h, w, dtype, x.device).repeat(b, 1)
                              for g in groups])
        elif flat3d:
            pad3 = pad_valid_flat(b, h, w, ws, dtype, x.device)
        else:
            pad_valid = pad_valid_mask(b, h, w, ws, dtype, x.device)
        run: List[int] = []
        for i in range(cfg.depth + 1):
            is_global = i < cfg.depth and i in cfg.global_attn_indexes
            if (i == cfg.depth or is_global) and run:
                if compact:
                    x2d = torch.cat([x3.reshape(-1, e)
                                     for x3 in window_partition_compact(x, groups)])
                    for j in run:
                        x2d = block_windowed_compact(packed[j], x2d, mask, spans, cfg, ops,
                                                     fused_mlp)
                    parts = [x2d[r0:r1].view(-1, g["np"], e) for g, r0, r1 in spans]
                    x = window_unpartition_compact(parts, groups, b, (h, w))
                elif flat3d:
                    x3, pad_hw = window_partition_flat(x, ws)
                    for j in run:
                        x3 = block_windowed(packed[j], x3, pad3, cfg, ops, fused_mlp)
                    x = window_unpartition_flat(x3, ws, pad_hw, (h, w))
                else:
                    xw, pad_hw = window_partition(x, ws)
                    for j in run:
                        if fused_window_blocks:
                            xw = block_apply_windowed_fused(packed[j], xw, pad_valid, cfg, ops)
                        else:
                            xw = block_apply_windowed(packed[j], xw, pad_valid, cfg,
                                                      attention_impl, fused_mlp, fused_qkv, ops)
                    x = window_unpartition(xw, ws, pad_hw, (h, w))
                run = []
            if i == cfg.depth:
                break
            if is_global:
                x = block_apply(packed[i], x, cfg, 0, attention_impl, fused_mlp, fused_qkv, ops)
            else:
                run.append(i)

        return self.neck(x.float().permute(0, 3, 1, 2))
