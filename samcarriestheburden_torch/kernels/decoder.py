"""D1: the SAM mask decoder's image-to-token branch in one fp32 kernel.

The branch is the last step of ``models/transformer.py:TwoWayAttentionBlock``:
every image-side row attends to its item's Nq prompt tokens, and the result
goes through the out projection, the residual and ``norm4``::

    keys = norm4(keys + out_proj(attend(q_proj(keys + key_pe),
                                        k_proj(queries + query_pe),
                                        v_proj(queries))))

It replaces no TPU kernel: the JAX package leaves it to XLA.  Unfused, it
made about nine passes over the (B, 4096, 256) image side; D1
(``csrc/decoder.cu``) reads each row once and writes it once, and keeps q,
the logits, the heads' outputs and the projected row on chip.  It splits q
as ``keys . Wq^T + (key_pe . Wq^T + b_q)``, the second term one (HW, 128)
table computed here with plain PyTorch, and takes the token keys and values
from the k and v projections here too.  All of it is IEEE fp32.

The image side may be shared: ``keys`` (n_img, HW, C) holds the rows of
n_img images, each shared by the ``G = B // n_img`` consecutive items of
``queries`` (B, Nq, C).  The refinement's first round gives its first
block one image for its 17 classes (``forward_image_shared``: G = 17);
every other block call, the predictor's and AMG's included (their keys come
expanded or materialised, one row set an item), has G = 1.  D1 computes a
row's q once and writes the G item rows, with the image row as their
residual.

The operands are tensors (:class:`Weights`), so this layer knows nothing of
the model's modules.  :func:`fused_applies` is the block's dispatch: D1 for
fp32 tensors on the card outside ``torch.export``; the unfused branch for
CPU tensors, the bf16 decode and an export.  :func:`image_to_token` checks
its operands on every device and raises on what D1 does not take (no
fallback), then calls the operator ``samcarriestheburden::d1_image_to_token``
(as K13's ``cost_probe`` is one): the plain version for a CPU tensor, the
kernel for a CUDA one, with a flop formula so that ``FlopCounterMode``
counts the products inside the kernel.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from samcarriestheburden_torch.kernels import LAUNCHES, build, raise_on_error, stream
from samcarriestheburden_torch.profiling import span

#: D1's widths: the decoder's 256, the attention's internal 128 in 8 heads
#: (every SAM and MedSAM decoder has them)
WIDTH, INTERNAL, HEADS = 256, 128, 8
#: image rows a block of D1 (HW must be a multiple)
ROWS = 64
#: the most tokens an item's keys and values may have (``csrc/decoder.cu``'s
#: ``d1_max_tokens``: what fits in shared memory beside the fixed tiles)
MAX_TOKENS = 146
#: items a block of D1 projects one q tile for, at most (G is split in even parts)
ITEMS_PER_BLOCK = 6

_VP, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


class Weights(NamedTuple):
    """The branch's parameters as D1 takes them: the q projection's weight
    transposed (C, 128) and bias, the k and v projections' weights (128, C)
    and biases, the out projection's weight transposed (128, C) and bias,
    the LayerNorm's weight, bias and eps, the number of heads."""

    wq_t: torch.Tensor
    bq: torch.Tensor
    wk: torch.Tensor
    bk: torch.Tensor
    wv: torch.Tensor
    bv: torch.Tensor
    wo_t: torch.Tensor
    bo: torch.Tensor
    gamma: torch.Tensor
    beta: torch.Tensor
    eps: float
    heads: int


def _lib():
    lib = build.load("decoder")
    if not getattr(lib, "_typed", False):
        lib.d1_image_to_token.argtypes = [_VP, _LL, _LL, _LL] + [_VP] * 8 + [_F, _VP] \
            + [_I] * 5 + [_VP]
        lib.d1_image_to_token.restype = _I
        lib.d1_max_tokens.argtypes = []
        lib.d1_max_tokens.restype = _I
        lib._typed = True
    return lib


def fused_applies(device_type: str, dtype: torch.dtype) -> bool:
    """Whether ``TwoWayAttentionBlock`` sends its image-to-token branch to
    D1: fp32 on the card, not while ``torch.export`` traces."""
    return (device_type == "cuda" and dtype == torch.float32
            and not torch.compiler.is_exporting())


def items_per_block(g: int) -> int:
    """Items of G that one block of D1 takes: G cut into ceil(G / 6) parts as
    even as they go (17 -> 6, 6, 5), so that the q tile a block projects
    serves several items and the grid still fills the card."""
    return math.ceil(g / math.ceil(g / ITEMS_PER_BLOCK))


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    """(..., n, d) -> (..., h, n, d // h)."""
    return x.unflatten(-1, (h, x.shape[-1] // h)).transpose(-3, -2)


def _projections(keys, key_pe, queries, query_pe, w: Weights):
    """What plain PyTorch computes before the kernel: the positional table
    peq = key_pe . Wq^T + b_q (HW, 128), and the item's token keys and
    values (B, Nq, 128)."""
    peq = F.linear(key_pe[0], w.wq_t.t(), w.bq)
    return (peq, F.linear(queries + query_pe, w.wk, w.bk), F.linear(queries, w.wv, w.bv))


def _kernel_plain(keys, peq, wq_t, kt, vt, wo_t, bo, gamma, beta, eps: float, heads: int):
    """Plain version of what the kernel computes, on the operands it takes:
    keys (n_img, HW, C), peq (HW, 128), kt and vt (B, Nq, 128)."""
    b = kt.shape[0]
    n_img, hw, c = keys.shape
    qh = _heads(keys @ wq_t + peq, heads)[:, None]                # (n_img, 1, h, HW, d)
    per_image = (n_img, b // n_img, heads, kt.shape[1], -1)      # (n_img, G, h, Nq, d)
    kh, vh = (_heads(t, heads).reshape(per_image) for t in (kt, vt))
    logits = qh @ kh.transpose(-1, -2) / math.sqrt(qh.shape[-1])
    out = torch.softmax(logits, dim=-1) @ vh                     # (n_img, G, h, HW, d)
    out = F.linear(out.transpose(-3, -2).flatten(-2), wo_t.t(), bo)
    return F.layer_norm((keys[:, None] + out).reshape(b, hw, c), (c,), gamma, beta, eps)


def image_to_token_plain(keys, key_pe, queries, query_pe, w: Weights):
    """Plain version of D1: keys (n_img, HW, C), any strides; key_pe (1 or
    B, HW, C), the same rows for every item; queries, query_pe (B, Nq, C), B
    a multiple of n_img.  Returns the new keys (B, HW, C): item b's rows
    from image b // (B // n_img)."""
    b, n_img = queries.shape[0], keys.shape[0]
    if b % n_img:
        raise ValueError(f"{b} items do not divide among {n_img} images")
    peq, kt, vt = _projections(keys, key_pe, queries, query_pe, w)
    return _kernel_plain(keys, peq, w.wq_t, kt, vt, w.wo_t, w.bo, w.gamma, w.beta, w.eps,
                         w.heads)


def _check(keys, key_pe, queries, query_pe, w: Weights) -> None:
    """Raise unless D1 takes these operands (on any device)."""
    tensors = {"keys": keys, "key_pe": key_pe, "queries": queries, "query_pe": query_pe,
               **{k: v for k, v in w._asdict().items() if isinstance(v, torch.Tensor)}}
    for name, t in tensors.items():
        if t.dtype != torch.float32 or t.device != keys.device:
            raise ValueError(f"D1: {name} must be fp32 on {keys.device}, got {t.dtype} on "
                             f"{t.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors.values()):
        raise ValueError("D1 has no backward: call it under torch.no_grad()")
    b, nq, c = queries.shape
    n_img, hw, ck = keys.shape
    shapes = {"wq_t": (WIDTH, INTERNAL), "wk": (INTERNAL, WIDTH), "wv": (INTERNAL, WIDTH),
              "wo_t": (INTERNAL, WIDTH), "bq": (INTERNAL,), "bk": (INTERNAL,),
              "bv": (INTERNAL,), "bo": (WIDTH,), "gamma": (WIDTH,), "beta": (WIDTH,)}
    got = {k: tuple(tensors[k].shape) for k in shapes}
    if (c, ck, w.heads) != (WIDTH, WIDTH, HEADS) or got != shapes:
        raise ValueError(f"D1 takes width {WIDTH}, {INTERNAL} in {HEADS} heads; got keys "
                         f"{ck}, queries {c}, {w.heads} heads, weights {got}")
    if b % n_img:
        raise ValueError(f"D1: {b} items do not divide among {n_img} images")
    if hw % ROWS:
        raise ValueError(f"D1 needs HW a multiple of {ROWS}, got {hw}")
    if key_pe.shape[1:] != keys.shape[1:] or (key_pe.shape[0] != 1 and key_pe.stride(0) != 0):
        raise ValueError(f"D1 needs one key_pe (1, {hw}, {c}) for every item, got "
                         f"{tuple(key_pe.shape)} with strides {key_pe.stride()}")
    sb, sr, sc = keys.stride()
    if not (sc == 1 and sr % 4 == 0 or sr == 1 and sc % 4 == 0) or sb % 4 \
            or keys.data_ptr() % 16:
        raise ValueError(f"D1 reads image rows with channels or rows contiguous, other strides "
                         f"multiples of 4 and 16-byte aligned; got strides {keys.stride()}")
    if tuple(query_pe.shape) != tuple(queries.shape):
        raise ValueError(f"D1: query_pe {tuple(query_pe.shape)} against queries "
                         f"{tuple(queries.shape)}")
    if not 1 <= nq <= MAX_TOKENS:
        raise ValueError(f"D1 takes 1 to {MAX_TOKENS} tokens, got {nq}")


def _d1_cuda(keys, peq, wq_t, kt, vt, wo_t, bo, gamma, beta, eps: float, heads: int):
    """The operator's CUDA implementation: one launch of D1, the span
    ``kernels.D1``."""
    b, nq, ci = kt.shape
    n_img, hw, c = keys.shape
    if (c, ci, heads) != (WIDTH, INTERNAL, HEADS) or b % n_img or any(
            t.dtype != torch.float32 for t in (keys, peq, wq_t, kt, vt, wo_t, bo, gamma, beta)):
        raise ValueError(f"D1 takes fp32 at width {WIDTH}, {INTERNAL} in {HEADS} heads, items "
                         f"a multiple of the images; got {c}, {ci}, {heads}, {b} items of "
                         f"{n_img}")
    g = b // n_img
    params = [t.contiguous() for t in (peq, wq_t, kt, vt, wo_t, bo, gamma, beta)]
    with span("kernels.D1"):
        out = torch.empty((b, hw, c), dtype=torch.float32, device=keys.device)
        code = _lib().d1_image_to_token(
            keys.data_ptr(), *keys.stride(), *(p.data_ptr() for p in params), eps,
            out.data_ptr(), n_img, g, items_per_block(g), hw, nq, stream())
        raise_on_error("D1 image_to_token", code)
        LAUNCHES["D1"] += 1
    return out


def _d1_fake(keys, peq, wq_t, kt, vt, wo_t, bo, gamma, beta, eps: float, heads: int):
    return keys.new_empty((kt.shape[0],) + tuple(keys.shape[1:]))


_LIB = torch.library.Library("samcarriestheburden", "FRAGMENT")
_LIB.define("d1_image_to_token(Tensor keys, Tensor peq, Tensor wq_t, Tensor kt, Tensor vt, "
            "Tensor wo_t, Tensor bo, Tensor gamma, Tensor beta, float eps, int heads) -> Tensor")
_LIB.impl("d1_image_to_token", _kernel_plain, "CPU")
_LIB.impl("d1_image_to_token", _d1_cuda, "CUDA")
torch.library.register_fake("samcarriestheburden::d1_image_to_token", _d1_fake, lib=_LIB)

#: the operator ``d1_image_to_token(keys, peq, wq_t, kt, vt, wo_t, bo, gamma,
#: beta, eps, heads)``: the plain version on the CPU, D1 on the card
d1_image_to_token = torch.ops.samcarriestheburden.d1_image_to_token.default


@register_flop_formula(torch.ops.samcarriestheburden.d1_image_to_token)
def _d1_flops(keys_shape, peq_shape, wq_t_shape, kt_shape, *args, **kwargs) -> int:
    """The products inside D1, so that ``FlopCounterMode`` counts them: q
    over the n_img x HW image rows, q.k and p.v of every item's rows, the out
    projection (the products before the launch it counts as they run)."""
    n_img, hw, c = keys_shape
    b, nq, ci = kt_shape
    return 2 * (n_img * hw * c * ci + 2 * b * hw * nq * ci + b * hw * ci * c)


def image_to_token(keys, key_pe, queries, query_pe, w: Weights):
    """D1 (operands as :func:`image_to_token_plain` takes them, held to what
    the kernel takes on every device): the token keys and values and the
    positional table in plain PyTorch, then the operator
    :data:`d1_image_to_token`, whose CPU implementation is the plain version
    and whose CUDA one launches the kernel."""
    _check(keys, key_pe, queries, query_pe, w)
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"D1 runs on the card or, as its plain version, the CPU; got "
                         f"{keys.device}")
    peq, kt, vt = _projections(keys, key_pe, queries, query_pe, w)
    return d1_image_to_token(keys, peq, w.wq_t, kt, vt, w.wo_t, w.bo, w.gamma, w.beta, w.eps,
                             w.heads)
