"""Batched SAM image embeddings (JAX ``engine/embeddings.py``).

Images arrive resized-longest-side on the host and zero-padded into a fixed
(B, 3, S, S) uint8 batch with their (B, 2) input sizes; normalisation and the
padding mask run on the device, so the encoder always sees one shape
(normalise-then-pad, reference sam.py:164-174).  The MedSAM variant takes
images resized to the square encoder size and normalises each to [0, 1] by
its own minimum and maximum.

Every entry point takes ``compact_windows``: ``None`` (the default) or
``True`` runs the compact ragged-window layout, as the JAX package serves
on its accelerator; ``False`` the flat layout with its pad tokens.

The encoder's other block formulations are chosen with JAX ``apply``'s
keywords, handed on to ``ImageEncoderViT.forward``: ``fused_qkv=False`` with
``attention_impl`` (v1: K9 through ``attention_apply_kernel``),
``fused_window_blocks=True`` (v2: K12), ``persistent_windows=False``.  As in
the JAX package the fused flags are on where there is an accelerator, so
``attention_impl`` alone changes nothing on the serving default: the flat and
compact paths never call it.

``unroll_blocks`` (JAX: inline the windowed layers instead of ``lax.scan``)
is accepted and unused by every entry point: eager PyTorch runs the layers
one after the other either way, and the JAX package's outputs are the same
both ways.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from samcarriestheburden_torch.models.image_encoder import (EncoderOps, attention_apply,
                                                            attention_apply_kernel, default_ops)
from samcarriestheburden_torch.models.quantize import prequantize_sam
from samcarriestheburden_torch.models.sam import SamModel

Packed = List[Dict[str, torch.Tensor]]


def default_attention_impl() -> Callable:
    """The ``attention_impl`` of the unfused formulation: K9 behind
    :func:`attention_apply_kernel` where there is a card, the plain
    :func:`attention_apply` elsewhere (JAX ``default_attention_impl``)."""
    return attention_apply_kernel if torch.cuda.is_available() else attention_apply


def make_encode_batch(model: SamModel, dtype=torch.bfloat16, *,
                      attention_impl: Optional[Callable] = None,
                      quantize: Optional[str] = None,
                      compact_windows: Optional[bool] = None,
                      ops: Optional[EncoderOps] = None,
                      fused_qkv: bool = True, fused_mlp: bool = True,
                      fused_window_blocks: bool = False,
                      persistent_windows: bool = True,
                      unroll_blocks: Optional[bool] = None) -> Callable:
    """``encode(packed, imgs, input_sizes)``: (B, 3, S, S) uint8 + (B, 2)
    int sizes -> (B, 256, G, G) fp32 embeddings, on the model's device.
    ``packed`` is ``model.image_encoder.pack(dtype, quantize)``;
    ``quantize="int8"`` selects the int8 serving mode (K2, K4, K7-int8 over
    prequantized weights).  ``ops`` overrides the mode's kernel wrappers.
    ``attention_impl`` (None: :func:`default_attention_impl`) and the four
    flags after it choose the block formulation
    (``ImageEncoderViT.forward``); with the flags as they are, the serving
    default, no block calls ``attention_impl``."""
    size = model.img_size
    if ops is None:
        ops = default_ops(quantize)
    compact = compact_windows is None or bool(compact_windows)
    variant = dict(attention_impl=attention_impl or default_attention_impl(),
                   fused_qkv=fused_qkv, fused_mlp=fused_mlp,
                   fused_window_blocks=fused_window_blocks,
                   persistent_windows=persistent_windows)

    @torch.no_grad()
    def encode(packed: Packed, imgs: torch.Tensor, input_sizes: torch.Tensor) -> torch.Tensor:
        dev = model.device
        imgs = imgs.to(dev)
        input_sizes = input_sizes.to(dev)
        ih = torch.arange(size, device=dev)
        valid = ((ih[None, :, None] < input_sizes[:, 0, None, None])
                 & (ih[None, None, :] < input_sizes[:, 1, None, None]))
        x = (imgs.float() - model.pixel_mean) / model.pixel_std
        x = x * valid[:, None]
        return model.image_encoder(x, dtype=dtype, packed=packed, ops=ops,
                                   compact_windows=compact, **variant)

    return encode


def make_encode_batch_medsam(model: SamModel, dtype=torch.bfloat16, *,
                             quantize: Optional[str] = None,
                             compact_windows: Optional[bool] = None,
                             unroll_blocks: Optional[bool] = None) -> Callable:
    """The MedSAM variant of :func:`make_encode_batch` (JAX
    ``make_encode_batch_medsam``): the (B, 3, S, S) images arrive resized to
    the square encoder size and each is normalised to [0, 1] by its own
    minimum and maximum, with no padding mask (``input_sizes`` is accepted
    and ignored).  The encoder stack, ``quantize`` and ``compact_windows``
    are the same."""
    ops = default_ops(quantize)
    compact = compact_windows is None or bool(compact_windows)

    @torch.no_grad()
    def encode(packed: Packed, imgs: torch.Tensor, input_sizes=None) -> torch.Tensor:
        x = imgs.to(model.device).float()
        lo = x.amin(dim=(1, 2, 3), keepdim=True)
        hi = x.amax(dim=(1, 2, 3), keepdim=True)
        x = (x - lo) / (hi - lo).clamp(min=1e-8)
        return model.image_encoder(x, dtype=dtype, packed=packed, ops=ops,
                                   compact_windows=compact)

    return encode


def make_serving_encoder(model: SamModel, dtype=torch.bfloat16,
                         quantize: Optional[str] = None, *, medsam: bool = False,
                         compact_windows: Optional[bool] = None,
                         attention_impl: Optional[Callable] = None,
                         unroll_blocks: Optional[bool] = None,
                         **variant) -> Tuple[Callable, Packed]:
    """(encode_fn, ready-to-serve weights) for the batched encoder: the
    weights are packed once into the kernels' layout and types, outside the
    serving loop, and every call reuses them.  With ``quantize="int8"`` that
    one pass also prequantizes the encoder's matrices
    (``models/quantize.py:prequantize_sam``), so no call quantizes a weight.
    ``medsam`` selects the MedSAM preprocessing over the same stack.
    ``attention_impl`` and ``variant`` (``fused_qkv``, ``fused_mlp``,
    ``fused_window_blocks``, ``persistent_windows``, ``ops``) go to
    :func:`make_encode_batch`; the MedSAM variant, as in the JAX package,
    runs the serving formulation only."""
    if medsam:
        if attention_impl is not None or variant:
            raise ValueError("the MedSAM encode runs the serving block formulation only")
        encode = make_encode_batch_medsam(model, dtype, quantize=quantize,
                                          compact_windows=compact_windows)
    else:
        encode = make_encode_batch(model, dtype, attention_impl=attention_impl,
                                   quantize=quantize, compact_windows=compact_windows,
                                   **variant)
    if quantize == "int8":
        return encode, prequantize_sam(model, dtype)
    return encode, model.image_encoder.pack(dtype)
