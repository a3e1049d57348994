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
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from samcarriestheburden_torch.models.image_encoder import EncoderOps, default_ops
from samcarriestheburden_torch.models.quantize import prequantize_sam
from samcarriestheburden_torch.models.sam import SamModel

Packed = List[Dict[str, torch.Tensor]]


def make_encode_batch(model: SamModel, dtype=torch.bfloat16, *,
                      quantize: Optional[str] = None,
                      compact_windows: Optional[bool] = None,
                      ops: Optional[EncoderOps] = None) -> Callable:
    """``encode(packed, imgs, input_sizes)``: (B, 3, S, S) uint8 + (B, 2)
    int sizes -> (B, 256, G, G) fp32 embeddings, on the model's device.
    ``packed`` is ``model.image_encoder.pack(dtype, quantize)``;
    ``quantize="int8"`` selects the int8 serving mode (K2, K4, K7-int8 over
    prequantized weights).  ``ops`` overrides the mode's kernel wrappers."""
    size = model.img_size
    if ops is None:
        ops = default_ops(quantize)
    compact = compact_windows is None or bool(compact_windows)

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
                                   compact_windows=compact)

    return encode


def make_encode_batch_medsam(model: SamModel, dtype=torch.bfloat16, *,
                             quantize: Optional[str] = None,
                             compact_windows: Optional[bool] = None) -> Callable:
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
                         compact_windows: Optional[bool] = None
                         ) -> Tuple[Callable, Packed]:
    """(encode_fn, ready-to-serve weights) for the batched encoder: the
    weights are packed once into the kernels' layout and types, outside the
    serving loop, and every call reuses them.  With ``quantize="int8"`` that
    one pass also prequantizes the encoder's matrices
    (``models/quantize.py:prequantize_sam``), so no call quantizes a weight.
    ``medsam`` selects the MedSAM preprocessing over the same stack."""
    make = make_encode_batch_medsam if medsam else make_encode_batch
    encode = make(model, dtype, quantize=quantize, compact_windows=compact_windows)
    if quantize == "int8":
        return encode, prequantize_sam(model, dtype)
    return encode, model.image_encoder.pack(dtype)
