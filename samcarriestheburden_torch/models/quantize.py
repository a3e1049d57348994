"""One-time int8 prequantization of the SAM image-encoder weights (JAX
``models/quantize.py``).

The encoder's matrix weights are quantized once, outside the serving loop,
into the int8 pack the kernels K2 and K4 consume (symmetric per-output-channel
absmax, ``kernels/quant.py:quantize_weight``).  Per block the qkv, lin1 and
lin2 weights become int8 ``(out, in)`` with fp32 scales; the qkv weight is
quantized after its per-head regrouping.  The output projection, the rel-pos
tables and the LayerNorm affines stay floating point, as do the patch embed,
the pos embed and the neck, which are not part of the pack.

The int8 pack is only valid for the int8 ops of ``models/image_encoder.py``
(``forward`` refuses it on the bf16 ops and the other way round).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from samcarriestheburden_torch.kernels.quant import quantize_weight

Pack = Dict[str, torch.Tensor]

#: the matrices of a block's pack that K2 and K4 take in int8
QUANTIZED = ("qkv", "lin1", "lin2")


def is_prequantized(pack) -> bool:
    """True for a block's int8 pack (or a list of them)."""
    block = pack[0] if isinstance(pack, (list, tuple)) else pack
    return "lin1_wq" in block


def quantize_block(pack: Pack) -> Pack:
    """A block's floating-point pack -> its int8 pack: ``<name>_w`` becomes
    ``<name>_wq`` int8 and ``<name>_s`` fp32 for qkv, lin1 and lin2; every
    other entry is kept."""
    out = {k: v for k, v in pack.items() if k not in {f"{n}_w" for n in QUANTIZED}}
    for name in QUANTIZED:
        out[f"{name}_wq"], out[f"{name}_s"] = quantize_weight(pack[f"{name}_w"])
    return out


def prequantize_image_encoder(encoder, dtype=torch.bfloat16) -> List[Pack]:
    """The encoder's per-block int8 packs, with the floating-point matrices
    that remain (output projection, rel-pos tables) in ``dtype``.  Call once,
    outside the serving loop."""
    return encoder.pack(dtype, quantize="int8")


def prequantize_sam(model, dtype=torch.bfloat16) -> List[Pack]:
    """The int8 packs of a SAM model's image encoder; the prompt encoder and
    the mask decoder are untouched."""
    return prequantize_image_encoder(model.image_encoder, dtype)
