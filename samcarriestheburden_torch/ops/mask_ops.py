"""Mask geometry (JAX ``ops/mask_ops.py``, reference segment_anything/utils/amg.py).

Only what the enhance path and the refinement sweep use; the
automatic-mask-generation helpers come with the AMG port."""

from __future__ import annotations

import numpy as np
import torch


def batched_mask_to_box(masks: torch.Tensor) -> torch.Tensor:
    """XYXY boxes around (..., H, W) boolean masks, [0, 0, 0, 0] for an empty
    mask (reference amg.py:303-346).  Returns (..., 4) int32."""
    h, w = masks.shape[-2:]
    masks = masks.bool()
    dev = masks.device

    in_height = masks.any(dim=-1)                                   # (..., H)
    h_coords = in_height * torch.arange(h, dtype=torch.int32, device=dev)
    bottom = h_coords.amax(dim=-1)
    top = (h_coords + h * ~in_height).amin(dim=-1)

    in_width = masks.any(dim=-2)                                    # (..., W)
    w_coords = in_width * torch.arange(w, dtype=torch.int32, device=dev)
    right = w_coords.amax(dim=-1)
    left = (w_coords + w * ~in_width).amin(dim=-1)

    empty = (right < left) | (bottom < top)
    box = torch.stack([left, top, right, bottom], dim=-1)
    return torch.where(empty[..., None], 0, box).int()


def packbits_device(masks: torch.Tensor) -> torch.Tensor:
    """Pack a boolean mask's last axis into uint8 on its device, bit order
    little-endian: ``np.unpackbits(..., bitorder="little")`` reads it.  The
    host fetch is 8x smaller than the bool mask's.  The last axis must be a
    multiple of 8."""
    *lead, w = masks.shape
    if w % 8:
        raise ValueError(f"the last axis ({w}) must be a multiple of 8")
    b = masks.reshape(*lead, w // 8, 8).to(torch.uint8)
    weights = 1 << torch.arange(8, dtype=torch.uint8, device=masks.device)
    return (b * weights).sum(dim=-1, dtype=torch.uint8)


def unpackbits_host(packed, w: int) -> np.ndarray:
    """Inverse of :func:`packbits_device` on the host; returns bool (..., w)."""
    flat = np.unpackbits(np.asarray(packed), axis=-1, bitorder="little")
    return flat[..., :w].astype(bool)
