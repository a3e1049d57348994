"""Resize helpers of the SAM path (JAX ``ops/resize.py``).

* ``get_preprocess_shape`` — the reference's +0.5 rounding rule
  (segment_anything/utils/transforms.py:93-102).
* ``resize_bilinear`` — half-pixel centres (torch ``align_corners=False``),
  no antialiasing: JAX ``jax.image.resize(method='linear', antialias=False)``.
* ``resize_longest_side_np`` — host-side uint8 resize with the antialiasing
  triangle filter of PIL's bilinear resize, which the reference uses.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def get_preprocess_shape(oldh: int, oldw: int, long_side_length: int) -> Tuple[int, int]:
    """Output (H, W) after resizing the longest side to ``long_side_length``."""
    scale = long_side_length * 1.0 / max(oldh, oldw)
    newh, neww = oldh * scale, oldw * scale
    return int(newh + 0.5), int(neww + 0.5)


def resize_bilinear(image: torch.Tensor, out_hw: Tuple[int, int], *,
                    antialias: bool = False) -> torch.Tensor:
    """Bilinear resize of the last two axes of a (..., H, W) tensor, in fp32."""
    lead = image.shape[:-2]
    x = image.float().reshape(1, -1, *image.shape[-2:])
    y = F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                      align_corners=False, antialias=antialias)
    return y.reshape(*lead, *out_hw)


def scale_coords(coords, original_size, target_size) -> torch.Tensor:
    """Scale (N, 2) xy coords between two (H, W) frames
    (reference segment_anything/utils/prompt_utils.py:146-166)."""
    coords = torch.as_tensor(coords, dtype=torch.float32)
    original = torch.as_tensor(original_size, dtype=torch.float32, device=coords.device)
    target = torch.as_tensor(target_size, dtype=torch.float32, device=coords.device)
    return coords * (target / original).flip(0)        # (H, W) ratio -> (x, y)


def scale_box(box, original_size, target_size) -> torch.Tensor:
    """Scale (N, 4) xyxy boxes between two (H, W) frames
    (reference prompt_utils.py:169-184)."""
    coords = torch.as_tensor(box, dtype=torch.float32).reshape(-1, 2)
    return scale_coords(coords, original_size, target_size).reshape(-1, 4)


def pad_bottom_right(image: torch.Tensor, out_hw: Tuple[int, int],
                     value: float = 0.0) -> torch.Tensor:
    """Pad the last two axes at the bottom/right to ``out_hw``
    (reference sam.py:164-174 preprocessing)."""
    pad_h = out_hw[0] - image.shape[-2]
    pad_w = out_hw[1] - image.shape[-1]
    return F.pad(image, (0, pad_w, 0, pad_h), value=value)


def resize_longest_side_np(image: np.ndarray, target_length: int) -> np.ndarray:
    """HWC (or HW) uint8 image -> longest side ``target_length``, uint8.

    The antialiased bilinear (triangle) filter PIL applies; rounding may
    differ from PIL's fixed-point arithmetic by one uint8 level."""
    newh, neww = get_preprocess_shape(image.shape[0], image.shape[1], target_length)
    x = torch.from_numpy(np.ascontiguousarray(image)).float()
    chw = x.movedim(-1, 0) if x.ndim == 3 else x
    out = resize_bilinear(chw, (newh, neww), antialias=True)
    out = out.movedim(0, -1) if x.ndim == 3 else out
    return out.round().clamp(0, 255).to(torch.uint8).numpy()
