"""Binary morphology (JAX ``ops/morphology.py``).

Every mask the pipeline morphs is 0/1, so flat binary morphology is one
cross-correlation of the mask with the structuring element (SE) plus a
threshold on the count:

* dilation(x)[p] = 1  iff  sum_q SE[q] * x[p + q - origin] > 0
* erosion(x)[p]  = 1  iff  sum_q SE[q] * x[p + q - origin] = sum SE

with the origin at ``size // 2`` (an even SE pads asymmetrically: ``square``
8 pads 4 before and 3 after), dilation padding with 0 and erosion with 1
(kornia's geodesic borders).  The SEs reproduce
skimage.morphology.{square, disk, diamond, star}.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def square(width: int, dtype=np.uint8) -> np.ndarray:
    """width x width block of ones.  The reference passes its ``radius`` knob
    as the width (seg_refinement.py:52): 'square radius 8' is 8 x 8."""
    return np.ones((width, width), dtype=dtype)


def disk(radius: int, dtype=np.uint8) -> np.ndarray:
    """(2r+1)^2 disk: x^2 + y^2 <= r^2."""
    yy, xx = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    return (xx ** 2 + yy ** 2 <= radius ** 2).astype(dtype)


def diamond(radius: int, dtype=np.uint8) -> np.ndarray:
    """(2r+1)^2 diamond: |x| + |y| <= r."""
    yy, xx = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    return (np.abs(xx) + np.abs(yy) <= radius).astype(dtype)


def star(a: int, dtype=np.uint8) -> np.ndarray:
    """skimage's star: a centred square of side 2a+1 united with the diamond
    that is its 45-degree rotated hull, in a (2a+1+2*(a//2))^2 array."""
    if a == 1:
        return np.ones((3, 3), dtype)
    m = 2 * a + 1
    n = a // 2
    size = m + 2 * n
    c = (size - 1) // 2
    yy, xx = np.mgrid[:size, :size]
    in_square = (np.abs(yy - c) <= a) & (np.abs(xx - c) <= a)
    in_diamond = np.abs(yy - c) + np.abs(xx - c) <= c
    return (in_square | in_diamond).astype(dtype)


STRUCT_ELEMENTS = {"square": square, "disk": disk, "diamond": diamond, "star": star}


def get_struct_element(name: str, radius: int) -> np.ndarray:
    """An SE by name, with the reference's square-radius-0 == 1x1 rule
    (seg_refinement.py:49-51)."""
    if name not in STRUCT_ELEMENTS:
        raise NotImplementedError(f"Invalid structuring element: {name}")
    if name == "square" and radius == 0:
        radius = 1
    return STRUCT_ELEMENTS[name](radius)


def _correlate_counts(mask: torch.Tensor, kernel, pad_value: float) -> torch.Tensor:
    """Cross-correlate (..., H, W) 0/1 masks with the SE, origin at size // 2.

    The counts are exact even where cuDNN runs float32 convolutions in TF32
    (its default on the card): the inputs are 0 and 1, and TF32's 11-bit
    significand holds every integer up to 2048; a larger SE is refused."""
    se = np.asarray(kernel, np.float32)
    if se.sum() > 2048:
        raise ValueError("structuring element too large for exact counts")
    kh, kw = se.shape
    oh, ow = kh // 2, kw // 2
    x = mask.reshape(-1, 1, *mask.shape[-2:]).float()
    x = F.pad(x, (ow, kw - 1 - ow, oh, kh - 1 - oh), value=pad_value)
    k = torch.from_numpy(se).to(mask.device)[None, None]
    return F.conv2d(x, k).reshape(mask.shape)


def dilation(mask: torch.Tensor, kernel) -> torch.Tensor:
    """Binary dilation of (..., H, W) masks by the 2-D SE ``kernel`` (an
    array); 0/1 in the mask's dtype."""
    return (_correlate_counts(mask, kernel, 0.0) > 0.5).to(mask.dtype)


def erosion(mask: torch.Tensor, kernel) -> torch.Tensor:
    """Binary erosion of (..., H, W) masks; 0/1 in the mask's dtype.  Border
    pixels see ones outside the image (kornia's geodesic semantics)."""
    total = float(np.asarray(kernel, np.float32).sum())
    return (_correlate_counts(mask, kernel, 1.0) > total - 0.5).to(mask.dtype)


def erode_mask_with_disc_struct(mask: torch.Tensor, radius: int) -> torch.Tensor:
    """Disk-SE erosion of a (C, H, W) boolean mask -> bool
    (reference utils/segmentation_preprocessing.py:55-71)."""
    if mask.ndim != 3:
        raise ValueError("mask should be 3D tensor of shape (C, H, W)")
    if radius <= 0:
        raise ValueError("radius should be greater than 0")
    return erosion(mask.float(), disk(radius)).bool()
