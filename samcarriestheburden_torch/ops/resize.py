"""Resize helpers of the SAM path (JAX ``ops/resize.py``).

* ``get_preprocess_shape`` — the reference's +0.5 rounding rule
  (segment_anything/utils/transforms.py:93-102).
* ``resize_bilinear`` — half-pixel centres (torch ``align_corners=False``),
  no antialiasing: JAX ``jax.image.resize(method='linear', antialias=False)``.
* ``resize_nearest`` — torch's ``nearest-exact`` and legacy ``nearest``
  conventions as JAX computes them: fp32 source indices, then a gather.
* ``apply_coords``, ``apply_boxes`` — prompts into the resized frame
  (reference ResizeLongestSide, transforms.py:33-53).
* ``resize_longest_side_np`` — host-side uint8 resize, PIL's antialiased
  bilinear resize (which the reference uses) bit for bit, in numpy.
"""

from __future__ import annotations

import math
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


def _nearest_indices(out_size: int, in_size: int, exact: bool, device) -> torch.Tensor:
    """Source index of each output index, JAX's rule: ``floor((i + 0.5) *
    scale)`` (``exact``) or ``floor(i * scale)``, in fp32 with ``scale``
    rounded to fp32 first.  ``F.interpolate`` computes its nearest indices
    otherwise and picks other pixels at some sizes."""
    scale = torch.tensor(in_size / out_size, dtype=torch.float32, device=device)
    i = torch.arange(out_size, dtype=torch.float32, device=device)
    src = torch.floor((i + 0.5) * scale if exact else i * scale)
    return src.long().clamp(0, in_size - 1)


def resize_nearest(image: torch.Tensor, out_hw: Tuple[int, int], *,
                   exact: bool = True) -> torch.Tensor:
    """Nearest-neighbour resize of the last two axes.  ``exact=True`` is torch
    ``mode='nearest-exact'`` (the reference at seg_refinement.py:111),
    ``exact=False`` the legacy ``mode='nearest'`` (seg_grazpedwri_dataset.py:
    176), both with the JAX package's fp32 indices."""
    h_idx = _nearest_indices(out_hw[0], image.shape[-2], exact, image.device)
    w_idx = _nearest_indices(out_hw[1], image.shape[-1], exact, image.device)
    return image[..., h_idx, :][..., :, w_idx]


def apply_coords(coords, original_size: Tuple[int, int], target_length: int) -> torch.Tensor:
    """Scale (..., 2) xy coords from ``original_size`` (H, W) into the
    resized-longest-side frame (reference transforms.py:33-45); fp32, on
    ``coords``' device."""
    old_h, old_w = original_size
    new_h, new_w = get_preprocess_shape(old_h, old_w, target_length)
    coords = torch.as_tensor(coords, dtype=torch.float32)
    return coords * torch.tensor([new_w / old_w, new_h / old_h], dtype=torch.float32,
                                 device=coords.device)


def apply_boxes(boxes, original_size: Tuple[int, int], target_length: int) -> torch.Tensor:
    """Scale (..., 4) xyxy boxes (reference transforms.py:47-53)."""
    boxes = torch.as_tensor(boxes, dtype=torch.float32)
    return apply_coords(boxes.reshape(-1, 2, 2), original_size, target_length).reshape(boxes.shape)


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


#: the fixed-point fraction bits of PIL's 8-bit resampling (libImaging/Resample.c)
_PIL_PRECISION_BITS = 32 - 8 - 2


def _pil_bilinear_coeffs(in_size: int, out_size: int):
    """PIL's antialiased bilinear taps for one axis (``precompute_coeffs``
    and ``normalize_coeffs_8bpc``): (out_size, K) source indices and
    fixed-point weights, the float arithmetic in PIL's order."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale                         # the bilinear filter's support is 1
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5), in_size).astype(np.int64) - xmin
    x = np.arange(ksize)
    t = np.abs((x[None] + xmin[:, None] - center[:, None] + 0.5) * (1.0 / filterscale))
    w = np.where((t < 1.0) & (x[None] < xmax[:, None]), 1.0 - t, 0.0)
    ww = np.zeros(out_size)
    for j in range(ksize):                        # summed in PIL's order
        ww = ww + w[:, j]
    w = w / np.where(ww == 0, 1.0, ww)[:, None]
    kk = np.floor(0.5 + w * (1 << _PIL_PRECISION_BITS)).astype(np.int64)
    return np.minimum(xmin[:, None] + x[None], in_size - 1), kk


def _pil_resample_rows(image: np.ndarray, out_size: int) -> np.ndarray:
    """One of PIL's two passes, along axis 0: integer taps, rounded and
    clipped to uint8 (the sums stay below 2^31, as in PIL's int32)."""
    idx, kk = _pil_bilinear_coeffs(image.shape[0], out_size)
    src = np.ascontiguousarray(image).astype(np.int32)
    acc = np.full((out_size,) + image.shape[1:], 1 << (_PIL_PRECISION_BITS - 1), np.int32)
    weight = (-1,) + (1,) * (image.ndim - 1)
    for j in range(idx.shape[1]):
        tap = src[idx[:, j]]
        tap *= kk[:, j].astype(np.int32).reshape(weight)
        acc += tap
    acc >>= _PIL_PRECISION_BITS
    return np.clip(acc, 0, 255).astype(np.uint8)


def resize_longest_side_np(image: np.ndarray, target_length: int) -> np.ndarray:
    """HWC (or HW) uint8 image -> longest side ``target_length``, uint8.

    PIL's antialiased bilinear resize, which the reference uses (torchvision
    ``resize(to_pil_image(image), ...)``, transforms.py:26-31) and the JAX
    package calls, bit for bit: PIL's taps and fixed-point arithmetic in
    numpy, the horizontal pass first, so the port needs no PIL."""
    if image.dtype != np.uint8:
        raise ValueError(f"expected a uint8 image, got {image.dtype}")
    newh, neww = get_preprocess_shape(image.shape[0], image.shape[1], target_length)
    out = image
    if neww != image.shape[1]:
        out = _pil_resample_rows(out.swapaxes(0, 1), neww).swapaxes(0, 1)
    if newh != image.shape[0]:
        out = _pil_resample_rows(out, newh)
    return np.ascontiguousarray(out)
