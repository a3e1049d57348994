"""PIL's antialiased bilinear resize of a uint8 image, longest side to a
target length, in numpy: the resize SAM's reference preprocessing applies
(torchvision ``resize(to_pil_image(image))``, transforms.py:26-31), PIL's
taps and fixed-point arithmetic written out (libImaging/Resample.c), so the
reference needs no PIL.  A frozen copy of the program's plain version."""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def get_preprocess_shape(oldh: int, oldw: int, long_side_length: int) -> Tuple[int, int]:
    """Output (H, W) after resizing the longest side to ``long_side_length``."""
    scale = long_side_length * 1.0 / max(oldh, oldw)
    newh, neww = oldh * scale, oldw * scale
    return int(newh + 0.5), int(neww + 0.5)


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
