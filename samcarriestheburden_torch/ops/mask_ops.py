"""Mask geometry (JAX ``ops/mask_ops.py``, reference segment_anything/utils/amg.py).

Tensor functions run on their inputs' device; the point grids and crop boxes
are host-side numpy and Python, as in the JAX package.  Data-dependent
filtering is the caller's (``engine/amg.py``)."""

from __future__ import annotations

import math
from itertools import product
from typing import List, Tuple

import numpy as np
import torch


def calculate_stability_score(masks: torch.Tensor, mask_threshold: float,
                              threshold_offset: float) -> torch.Tensor:
    """IoU between the high- and low-thresholded versions of (..., H, W)
    mask logits (reference amg.py:156-176), from int32 pixel counts -> fp32."""
    intersections = (masks > (mask_threshold + threshold_offset)).sum(dim=(-1, -2),
                                                                       dtype=torch.int32)
    unions = (masks > (mask_threshold - threshold_offset)).sum(dim=(-1, -2), dtype=torch.int32)
    return intersections / unions


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


def is_box_near_crop_edge(boxes: torch.Tensor, crop_box, orig_box,
                          atol: float = 20.0) -> torch.Tensor:
    """True for (N, 4) crop-frame boxes near the crop's edge but not near the
    image's (reference amg.py:78-88)."""
    crop = torch.as_tensor(crop_box, dtype=torch.float32, device=boxes.device)
    orig = torch.as_tensor(orig_box, dtype=torch.float32, device=boxes.device)
    boxes = uncrop_boxes_xyxy(boxes, crop_box).float()
    near_crop = (boxes - crop[None]).abs() <= atol
    near_image = (boxes - orig[None]).abs() <= atol
    return (near_crop & ~near_image).any(dim=1)


def box_xyxy_to_xywh(box_xyxy: torch.Tensor) -> torch.Tensor:
    """(..., 4) xyxy -> xywh (reference amg.py:91-95)."""
    x0, y0, x1, y1 = box_xyxy.unbind(-1)
    return torch.stack([x0, y0, x1 - x0, y1 - y0], dim=-1)


def build_point_grid(n_per_side: int) -> np.ndarray:
    """(n^2, 2) xy points evenly spaced in [0, 1]^2 (reference amg.py:179-186)."""
    offset = 1 / (2 * n_per_side)
    pts = np.linspace(offset, 1 - offset, n_per_side)
    xx = np.tile(pts[None, :], (n_per_side, 1))
    yy = np.tile(pts[:, None], (1, n_per_side))
    return np.stack([xx, yy], axis=-1).reshape(-1, 2)


def build_all_layer_point_grids(n_per_side: int, n_layers: int,
                                scale_per_layer: int) -> List[np.ndarray]:
    """The point grid of each crop layer (reference amg.py:189-197)."""
    return [build_point_grid(int(n_per_side / (scale_per_layer ** i)))
            for i in range(n_layers + 1)]


def generate_crop_boxes(im_size: Tuple[int, int], n_layers: int,
                        overlap_ratio: float) -> Tuple[List[List[int]], List[int]]:
    """Layered crop boxes, (2^i)^2 in layer i (reference amg.py:200-234)."""
    crop_boxes, layer_idxs = [[0, 0, im_size[1], im_size[0]]], [0]
    im_h, im_w = im_size
    short_side = min(im_h, im_w)

    def crop_len(orig_len, n_crops, overlap):
        return int(math.ceil((overlap * (n_crops - 1) + orig_len) / n_crops))

    for i_layer in range(n_layers):
        n_per_side = 2 ** (i_layer + 1)
        overlap = int(overlap_ratio * short_side * (2 / n_per_side))
        crop_w = crop_len(im_w, n_per_side, overlap)
        crop_h = crop_len(im_h, n_per_side, overlap)
        x0s = [int((crop_w - overlap) * i) for i in range(n_per_side)]
        y0s = [int((crop_h - overlap) * i) for i in range(n_per_side)]
        for x0, y0 in product(x0s, y0s):
            crop_boxes.append([x0, y0, min(x0 + crop_w, im_w), min(y0 + crop_h, im_h)])
            layer_idxs.append(i_layer + 1)
    return crop_boxes, layer_idxs


def uncrop_boxes_xyxy(boxes: torch.Tensor, crop_box) -> torch.Tensor:
    """Shift crop-frame (..., 4) boxes into the original frame (reference amg.py:237-243)."""
    x0, y0 = crop_box[0], crop_box[1]
    offset = torch.tensor([x0, y0, x0, y0], dtype=boxes.dtype, device=boxes.device)
    return boxes + offset


def uncrop_points(points: torch.Tensor, crop_box) -> torch.Tensor:
    """Shift crop-frame (..., 2) points into the original frame (reference amg.py:246-252)."""
    return points + torch.tensor(crop_box[:2], dtype=points.dtype, device=points.device)


def uncrop_masks(masks: torch.Tensor, crop_box, orig_h: int, orig_w: int) -> torch.Tensor:
    """Zero-pad crop-frame (..., h, w) masks back to (orig_h, orig_w)
    (reference amg.py:255-264)."""
    x0, y0, x1, y1 = crop_box
    if x0 == 0 and y0 == 0 and x1 == orig_w and y1 == orig_h:
        return masks
    pad_x, pad_y = orig_w - (x1 - x0), orig_h - (y1 - y0)
    return torch.nn.functional.pad(masks, (x0, pad_x - x0, y0, pad_y - y0))


def batch_iterator(batch_size: int, *args):
    """Equal-length slices of each argument (reference amg.py:98-104)."""
    if not args or any(len(a) != len(args[0]) for a in args):
        raise ValueError("batch_iterator needs arguments of one length")
    n_batches = len(args[0]) // batch_size + int(len(args[0]) % batch_size != 0)
    for b in range(n_batches):
        yield [a[b * batch_size:(b + 1) * batch_size] for a in args]
