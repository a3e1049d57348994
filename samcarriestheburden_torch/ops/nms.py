"""Greedy box NMS as a keep mask (JAX ``ops/nms.py``).

The reference calls ``torchvision.ops.batched_nms`` (automatic_mask_generator.py:
9,251); the card's machine does not promise torchvision, and the JAX package
returns a boolean keep mask from a fixed-length greedy pass over the
score-sorted boxes.  Here the (n, n) IoU is computed once on the boxes'
device and the greedy pass runs there too, one box after the other as JAX's
``fori_loop`` does, with no host sync inside the pass."""

from __future__ import annotations

from typing import Optional

import torch


def box_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of (N, 4) and (M, 4) xyxy boxes -> (N, M)."""
    a = boxes_a[:, None, :]
    b = boxes_b[None, :, :]
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (boxes_a[:, 2] - boxes_a[:, 0]) * (boxes_a[:, 3] - boxes_a[:, 1])
    area_b = (boxes_b[:, 2] - boxes_b[:, 0]) * (boxes_b[:, 3] - boxes_b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return torch.where(union > 0, inter / union, 0.0)


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
             valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy NMS; a bool keep mask in the input order.

    torchvision's semantics: descending scores (a stable sort, so ties keep
    their input order), a box suppressed by an earlier kept box whose IoU
    with it is strictly above the threshold.  ``valid`` marks entries that
    are never kept (they sort last and are dropped after the pass, as in
    JAX)."""
    n = boxes.shape[0]
    boxes = boxes.float()
    scores = scores.float()
    if valid is not None:
        scores = torch.where(valid, scores, -torch.inf)
    order = torch.argsort(-scores, stable=True)
    suppress = box_iou(boxes[order], boxes[order]) > iou_threshold
    # suppressed[i]: some kept box before i overlaps box i; the pass keeps box
    # i unless suppressed, then lets it suppress its row (the IoU is symmetric)
    suppressed = torch.zeros(n, dtype=torch.bool, device=boxes.device)
    keep_sorted = torch.empty(n, dtype=torch.bool, device=boxes.device)
    for i in range(n):
        keep_i = ~suppressed[i]
        keep_sorted[i] = keep_i
        suppressed |= suppress[i] & keep_i
    if valid is not None:
        keep_sorted &= scores[order] > -torch.inf
    keep = torch.zeros(n, dtype=torch.bool, device=boxes.device)
    keep[order] = keep_sorted
    return keep


def batched_nms_mask(boxes: torch.Tensor, scores: torch.Tensor, category_ids: torch.Tensor,
                     iou_threshold: float, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-category NMS by the coordinate-offset trick (torchvision ``batched_nms``)."""
    if boxes.shape[0] == 0:
        return torch.zeros((0,), dtype=torch.bool, device=boxes.device)
    max_coord = boxes.max() + 1
    offsets = category_ids.float()[:, None] * max_coord
    return nms_mask(boxes + offsets, scores, iou_threshold, valid)
