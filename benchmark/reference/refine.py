"""Plain SAM refinement of U-Net probability masks, as the paper refines its
pseudo-labels (utils/seg_refinement.py, segmentation_preprocessing.py,
prompt_utils.py of SamCarriesTheBurden), one image at a time:

1. keep one 8-connected component per class (foreground > 0.5), the one of
   highest mean probability (``scipy.ndimage.label``; a component is named
   by the largest ``linear index + 1`` it holds, and ties go to the smaller
   name);
2. per class with a seed: the positive seed is the rounded centroid of the
   component's pixels no other class covers, the box its tight box, the
   negative seeds the other classes' positive seeds in class order;
3. round 1 decodes the boxes, round 2 the points with round 1's logits as
   the mask prompt (multimask off), in float32;
4. the logits go up to the encoder's square input (bilinear), are cropped to
   the input size, resized to the original size (bilinear), thresholded at
   0 and taken nearest-exact onto the U-Net grid;
5. a class without a seed keeps its selected component; the estimated Dice
   is 2J / (1 + J) of the last round's IoU prediction (NaN without a seed).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage


def keep_one_component(prob: np.ndarray) -> np.ndarray:
    """(H, W) probabilities -> the same with all but the highest-mean
    component zeroed."""
    fg = prob > 0.5
    lab, n = ndimage.label(fg, structure=np.ones((3, 3), bool))
    if n == 0:
        return np.zeros_like(prob)
    idx = np.arange(1, prob.size + 1).reshape(prob.shape)
    names = ndimage.maximum(idx, lab, index=np.arange(1, n + 1))
    means = ndimage.mean(prob.astype(np.float64), lab, index=np.arange(1, n + 1))
    best = means.max()
    cand = np.flatnonzero(means == best)
    keep = cand[np.argmin(names[cand])] + 1
    return np.where(lab == keep, prob, 0).astype(prob.dtype)


def prompts(mask: np.ndarray):
    """(C, H, W) bool -> seeds (C, 2) xy, valid (C,), boxes (C, 4) xyxy."""
    c, h, w = mask.shape
    seed_area = mask & (mask.sum(0, keepdims=True) < 2)
    seeds = np.zeros((c, 2), np.float32)
    valid = np.zeros(c, bool)
    boxes = np.zeros((c, 4), np.float32)
    for i in range(c):
        ys, xs = np.nonzero(seed_area[i])
        if len(ys):
            valid[i] = True
            seeds[i] = (np.round(np.float32(xs.sum()) / np.float32(len(xs))),
                        np.round(np.float32(ys.sum()) / np.float32(len(ys))))
        ys, xs = np.nonzero(mask[i])
        if len(ys):
            boxes[i] = (xs.min(), ys.min(), xs.max(), ys.max())
    return seeds, valid, boxes


def to_grid(low_res: torch.Tensor, input_hw, original_hw, grid_hw, img_size: int) -> torch.Tensor:
    """(C, 1, lr, lr) logits -> (C, H, W) bool on the U-Net grid."""
    m = F.interpolate(low_res, (img_size, img_size), mode="bilinear", align_corners=False)
    m = m[..., :input_hw[0], :input_hw[1]]
    m = F.interpolate(m, tuple(original_hw), mode="bilinear", align_corners=False) > 0
    return F.interpolate(m.float(), tuple(grid_hw), mode="nearest-exact")[:, 0] > 0.5


@torch.no_grad()
def refine_image(sam, prob: np.ndarray, features: torch.Tensor, input_hw: Tuple[int, int],
                 original_hw: Tuple[int, int]):
    """One image: (C, H, W) probabilities, its (1, 256, G, G) embedding ->
    (refined (C, H, W) bool, estimated Dice (C,))."""
    c, h, w = prob.shape
    kept = np.stack([keep_one_component(p) for p in prob])
    mask = kept > 0
    seeds, valid, boxes = prompts(mask)
    dev = features.device
    factor = np.array([input_hw[1], input_hw[0]], np.float32) / np.array([w, h], np.float32)
    box_pts = torch.from_numpy((boxes.reshape(c, 2, 2) * factor).astype(np.float32)).to(dev)
    box_lab = torch.tensor([[2, 3]] * c, device=dev)
    low1, _ = sam.decode(features, box_pts, box_lab)
    pos = seeds[:, None] * factor
    others = np.array([[j for j in range(c) if j != i] for i in range(c)])
    neg = seeds[others] * factor
    pts = np.concatenate([pos, neg, np.zeros((c, 1, 2), np.float32)], axis=1)
    lab = np.concatenate([np.where(valid, 1, -1)[:, None], np.where(valid[others], 0, -1),
                          -np.ones((c, 1), int)], axis=1)
    low2, iou = sam.decode(features, torch.from_numpy(pts.astype(np.float32)).to(dev),
                           torch.from_numpy(lab).to(dev), low1)
    masks = to_grid(low2, input_hw, original_hw, (h, w), sam.cfg["image_size"]).cpu().numpy()
    refined = np.where(valid[:, None, None], masks, mask)
    j = iou[:, 0].double().cpu().numpy()
    dice = np.where(valid, 2 * j / (1 + j), np.nan)
    return refined, dice
