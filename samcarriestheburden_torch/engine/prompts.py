"""Automatic prompt extraction from predicted masks (JAX ``engine/prompts.py``,
reference segment_anything/utils/prompt_utils.py).

:func:`extract_prompt_arrays` computes every class's centroid seed and box at
once as masked reductions, into fixed-shape tensors plus validity flags, so
the batched decoder takes all classes of an image in one call.
:class:`PromptExtractor` keeps the reference's list-of-``Prompt`` API on top.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from samcarriestheburden_torch.ops.mask_ops import batched_mask_to_box
from samcarriestheburden_torch.ops.resize import (get_preprocess_shape, pad_bottom_right,
                                                  resize_bilinear)


@dataclass
class Prompt:
    """Per-class prompt (reference prompt_utils.py:11-18); coordinates (x, y)."""

    class_idx: int
    img_size: Tuple[int, int]
    pos_seeds: Optional[np.ndarray] = None
    neg_seeds: Optional[np.ndarray] = None
    box: Optional[np.ndarray] = None
    mask_logits: Optional[np.ndarray] = None


def extract_prompt_arrays(pred_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """All-class prompts of a (..., C, H, W) boolean mask, one set per
    (C, H, W) image of the leading dimensions:

    pos_seeds (..., C, 2) float32 xy — rounded centroid over the area no
    other class of the same image covers; pos_valid (..., C) bool — the
    reference skips seedless classes (:125); boxes (..., C, 4) float32 xyxy —
    tight box of the whole class mask; box_valid (..., C) bool.

    The coordinate sums are integers (exact in int64) and the division is
    float32, as the JAX package divides its float32 sums."""
    mask = pred_mask.bool()
    h, w = mask.shape[-2:]
    dev = mask.device
    seed_mask = mask & (mask.sum(dim=-3, keepdim=True) < 2)     # reference :65-67
    ys = torch.arange(h, device=dev)
    xs = torch.arange(w, device=dev)
    n = seed_mask.sum(dim=(-2, -1)).float()
    denom = n.clamp(min=1)
    cy = (seed_mask * ys[:, None]).sum(dim=(-2, -1)).float() / denom
    cx = (seed_mask * xs).sum(dim=(-2, -1)).float() / denom
    return {
        "pos_seeds": torch.stack([cx.round(), cy.round()], dim=-1),
        "pos_valid": n > 0,
        "boxes": batched_mask_to_box(mask).float(),
        "box_valid": mask.any(dim=-1).any(dim=-1),
    }


def neg_seed_table(pos_seeds: torch.Tensor, pos_valid: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Negative seeds of class i = every other class's positive seed of the
    same image, in ascending class order (reference :132-133), as a
    (..., C, C-1, 2) table and (..., C, C-1) validity from (..., C, 2) seeds
    and (..., C) validity; a seedless class becomes a not-a-point pad."""
    c = pos_seeds.shape[-2]
    idx = torch.tensor([[j for j in range(c) if j != i] for i in range(c)],
                       dtype=torch.long, device=pos_seeds.device).reshape(c, c - 1)
    return pos_seeds[..., idx, :], pos_valid[..., idx]


def compute_logits_from_mask(class_mask: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """(H, W) bool -> (1, 256, 256) SAM mask-input logits (reference :70-110,
    micro-sam's adaptation): inverse sigmoid of the eps-clamped mask,
    antialiased resize of the longest side to 256, zero pad."""
    h, w = class_mask.shape
    logit_hi = float(np.log((1 - eps) / eps))
    logits = torch.where(class_mask.bool(), logit_hi, -logit_hi).float()
    newh, neww = get_preprocess_shape(h, w, 256)
    logits = resize_bilinear(logits, (newh, neww), antialias=True)
    return pad_bottom_right(logits, (256, 256))[None]


def extract_selecting_prompt_arrays(prob_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """SAMSelectingPromptExtractor's core (reference :187-220): the pixel of
    highest / lowest probability of each class as its pos / neg seed."""
    c, h, w = prob_mask.shape
    flat = prob_mask.reshape(c, -1)

    def to_xy(idx):
        return torch.stack([(idx % w).float(), (idx // w).float()], dim=-1)

    return {
        "pos_seeds": to_xy(flat.argmax(dim=1)),
        "neg_seeds": to_xy(flat.argmin(dim=1)),
        "valid": (prob_mask > 0.5).flatten(1).any(dim=1),
    }


def _numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class PromptExtractor:
    """Reference-compatible extractor over a (C, H, W) boolean mask
    (prompt_utils.py:21-143); its prompts hold numpy arrays."""

    def __init__(self, pred_mask):
        pred_mask = _numpy(pred_mask)
        if pred_mask.ndim != 3:
            raise ValueError("pred_mask should be 3D tensor of shape (C, H, W)")
        if pred_mask.dtype != bool:
            raise ValueError("pred_mask should be boolean tensor")
        self.pred_mask = pred_mask
        self.num_classes = pred_mask.shape[0]
        arrays = extract_prompt_arrays(torch.from_numpy(pred_mask))
        self._arrays = {k: v.numpy() for k, v in arrays.items()}

    @property
    def seeds(self) -> List[Optional[np.ndarray]]:
        a = self._arrays
        return [a["pos_seeds"][i].round().astype(np.int32)[None] if a["pos_valid"][i] else None
                for i in range(self.num_classes)]

    def extract(self, seeds: bool = True, boxes: bool = True,
                mask: bool = False) -> List[Prompt]:
        a = self._arrays
        img_size = tuple(self.pred_mask.shape[-2:])
        all_seeds = self.seeds
        prompts = []
        for i in range(self.num_classes):
            if all_seeds[i] is None:          # reference skips seedless classes (:125)
                continue
            p = Prompt(i, img_size)
            if seeds:
                p.pos_seeds = all_seeds[i]
                others = [all_seeds[j] for j in range(self.num_classes)
                          if j != i and all_seeds[j] is not None]
                p.neg_seeds = np.concatenate(others) if others else np.zeros((0, 2), np.int32)
            if boxes:
                p.box = a["boxes"][i].round().astype(np.int32)
            if mask:
                p.mask_logits = compute_logits_from_mask(
                    torch.from_numpy(self.pred_mask[i])).numpy()
            prompts.append(p)
        return prompts


class SAMSelectingPromptExtractor(PromptExtractor):
    """Reference prompt_utils.py:187-220."""

    def __init__(self, pred_mask):
        pred_mask = _numpy(pred_mask).astype(np.float32)
        super().__init__(pred_mask > 0.5)
        self.float_pred_mask = pred_mask
        sel = extract_selecting_prompt_arrays(torch.from_numpy(pred_mask))
        self._sel = {k: v.numpy() for k, v in sel.items()}

    def extract(self, mask: bool = True) -> List[Prompt]:
        img_size = tuple(self.pred_mask.shape[-2:])
        prompts = []
        for i in range(self.num_classes):
            if not self.float_pred_mask[i].any():
                continue
            p = Prompt(i, img_size)
            p.pos_seeds = self._sel["pos_seeds"][i][None]
            p.neg_seeds = self._sel["neg_seeds"][i][None]
            if mask:
                p.mask_logits = compute_logits_from_mask(
                    torch.from_numpy(self.pred_mask[i])).numpy()
            prompts.append(p)
        return prompts
