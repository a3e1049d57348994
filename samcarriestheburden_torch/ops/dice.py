"""NaN-aware Dice metrics (JAX ``ops/dice.py``, reference utils/dice_coefficient.py).

NaN marks a class absent from the ground truth, so ``torch.nanmean`` skips
it, as the reference does (dice_coefficient.py:51)."""

from __future__ import annotations

import torch


def multilabel_dice(y_hat: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-class Dice of boolean tensors (B, C, *spatial*) -> (B, C) float32,
    NaN where the ground-truth class is empty (reference :30-53)."""
    if y_hat.shape != y.shape:
        raise ValueError(f"Shape mismatch: {tuple(y_hat.shape)} != {tuple(y.shape)}")
    if y_hat.ndim <= 2:
        raise ValueError("expected (B, C, *spatial*) tensors")
    b, c = y.shape[:2]
    y_hat_f = y_hat.reshape(b, c, -1).float()
    y_f = y.reshape(b, c, -1).float()
    intersection = (y_hat_f * y_f).sum(dim=2)
    cardinality = (y_hat_f + y_f).sum(dim=2)
    dice = 2 * intersection / (cardinality + 1e-8)
    gt_present = y.reshape(b, c, -1).bool().any(dim=2)
    return torch.where(gt_present, dice, torch.nan)


def multiclass_dice(y_hat: torch.Tensor, y: torch.Tensor, max_label: int) -> torch.Tensor:
    """Per-class Dice of integer label maps (B, ...), class 0 ignored
    (reference :5-26).  Returns (B, max_label)."""
    if y_hat.shape != y.shape:
        raise ValueError(f"Shape mismatch: {tuple(y_hat.shape)} != {tuple(y.shape)}")
    if y_hat.ndim <= 1:
        raise ValueError("expected (B, ...) label maps")
    b = y.shape[0]
    labels = torch.arange(1, max_label + 1, device=y.device).reshape(1, -1, 1)
    return multilabel_dice(y_hat.reshape(b, 1, -1) == labels, y.reshape(b, 1, -1) == labels)


def jaccard_to_dice(j: torch.Tensor) -> torch.Tensor:
    """IoU -> Dice, ``2J/(1+J)`` (reference seg_refinement.py:114)."""
    return 2 * j / (1 + j)
