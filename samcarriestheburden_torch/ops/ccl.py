"""Connected-component labelling and component selection (JAX ``ops/ccl.py``).

* :func:`connected_components` — 8-connected max-label propagation with the
  JAX ``method='pool'`` semantics, through K8 (``kernels/ccl.py``).
* :func:`remove_all_but_one_connected_component` — one component kept per
  class, chosen by one per-map histogram over label ids (the JAX exact
  branch; its top-k candidate stage was a device for the TPU's serialised
  scatters and has no counterpart here).

Both take the JAX package's ``method`` keyword: ``"pool"``, ``"pallas"`` and
(for the selection) ``"auto"`` are one fixpoint, computed by K8 on the card;
``"scan"`` is a slower formulation of the same fixpoint, not ported yet.
"""

from __future__ import annotations

import torch

from samcarriestheburden_torch.kernels import ccl as ccl_k


_METHODS = ("auto", "pool", "pallas")


def _check_method(method: str) -> None:
    if method == "scan":
        raise NotImplementedError("method='scan' is not ported yet (ROADMAP.md, M11); "
                                  "'pool', 'pallas' and 'auto' run K8")
    if method not in _METHODS:
        raise ValueError(f"unknown method {method!r}: one of {_METHODS + ('scan',)}")


def connected_components(mask: torch.Tensor, num_iterations: int, check_every: int = 16,
                         method: str = "pool", return_converged: bool = False):
    """Label 8-connected components of (..., H, W) masks (foreground > 0.5).

    Returns int32 labels: 0 is background, a component's label is the largest
    ``linear index + 1`` that reached it.  Propagation runs ``num_iterations``
    steps at most and stops at the fixpoint, checked every ``check_every``
    steps, so truncated labels are bit-identical to the JAX package's.  With
    ``return_converged`` also a 0-d bool tensor: every map reached its
    fixpoint.  ``method``: see the module docstring."""
    _check_method(method)
    h, w = mask.shape[-2:]
    lead = mask.shape[:-2]
    flat = mask.reshape(-1, h, w).float().contiguous()
    labels, converged, _ = ccl_k.propagate(flat, num_iterations, check_every)
    labels = labels.reshape(*lead, h, w)
    return (labels, converged.all()) if return_converged else labels


def _winners(labels: torch.Tensor, prob: torch.Tensor, selection: str) -> torch.Tensor:
    """The kept label of each (H, W) map of (M, H, W) labels.

    Areas are integer counts.  The probability sums are float64 and exact:
    every labelled pixel has a float32 probability above 0.5, a multiple of
    2**-24, and the sum of at most 2**29 of them needs fewer than 53 bits, so
    the mean of a component does not depend on the order of summation and
    equal means tie exactly.  Ties go to the smallest label id."""
    m = labels.shape[0]
    n = labels[0].numel() + 1                       # label ids 0..H*W
    dev = labels.device
    idx = (labels.reshape(m, -1).long()
           + torch.arange(m, device=dev)[:, None] * n).reshape(-1)
    areas = torch.bincount(idx, minlength=m * n).view(m, n)
    if selection == "largest":
        metric = areas.double()
    else:
        sums = torch.bincount(idx, weights=prob.reshape(-1).double(), minlength=m * n)
        metric = sums.view(m, n) / areas.clamp(min=1)
    ids = torch.arange(n, device=dev)
    valid = (areas > 0) & (ids > 0)                  # 0 is background
    metric = metric.masked_fill(~valid, float("-inf"))
    best = metric.max(dim=1, keepdim=True).values
    return torch.where(metric == best, ids, n).min(dim=1).values


def remove_all_but_one_connected_component(prob_mask: torch.Tensor, selection: str,
                                           num_iter: int, max_components: int = 256,
                                           method: str = "auto") -> torch.Tensor:
    """Keep one 8-connected component per class of a (C, H, W) or
    (N, C, H, W) probability mask, zeroing the rest (reference
    segmentation_preprocessing.py:7-52).

    ``selection``: 'largest' (pixel area) or 'highest_probability' (mean
    probability).  Propagation runs to its fixpoint (``max(num_iter, H*W)``
    steps at most), so a component is never split; an (N, C, H, W) stack is
    one K8 launch.  Empty classes stay empty.  ``max_components`` (the JAX
    candidate count) is accepted and unused: the histogram is exact over
    every label.  ``method``: see the module docstring."""
    _check_method(method)
    if prob_mask.ndim not in (3, 4):
        raise ValueError("segmentation_mask should be (C, H, W) or (N, C, H, W)")
    if selection not in ("largest", "highest_probability"):
        raise NotImplementedError(f"Invalid selection: {selection}")
    shape = prob_mask.shape
    h, w = shape[-2:]
    flat = prob_mask.reshape(-1, h, w)
    labels = connected_components(flat, max(num_iter, h * w))
    winners = _winners(labels, flat.float(), selection)
    keep = (labels == winners[:, None, None]) & (labels > 0)
    return (keep.to(prob_mask.dtype) * flat).reshape(shape)
