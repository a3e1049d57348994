"""Connected-component labelling and component selection (JAX ``ops/ccl.py``).

* :func:`connected_components` — 8-connected max-label propagation with the
  JAX ``method='pool'`` semantics, through K8 (``kernels/ccl.py``); or
  JAX's ``method='scan'`` rounds in plain PyTorch.
* :func:`remove_all_but_one_connected_component` — one component kept per
  class, chosen by one per-map histogram over label ids (the JAX exact
  branch; its top-k candidate stage was a device for the TPU's serialised
  scatters and has no counterpart here).

Both take the JAX package's ``method`` keyword: ``"pool"``, ``"pallas"`` and
(for the selection) ``"auto"`` are one fixpoint, computed by K8 on the card;
``"scan"`` is JAX's other formulation (``_seg_cummax``): each round four
segmented running maxes (rows forward and back, columns forward and back)
and one 3x3 pool step, to the same fixpoint in fewer rounds.  JAX computes
it with XLA's ``associative_scan``, not Pallas, so it has no kernel here:
plain PyTorch, a log-step doubling of the same operator, equal to JAX's bits
at every round count since its values are integers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from samcarriestheburden_torch.kernels import ccl as ccl_k


_METHODS = ("auto", "pool", "pallas", "scan")


def _check_method(method: str) -> None:
    if method not in _METHODS:
        raise ValueError(f"unknown method {method!r}: one of {_METHODS}")


def _seg_cummax(vals: torch.Tensor, bg: torch.Tensor, dim: int, reverse: bool) -> torch.Tensor:
    """Segmented running max of ``vals`` along ``dim``; background pixels
    (``bg``) block propagation and keep their own value (JAX ``_seg_cummax``:
    the scan of ``(v, r) o (v', r') = (r' ? v' : max(v, v'), r | r')``), by
    Hillis-Steele doubling: log2(n) steps, each combining every element with
    the one ``d`` before it."""
    if reverse:
        return _seg_cummax(vals.flip(dim), bg.flip(dim), dim, False).flip(dim)
    v, r = vals, bg
    n = v.shape[dim]
    d = 1
    while d < n:
        v_prev, r_prev = v.narrow(dim, 0, n - d), r.narrow(dim, 0, n - d)
        v_cur, r_cur = v.narrow(dim, d, n - d), r.narrow(dim, d, n - d)
        v = torch.cat([v.narrow(dim, 0, d),
                       torch.where(r_cur, v_cur, torch.maximum(v_prev, v_cur))], dim)
        r = torch.cat([r.narrow(dim, 0, d), r_prev | r_cur], dim)
        d *= 2
    return v


def _scan_components(flat: torch.Tensor, num_iterations: int):
    """JAX ``method='scan'``: at most ``num_iterations`` rounds, stopping at
    the first round that changes nothing.  Returns (labels, converged)."""
    h, w = flat.shape[-2:]
    fg = flat > 0.5
    bg = ~fg
    labels = (torch.arange(1, h * w + 1, dtype=torch.int32, device=flat.device).view(h, w)
              * fg)
    done = False
    for _ in range(num_iterations):
        new = labels
        for dim, reverse in ((-1, False), (-1, True), (-2, False), (-2, True)):
            new = _seg_cummax(new, bg, dim, reverse)
        # one 8-connected step, the 3x3 max as K8's plain version takes it
        # (float32 is exact: labels are below 2**24)
        new = F.max_pool2d(new[:, None].float(), 3, stride=1, padding=1)[:, 0].int() * fg
        done = torch.equal(new, labels)
        labels = new
        if done:
            break
    return labels, torch.tensor(done, device=flat.device)


def connected_components(mask: torch.Tensor, num_iterations: int, check_every: int = 16,
                         method: str = "pool", return_converged: bool = False):
    """Label 8-connected components of (..., H, W) masks (foreground > 0.5).

    Returns int32 labels: 0 is background, a component's label is the largest
    ``linear index + 1`` that reached it.  Propagation runs ``num_iterations``
    steps at most and stops at the fixpoint, checked every ``check_every``
    steps, so truncated labels are bit-identical to the JAX package's.  With
    ``return_converged`` also a 0-d bool tensor: every map reached its
    fixpoint.  ``method``: see the module docstring; ``"scan"`` counts
    rounds, not steps, and checks for the fixpoint after each round
    (``check_every`` unused), as JAX's does."""
    _check_method(method)
    h, w = mask.shape[-2:]
    lead = mask.shape[:-2]
    flat = mask.reshape(-1, h, w).float().contiguous()
    if method == "scan":
        labels, converged = _scan_components(flat, num_iterations)
    else:
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
    labels = connected_components(flat, max(num_iter, h * w),
                                  method="scan" if method == "scan" else "pool")
    winners = _winners(labels, flat.float(), selection)
    keep = (labels == winners[:, None, None]) & (labels > 0)
    return (keep.to(prob_mask.dtype) * flat).reshape(shape)
