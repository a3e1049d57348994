"""Host-side small-region removal (JAX ``ops/regions.py``, reference
segment_anything/utils/amg.py:267-291).

The labels and areas come from the native union-find CCL (``native.py``,
8-connectivity), the JAX package's first backend.  The reference's
``cv2.connectedComponentsWithStats``, the JAX package's second, is not used:
the card's machine has no cv2, and a native library that fails to build
raises instead of reaching for it."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _label_with_areas(working_mask: np.ndarray):
    """(labels, n_labels, areas of labels 1..n) of an (H, W) 0/1 mask."""
    from samcarriestheburden_torch import native

    try:
        labels, areas = native.connected_components_with_areas(working_mask > 0)
    except (RuntimeError, OSError) as exc:
        raise RuntimeError(
            "remove_small_regions labels components with the native union-find CCL "
            "(native/sctb_native.cpp, built with g++), which is unavailable; the JAX "
            "package's other backend, cv2.connectedComponentsWithStats, is not used "
            f"here: {exc}") from exc
    return labels, len(areas), areas[1:]


def remove_small_regions(mask: np.ndarray, area_thresh: float,
                         mode: str) -> Tuple[np.ndarray, bool]:
    """Remove small disconnected regions ('islands') or holes ('holes') of an
    (H, W) bool mask.  Returns (mask, changed)."""
    if mode not in ("holes", "islands"):
        raise ValueError(f"mode must be 'holes' or 'islands', got {mode!r}")
    correct_holes = mode == "holes"
    working_mask = (correct_holes ^ mask).astype(np.uint8)
    regions, n_labels, sizes = _label_with_areas(working_mask)
    small_regions = [i + 1 for i, s in enumerate(sizes) if s < area_thresh]
    if not small_regions:
        return mask, False
    fill_labels = [0] + small_regions
    if not correct_holes:
        fill_labels = [i for i in range(n_labels) if i not in fill_labels]
        if not fill_labels:  # keep the largest if everything is below the threshold
            fill_labels = [int(np.argmax(sizes)) + 1]
    return np.isin(regions, fill_labels), True
