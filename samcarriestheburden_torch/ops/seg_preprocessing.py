"""Mask pre/post-processing combinations (JAX ``ops/seg_preprocessing.py``,
reference utils/segmentation_preprocessing.py:74-119).

Composes the morphology of ``ops/morphology.py`` and the component selection
of ``ops/ccl.py`` (K8 on the card); the re-exports keep the reference's
import surface."""

from __future__ import annotations

import torch

from samcarriestheburden_torch.ops.ccl import (  # noqa: F401 (re-export, reference import surface)
    connected_components, remove_all_but_one_connected_component)
from samcarriestheburden_torch.ops.morphology import (  # noqa: F401
    dilation, erode_mask_with_disc_struct, erosion, get_struct_element)


def opening_with_connected_component(prob_mask: torch.Tensor, structuring_element: str,
                                     radius: int, num_iter: int, selection) -> torch.Tensor:
    """Morphological opening with an optional single-component selection
    between the erosion and the dilation (reference
    segmentation_preprocessing.py:74-119).

    prob_mask: (C, H, W) probabilities, on the device the work runs on.
    Returns the processed probabilities (fp32)."""
    prob_mask = torch.as_tensor(prob_mask).float()
    if prob_mask.ndim != 3:
        raise ValueError("prob_mask should be 3D tensor of shape (C, H, W)")
    kernel = get_struct_element(structuring_element, radius)
    binary = (prob_mask > 0.5).float()
    eroded = erosion(binary, kernel)
    if selection is not None:
        eroded = remove_all_but_one_connected_component(prob_mask * eroded, selection, num_iter)
        eroded = (eroded > 0.5).float()
    return dilation(eroded, kernel) * prob_mask
