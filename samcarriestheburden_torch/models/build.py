"""SAM model registry (JAX ``models/build.py``, reference
segment_anything/build_sam.py).

``sam_model_registry['vit_h'](checkpoint=..., device=...)`` returns a
:class:`SamModel` on ``device`` (None: the card; raises without one).  The
checkpoint may be a reference ``.pth`` state dict (the published SAM
weights) or a JAX-package ``.npz`` params pytree
(``models/modelio.py:save_params``).  ``checkpoint=None`` gives seeded random
weights (seed 0, through :func:`build_sam`): random weights, but not the JAX
package's ``PRNGKey(0)`` ones.
"""

from __future__ import annotations

from pathlib import Path

from samcarriestheburden_torch.config import (SamConfig, sam_vit_b_config, sam_vit_h_config,
                                              sam_vit_l_config, sam_vit_t_config)
from samcarriestheburden_torch.models import convert, modelio
from samcarriestheburden_torch.models.sam import SamModel, build_sam


def _build(cfg: SamConfig, checkpoint=None, device=None) -> SamModel:
    if checkpoint is None:
        return build_sam(cfg, device=device, seed=0)
    checkpoint = Path(checkpoint)
    if checkpoint.suffix == ".npz":
        sd = convert.sam_state_dict_from_jax(modelio.load_params(checkpoint), cfg)
    else:
        sd = convert.load_reference_checkpoint(checkpoint)
    return build_sam(cfg, device=device, state_dict=sd)


def build_sam_vit_h(checkpoint=None, device=None) -> SamModel:
    return _build(sam_vit_h_config(), checkpoint, device)


def build_sam_vit_l(checkpoint=None, device=None) -> SamModel:
    return _build(sam_vit_l_config(), checkpoint, device)


def build_sam_vit_b(checkpoint=None, device=None) -> SamModel:
    return _build(sam_vit_b_config(), checkpoint, device)


def build_sam_vit_t(checkpoint=None, device=None) -> SamModel:
    """Tiny test-scale config (no reference analogue; not a released model)."""
    return _build(sam_vit_t_config(), checkpoint, device)


sam_model_registry = {
    "default": build_sam_vit_h,
    "vit_h": build_sam_vit_h,
    "vit_l": build_sam_vit_l,
    "vit_b": build_sam_vit_b,
    "vit_t": build_sam_vit_t,
}
