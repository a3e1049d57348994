"""PyTorch/CUDA port of samcarriestheburden_tpu for NVIDIA Hopper (H100).

The SAM ViT-H image encoder runs in bf16 through four hand-written CUDA
kernels, and the enhance leg (``engine/refinement.py``) labels connected
components with a fifth (``kernels/``, sources in ``csrc/``); the prompt
encoder, the mask decoder and the rest of enhance run in plain PyTorch.
Entry points run on the card unless the caller passes ``device="cpu"``,
where every kernel wrapper takes its plain PyTorch version.  This package
imports nothing of the JAX package.
"""

from samcarriestheburden_torch.config import (N_CLASSES, SamConfig,
                                              sam_vit_h_config,
                                              sam_vit_t_config)
from samcarriestheburden_torch.models.sam import SamModel, build_sam

__all__ = ["N_CLASSES", "SamConfig", "SamModel", "build_sam",
           "sam_vit_h_config", "sam_vit_t_config"]
