"""Composite SAM model (reference segment_anything/modeling/sam.py).

``SamModel`` holds the three sub-modules under the reference's names
(``image_encoder``, ``prompt_encoder``, ``mask_decoder``), so a reference
SAM state dict loads with ``load_state_dict``, and exposes the JAX
``SamModel`` surface: ``preprocess``, ``encode_image``, ``encode_prompts``,
``decode_masks``, ``postprocess_masks`` and the batched ``forward``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from samcarriestheburden_torch.config import SamConfig
from samcarriestheburden_torch.device import resolve_device
from samcarriestheburden_torch.models.common import random_init_
from samcarriestheburden_torch.models.image_encoder import ImageEncoderViT
from samcarriestheburden_torch.models.mask_decoder import MaskDecoder
from samcarriestheburden_torch.models.prompt_encoder import PromptEncoder
from samcarriestheburden_torch.ops.resize import pad_bottom_right, resize_bilinear


def postprocess_masks(cfg: SamConfig, masks: torch.Tensor, input_size: Tuple[int, int],
                      original_size: Tuple[int, int]) -> torch.Tensor:
    """Low-res mask logits -> the original image frame (reference
    sam.py:133-162): bilinear to img_size^2, crop the padding, bilinear to
    ``original_size``."""
    size = cfg.image_encoder.img_size
    masks = resize_bilinear(masks, (size, size))
    masks = masks[..., :input_size[0], :input_size[1]]
    return resize_bilinear(masks, tuple(original_size))


class SamModel(nn.Module):
    def __init__(self, cfg: SamConfig):
        super().__init__()
        self.cfg = cfg
        self.image_encoder = ImageEncoderViT(cfg.image_encoder)
        self.prompt_encoder = PromptEncoder(cfg.prompt_encoder)
        self.mask_decoder = MaskDecoder(cfg.mask_decoder)
        self.register_buffer("pixel_mean", torch.tensor(cfg.pixel_mean).view(-1, 1, 1), False)
        self.register_buffer("pixel_std", torch.tensor(cfg.pixel_std).view(-1, 1, 1), False)

    @property
    def device(self) -> torch.device:
        return self.pixel_mean.device

    @property
    def img_size(self) -> int:
        return self.cfg.image_encoder.img_size

    @property
    def mask_threshold(self) -> float:
        return self.cfg.mask_threshold

    def preprocess(self, x: torch.Tensor) -> torch.Tensor:
        """Normalise pixels and pad bottom/right to the encoder's square input."""
        x = (x.float() - self.pixel_mean) / self.pixel_std
        return pad_bottom_right(x, (self.img_size, self.img_size))

    def encode_image(self, x: torch.Tensor, *, dtype=None) -> torch.Tensor:
        """(B, 3, img, img) preprocessed -> (B, out_chans, grid, grid); the
        encoder's compute type ``dtype`` defaults to bf16 on the card and
        fp32 on the CPU."""
        return self.image_encoder(x, dtype=dtype)

    def encode_prompts(self, points=None, boxes=None, masks=None):
        return self.prompt_encoder(points=points, boxes=boxes, masks=masks)

    def get_dense_pe(self) -> torch.Tensor:
        return self.prompt_encoder.get_dense_pe()

    def decode_masks(self, image_embeddings, image_pe, sparse, dense,
                     multimask_output: bool, image_shared: bool = False):
        return self.mask_decoder(image_embeddings, image_pe, sparse, dense,
                                 multimask_output, image_shared=image_shared)

    def postprocess_masks(self, masks, input_size, original_size):
        return postprocess_masks(self.cfg, masks, input_size, original_size)

    @torch.no_grad()
    def forward(self, batched_input: List[Dict[str, Any]],
                multimask_output: bool) -> List[Dict[str, torch.Tensor]]:
        """Reference ``Sam.forward`` over per-image dicts (tensors on the
        model's device)."""
        images = torch.stack([self.preprocess(rec["image"]) for rec in batched_input])
        embeddings = self.encode_image(images)
        outputs = []
        for rec, emb in zip(batched_input, embeddings):
            points = None
            if "point_coords" in rec:
                points = (rec["point_coords"], rec["point_labels"])
            sparse, dense = self.encode_prompts(points=points, boxes=rec.get("boxes"),
                                                masks=rec.get("mask_inputs"))
            low_res, iou = self.decode_masks(emb[None], self.get_dense_pe(), sparse,
                                             dense, multimask_output)
            masks = self.postprocess_masks(low_res, tuple(rec["image"].shape[-2:]),
                                           tuple(rec["original_size"]))
            outputs.append({"masks": masks > self.mask_threshold,
                            "iou_predictions": iou, "low_res_logits": low_res})
        return outputs


@torch.no_grad()
def two_round_decode(model: SamModel, features: torch.Tensor, coords: torch.Tensor,
                     labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The refinement decode of every class of one image: (1, C, H, W)
    embedding, (N, P, 2) point coords and (N, P) labels (one point set per
    class) -> (low-res logits (N, 1, 4H, 4W), iou (N, 1)).  Round 1 decodes
    the points alone, sharing the image side across the N sets; round 2
    feeds round 1's logits back as the mask prompt (JAX bench.py:311-327)."""
    pe = model.prompt_encoder
    sparse = pe.embed_unified_points(coords, labels)
    image_pe = pe.get_dense_pe()
    low1, _ = model.decode_masks(features, image_pe, sparse, pe.no_mask_dense(1),
                                 False, image_shared=True)
    return model.decode_masks(features, image_pe, sparse, pe.embed_masks(low1), False)


def build_sam(cfg: SamConfig, *, device=None, seed: Optional[int] = None,
              state_dict: Optional[Dict[str, torch.Tensor]] = None) -> SamModel:
    """A ``SamModel`` on ``device`` (None: the card; raises without one),
    with ``state_dict``'s weights or, given ``seed``, random weights drawn
    from a ``torch.Generator`` on that device."""
    dev = resolve_device(device)
    if (seed is None) == (state_dict is None):
        raise ValueError("pass exactly one of seed and state_dict")
    with torch.device("meta"):
        model = SamModel(cfg)
    model = model.to_empty(device=dev)
    model.pixel_mean.copy_(torch.tensor(cfg.pixel_mean).view(-1, 1, 1))
    model.pixel_std.copy_(torch.tensor(cfg.pixel_std).view(-1, 1, 1))
    if state_dict is not None:
        model.load_state_dict(state_dict)
        return model.eval()
    gen = torch.Generator(device=dev).manual_seed(seed)
    random_init_(model, gen)
    with torch.no_grad():
        # the reference initialises these to zeros or N(0, 1); trained values are
        # small and nonzero, which exercises the rel-pos path
        for name, p in model.named_parameters():
            if name.endswith(("rel_pos_h", "rel_pos_w", "pos_embed")):
                p.normal_(0.0, 0.02, generator=gen)
        model.prompt_encoder.pe_layer.positional_encoding_gaussian_matrix.normal_(
            0.0, 1.0, generator=gen)
    return model.eval()
