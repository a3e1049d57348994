"""SAM prompt encoder (reference segment_anything/modeling/prompt_encoder.py).

Two call styles, as in the JAX package:

* ``forward(points, boxes, masks)`` — the reference's optional-argument API
  (JAX ``prompt_encoder.apply``);
* :meth:`PromptEncoder.embed_unified_points` — one static-shape (B, N, 2)
  coords + (B, N) labels tensor, labels in {-1 pad, 0 neg, 1 pos, 2 box-TL,
  3 box-BR} (the layout of SAM's ONNX export), which the batched 17-class
  refinement decode uses.

Coordinates are in the input-image frame (after resize-longest-side).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from samcarriestheburden_torch.config import PromptEncoderConfig
from samcarriestheburden_torch.models.common import LayerNorm2d


class PositionEmbeddingRandom(nn.Module):
    """Random Fourier positional encoding (reference prompt_encoder.py:171-214)."""

    def __init__(self, num_pos_feats: int):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.zeros(2, num_pos_feats))

    def encode(self, coords01: torch.Tensor) -> torch.Tensor:
        """(..., 2) coords in [0, 1]^2 -> (..., 2 * num_pos_feats)."""
        coords = (2 * coords01 - 1) @ self.positional_encoding_gaussian_matrix
        coords = 2 * math.pi * coords
        return torch.cat([torch.sin(coords), torch.cos(coords)], dim=-1)


class PromptEncoder(nn.Module):
    def __init__(self, cfg: PromptEncoderConfig):
        super().__init__()
        self.cfg = cfg
        ed, mc = cfg.embed_dim, cfg.mask_in_chans
        self.pe_layer = PositionEmbeddingRandom(ed // 2)
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, ed) for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, ed)
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, mc // 4, kernel_size=2, stride=2),
            LayerNorm2d(mc // 4),
            nn.GELU(),
            nn.Conv2d(mc // 4, mc, kernel_size=2, stride=2),
            LayerNorm2d(mc),
            nn.GELU(),
            nn.Conv2d(mc, ed, kernel_size=1),
        )
        self.no_mask_embed = nn.Embedding(1, ed)

    def get_dense_pe(self) -> torch.Tensor:
        """Grid positional encoding, (1, embed_dim, H, W)."""
        h, w = self.cfg.image_embedding_size
        dev = self.no_mask_embed.weight.device
        y = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
        x = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
        grid = torch.stack(torch.meshgrid(x, y, indexing="xy"), dim=-1)  # (H, W, 2) as (x, y)
        return self.pe_layer.encode(grid).permute(2, 0, 1)[None]

    def pe_with_coords(self, coords: torch.Tensor, image_size: Tuple[int, int]) -> torch.Tensor:
        """Encode unnormalised (..., 2) xy coords against an (H, W)
        ``image_size`` (reference prompt_encoder.py:207-214)."""
        norm = coords / torch.tensor([image_size[1], image_size[0]], dtype=coords.dtype,
                                     device=coords.device)
        return self.pe_layer.encode(norm)

    def embed_unified_points(self, coords: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """(B, N, 2) coords + (B, N) labels -> (B, N, embed_dim).  Points get
        the reference's +0.5 pixel-centre shift (prompt_encoder.py:80,95)."""
        h, w = self.cfg.input_image_size
        coords = coords.float() + 0.5
        coords = coords / torch.tensor([w, h], dtype=torch.float32, device=coords.device)
        pe = self.pe_layer.encode(coords)
        labels = labels.long()
        table = torch.cat([e.weight for e in self.point_embeddings], dim=0)
        type_emb = table[labels.clamp(0, 3)]
        return torch.where((labels == -1)[..., None],
                           self.not_a_point_embed.weight[0], pe + type_emb)

    def no_mask_dense(self, batch: int) -> torch.Tensor:
        """Dense embedding without a mask prompt, (B, embed_dim, H, W)."""
        h, w = self.cfg.image_embedding_size
        return self.no_mask_embed.weight.reshape(1, -1, 1, 1).expand(batch, -1, h, w)

    def embed_masks(self, masks: torch.Tensor) -> torch.Tensor:
        """(B, 1, 4H, 4W) mask logits -> (B, embed_dim, H, W)."""
        return self.mask_downscaling(masks)

    def embed_masks_or_default(self, masks: torch.Tensor, use_mask: torch.Tensor) -> torch.Tensor:
        """The mask or no-mask dense embedding per batch item, with static
        shapes: the downscaler runs on every (B, 1, 4H, 4W) mask and
        ``use_mask`` (B,) bool picks it or the no-mask embedding."""
        dense = self.embed_masks(masks)
        return torch.where(use_mask[:, None, None, None], dense,
                           self.no_mask_dense(masks.shape[0]))

    def forward(self, points: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                boxes: Optional[torch.Tensor] = None,
                masks: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Reference ``PromptEncoder.forward``: (sparse (B, N', C), dense (B, C, H, W))."""
        if points is not None:
            bs = points[0].shape[0]
        elif boxes is not None:
            bs = boxes.shape[0]
        elif masks is not None:
            bs = masks.shape[0]
        else:
            bs = 1
        dev = self.no_mask_embed.weight.device
        parts = []
        if points is not None:
            coords, labels = points
            coords, labels = coords.float(), labels.long()
            if boxes is None:  # pad with one not-a-point (reference :81-85)
                coords = torch.cat([coords, coords.new_zeros(bs, 1, 2)], dim=1)
                labels = torch.cat([labels, -labels.new_ones(bs, 1)], dim=1)
            parts.append(self.embed_unified_points(coords, labels))
        if boxes is not None:
            corners = boxes.float().reshape(-1, 2, 2)
            corner_labels = torch.tensor([2, 3], device=corners.device).expand(corners.shape[0], 2)
            parts.append(self.embed_unified_points(corners, corner_labels)
                         .reshape(bs, -1, self.cfg.embed_dim))
        if parts:
            sparse = torch.cat(parts, dim=1)
        else:
            sparse = torch.zeros((bs, 0, self.cfg.embed_dim), device=dev)
        dense = self.embed_masks(masks) if masks is not None else self.no_mask_dense(bs)
        return sparse, dense
