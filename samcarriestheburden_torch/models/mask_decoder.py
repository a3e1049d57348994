"""SAM mask decoder (reference segment_anything/modeling/mask_decoder.py).

The 4x upscaling runs ``nn.ConvTranspose2d`` in the torch orientation; the
JAX package stores those kernels spatially flipped for
``lax.conv_transpose``, which ``models/convert.py`` undoes.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from samcarriestheburden_torch.config import MaskDecoderConfig
from samcarriestheburden_torch.models.common import MLP, LayerNorm2d
from samcarriestheburden_torch.models.transformer import TwoWayTransformer


class MaskDecoder(nn.Module):
    def __init__(self, cfg: MaskDecoderConfig):
        super().__init__()
        self.cfg = cfg
        td = cfg.transformer_dim
        nt = cfg.num_mask_tokens
        self.transformer = TwoWayTransformer(cfg)
        self.iou_token = nn.Embedding(1, td)
        self.mask_tokens = nn.Embedding(nt, td)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(td, td // 4, kernel_size=2, stride=2),
            LayerNorm2d(td // 4),
            nn.GELU(),
            nn.ConvTranspose2d(td // 4, td // 8, kernel_size=2, stride=2),
            nn.GELU(),
        )
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLP(td, td, td // 8, 3) for _ in range(nt))
        self.iou_prediction_head = MLP(td, cfg.iou_head_hidden_dim, nt, cfg.iou_head_depth)

    def predict_masks(self, image_embeddings: torch.Tensor, image_pe: torch.Tensor,
                      sparse_prompt_embeddings: torch.Tensor,
                      dense_prompt_embeddings: torch.Tensor,
                      image_shared: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """image_embeddings (1 or B, C, H, W); image_pe (1, C, H, W); sparse
        (B, N, C); dense (B, C, H, W) -> (masks (B, nt, 4H, 4W), iou (B, nt)).
        ``image_shared``: every batch item decodes the same batch-1 image with
        the same dense embedding (round 1 of the refinement decode)."""
        b = sparse_prompt_embeddings.shape[0]
        nt = self.cfg.num_mask_tokens
        out_tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight], dim=0)
        tokens = torch.cat([out_tokens[None].expand(b, -1, -1), sparse_prompt_embeddings], dim=1)

        if image_shared:
            src = image_embeddings + dense_prompt_embeddings[:1]
        else:
            src = image_embeddings.expand(b, -1, -1, -1) + dense_prompt_embeddings
        _, c, h, w = src.shape
        hs, src_out = self.transformer(src, image_pe, tokens, image_shared=image_shared)
        iou_token_out = hs[:, 0]
        mask_tokens_out = hs[:, 1:1 + nt]

        upscaled = self.output_upscaling(src_out.transpose(1, 2).reshape(b, c, h, w))
        hyper_in = torch.stack(
            [mlp(mask_tokens_out[:, i]) for i, mlp in enumerate(self.output_hypernetworks_mlps)],
            dim=1)
        bu, cu, hu, wu = upscaled.shape
        masks = (hyper_in @ upscaled.reshape(bu, cu, hu * wu)).reshape(b, nt, hu, wu)
        return masks, self.iou_prediction_head(iou_token_out)

    def forward(self, image_embeddings, image_pe, sparse_prompt_embeddings,
                dense_prompt_embeddings, multimask_output: bool,
                image_shared: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """Reference ``MaskDecoder.forward`` (mask_decoder.py:71-110)."""
        masks, iou_pred = self.predict_masks(image_embeddings, image_pe,
                                             sparse_prompt_embeddings,
                                             dense_prompt_embeddings, image_shared)
        sl = slice(1, None) if multimask_output else slice(0, 1)
        return masks[:, sl], iou_pred[:, sl]
