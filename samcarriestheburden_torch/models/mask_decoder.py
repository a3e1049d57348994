"""SAM mask decoder (reference segment_anything/modeling/mask_decoder.py).

The 4x upscaling runs ``nn.ConvTranspose2d`` in the torch orientation; the
JAX package stores those kernels spatially flipped for
``lax.conv_transpose``, which ``models/convert.py`` undoes.

``predict_masks(dtype=torch.bfloat16)`` is the JAX package's bf16 decode
(``models/mask_decoder.py:predict_masks(dtype=)``): the fp32 parameters and
the four inputs are cast to bf16 at use; LayerNorm statistics, the
attention softmax, the upscaling's LayerNorm and GELU and the hypernetwork
product's sums stay in fp32; masks and IoU come back in fp32.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from samcarriestheburden_torch.config import MaskDecoderConfig
from samcarriestheburden_torch.models.common import MLP, LayerNorm2d, gelu, layer_norm
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

    def _upscale(self, x: torch.Tensor) -> torch.Tensor:
        """``output_upscaling(x)`` in x's dtype, with the LayerNorm2d and the
        GELU after it in fp32, rounded once (JAX ``_upscale_hyper_preshuffle``)."""
        dt = x.dtype
        up1, ln, _, up2, _ = self.output_upscaling
        x = F.conv_transpose2d(x, up1.weight.to(dt), up1.bias.to(dt), stride=2)
        x = layer_norm(x.movedim(1, -1).float(), ln.weight.to(dt), ln.bias.to(dt), ln.eps)
        x = gelu(x).to(dt).movedim(-1, 1)
        return gelu(F.conv_transpose2d(x, up2.weight.to(dt), up2.bias.to(dt), stride=2))

    def predict_masks(self, image_embeddings: torch.Tensor, image_pe: torch.Tensor,
                      sparse_prompt_embeddings: torch.Tensor,
                      dense_prompt_embeddings: torch.Tensor,
                      image_shared: bool = False,
                      dtype: torch.dtype = torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
        """image_embeddings (n_img, C, H, W); image_pe (1, C, H, W); sparse
        (B, N, C); dense (B, C, H, W) -> (masks (B, nt, 4H, 4W), iou (B, nt)),
        both fp32.  The B items are image-major: item b decodes image
        b // (B // n_img).  ``image_shared``: no item has a mask input, so the
        dense embedding is one shared no-mask embedding (dense[:1]) and the
        transformer projects each image's side once (round 1 of the
        refinement decode).  ``dtype``: the compute type (module docstring)."""
        if dtype != torch.float32:
            def cast(a):
                return a.to(dtype) if a.dtype == torch.float32 else a
            image_embeddings, image_pe = cast(image_embeddings), cast(image_pe)
            sparse_prompt_embeddings = cast(sparse_prompt_embeddings)
            dense_prompt_embeddings = cast(dense_prompt_embeddings)
        b = sparse_prompt_embeddings.shape[0]
        n_img = image_embeddings.shape[0]
        if b % n_img:
            raise ValueError(f"{b} prompt sets do not divide among {n_img} images")
        nt = self.cfg.num_mask_tokens
        out_tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight], dim=0)
        tokens = torch.cat([out_tokens.to(sparse_prompt_embeddings.dtype)[None].expand(b, -1, -1),
                            sparse_prompt_embeddings], dim=1)

        if image_shared:
            src = image_embeddings + dense_prompt_embeddings[:1]
        elif n_img == 1:
            src = image_embeddings.expand(b, -1, -1, -1) + dense_prompt_embeddings
        else:
            src = image_embeddings.repeat_interleave(b // n_img, dim=0) + dense_prompt_embeddings
        c, h, w = src.shape[1:]
        hs, src_out = self.transformer(src, image_pe, tokens, image_shared=image_shared)
        iou_token_out = hs[:, 0]
        mask_tokens_out = hs[:, 1:1 + nt]

        upscaled = self._upscale(src_out.transpose(1, 2).reshape(b, c, h, w))
        hyper_in = torch.stack(
            [mlp(mask_tokens_out[:, i]) for i, mlp in enumerate(self.output_hypernetworks_mlps)],
            dim=1)
        bu, cu, hu, wu = upscaled.shape
        masks = (hyper_in.float() @ upscaled.reshape(bu, cu, hu * wu).float()).reshape(b, nt, hu, wu)
        return masks, self.iou_prediction_head(iou_token_out).float()

    def forward(self, image_embeddings, image_pe, sparse_prompt_embeddings,
                dense_prompt_embeddings, multimask_output: bool,
                image_shared: bool = False,
                dtype: torch.dtype = torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
        """Reference ``MaskDecoder.forward`` (mask_decoder.py:71-110)."""
        masks, iou_pred = self.predict_masks(image_embeddings, image_pe,
                                             sparse_prompt_embeddings,
                                             dense_prompt_embeddings, image_shared, dtype)
        sl = slice(1, None) if multimask_output else slice(0, 1)
        return masks[:, sl], iou_pred[:, sl]
