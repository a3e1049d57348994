"""TwoWayTransformer of the SAM mask decoder (reference segment_anything/modeling/transformer.py).

Each block's image-to-token branch runs as one kernel, D1
(``kernels/decoder.py``), for fp32 tensors on the card outside
``torch.export`` (``decoder.fused_applies``); D1 raises on widths other than
SAM's decoder's.  CPU tensors, the bf16 decode and an export run the branch
as written here.  Every block call adds one to the counter
``decode.i2t_fused`` or ``decode.i2t_plain`` (``profiling.count``).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from samcarriestheburden_torch.config import MaskDecoderConfig
from samcarriestheburden_torch.kernels import decoder
from samcarriestheburden_torch.models.common import MLPBlock, linear, norm
from samcarriestheburden_torch.profiling import count


class Attention(nn.Module):
    """Attention with an optional downscaled internal width (reference :185-240).
    It runs in its inputs' dtype with the logits and the softmax in fp32, cast
    back before the product with v (JAX ``transformer.attention``)."""

    def __init__(self, embedding_dim: int, num_heads: int, downsample_rate: int = 1):
        super().__init__()
        internal = embedding_dim // downsample_rate
        if internal % num_heads:
            raise ValueError("num_heads must divide embedding_dim // downsample_rate")
        self.num_heads = num_heads
        self.q_proj = nn.Linear(embedding_dim, internal)
        self.k_proj = nn.Linear(embedding_dim, internal)
        self.v_proj = nn.Linear(embedding_dim, internal)
        self.out_proj = nn.Linear(internal, embedding_dim)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        return x.reshape(b, n, self.num_heads, c // self.num_heads).transpose(1, 2)

    @staticmethod
    def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        logits = q.float() @ k.float().transpose(-1, -2) / math.sqrt(q.shape[-1])
        return torch.softmax(logits, dim=-1).to(v.dtype) @ v

    def _merge(self, out: torch.Tensor) -> torch.Tensor:
        b, _, n, _ = out.shape
        return linear(self.out_proj, out.transpose(1, 2).reshape(b, n, -1))

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        return self._merge(self._attend(self._split(linear(self.q_proj, q)),
                                        self._split(linear(self.k_proj, k)),
                                        self._split(linear(self.v_proj, v))))

    def forward_shared_queries(self, q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor) -> torch.Tensor:
        """``forward`` where the queries (n_img, Nq, C) are shared by the
        B // n_img consecutive items of k, v (B, Nk, C) that belong to each
        image: q's projection runs once per image (JAX
        ``block_apply_image_shared``'s image-to-token step)."""
        n_img = q.shape[0]
        b, nk, _ = k.shape
        qh = self._split(linear(self.q_proj, q))[:, None]           # (n_img, 1, h, Nq, d)
        kh = self._split(linear(self.k_proj, k))
        vh = self._split(linear(self.v_proj, v))
        per_image = (n_img, b // n_img) + kh.shape[1:]
        out = self._attend(qh, kh.reshape(per_image), vh.reshape(per_image))
        return self._merge(out.reshape(b, *out.shape[2:]))


class TwoWayAttentionBlock(nn.Module):
    """Reference transformer.py:109-182 (ReLU MLP, LayerNorm eps 1e-5)."""

    def __init__(self, cfg: MaskDecoderConfig, skip_first_layer_pe: bool):
        super().__init__()
        ed, nh = cfg.transformer_dim, cfg.transformer_num_heads
        dr = cfg.attention_downsample_rate
        self.self_attn = Attention(ed, nh)
        self.norm1 = nn.LayerNorm(ed)
        self.cross_attn_token_to_image = Attention(ed, nh, dr)
        self.norm2 = nn.LayerNorm(ed)
        self.mlp = MLPBlock(ed, cfg.transformer_mlp_dim, act=F.relu)
        self.norm3 = nn.LayerNorm(ed)
        self.norm4 = nn.LayerNorm(ed)
        self.cross_attn_image_to_token = Attention(ed, nh, dr)
        self.skip_first_layer_pe = skip_first_layer_pe
        self._i2t_transposed = (None, None)

    def _i2t_weights(self) -> decoder.Weights:
        """The image-to-token branch's parameters as D1 takes them; its two
        transposed weights are copied again only when a weight changes."""
        a, n = self.cross_attn_image_to_token, self.norm4
        wq, wo = a.q_proj.weight, a.out_proj.weight
        key = (wq.data_ptr(), wq._version, wo.data_ptr(), wo._version)
        if self._i2t_transposed[0] != key:
            self._i2t_transposed = (key, (wq.detach().t().contiguous(),
                                          wo.detach().t().contiguous()))
        wq_t, wo_t = self._i2t_transposed[1]
        return decoder.Weights(wq_t, a.q_proj.bias, a.k_proj.weight, a.k_proj.bias,
                               a.v_proj.weight, a.v_proj.bias, wo_t, a.out_proj.bias,
                               n.weight, n.bias, n.eps, a.num_heads)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = norm(self.norm1, queries)

        q = queries + query_pe
        k = keys + key_pe
        queries = norm(self.norm2, queries + self.cross_attn_token_to_image(q, k, keys))
        queries = norm(self.norm3, queries + self.mlp(queries))

        if decoder.fused_applies(keys.device.type, keys.dtype):
            count("decode.i2t_fused")
            keys = decoder.image_to_token(keys, key_pe, queries, query_pe, self._i2t_weights())
        else:
            count("decode.i2t_plain")
            q = queries + query_pe
            k = keys + key_pe
            keys = norm(self.norm4, keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys

    def forward_image_shared(self, queries, keys, query_pe, key_pe):
        """Layer 0 for items that share their image side (JAX
        ``block_apply_image_shared``, vmapped over images): queries (B, Nq, C)
        image-major, keys (n_img, HW, C) with B a multiple of n_img, key_pe
        (1, HW, C).  The image-side projections (token-to-image k and v,
        image-to-token q) run once per image, and the token-to-image attention
        takes each image's B // n_img prompt sets as one query axis.  Returns
        (queries (B, Nq, C), keys (B, HW, C))."""
        b, nq, c = queries.shape
        n_img = keys.shape[0]
        if b % n_img:
            raise ValueError(f"{b} items do not divide among {n_img} images")
        queries = norm(self.norm1, self.self_attn(queries, queries, queries))

        k_img = keys + key_pe
        q = (queries + query_pe).reshape(n_img, (b // n_img) * nq, c)
        out = self.cross_attn_token_to_image(q, k_img, keys).reshape(b, nq, c)
        queries = norm(self.norm2, queries + out)
        queries = norm(self.norm3, queries + self.mlp(queries))

        if decoder.fused_applies(keys.device.type, keys.dtype):
            count("decode.i2t_fused")
            keys = decoder.image_to_token(keys, key_pe, queries, query_pe, self._i2t_weights())
        else:
            count("decode.i2t_plain")
            out = self.cross_attn_image_to_token.forward_shared_queries(
                k_img, queries + query_pe, queries)
            keys = norm(self.norm4, keys.repeat_interleave(b // n_img, dim=0) + out)
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, cfg: MaskDecoderConfig):
        super().__init__()
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(cfg, skip_first_layer_pe=(i == 0))
            for i in range(cfg.transformer_depth))
        self.final_attn_token_to_image = Attention(
            cfg.transformer_dim, cfg.transformer_num_heads, cfg.attention_downsample_rate)
        self.norm_final_attn = nn.LayerNorm(cfg.transformer_dim)

    def forward(self, image_embedding: torch.Tensor, image_pe: torch.Tensor,
                point_embedding: torch.Tensor,
                image_shared: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """image_embedding (1 or B, C, H, W), image_pe (1, C, H, W),
        point_embedding (B, N, C) -> (queries (B, N, C), keys (B, HW, C)).

        ``image_shared``: the image rows are those of n_img images, each
        shared by B // n_img consecutive point sets (image_embedding (n_img,
        C, H, W); round 1 of the refinement decode, where no item has a mask
        input).  Layer 0 then projects each image's side once
        (:meth:`TwoWayAttentionBlock.forward_image_shared`)."""
        b = point_embedding.shape[0]
        c = image_embedding.shape[1]
        keys = image_embedding.flatten(2).transpose(1, 2)
        key_pe = image_pe.flatten(2).transpose(1, 2)
        queries = point_embedding
        layers = list(self.layers)
        if image_shared:
            queries, keys = layers[0].forward_image_shared(queries, keys, point_embedding, key_pe)
            layers = layers[1:]
        else:
            keys = keys.expand(b, -1, c)
        key_pe = key_pe.expand(b, -1, c)
        for layer in layers:
            queries, keys = layer(queries, keys, point_embedding, key_pe)
        q = queries + point_embedding
        k = keys + key_pe
        queries = norm(self.norm_final_attn,
                       queries + self.final_attn_token_to_image(q, k, keys))
        return queries, keys
