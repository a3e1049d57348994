"""TwoWayTransformer of the SAM mask decoder (reference segment_anything/modeling/transformer.py)."""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from samcarriestheburden_torch.config import MaskDecoderConfig
from samcarriestheburden_torch.models.common import MLPBlock


class Attention(nn.Module):
    """Attention with an optional downscaled internal width (reference :185-240)."""

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

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        q = self._split(self.q_proj(q))
        k = self._split(self.k_proj(k))
        v = self._split(self.v_proj(v))
        attn = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
        out = torch.softmax(attn, dim=-1) @ v
        b, _, n, _ = out.shape
        return self.out_proj(out.transpose(1, 2).reshape(b, n, -1))


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

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)

        q = queries + query_pe
        k = keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))

        q = queries + query_pe
        k = keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
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
        """image_embedding/image_pe (1 or B, C, H, W); point_embedding (B, N, C)
        -> (queries (B, N, C), keys (B, HW, C)).  ``image_shared`` says the
        image rows are one batch-1 embedding shared by every point set (JAX
        computes its layer-0 image side once); here it is a broadcast,
        which gives the same numbers."""
        b = point_embedding.shape[0]
        if image_shared and image_embedding.shape[0] != 1:
            raise ValueError("image_shared needs a batch-1 image embedding")
        c = image_embedding.shape[1]
        keys = image_embedding.flatten(2).transpose(1, 2).expand(b, -1, c)
        key_pe = image_pe.flatten(2).transpose(1, 2).expand(b, -1, c)
        queries = point_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, key_pe)
        q = queries + point_embedding
        k = keys + key_pe
        queries = self.norm_final_attn(
            queries + self.final_attn_token_to_image(q, k, keys))
        return queries, keys
