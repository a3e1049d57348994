"""Plain SAM in float32: the image encoder, the prompt encoder and the mask
decoder as segment_anything/modeling/{image_encoder,prompt_encoder,
mask_decoder,transformer}.py write them (Kirillov et al., 2023), with the
published parameter names, so one seeded state dict loads into this module
and into the program under test.

Written from the published description for the benchmark's comparison:
plain ``torch`` operations, no kernels, no batching across images, no
shared image side.  Two departures, both to reach the program's inputs
without a second convention: ``decode`` takes one unified (B, N, 2) point
tensor with labels in {-1 pad, 0 neg, 1 pos, 2 box corner 1, 3 box corner
2} (the layout of SAM's ONNX export, which the reference's ``_embed_points``
and ``_embed_boxes`` produce for these prompts), and the encoder may quantize
the three matrices of each block to ``act_bits`` (the lower-precision
control; None: float32).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


class LayerNorm2d(nn.Module):
    def __init__(self, c: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.eps = eps

    def forward(self, x):
        u = x.mean(1, keepdim=True)
        s = (x - u).pow(2).mean(1, keepdim=True)
        x = (x - u) / torch.sqrt(s + self.eps)
        return self.weight[:, None, None] * x + self.bias[:, None, None]


def fake_quant(x: torch.Tensor, bits: Optional[int], dim: int = -1) -> torch.Tensor:
    """Symmetric absmax quantization to ``bits`` along ``dim`` (one scale per
    row of the other axes), returned dequantized; None: x unchanged."""
    if bits is None:
        return x
    q = 2 ** (bits - 1) - 1
    s = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / q
    return torch.round(x / s).clamp(-q, q) * s


def qlinear(layer: nn.Linear, x: torch.Tensor, bits: Optional[int]) -> torch.Tensor:
    return F.linear(fake_quant(x, bits), fake_quant(layer.weight, bits), layer.bias)


# ---------------------------------------------------------------------------
# image encoder (image_encoder.py)
# ---------------------------------------------------------------------------


def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    q_coords = torch.arange(q_size, device=rel_pos.device)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size, device=rel_pos.device)[None, :] * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[rel.long()]


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, size: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        hd = dim // heads
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * size - 1, hd))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * size - 1, hd))

    def forward(self, x, bits=None):
        b, h, w, _ = x.shape
        qkv = qlinear(self.qkv, x, bits).reshape(b, h * w, 3, self.heads, -1).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.reshape(3, b * self.heads, h * w, -1).unbind(0)
        hd = q.shape[-1]
        attn = (q * hd ** -0.5) @ k.transpose(-2, -1)
        rh = get_rel_pos(h, h, self.rel_pos_h)
        rw = get_rel_pos(w, w, self.rel_pos_w)
        r_q = q.reshape(b * self.heads, h, w, hd)
        rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, rh)
        rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, rw)
        attn = (attn.view(-1, h, w, h, w) + rel_h[:, :, :, :, None]
                + rel_w[:, :, :, None, :]).view(-1, h * w, h * w)
        out = (attn.softmax(dim=-1) @ v).view(b, self.heads, h, w, -1)
        return self.proj(out.permute(0, 2, 3, 1, 4).reshape(b, h, w, -1))


class MLPBlock(nn.Module):
    def __init__(self, dim: int, hidden: int, act=F.gelu):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)
        self.act = act

    def forward(self, x, bits=None):
        return qlinear(self.lin2, self.act(qlinear(self.lin1, x, bits)), bits)


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: float, window: int, grid: int):
        super().__init__()
        self.window = window
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, heads, window if window > 0 else grid)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MLPBlock(dim, int(dim * mlp_ratio))

    def forward(self, x, bits=None):
        shortcut = x
        x = self.norm1(x)
        if self.window > 0:
            h, w = x.shape[1:3]
            ws = self.window
            ph, pw = -h % ws, -w % ws
            x = F.pad(x, (0, 0, 0, pw, 0, ph))
            hp, wp = h + ph, w + pw
            b, c = x.shape[0], x.shape[-1]
            x = x.view(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
            x = self.attn(x.reshape(-1, ws, ws, c), bits)
            x = x.view(b, hp // ws, wp // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
            x = x.reshape(b, hp, wp, c)[:, :h, :w]
        else:
            x = self.attn(x, bits)
        x = shortcut + x
        return x + self.mlp(self.norm2(x), bits)


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, kernel_size=patch, stride=patch)


class ImageEncoder(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        dim, grid = c["encoder_embed_dim"], c["image_size"] // c["vit_patch_size"]
        self.patch_embed = PatchEmbed(c["vit_patch_size"], dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, grid, grid, dim))
        self.blocks = nn.ModuleList(
            Block(dim, c["encoder_num_heads"], c["mlp_ratio"],
                  0 if i in c["encoder_global_attn_indexes"] else c["window_size"], grid)
            for i in range(c["encoder_depth"]))
        oc = c["prompt_embed_dim"]
        self.neck = nn.Sequential(nn.Conv2d(dim, oc, 1, bias=False), LayerNorm2d(oc),
                                  nn.Conv2d(oc, oc, 3, padding=1, bias=False), LayerNorm2d(oc))

    def forward(self, x, bits=None):
        x = self.patch_embed.proj(x).permute(0, 2, 3, 1) + self.pos_embed
        for blk in self.blocks:
            x = blk(x, bits)
        return self.neck(x.permute(0, 3, 1, 2))


# ---------------------------------------------------------------------------
# prompt encoder (prompt_encoder.py)
# ---------------------------------------------------------------------------


class PositionEmbeddingRandom(nn.Module):
    def __init__(self, n: int):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix", torch.zeros(2, n))

    def pe(self, coords01):
        c = 2 * math.pi * ((2 * coords01 - 1) @ self.positional_encoding_gaussian_matrix)
        return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)


class PromptEncoder(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        d, mc = c["prompt_embed_dim"], c["mask_in_chans"]
        g = c["image_size"] // c["vit_patch_size"]
        self.grid, self.image_size = g, c["image_size"]
        self.pe_layer = PositionEmbeddingRandom(d // 2)
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, d) for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, d)
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, mc // 4, 2, stride=2), LayerNorm2d(mc // 4), nn.GELU(),
            nn.Conv2d(mc // 4, mc, 2, stride=2), LayerNorm2d(mc), nn.GELU(),
            nn.Conv2d(mc, d, 1))
        self.no_mask_embed = nn.Embedding(1, d)

    def dense_pe(self):
        g = self.grid
        ones = torch.ones((g, g), device=self.no_mask_embed.weight.device)
        y = (ones.cumsum(0) - 0.5) / g
        x = (ones.cumsum(1) - 0.5) / g
        return self.pe_layer.pe(torch.stack([x, y], dim=-1)).permute(2, 0, 1)[None]

    def sparse(self, coords, labels):
        pe = self.pe_layer.pe((coords + 0.5) / self.image_size)
        out = torch.zeros_like(pe)
        out[labels == -1] = self.not_a_point_embed.weight[0]
        for lab in range(4):
            sel = labels == lab
            out[sel] = pe[sel] + self.point_embeddings[lab].weight[0]
        return out

    def dense(self, masks, batch):
        if masks is None:
            return self.no_mask_embed.weight.reshape(1, -1, 1, 1).expand(
                batch, -1, self.grid, self.grid)
        return self.mask_downscaling(masks)


# ---------------------------------------------------------------------------
# mask decoder (mask_decoder.py, transformer.py)
# ---------------------------------------------------------------------------


class DecAttention(nn.Module):
    def __init__(self, dim: int, heads: int, down: int = 1):
        super().__init__()
        inner = dim // down
        self.heads = heads
        self.q_proj = nn.Linear(dim, inner)
        self.k_proj = nn.Linear(dim, inner)
        self.v_proj = nn.Linear(dim, inner)
        self.out_proj = nn.Linear(inner, dim)

    def _split(self, x):
        b, n, c = x.shape
        return x.reshape(b, n, self.heads, c // self.heads).transpose(1, 2)

    def forward(self, q, k, v):
        q, k, v = self._split(self.q_proj(q)), self._split(self.k_proj(k)), self._split(self.v_proj(v))
        attn = torch.softmax(q @ k.permute(0, 1, 3, 2) / math.sqrt(q.shape[-1]), dim=-1)
        out = (attn @ v).transpose(1, 2)
        return self.out_proj(out.reshape(out.shape[0], out.shape[1], -1))


class TwoWayBlock(nn.Module):
    def __init__(self, dim, heads, mlp_dim, down, skip_first_layer_pe):
        super().__init__()
        self.self_attn = DecAttention(dim, heads)
        self.norm1 = nn.LayerNorm(dim)
        self.cross_attn_token_to_image = DecAttention(dim, heads, down)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = MLPBlock(dim, mlp_dim, act=F.relu)
        self.norm3 = nn.LayerNorm(dim)
        self.norm4 = nn.LayerNorm(dim)
        self.cross_attn_image_to_token = DecAttention(dim, heads, down)
        self.skip_first_layer_pe = skip_first_layer_pe

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class Transformer(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        d, down = c["prompt_embed_dim"], 2
        self.layers = nn.ModuleList(
            TwoWayBlock(d, c["transformer_num_heads"], c["transformer_mlp_dim"], down, i == 0)
            for i in range(c["transformer_depth"]))
        self.final_attn_token_to_image = DecAttention(d, c["transformer_num_heads"], down)
        self.norm_final_attn = nn.LayerNorm(d)

    def forward(self, image, image_pe, points):
        keys = image.flatten(2).permute(0, 2, 1)
        key_pe = image_pe.flatten(2).permute(0, 2, 1)
        queries = points
        for layer in self.layers:
            queries, keys = layer(queries, keys, points, key_pe)
        q, k = queries + points, keys + key_pe
        queries = self.norm_final_attn(queries + self.final_attn_token_to_image(q, k, keys))
        return queries, keys


class MLP(nn.Module):
    def __init__(self, i, h, o, n):
        super().__init__()
        dims = [i] + [h] * (n - 1) + [o]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims, dims[1:]))

    def forward(self, x):
        for j, layer in enumerate(self.layers):
            x = layer(x) if j == len(self.layers) - 1 else F.relu(layer(x))
        return x


class MaskDecoder(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        d = c["prompt_embed_dim"]
        nt = c["num_multimask_outputs"] + 1
        self.transformer = Transformer(c)
        self.iou_token = nn.Embedding(1, d)
        self.mask_tokens = nn.Embedding(nt, d)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(d, d // 4, 2, stride=2), LayerNorm2d(d // 4), nn.GELU(),
            nn.ConvTranspose2d(d // 4, d // 8, 2, stride=2), nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList(MLP(d, d, d // 8, 3) for _ in range(nt))
        self.iou_prediction_head = MLP(d, c["iou_head_hidden_dim"], nt, c["iou_head_depth"])

    def forward(self, image, image_pe, sparse, dense):
        """One image (1, C, H, W) against B prompt sets: (mask 0 logits
        (B, 1, 4H, 4W), its IoU (B, 1)), multimask_output=False."""
        b = sparse.shape[0]
        out_tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight], dim=0)
        tokens = torch.cat([out_tokens[None].expand(b, -1, -1), sparse], dim=1)
        src = image.expand(b, -1, -1, -1) + dense
        c, h, w = src.shape[1:]
        hs, src = self.transformer(src, image_pe.expand(b, -1, -1, -1), tokens)
        nt = self.mask_tokens.weight.shape[0]
        up = self.output_upscaling(src.transpose(1, 2).reshape(b, c, h, w))
        hyper = torch.stack([m(hs[:, 1 + i]) for i, m in enumerate(self.output_hypernetworks_mlps)],
                            dim=1)
        bu, cu, hu, wu = up.shape
        masks = (hyper @ up.reshape(bu, cu, hu * wu)).reshape(b, nt, hu, wu)
        iou = self.iou_prediction_head(hs[:, 0])
        return masks[:, :1], iou[:, :1]


class Sam(nn.Module):
    """The three modules under the published names (without the image
    encoder where ``encoder`` is false: the decoding half)."""

    def __init__(self, c: dict, encoder: bool = True):
        super().__init__()
        self.cfg = c
        if encoder:
            self.image_encoder = ImageEncoder(c)
        self.prompt_encoder = PromptEncoder(c)
        self.mask_decoder = MaskDecoder(c)

    def encode(self, imgs_u8: torch.Tensor, input_hw: Tuple[int, int], bits=None):
        """(B, 3, h, w) uint8 images resized longest side -> embeddings:
        normalise, pad bottom right to the square input, encode."""
        mean = torch.tensor(self.cfg["pixel_mean"], device=imgs_u8.device).view(1, -1, 1, 1)
        std = torch.tensor(self.cfg["pixel_std"], device=imgs_u8.device).view(1, -1, 1, 1)
        x = (imgs_u8.float() - mean) / std
        s = self.cfg["image_size"]
        x = F.pad(x, (0, s - input_hw[1], 0, s - input_hw[0]))
        return self.image_encoder(x, bits)

    def decode(self, image, coords, labels, mask_input=None):
        pe = self.prompt_encoder
        sparse = pe.sparse(coords, labels)
        return self.mask_decoder(image, pe.dense_pe(), sparse, pe.dense(mask_input, len(coords)))
