"""Shared NN blocks (reference segment_anything/modeling/common.py).

PyTorch idiom: ``nn.Module``s with the reference's parameter names, so the
reference state dicts load with ``load_state_dict``; linear weights are
(out, in) and images NCHW, as in the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, torch ``nn.GELU()``'s default, which every SAM module uses."""
    return F.gelu(x, approximate="none")


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm over the last axis with fp32 statistics, output in x's dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``layer(x)`` in x's dtype: the weights are cast to it at use, as the
    JAX package's ``linear`` casts its parameters (fp32 weights serve a bf16
    decode without a second copy).  In fp32 this is ``layer(x)``."""
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), bias)


def norm(layer: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """``layer(x)``; below fp32, :func:`layer_norm` with fp32 statistics and
    the affine parameters rounded to x's dtype (JAX ``layer_norm`` on cast
    parameters)."""
    if x.dtype == torch.float32:
        return layer(x)
    return layer_norm(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype), layer.eps)


class LayerNorm2d(nn.Module):
    """Per-pixel LayerNorm over the channel axis of an NCHW tensor
    (reference modeling/common.py:31-43)."""

    def __init__(self, num_channels: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x.movedim(1, -1), self.weight, self.bias,
                          self.eps).movedim(-1, 1)


class MLPBlock(nn.Module):
    """lin1 -> act -> lin2 (reference modeling/common.py:13-26)."""

    def __init__(self, embedding_dim: int, mlp_dim: int, act=gelu):
        super().__init__()
        self.lin1 = nn.Linear(embedding_dim, mlp_dim)
        self.lin2 = nn.Linear(mlp_dim, embedding_dim)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(self.lin2, self.act(linear(self.lin1, x)))


class MLP(nn.Module):
    """The decoder's MLP heads (reference mask_decoder.py:154-176)."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int, sigmoid_output: bool = False):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(
            nn.Linear(dims[i], dims[i + 1]) for i in range(num_layers))
        self.sigmoid_output = sigmoid_output

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = linear(layer, x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return torch.sigmoid(x) if self.sigmoid_output else x


@torch.no_grad()
def random_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter from ``generator``: torch's default uniform
    bound 1/sqrt(fan_in) for linear and conv layers, unit/zero LayerNorms,
    N(0, 1) embeddings.  Used for seeded random weights at full width
    (checkpoints load with ``load_state_dict`` instead)."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            fan_in = m.weight[0].numel()
            bound = fan_in ** -0.5
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, (nn.LayerNorm, LayerNorm2d)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 1.0, generator=generator)
    return module
