"""Seeded weights for a module's state dict, made on the device in two
large calls (one uniform, one normal draw) and cut into the tensors.

The scheme is torch's default initialisation where it has one: linear and
convolution weights and biases uniform in +-1/sqrt(fan_in).  Norm affines
are 1 + 0.1 u and 0.1 u (u uniform in [-1, 1]), so that a dropped affine
shows; embeddings and the Fourier feature matrix N(0, 1); the ViT's
position embedding and relative-position tables N(0, 0.02), small and
nonzero as trained ones are.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

NORMS = (nn.LayerNorm, nn.InstanceNorm2d, nn.GroupNorm)


def _plan(module: nn.Module):
    """[(key, shape, kind, a, b)]: the tensor is a + b * draw, the draw
    uniform in [-1, 1] (kind 'u') or standard normal ('n')."""
    plan = []
    for mname, m in module.named_modules():
        pre = f"{mname}." if mname else ""
        own = list(m.named_parameters(recurse=False)) + list(m.named_buffers(recurse=False))
        for pname, t in own:
            key, shape = pre + pname, tuple(t.shape)
            if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
                bound = m.weight[0].numel() ** -0.5
                plan.append((key, shape, "u", 0.0, bound))
            elif isinstance(m, NORMS) or type(m).__name__ == "LayerNorm2d":
                plan.append((key, shape, "u", 1.0 if pname == "weight" else 0.0, 0.1))
            elif pname in ("pos_embed", "rel_pos_h", "rel_pos_w"):
                plan.append((key, shape, "n", 0.0, 0.02))
            else:
                plan.append((key, shape, "n", 0.0, 1.0))
    return plan


@torch.no_grad()
def seeded_state_dict(module: nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """A state dict for ``module`` (built on the meta device, say) drawn
    from ``seed`` on ``device``, float32."""
    plan = _plan(module)
    counts = {"u": 0, "n": 0}
    for _, shape, kind, _, _ in plan:
        counts[kind] += int(torch.Size(shape).numel())
    gen = torch.Generator(device=device).manual_seed(seed)
    pools = {"u": torch.rand(counts["u"], generator=gen, device=device).mul_(2).sub_(1),
             "n": torch.randn(counts["n"], generator=gen, device=device)}
    out, offset = {}, {"u": 0, "n": 0}
    for key, shape, kind, a, b in plan:
        n = int(torch.Size(shape).numel())
        t = pools[kind][offset[kind]:offset[kind] + n].view(shape)
        out[key] = t.mul_(b).add_(a)
        offset[kind] += n
    return out
