"""Plain U-Net and its training step in float32, as the paper trains it:
the classic 4-down/4-up U-Net of milesial/Pytorch-UNet (conv3x3 without
bias, InstanceNorm2d(affine), LeakyReLU 0.01, transposed-conv upsampling,
the [skip, up] concat), the per-class pos-weighted BCE with logits, the
random affine augmentation through ``F.affine_grid``/``F.grid_sample``, and
AdamW written out.  Parameter names are the published ones, so the
benchmark's seeded state dict loads here and into the program alike.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class DoubleConv(nn.Module):
    def __init__(self, cin, cout, mid=None):
        super().__init__()
        mid = mid or cout
        self.double_conv = nn.Sequential(
            nn.Conv2d(cin, mid, 3, padding=1, bias=False), nn.InstanceNorm2d(mid, affine=True),
            nn.LeakyReLU(0.01),
            nn.Conv2d(mid, cout, 3, padding=1, bias=False), nn.InstanceNorm2d(cout, affine=True),
            nn.LeakyReLU(0.01))

    def forward(self, x):
        return self.double_conv(x)


class Down(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.maxpool_conv = nn.Sequential(nn.MaxPool2d(2), DoubleConv(cin, cout))

    def forward(self, x):
        return self.maxpool_conv(x)


class Up(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.up = nn.ConvTranspose2d(cin, cin // 2, 2, stride=2)
        self.conv = DoubleConv(cin, cout)

    def forward(self, x1, x2):
        x1 = self.up(x1)
        dy, dx = x2.shape[2] - x1.shape[2], x2.shape[3] - x1.shape[3]
        x1 = F.pad(x1, [dx // 2, dx - dx // 2, dy // 2, dy - dy // 2])
        return self.conv(torch.cat([x2, x1], dim=1))


class OutConv(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 1)

    def forward(self, x):
        return self.conv(x)


class UNet(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        bc = c["base_channels"]
        self.inc = DoubleConv(c["n_channels"], bc)
        self.down1 = Down(bc, bc * 2)
        self.down2 = Down(bc * 2, bc * 4)
        self.down3 = Down(bc * 4, bc * 8)
        self.down4 = Down(bc * 8, bc * 16)
        self.up1 = Up(bc * 16, bc * 8)
        self.up2 = Up(bc * 8, bc * 4)
        self.up3 = Up(bc * 4, bc * 2)
        self.up4 = Up(bc * 2, c["n_last_channel"])
        self.outc = OutConv(c["n_last_channel"], c["n_classes"])

    def forward(self, x):
        x1 = self.inc(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        x5 = self.down4(x4)
        x = self.up1(x5, x4)
        x = self.up2(x, x3)
        x = self.up3(x, x2)
        return self.outc(self.up4(x, x1))


def probabilities(unet: UNet, imgs_u8: torch.Tensor, mean: float, std: float) -> torch.Tensor:
    """(B, H, W) uint8 images on the U-Net grid -> (B, C, H, W) sigmoid
    probabilities of the normalised [0, 1] image."""
    x = imgs_u8.float()[:, None] / 255.0
    return torch.sigmoid(unet((x - mean) / std))


# ---------------------------------------------------------------------------
# training (the paper's training_on_pseudo_labels.py, shuffle sampling)
# ---------------------------------------------------------------------------


def epoch_batches(seed: int, n: int, batch: int, epoch: int) -> List[np.ndarray]:
    """The epoch's batches: a permutation keyed on (seed, epoch), drop_last."""
    order = np.random.default_rng((seed, epoch)).permutation(n)
    order = order[: (n // batch) * batch]
    return [order[i:i + batch] for i in range(0, len(order), batch)]


def epoch_thetas(seed: int, epoch: int, sizes: List[int], strength: float) -> List[torch.Tensor]:
    """One (B, 2, 3) affine I + N(0, 1) * strength per step, drawn in step
    order from a CPU generator keyed on (seed, epoch)."""
    gen = torch.Generator().manual_seed(seed * 100003 + epoch)
    return [torch.eye(2, 3)[None] + torch.randn((b, 2, 3), generator=gen) * strength
            for b in sizes]


def augment(x, y, theta, mean, std):
    """Normalise, then warp images (bilinear) and labels (nearest) by theta."""
    x = (x - mean) / std
    grid = F.affine_grid(theta.to(x.device), list(x.shape), align_corners=False)
    return (F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros", align_corners=False),
            F.grid_sample(y, grid, mode="nearest", padding_mode="zeros", align_corners=False))


def bce_loss(logits, y, pos_weight):
    sp = F.softplus(-logits)
    return (pos_weight * y * sp + (1 - y) * (logits + sp)).mean()


def cosine_lr(epoch: int, lr: float, epochs: int) -> float:
    eta_min = lr / 100
    return eta_min + (lr - eta_min) * (1 + math.cos(math.pi * epoch / epochs)) / 2


class AdamW:
    """AdamW (Loshchilov & Hutter) with torch's defaults of bias
    correction: decay, then the moment update."""

    def __init__(self, params: List[torch.Tensor], betas=(0.9, 0.999), eps=1e-8, wd=0.0):
        self.params = params
        self.b1, self.b2 = betas
        self.eps, self.wd = eps, wd
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor], lr: float) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            p.mul_(1 - lr * self.wd)
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(lr * (m / c1) / ((v / c2).sqrt() + self.eps))


def train_steps(unet: UNet, x_all: torch.Tensor, y_all: torch.Tensor, *, seed: int,
                steps: int, batch: int, lr: float, epochs: int, strength: float,
                weight_decay: float, mean: float, std: float,
                pos_weight: torch.Tensor, epoch: int = 0,
                start: Optional[dict] = None) -> Dict[str, list]:
    """The first ``steps`` steps of ``epoch`` from the module's weights:
    {"loss": [...], "grad": {name: the first step's gradient},
    "params": {name: the parameter after the last step}}.  ``start``:
    AdamW's state at the epoch's start ({"exp_avg": {name: ...},
    "exp_avg_sq": {name: ...}, "steps": n}); None, a fresh AdamW."""
    n = x_all.shape[0]
    batches = epoch_batches(seed, n, batch, epoch)[:steps]
    thetas = epoch_thetas(seed, epoch, [len(b) for b in batches], strength)
    names, params = zip(*unet.named_parameters())
    opt = AdamW(list(params), wd=weight_decay)
    if start is not None:
        opt.m = [start["exp_avg"][k].clone() for k in names]
        opt.v = [start["exp_avg_sq"][k].clone() for k in names]
        opt.t = int(start["steps"])
    out = {"loss": [], "grad": None}
    step_lr = cosine_lr(epoch, lr, epochs)
    for idx, theta in zip(batches, thetas):
        ii = torch.from_numpy(idx).to(x_all.device)
        x, y = augment(x_all[ii].float(), y_all[ii].float(), theta, mean, std)
        loss = bce_loss(unet(x), y, pos_weight)
        grads = torch.autograd.grad(loss, params)
        if out["grad"] is None:
            out["grad"] = {n: g.detach().clone() for n, g in zip(names, grads)}
        out["loss"].append(float(loss.detach()))
        opt.step(grads, step_lr)
    out["params"] = {n: p.detach().clone() for n, p in zip(names, params)}
    return out
