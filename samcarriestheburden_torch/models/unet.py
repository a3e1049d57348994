"""Classic 4-down/4-up U-Net (JAX ``models/unet.py``, reference
custom_arcitecture/classic_u_net.py, milesial lineage).

Per block: conv3x3 (no bias) -> InstanceNorm2d(affine) -> LeakyReLU(0.01),
twice.  Down: 2x2 max-pool + double conv.  Up: transposed conv (or the
align-corners bilinear upsample) + pad-to-match + the ``[x2, x1]`` skip
concat.  The submodules carry the reference's names, so a reference state
dict (``inc.double_conv.0.weight``, ``down1.maxpool_conv.1.double_conv.0
.weight``, ``up1.up.weight``, ``outc.conv.weight``, ...) loads with
``load_state_dict``.

Precision: fp32 tensors throughout; the convolutions are cuDNN's, so on
the card they run in TF32 under PyTorch's default
(``torch.backends.cudnn.allow_tf32``, which this module leaves as it finds
it), as XLA runs fp32 convolutions at reduced precision on an accelerator.
On the CPU they are plain fp32.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from samcarriestheburden_torch.config import GRAZ_IMG_MEAN, GRAZ_IMG_STD, UNetConfig
from samcarriestheburden_torch.device import resolve_device
from samcarriestheburden_torch.models.common import random_init_


class DoubleConv(nn.Module):
    """(conv3x3 -> InstanceNorm -> LeakyReLU) x 2 (reference classic_u_net.py:10-27)."""

    def __init__(self, in_ch: int, out_ch: int, mid_ch: int = None):
        super().__init__()
        mid_ch = mid_ch or out_ch
        self.double_conv = nn.Sequential(
            nn.Conv2d(in_ch, mid_ch, 3, padding=1, bias=False),
            nn.InstanceNorm2d(mid_ch, affine=True, eps=1e-5),
            nn.LeakyReLU(0.01),
            nn.Conv2d(mid_ch, out_ch, 3, padding=1, bias=False),
            nn.InstanceNorm2d(out_ch, affine=True, eps=1e-5),
            nn.LeakyReLU(0.01))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.double_conv(x)


class Down(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.maxpool_conv = nn.Sequential(nn.MaxPool2d(2), DoubleConv(in_ch, out_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.maxpool_conv(x)


class Up(nn.Module):
    """Upscale x1, pad it to x2's spatial size, concat ``[x2, x1]``, double
    conv (reference classic_u_net.py:41-69)."""

    def __init__(self, in_ch: int, out_ch: int, bilinear: bool):
        super().__init__()
        self.bilinear = bilinear
        if bilinear:
            self.conv = DoubleConv(in_ch, out_ch, in_ch // 2)
        else:
            self.up = nn.ConvTranspose2d(in_ch, in_ch // 2, 2, stride=2)
            self.conv = DoubleConv(in_ch, out_ch)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        if self.bilinear:
            x1 = F.interpolate(x1, scale_factor=2, mode="bilinear", align_corners=True)
        else:
            x1 = self.up(x1)
        dh = x2.shape[-2] - x1.shape[-2]
        dw = x2.shape[-1] - x1.shape[-1]
        x1 = F.pad(x1, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
        return self.conv(torch.cat([x2, x1], dim=1))


class OutConv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class UNet(nn.Module):
    def __init__(self, cfg: UNetConfig = UNetConfig()):
        super().__init__()
        self.cfg = cfg
        bc = cfg.base_channels
        factor = 2 if cfg.bilinear else 1
        self.inc = DoubleConv(cfg.n_channels, bc)
        self.down1 = Down(bc, bc * 2)
        self.down2 = Down(bc * 2, bc * 4)
        self.down3 = Down(bc * 4, bc * 8)
        self.down4 = Down(bc * 8, bc * 16 // factor)
        self.up1 = Up(bc * 16, bc * 8 // factor, cfg.bilinear)
        self.up2 = Up(bc * 8, bc * 4 // factor, cfg.bilinear)
        self.up3 = Up(bc * 4, bc * 2 // factor, cfg.bilinear)
        self.up4 = Up(bc * 2, cfg.n_last_channel, cfg.bilinear)
        self.outc = OutConv(cfg.n_last_channel, cfg.n_classes)

    @property
    def device(self) -> torch.device:
        return self.outc.conv.weight.device

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, n_channels, H, W) -> (B, n_classes, H, W) logits."""
        x1 = self.inc(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        x5 = self.down4(x4)
        y = self.up1(x5, x4)
        y = self.up2(y, x3)
        y = self.up3(y, x2)
        y = self.up4(y, x1)
        return self.outc(y)


def build_unet(cfg: UNetConfig = UNetConfig(), *, device=None, seed: Optional[int] = None,
               state_dict: Optional[Dict[str, torch.Tensor]] = None) -> UNet:
    """A :class:`UNet` on ``device`` (None: the card; raises without one),
    in eval mode, with ``state_dict``'s weights or, given ``seed``, random
    weights drawn from a ``torch.Generator`` on that device (torch's default
    uniform bound for the convolutions, unit/zero instance norms)."""
    dev = resolve_device(device)
    if (seed is None) == (state_dict is None):
        raise ValueError("pass exactly one of seed and state_dict")
    with torch.device(dev):
        model = UNet(cfg)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    else:
        random_init_(model, torch.Generator(device=dev).manual_seed(seed))
    return model.eval()


@torch.no_grad()
def unet_probabilities(model: UNet, imgs: torch.Tensor) -> torch.Tensor:
    """(B, H, W) uint8 grayscale images on the U-Net grid -> (B, n_classes,
    H, W) fp32 probabilities on the model's device: scaled to [0, 1],
    normalised by the GrazPedWri statistics, sigmoid of the logits (JAX
    ``cli/save_segmentations.py`` and ``save_refined_segmentations.py``)."""
    x = imgs.to(model.device).float()[:, None] / 255.0
    return torch.sigmoid(model((x - GRAZ_IMG_MEAN) / GRAZ_IMG_STD))
