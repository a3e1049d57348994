"""Seeded wrist X-ray-like images and their 17 bone masks, drawn on the
device in a few large calls.

The drawing follows the program's synthetic dataset
(``cli/make_synthetic_dataset.py``: a noisy background, a blurred
soft-tissue ellipse, 17 bright blurred bones at a frontal left-wrist layout
with jittered size, position and rotation, sensor noise), written with
tensor operations in place of OpenCV so that it runs where OpenCV is not
installed; the bone outlines are jittered ellipses rather than jittered
polygons.  Every image of a call has the same size; the seed changes only
what is drawn.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# (cy, cx, ry, rx) fractions of the image size, the program's layout table
LAYOUT = {
    "Radius": (0.86, 0.38, 0.13, 0.07),
    "Ulna": (0.86, 0.62, 0.13, 0.06),
    "Epiphyse Radius": (0.68, 0.38, 0.045, 0.075),
    "Epiphyse Ulna": (0.68, 0.62, 0.04, 0.055),
    "Os lunatum": (0.585, 0.47, 0.035, 0.05),
    "Os scaphoideum": (0.575, 0.30, 0.04, 0.055),
    "Os triquetrum": (0.585, 0.64, 0.035, 0.045),
    "Os pisiforme": (0.60, 0.76, 0.025, 0.03),
    "Os trapezium": (0.50, 0.22, 0.035, 0.045),
    "Os trapezoideum": (0.495, 0.35, 0.03, 0.04),
    "Os capitatum": (0.49, 0.49, 0.045, 0.05),
    "Os hamatum": (0.495, 0.65, 0.04, 0.05),
    "Ossa metacarpalia I": (0.38, 0.14, 0.075, 0.04),
    "Ossa metacarpalia II": (0.33, 0.32, 0.10, 0.04),
    "Ossa metacarpalia III": (0.31, 0.48, 0.105, 0.04),
    "Ossa metacarpalia IV": (0.325, 0.63, 0.10, 0.038),
    "Ossa metacarpalia V": (0.36, 0.78, 0.085, 0.035),
}
#: class order: the labels sorted, as the dataset's label mapping has them
CLASSES = tuple(sorted(LAYOUT))


def _blur(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of (N, H, W), reflected borders."""
    r = max(1, int(math.ceil(3 * sigma)))
    t = torch.arange(-r, r + 1, dtype=torch.float32, device=x.device)
    k = torch.exp(-0.5 * (t / sigma) ** 2)
    k = k / k.sum()
    n, h, w = x.shape
    y = F.pad(x[:, None], (r, r, 0, 0), mode="reflect")
    y = F.conv2d(y, k.view(1, 1, 1, -1))
    y = F.pad(y, (0, 0, r, r), mode="reflect")
    return F.conv2d(y, k.view(1, 1, -1, 1))[:, 0]


def _bones(gen: torch.Generator, n: int, h: int, w: int, device) -> torch.Tensor:
    """(n, 17, h, w) bool bone masks, class order :data:`CLASSES`."""
    lay = torch.tensor([LAYOUT[c] for c in CLASSES], device=device)       # (17, 4)
    u = torch.rand((n, len(CLASSES), 8), generator=gen, device=device)
    cy = (lay[:, 0] + 0.02 * (u[..., 0] - 0.5)) * h
    cx = (lay[:, 1] + 0.02 * (u[..., 1] - 0.5)) * w
    ry = lay[:, 2] * h * (0.85 + 0.3 * u[..., 2])
    rx = lay[:, 3] * w * (0.85 + 0.3 * u[..., 3])
    rot = 0.24 * (u[..., 4] - 0.5)
    ph1, ph2 = 2 * math.pi * u[..., 5], 2 * math.pi * u[..., 6]
    ys = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    out = torch.empty((n, len(CLASSES), h, w), dtype=torch.bool, device=device)
    for i in range(len(CLASSES)):
        def p(t):
            return t[:, i, None, None]
        dy, dx = ys - p(cy), xs - p(cx)
        cr, sr = torch.cos(p(rot)), torch.sin(p(rot))
        a = (dx * cr + dy * sr) / p(rx)
        b = (-dx * sr + dy * cr) / p(ry)
        th = torch.atan2(b, a)
        rj = 1 + 0.06 * torch.sin(3 * th + p(ph1)) + 0.04 * torch.sin(5 * th + p(ph2))
        out[:, i] = a * a + b * b <= rj * rj
    return out


def xrays(seed: int, n: int, hw, device, with_masks: bool = False):
    """``n`` grayscale images (n, H, W) uint8 on ``device`` and, with
    ``with_masks``, their (n, 17, H, W) uint8 bone masks."""
    h, w = hw
    gen = torch.Generator(device=device).manual_seed(seed)
    bones = _bones(gen, n, h, w, device)
    scale = h / 384
    img = 35 + 8 * torch.randn((n, h, w), generator=gen, device=device)
    ys = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    tissue = (((ys - 0.55 * h) / (0.5 * h)) ** 2 + ((xs - 0.5 * w) / (0.42 * w)) ** 2 <= 1)
    img = img + 45 * _blur(tissue.float().expand(1, h, w), 9 * scale)
    gain = 55 + 35 * torch.rand((n, len(CLASSES), 1, 1), generator=gen, device=device)
    drawn = _blur((bones.float() * gain).sum(1), 1.5 * scale)
    img = img + drawn + 4 * torch.randn((n, h, w), generator=gen, device=device)
    img = img.round().clamp(0, 255).to(torch.uint8)
    if with_masks:
        return img, bones.to(torch.uint8)
    return img
