"""Random affine augmentation (JAX ``train/augment.py``, reference
unet_training/forward_func.py:37-42).

θ = I + N(0, 1)·strength per sample; the warp reproduces torch
``F.affine_grid``/``F.grid_sample`` with ``align_corners=False``, bilinear
for images, nearest for label masks, zero padding.  Two formulations, as in
the JAX package: the 4-tap gather (``grid_sample``) and the gather-free one
(``grid_sample_matmul``: two contractions against hat or one-hot weights).
Plain PyTorch ops: the JAX package's warp is XLA, not a Pallas kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch

METHODS = ("gather", "matmul")


def affine_grid(theta: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """theta: (N, 2, 3) -> normalised sampling grid (N, H, W, 2) in xy order
    (torch ``F.affine_grid``, align_corners=False).  Elementwise products and
    sums, each rounded once, and a product by 2 / w where the JAX package
    divides (PyTorch divides by a scalar on the card as a product by its
    reciprocal), so the card and the CPU make the same grid bit for bit: a
    sample moved by ulps moves an image's sharp edges by 1e-4 of its values."""
    h, w = hw
    x = (torch.arange(w, dtype=torch.float32, device=theta.device) + 0.5) * (2.0 / w) - 1
    y = (torch.arange(h, dtype=torch.float32, device=theta.device) + 0.5) * (2.0 / h) - 1
    t = theta.float()[:, :, :, None, None]                          # (N, 2, 3, 1, 1)
    grid = t[:, :, 0] * x[None, :] + t[:, :, 1] * y[:, None] + t[:, :, 2]
    return grid.permute(0, 2, 3, 1)                                 # (N, H, W, 2)


def _pixel_coords(grid: torch.Tensor, h: int, w: int):
    gx = (grid[..., 0] + 1) * w / 2 - 0.5
    gy = (grid[..., 1] + 1) * h / 2 - 0.5
    return gx, gy


def grid_sample(x: torch.Tensor, grid: torch.Tensor, mode: str = "bilinear") -> torch.Tensor:
    """x: (N, C, H, W); grid: (N, H', W', 2) normalised xy.  Zero padding,
    align_corners=False (torch ``F.grid_sample`` semantics; nearest rounds
    half to even).  Taps are fetched along the linearised spatial axis."""
    n, c, h, w = x.shape
    oh, ow = grid.shape[1:3]
    gx, gy = _pixel_coords(grid, h, w)
    flat = x.reshape(n, c, h * w)

    def gather(yi, xi):
        """(N, H', W') integer taps -> (N, C, H', W'); zero outside bounds."""
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        lin = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        vals = torch.take_along_dim(flat, lin.reshape(n, 1, oh * ow).expand(n, c, oh * ow), 2)
        return vals.reshape(n, c, oh, ow) * valid[:, None].to(x.dtype)

    if mode == "nearest":
        return gather(torch.round(gy).long(), torch.round(gx).long())
    if mode != "bilinear":
        raise ValueError(f"unknown mode {mode!r}")
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    fx = (gx - x0)[:, None]
    fy = (gy - y0)[:, None]
    x0i = x0.long()
    y0i = y0.long()
    v00 = gather(y0i, x0i)
    v01 = gather(y0i, x0i + 1)
    v10 = gather(y0i + 1, x0i)
    v11 = gather(y0i + 1, x0i + 1)
    return (v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx
            + v10 * fy * (1 - fx) + v11 * fy * fx)


def grid_sample_matmul(x: torch.Tensor, grid: torch.Tensor, mode: str = "bilinear",
                       row_block: int = 16) -> torch.Tensor:
    """``grid_sample`` with no gather: the weight of input pixel (y, x) at
    sample (gy, gx) is ``hat(gy - y) * hat(gx - x)``, ``hat(t) = max(0, 1 - |t|)``
    (nearest: one-hot weights, which copy values exactly), so the warp is two
    contractions, ``out[n,c,i,j] = sum_y wy * sum_x wx * x[n,c,y,x]``.
    Out-of-range samples get all-zero weight rows (``padding_mode='zeros'``).
    Output rows go ``row_block`` at a time to bound the weights' footprint."""
    n, c, h, w = x.shape
    oh, ow = grid.shape[1:3]
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f"unknown mode {mode!r}")
    gx, gy = _pixel_coords(grid, h, w)
    ys = torch.arange(h, dtype=x.dtype, device=x.device)
    xs = torch.arange(w, dtype=x.dtype, device=x.device)
    out = []
    for r0 in range(0, oh, row_block):
        gyk, gxk = gy[:, r0:r0 + row_block], gx[:, r0:r0 + row_block]      # (N, R, OW)
        if mode == "bilinear":
            wy = (1.0 - (gyk[..., None] - ys).abs()).clamp_min(0.0)
            wx = (1.0 - (gxk[..., None] - xs).abs()).clamp_min(0.0)
        else:
            wy = (torch.round(gyk)[..., None] == ys).to(x.dtype)
            wx = (torch.round(gxk)[..., None] == xs).to(x.dtype)
        s = torch.einsum("nrjy,ncyx->ncrjx", wy, x)
        out.append(torch.einsum("ncrjx,nrjx->ncrj", s, wx))
    return torch.cat(out, dim=2)


def warp_affine(x: torch.Tensor, y: torch.Tensor, theta: torch.Tensor,
                method: str = "gather"):
    """Warp images (bilinear) and label masks (nearest) by per-sample affines.

    ``method``: ``"gather"`` (the 4-tap formulation) or ``"matmul"``
    (``grid_sample_matmul``; the label channels, which must be binary, are
    bit-packed into one fp32 plane when there are at most 23, which the
    one-hot products copy exactly: so it needs full fp32 products, and
    refuses to run with TF32 matmuls enabled)."""
    if method not in METHODS:
        raise ValueError(f"Unknown warp method {method!r}: use 'matmul' or 'gather'")
    grid = affine_grid(theta, x.shape[-2:])
    if method == "gather":
        return grid_sample(x, grid, "bilinear"), grid_sample(y, grid, "nearest")
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise ValueError("the matmul warp copies labels through fp32 products: "
                         "TF32 matmuls (torch.backends.cuda.matmul.allow_tf32) would round them")
    xw = grid_sample_matmul(x, grid, "bilinear")
    nc = y.shape[1]
    if nc <= 23:  # packed values < 2^23 stay exact through fp32 products
        weights = (2.0 ** torch.arange(nc, dtype=torch.float32, device=y.device)
                   ).reshape(1, nc, 1, 1)
        packed = (y.float() * weights).sum(dim=1, keepdim=True)
        pw = grid_sample_matmul(packed, grid, "nearest").to(torch.int32)
        shifts = torch.arange(nc, dtype=torch.int32, device=y.device).reshape(1, nc, 1, 1)
        yw = ((pw >> shifts) & 1).to(y.dtype)
    else:
        yw = grid_sample_matmul(y, grid, "nearest")
    return xw, yw


def random_theta(generator: torch.Generator, n: int, strength: float) -> torch.Tensor:
    """(n, 2, 3) affines I + N(0, 1)·strength, drawn from ``generator``
    (on the generator's device)."""
    noise = torch.randn((n, 2, 3), generator=generator, device=generator.device)
    return torch.eye(2, 3, device=generator.device)[None] + noise * strength


def random_affine(generator: torch.Generator, x: torch.Tensor, y: torch.Tensor,
                  strength: float, method: str = "gather"):
    """The reference's augmentation: one random affine per sample, drawn from
    ``generator`` (a CPU generator gives the card and the CPU the same θ) and
    moved to ``x``'s device; bilinear on images, nearest on masks
    (forward_func.py:37-42)."""
    theta = random_theta(generator, x.shape[0], strength)
    return warp_affine(x, y, theta.to(x.device), method=method)
