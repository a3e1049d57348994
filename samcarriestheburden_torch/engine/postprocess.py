"""Decoder logits straight onto a fixed output grid (JAX ``engine/postprocess.py``).

The reference upscales the decoder's 256^2 logits to 1024^2 (bilinear),
crops the padding to ``input_size``, resizes bilinearly to the per-image
``original_size``, thresholds, and the refinement engine then resizes
nearest-exact to the U-Net grid (sam.py:133-162, seg_refinement.py:111).
:func:`postprocess_to_grid` evaluates that chain (nearest-exact o bilinear o
crop o bilinear) for each pixel of the output grid directly: the chain is
separable, so it is one (out, 256) resampling matrix per axis and one
product, and the per-image sizes are tensors, never shapes.  A batch of N
images takes (N, 2) sizes: one pair of matrices per image, one batched
product (what the JAX package gets by vmapping it).
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import torch


@contextlib.contextmanager
def _full_fp32_matmul():
    """Float32 products in full float32 (no TF32) inside the block, whatever
    the global setting, restored after."""
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved)


def _src_coord(dst: torch.Tensor, scale) -> torch.Tensor:
    """torch ``align_corners=False`` source coordinate, clamped at 0 as
    torch's area_pixel_compute_source_index does."""
    return ((dst + 0.5) * scale - 0.5).clamp(min=0.0)


def _low_res_taps(idx: torch.Tensor, s: float, lr: int):
    """Integer positions of the img_enc_size frame -> (tap0, tap1, frac) on
    the low-res grid."""
    c = _src_coord(idx.float(), s)
    c0 = c.floor()
    c0i = c0.int().clamp(0, lr - 1)
    return c0i, (c0i + 1).clamp(0, lr - 1), c - c0


def _axis_matrix(t0, t1, f_outer, s: float, lr: int) -> torch.Tensor:
    """(..., n_out, lr) outer-bilinear o inner-bilinear resampling matrix."""
    lanes = torch.arange(lr, device=t0.device)

    def inner(ti):
        a, b, f = _low_res_taps(ti, s, lr)
        return ((1 - f)[..., None] * (lanes == a[..., None])
                + f[..., None] * (lanes == b[..., None]))

    return ((1 - f_outer)[..., None] * inner(t0) + f_outer[..., None] * inner(t1)).float()


def _grid_matrices(input_size: torch.Tensor, original_size: torch.Tensor,
                   out_hw: Tuple[int, int], lr: int, img_enc_size: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (..., out_h, lr) row and (..., out_w, lr) column resampling
    matrices of one image per (..., 2) input and original size (H, W)."""
    out_h, out_w = out_hw
    dev = input_size.device
    hi, wi = input_size[..., 0, None].float(), input_size[..., 1, None].float()
    ho, wo = original_size[..., 0, None].float(), original_size[..., 1, None].float()

    # stage 3 (nearest-exact onto the output grid): original-frame indices
    oy = torch.minimum(((torch.arange(out_h, device=dev) + 0.5) * ho / out_h).floor(), ho - 1)
    ox = torch.minimum(((torch.arange(out_w, device=dev) + 0.5) * wo / out_w).floor(), wo - 1)
    oy, ox = oy.clamp(min=0), ox.clamp(min=0)

    # stage 2 (bilinear original <- input crop): input-frame taps and weights
    sy = _src_coord(oy, hi / ho)
    sx = _src_coord(ox, wi / wo)
    y0, x0 = sy.floor(), sx.floor()
    hi_max, wi_max = input_size[..., 0, None] - 1, input_size[..., 1, None] - 1
    y0i = torch.minimum(y0.int(), hi_max).clamp(min=0)
    y1i = torch.minimum(y0i + 1, hi_max).clamp(min=0)
    x0i = torch.minimum(x0.int(), wi_max).clamp(min=0)
    x1i = torch.minimum(x0i + 1, wi_max).clamp(min=0)

    # stage 1 (bilinear img_enc_size <- lr) at integer positions of the
    # img_enc_size frame (the crop is the identity on indices)
    s = lr / img_enc_size
    return (_axis_matrix(y0i, y1i, sy - y0, s, lr),
            _axis_matrix(x0i, x1i, sx - x0, s, lr))


def postprocess_to_grid(low_res: torch.Tensor, input_size, original_size,
                        out_hw: Tuple[int, int], img_enc_size: int = 1024,
                        threshold_only: bool = True,
                        mask_threshold: float = 0.0) -> torch.Tensor:
    """The reference postprocess chain evaluated on a fixed (out_h, out_w) grid.

    low_res: (..., lr, lr) logits of one image with (2,) (H, W) sizes, or
    (N, ..., lr, lr) of N images with (N, 2) sizes, one row per image.
    Returns (..., out_h, out_w) bool, or the float32 logits with
    ``threshold_only=False``.  The product runs in full float32: the
    thresholded masks must not move with TF32 rounding."""
    dev = low_res.device
    lr = low_res.shape[-1]
    input_size = torch.as_tensor(input_size, device=dev)
    original_size = torch.as_tensor(original_size, device=dev)
    ry, cx = _grid_matrices(input_size, original_size, tuple(out_hw), lr, img_enc_size)
    if input_size.ndim == 2:        # one matrix pair per image, broadcast over its maps
        lead = (low_res.shape[0],) + (1,) * (low_res.ndim - 3)
        ry, cx = ry.reshape(*lead, *ry.shape[-2:]), cx.reshape(*lead, *cx.shape[-2:])
    with _full_fp32_matmul():
        out = ry @ low_res.float() @ cx.transpose(-1, -2)
    if threshold_only:
        return out > mask_threshold
    return out
