"""The port's augmentation (``samcarriestheburden_torch/train/augment.py``)
against the JAX package's ``train/augment.py`` on the same θ, and against
torch's ``F.affine_grid``/``F.grid_sample``, whose semantics both reproduce."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from samcarriestheburden_torch.train import augment as taug
from samcarriestheburden_tpu.train import augment as jaug

# the tier-1 command runs six xdist workers on the machine's cores: one
# intra-op thread each, or their thread pools oversubscribe the cores
torch.set_num_threads(1)

#: fp32 sums of four weighted taps, or of two contractions, in another order
WARP_ATOL = 1e-5
#: and the sampling grid's own rounding: the JAX package divides by the
#: width where the port multiplies by its reciprocal (the same bits on the
#: card and the CPU), and sums theta's products in another order, so a
#: sample may sit a few ulps of a coordinate (< 64 px here: ulp <= 7.6e-6 px)
#: away, which changes it by at most that shift times the image's largest
#: step between neighbouring pixels
GRID_SHIFT_PX = 1e-5


def edge_atol(x):
    steps = max(np.abs(np.diff(x, axis=-1)).max(), np.abs(np.diff(x, axis=-2)).max())
    return WARP_ATOL + GRID_SHIFT_PX * steps


def _theta(rng, n, strength=0.1):
    return (np.eye(2, 3)[None] + rng.standard_normal((n, 2, 3)) * strength).astype(np.float32)


def _labels(rng, n, c, hw, p=0.6):
    return (rng.random((n, c, *hw)) > p).astype(np.float32)


def test_affine_grid_matches_jax_and_torch():
    rng = np.random.default_rng(0)
    theta = _theta(rng, 4, 0.05)
    ours = taug.affine_grid(torch.from_numpy(theta), (13, 9)).numpy()
    np.testing.assert_allclose(ours, np.asarray(jaug.affine_grid(theta, (13, 9))), atol=1e-6)
    theirs = F.affine_grid(torch.from_numpy(theta), (4, 1, 13, 9), align_corners=False)
    np.testing.assert_allclose(ours, theirs.numpy(), atol=1e-6)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_grid_sample_matches_jax(mode):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 16, 12)).astype(np.float32)
    grid = np.array(jaug.affine_grid(_theta(rng, 2), (16, 12)))
    ours = taug.grid_sample(torch.from_numpy(x), torch.from_numpy(grid), mode).numpy()
    ref = np.asarray(jaug.grid_sample(x, grid, mode))
    if mode == "nearest":
        np.testing.assert_array_equal(ours, ref)      # the same taps: a copy
    else:
        np.testing.assert_allclose(ours, ref, atol=WARP_ATOL)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_grid_sample_matches_torch(mode):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 16, 12)).astype(np.float32)
    grid = F.affine_grid(torch.from_numpy(_theta(rng, 2)), (2, 3, 16, 12), align_corners=False)
    ours = taug.grid_sample(torch.from_numpy(x), grid, mode)
    theirs = F.grid_sample(torch.from_numpy(x), grid, mode=mode, align_corners=False)
    if mode == "nearest":
        # torch computes the pixel coordinate as ((g + 1) * w - 1) / 2, the JAX
        # package (and so the port) as (g + 1) * w / 2 - 0.5: a sample that lands
        # within an ulp of a half pixel may round the other way
        assert torch.isclose(ours, theirs, atol=1e-6).float().mean() > 0.99
    else:
        torch.testing.assert_close(ours, theirs, atol=WARP_ATOL, rtol=0)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_grid_sample_matmul_matches_jax_and_the_gather(mode):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 2, 37, 29)).astype(np.float32)
    grid = np.array(jaug.affine_grid(_theta(rng, 3), (37, 29)))
    ours = taug.grid_sample_matmul(torch.from_numpy(x), torch.from_numpy(grid), mode,
                                   row_block=8).numpy()
    np.testing.assert_allclose(ours, np.asarray(jaug.grid_sample_matmul(x, grid, mode,
                                                                        row_block=8)),
                               atol=WARP_ATOL)
    gather = taug.grid_sample(torch.from_numpy(x), torch.from_numpy(grid), mode).numpy()
    np.testing.assert_allclose(ours, gather, atol=WARP_ATOL)


@pytest.mark.parametrize("method", ["gather", "matmul"])
@pytest.mark.parametrize("classes", [17, 25])
def test_warp_affine_matches_jax(method, classes):
    """Images within edge_atol, labels bit for bit: with 17 classes the matmul
    warp moves them as one bit-packed plane, with 25 (over 23 bits) channel
    by channel."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 1, 48, 40)).astype(np.float32)
    y = _labels(rng, 3, classes, (48, 40))
    theta = _theta(rng, 3, 0.08)
    xw, yw = taug.warp_affine(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(theta),
                              method=method)
    jx, jy = jaug.warp_affine(x, y, theta, method=method)
    np.testing.assert_allclose(xw.numpy(), np.asarray(jx), rtol=0, atol=edge_atol(x))
    np.testing.assert_array_equal(yw.numpy(), np.asarray(jy))
    assert yw.dtype == torch.float32 and set(np.unique(yw.numpy())) <= {0.0, 1.0}


def test_the_two_warps_move_labels_the_same():
    """The bit-packed nearest warp equals the per-channel gather exactly."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((4, 1, 48, 40)).astype(np.float32))
    y = torch.from_numpy(_labels(rng, 4, 17, (48, 40)))
    theta = torch.from_numpy(_theta(rng, 4, 0.08))
    xm, ym = taug.warp_affine(x, y, theta, method="matmul")
    xg, yg = taug.warp_affine(x, y, theta, method="gather")
    assert torch.equal(ym, yg)
    torch.testing.assert_close(xm, xg, atol=WARP_ATOL, rtol=0)
    with pytest.raises(ValueError, match="Unknown warp method"):
        taug.warp_affine(x, y, theta, method="pallas")


def test_random_affine_draws_theta_from_the_generator():
    """θ = I + N(0, 1)·strength from the given generator, one (N, 2, 3) draw a
    call, so the same seed gives the same warp."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((2, 1, 24, 16)).astype(np.float32))
    y = torch.from_numpy(_labels(rng, 2, 3, (24, 16)))
    xa, ya = taug.random_affine(torch.Generator().manual_seed(7), x, y, 0.03)
    theta = torch.eye(2, 3)[None] + torch.randn((2, 2, 3),
                                                generator=torch.Generator().manual_seed(7)) * 0.03
    assert torch.equal(taug.random_theta(torch.Generator().manual_seed(7), 2, 0.03), theta)
    xw, yw = taug.warp_affine(x, y, theta)
    assert torch.equal(xa, xw) and torch.equal(ya, yw)
    xb, _ = taug.random_affine(torch.Generator().manual_seed(8), x, y, 0.03)
    assert not torch.equal(xa, xb)
