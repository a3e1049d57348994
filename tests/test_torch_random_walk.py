"""The port's random walk (``ops/random_walk.py``), opening
(``ops/seg_preprocessing.py``) and ``RndWalkSegRefiner`` against the JAX
package on the CPU, on seeded images with blob edges (a bright ellipse on a
mildly noisy background, as an X-ray's bone on soft tissue).

Tolerances: the edge weights and the stencil 1e-6 relative to their largest
value (fp32 ``exp`` and sums in two frameworks); the probabilities 1e-4
absolute at ``tol=1e-8`` (read: 1.0e-5; both solves sit 1.3e-5 to 2.6e-5
from a float64 sparse solve, fp32's reach on these systems) and ``RW_TOL``
= 1e-4 at the default ``tol=1e-3`` (read: 1.2e-5), where masks thresholded
at 0.5 are equal except at pixels whose port probability lies within
``RW_TOL`` of 0.5.  The opening is exact."""

import numpy as np
import pytest
import torch

from samcarriestheburden_torch.engine.refinement import RndWalkSegRefiner, SegEnhance
from samcarriestheburden_torch.ops import random_walk as trw
from samcarriestheburden_torch.ops import seg_preprocessing as tsp
from samcarriestheburden_tpu.engine.refinement import RndWalkSegRefiner as JaxRefiner
from samcarriestheburden_tpu.engine.refinement import SegEnhance as JaxEnhance
from samcarriestheburden_tpu.ops import random_walk as jrw
from samcarriestheburden_tpu.ops import seg_preprocessing as jsp

# the tier-1 command runs six xdist workers on the machine's cores: one
# intra-op thread each, or their thread pools oversubscribe the cores
torch.set_num_threads(1)

RW_TOL = 1e-4


def blob_image(rng, hw) -> np.ndarray:
    """(H, W) uint8: an ellipse 100 grey levels above a background of 40 + U(0, 8)."""
    yy, xx = np.mgrid[:hw[0], :hw[1]]
    inside = ((yy - hw[0] * 0.45) / (hw[0] * 0.3)) ** 2 + ((xx - hw[1] * 0.5)
                                                          / (hw[1] * 0.25)) ** 2 < 1
    return (40 + rng.uniform(0, 8, hw) + 100 * inside).astype(np.uint8)


def seeds_for(hw, k) -> np.ndarray:
    """(k, H, W) seed maps: the top rows, a square in the blob, a soft 0.7
    seed in a corner (k > 3), and the last class with no seed."""
    s = np.zeros((k,) + tuple(hw), np.float32)
    s[0, :3] = 1.0
    s[1, hw[0] // 2 - 2:hw[0] // 2 + 2, hw[1] // 2 - 2:hw[1] // 2 + 2] = 1.0
    if k > 3:
        s[2, -3:, :5] = 0.7
    return s


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_edge_weights_and_laplacian_against_jax():
    rng = np.random.default_rng(0)
    img = blob_image(rng, (31, 27))
    for sigma in (10.0, 3.0):
        wh, wv = jrw.edge_weights(img, sigma)
        th, tv = trw.edge_weights(_t(img), sigma)
        for got, want in ((th, wh), (tv, wv)):
            want = np.asarray(want)
            assert got.shape == want.shape
            assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()
        x = rng.standard_normal(img.shape).astype(np.float32)
        for lam in (1.0, 0.5):
            want = np.asarray(jrw.apply_laplacian(x, wh, wv, lam))
            got = trw.apply_laplacian(_t(x), th, tv, lam).numpy()
            assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("hw, k", [((32, 32), 3), ((48, 40), 4)])
def test_random_walk_probs_against_jax(hw, k):
    rng = np.random.default_rng(1)
    img, seeds = blob_image(rng, hw), seeds_for(hw, k)
    want = np.asarray(jrw.random_walk_probs(img, seeds, tol=1e-8, maxiter=2000))
    got, iters = trw.solve_seeded(_t(img), _t(seeds), tol=1e-8, maxiter=2000)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    assert iters[-1] == 0 and (iters[:-1] > 0).all()     # the seedless class never runs

    want = np.asarray(jrw.random_walk_probs(img, seeds))
    got = trw.random_walk_probs(_t(img), _t(seeds)).numpy()
    np.testing.assert_allclose(got, want, atol=RW_TOL, rtol=0)
    differ = (got > 0.5) != (want > 0.5)
    assert (np.abs(got[differ] - 0.5) <= RW_TOL).all()


def test_absent_and_fully_seeded_classes_give_no_nan():
    rng = np.random.default_rng(2)
    img = blob_image(rng, (24, 20))
    seeds = seeds_for((24, 20), 3)                      # class 2 has no seed
    got, iters = trw.solve_seeded(_t(img), _t(seeds))
    assert torch.isfinite(got).all() and (got[2] == 0).all() and iters[2] == 0
    full = np.zeros((2, 24, 20), np.float32)
    full[0] = 1.0                                       # every pixel seeded: b = 0 everywhere
    got, iters = trw.solve_seeded(_t(img), _t(full))
    assert torch.equal(got, _t(full)) and (iters == 0).all()
    np.testing.assert_array_equal(got.numpy(), np.asarray(jrw.random_walk_probs(img, full)))


def test_the_result_does_not_depend_on_how_often_the_flag_is_read():
    """A system stopped at its own step stays frozen: reading the
    all-converged flag every step, every 7 or every 16 gives the same bits
    and the same counts."""
    rng = np.random.default_rng(3)
    img, seeds = blob_image(rng, (32, 28)), seeds_for((32, 28), 4)
    runs = [trw.solve_seeded(_t(img), _t(seeds), check_every=c) for c in (1, 7, 16)]
    for probs, iters in runs[1:]:
        assert torch.equal(probs, runs[0][0]) and torch.equal(iters, runs[0][1])
    assert len(set(runs[0][1].tolist())) > 2              # the classes stop at different steps


def test_random_walk_wrapper_against_jax():
    rng = np.random.default_rng(4)
    img = blob_image(rng, (32, 32))
    seg = np.zeros((2, 32, 32), bool)
    seg[0, 10:15, 10:15] = True
    seg[1, 20:25, 20:25] = True
    for radius in (1, 3):
        want = np.asarray(jrw.random_walk(img, seg, background_erosion_radius=radius))
        got = trw.random_walk(_t(img), _t(seg), background_erosion_radius=radius).numpy()
        assert got.shape == (2, 32, 32)
        np.testing.assert_allclose(got, want, atol=RW_TOL, rtol=0)
    with pytest.raises(ValueError):
        trw.random_walk(_t(img)[None], _t(seg))


def _probs(rng, c, hw):
    """(C, H, W) U-Net-like probabilities: a soft blob and a speck per class."""
    yy, xx = np.mgrid[:hw[0], :hw[1]]
    out = np.zeros((c,) + hw, np.float32)
    for i in range(c):
        cy, cx = rng.uniform(0.3, 0.7) * hw[0], rng.uniform(0.3, 0.7) * hw[1]
        d2 = ((yy - cy) / (0.25 * hw[0])) ** 2 + ((xx - cx) / (0.2 * hw[1])) ** 2
        out[i] = np.clip(1.1 - d2, 0, 1) * rng.uniform(0.8, 1.0)
        y, x = rng.integers(0, hw[0] - 3), rng.integers(0, hw[1] - 3)
        out[i, y:y + 3, x:x + 3] = 0.9
    return out


@pytest.mark.parametrize("struct", ["square", "disk", "diamond", "star"])
@pytest.mark.parametrize("selection", ["largest", "highest_probability", None])
def test_opening_against_jax(struct, selection):
    prob = _probs(np.random.default_rng(5), 3, (40, 36))
    for radius in (0, 1, 3):
        want = np.asarray(jsp.opening_with_connected_component(prob, struct, radius, 40,
                                                               selection))
        got = tsp.opening_with_connected_component(_t(prob), struct, radius, 40, selection)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


def test_rndwalk_refiner_through_seg_enhance_against_jax():
    hw = (48, 40)
    rng = np.random.default_rng(6)
    img, prob = blob_image(rng, hw), _probs(rng, 4, hw)
    refiner = RndWalkSegRefiner(4, 10.0, device="cpu")
    jrefiner = JaxRefiner(4, 10.0)
    for r in (refiner, jrefiner):
        r._load_image = lambda name, shape: img
    enh = SegEnhance(refiner, "highest_probability", "erosion", "disk", 2)
    jenh = JaxEnhance(jrefiner, "highest_probability", "erosion", "disk", 2)
    got, est = enh.enhance(prob, "img000")
    want, jest = jenh.enhance(prob, "img000")
    assert est is None and jest is None and got.dtype == torch.bool
    assert got.device.type == "cpu" and enh._device().type == "cpu"
    np.testing.assert_array_equal(refiner.last_input_seg.numpy(),
                                  np.asarray(jrefiner.last_input_seg))
    # the walk's probabilities, for the threshold ties
    seg = refiner.last_input_seg
    background = ~seg.bool().any(0)
    from samcarriestheburden_torch.ops.morphology import erode_mask_with_disc_struct

    background = erode_mask_with_disc_struct(background[None], 4)[0]
    p = trw.random_walk_probs(_t(img), torch.cat([background[None].float(), seg]))[1:].numpy()
    differ = got.numpy() != np.asarray(want)
    assert (np.abs(p[differ] - 0.5) <= RW_TOL).all()
    assert got.any()
