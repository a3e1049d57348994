"""The port's enhance leg against the JAX package, on the CPU in fp32 at the
tiny vit_t config: morphology, prompts, the composed postprocess, the decoder
head over an embeddings h5 written by one package and read by the other, and
``SegEnhance`` with ``SamSegRefiner`` at 17 classes on the 48x32 grid of
``bench.py --smoke``.  Weights: the reference-derived ``sam_e2e`` golden."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samcarriestheburden_torch.config import N_CLASSES, UNET_INPUT_HW
from samcarriestheburden_torch.data import h5io as th5
from samcarriestheburden_torch.engine import postprocess as tpost
from samcarriestheburden_torch.engine import prompts as tprompts
from samcarriestheburden_torch.engine.decoder_head import SamMaskDecoderHead as TorchHead
from samcarriestheburden_torch.engine.refinement import SamSegRefiner as TorchRefiner
from samcarriestheburden_torch.engine.refinement import SegEnhance as TorchEnhance
from samcarriestheburden_torch.models.convert import sam_state_dict_from_torch
from samcarriestheburden_torch.ops import dice as tdice
from samcarriestheburden_torch.ops import mask_ops as tmask_ops
from samcarriestheburden_torch.ops import morphology as tmorph
from samcarriestheburden_torch.ops import resize as tresize
from samcarriestheburden_tpu.config import UNET_INPUT_HW as JAX_UNET_INPUT_HW
from samcarriestheburden_tpu.config import sam_vit_t_config
from samcarriestheburden_tpu.data import h5io as jh5
from samcarriestheburden_tpu.engine import postprocess as jpost
from samcarriestheburden_tpu.engine import prompts as jprompts
from samcarriestheburden_tpu.engine.decoder_head import SamMaskDecoderHead as JaxHead
from samcarriestheburden_tpu.engine.refinement import SamSegRefiner as JaxRefiner
from samcarriestheburden_tpu.engine.refinement import SegEnhance as JaxEnhance
from samcarriestheburden_tpu.models import convert as jconvert
from samcarriestheburden_tpu.models import modelio
from samcarriestheburden_tpu.ops import dice as jdice
from samcarriestheburden_tpu.ops import mask_ops as jmask_ops
from samcarriestheburden_tpu.ops import morphology as jmorph
from samcarriestheburden_tpu.ops import resize as jresize

# the tier-1 command runs six xdist workers on the machine's cores: one
# intra-op thread each, or their thread pools oversubscribe the cores
torch.set_num_threads(1)

GOLDEN = Path(__file__).parent / "golden"
CFG = sam_vit_t_config()
SEG_HW = (48, 32)             # bench.py --smoke's grid
INPUT_SIZE = (128, 75)        # resize-longest-side of ORIGINAL_SIZE to 128
ORIGINAL_SIZE = (256, 150)
STEMS = ("img_a", "img_b")
CKPT = "tiny.npz"


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.fixture(scope="module")
def golden_sd():
    data = np.load(GOLDEN / "sam_e2e.npz")
    return {k[3:]: data[k] for k in data.files if k.startswith("sd/")}


@pytest.fixture(scope="module")
def jax_params(golden_sd):
    return {"prompt_encoder": jconvert.prompt_encoder_params_from_torch(golden_sd),
            "mask_decoder": jconvert.mask_decoder_params_from_torch(golden_sd, CFG.mask_decoder)}


@pytest.fixture(scope="module")
def h5_path(tmp_path_factory):
    """Two embeddings written by the JAX package's writer."""
    rng = np.random.default_rng(3)
    path = tmp_path_factory.mktemp("emb") / "emb.h5"
    with jh5.EmbeddingWriter(path, checkpoint_name=CKPT, img_encoder_img_size=128) as w:
        for stem in STEMS:
            w.write(stem, rng.standard_normal((1, 16, 8, 8)).astype(np.float32),
                    ORIGINAL_SIZE, INPUT_SIZE)
    return path


@pytest.fixture(scope="module")
def heads(golden_sd, jax_params, h5_path):
    jax_head = JaxHead(None, "vit_t", h5_path, params=jax_params)
    torch_head = TorchHead(None, "vit_t", h5_path, device="cpu",
                           params=sam_state_dict_from_torch(golden_sd))
    return jax_head, torch_head


def seg_probs(seed: int) -> np.ndarray:
    """17-class U-Net-like probabilities on SEG_HW: one soft elongated blob
    per class (bench.py's), a smaller second blob in every odd class, specks
    at 0.6, and two empty classes."""
    rng = np.random.default_rng(seed)
    h, w = SEG_HW
    yy, xx = np.mgrid[:h, :w]
    prob = np.zeros((N_CLASSES, h, w), np.float32)
    for c in range(N_CLASSES - 2):
        cy, cx = rng.uniform(0.2, 0.8) * h, rng.uniform(0.2, 0.8) * w
        ry, rx = rng.uniform(0.1, 0.3) * h, rng.uniform(0.05, 0.2) * w
        prob[c] = np.clip(1.2 - ((yy - cy) / ry) ** 2 - ((xx - cx) / rx) ** 2, 0, 1)
        if c % 2:
            sy, sx = rng.integers(2, h - 4), rng.integers(2, w - 4)
            prob[c, sy:sy + 3, sx:sx + 3] = np.maximum(prob[c, sy:sy + 3, sx:sx + 3], 0.8)
        specks = rng.random((h, w)) < 0.01
        prob[c][specks] = np.maximum(prob[c][specks], 0.6)
    return prob


# ---------------------------------------------------------------------------
# small ops
# ---------------------------------------------------------------------------


def test_unet_grid_matches():
    assert UNET_INPUT_HW == tuple(JAX_UNET_INPUT_HW)


@pytest.mark.parametrize("name", ["square", "disk", "diamond", "star"])
@pytest.mark.parametrize("op", ["dilation", "erosion"])
def test_morphology_every_se_and_radius(name, op):
    rng = np.random.default_rng(7)
    mask = (rng.random((3, 30, 26)) < 0.3).astype(np.float32)
    mask[1, 5:20, 4:18] = 1.0
    for radius in range(9):
        se_t = tmorph.get_struct_element(name, radius)
        se_j = jmorph.get_struct_element(name, radius)
        np.testing.assert_array_equal(se_t, se_j)
        got = getattr(tmorph, op)(torch.from_numpy(mask), se_t)
        want = getattr(jmorph, op)(jnp.asarray(mask), jnp.asarray(se_j))
        np.testing.assert_array_equal(_np(got), np.asarray(want), err_msg=f"{name} {radius}")


def test_erode_mask_with_disc_struct():
    rng = np.random.default_rng(8)
    mask = rng.random((2, 30, 26)) < 0.7
    got = tmorph.erode_mask_with_disc_struct(torch.from_numpy(mask), 3)
    want = jmorph.erode_mask_with_disc_struct(jnp.asarray(mask), 3)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_prompt_arrays_neg_table_and_boxes():
    bool_mask = seg_probs(1) > 0.5
    got = tprompts.extract_prompt_arrays(torch.from_numpy(bool_mask))
    want = jprompts.extract_prompt_arrays(jnp.asarray(bool_mask))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]), err_msg=k)
    assert not _np(got["pos_valid"])[-2:].any()
    tab, val = tprompts.neg_seed_table(got["pos_seeds"], got["pos_valid"])
    jtab, jval = jprompts.neg_seed_table(want["pos_seeds"], want["pos_valid"])
    np.testing.assert_array_equal(_np(tab), np.asarray(jtab))
    np.testing.assert_array_equal(_np(val), np.asarray(jval))
    boxes = tmask_ops.batched_mask_to_box(torch.from_numpy(bool_mask))
    assert boxes.dtype == torch.int32
    np.testing.assert_array_equal(_np(boxes),
                                  np.asarray(jmask_ops.batched_mask_to_box(bool_mask)))


@pytest.mark.parametrize("hw", [(48, 32), (300, 200), (170, 256)])
def test_compute_logits_from_mask(hw):
    rng = np.random.default_rng(9)
    mask = np.zeros(hw, bool)
    mask[hw[0] // 4: hw[0] // 2, hw[1] // 5: hw[1] // 2] = True
    mask |= rng.random(hw) < 0.05
    got = tprompts.compute_logits_from_mask(torch.from_numpy(mask))
    want = jprompts.compute_logits_from_mask(jnp.asarray(mask))
    assert got.shape == (1, 256, 256)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-4)


def test_prompt_extractors():
    prob = seg_probs(2)
    got = tprompts.PromptExtractor(prob > 0.5).extract(mask=True)
    want = jprompts.PromptExtractor(prob > 0.5).extract(mask=True)
    assert [p.class_idx for p in got] == [p.class_idx for p in want]
    for a, b in zip(got, want):
        for k in ("pos_seeds", "neg_seeds", "box"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
        np.testing.assert_allclose(a.mask_logits, b.mask_logits, atol=1e-4)
    got = tprompts.SAMSelectingPromptExtractor(prob).extract(mask=False)
    want = jprompts.SAMSelectingPromptExtractor(prob).extract(mask=False)
    assert [p.class_idx for p in got] == [p.class_idx for p in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.pos_seeds, b.pos_seeds)
        np.testing.assert_array_equal(a.neg_seeds, b.neg_seeds)


def test_dice_and_scaling():
    rng = np.random.default_rng(10)
    y_hat, y = rng.random((2, 3, 12, 10)) < 0.4, rng.random((2, 3, 12, 10)) < 0.4
    y[0, 1] = False
    np.testing.assert_allclose(_np(tdice.multilabel_dice(torch.from_numpy(y_hat), torch.from_numpy(y))),
                               np.asarray(jdice.multilabel_dice(y_hat, y)), atol=1e-6)
    a, b = rng.integers(0, 4, (2, 12, 10)), rng.integers(0, 4, (2, 12, 10))
    np.testing.assert_allclose(_np(tdice.multiclass_dice(torch.from_numpy(a), torch.from_numpy(b), 3)),
                               np.asarray(jdice.multiclass_dice(a, b, 3)), atol=1e-6)
    j = rng.random(5).astype(np.float32)
    np.testing.assert_allclose(_np(tdice.jaccard_to_dice(torch.from_numpy(j))),
                               np.asarray(jdice.jaccard_to_dice(j)), atol=1e-7)
    pts = rng.uniform(0, 40, (4, 2)).astype(np.float32)
    np.testing.assert_allclose(_np(tresize.scale_coords(pts, SEG_HW, INPUT_SIZE)),
                               np.asarray(jresize.scale_coords(pts, SEG_HW, INPUT_SIZE)), atol=1e-6)
    box = rng.uniform(0, 40, (3, 4)).astype(np.float32)
    np.testing.assert_allclose(_np(tresize.scale_box(box, SEG_HW, INPUT_SIZE)),
                               np.asarray(jresize.scale_box(box, SEG_HW, INPUT_SIZE)), atol=1e-6)


@pytest.mark.parametrize("case", ["vit_t", "vit_h"])
def test_postprocess_to_grid(case):
    """The composed chain: masks equal, logits within 1e-5."""
    lr, enc, inp, orig, out = {
        "vit_t": (32, 128, INPUT_SIZE, ORIGINAL_SIZE, SEG_HW),
        "vit_h": (256, 1024, (1024, 597), (2304, 1344), UNET_INPUT_HW)}[case]
    rng = np.random.default_rng(11)
    low = (rng.standard_normal((N_CLASSES, 1, lr, lr)) * 8).astype(np.float32)
    args_t = (torch.from_numpy(low), torch.tensor(inp), torch.tensor(orig), out, enc)
    args_j = (jnp.asarray(low), jnp.asarray(inp), jnp.asarray(orig), out, enc)
    logits = tpost.postprocess_to_grid(*args_t, threshold_only=False)
    np.testing.assert_allclose(_np(logits), np.asarray(
        jpost.postprocess_to_grid(*args_j, threshold_only=False)), atol=1e-5)
    masks = tpost.postprocess_to_grid(*args_t)
    assert masks.dtype == torch.bool and masks.shape == (N_CLASSES, 1, *out)
    np.testing.assert_array_equal(_np(masks), np.asarray(jpost.postprocess_to_grid(*args_j)))


# ---------------------------------------------------------------------------
# the embeddings store and the decoder head
# ---------------------------------------------------------------------------


def test_h5_files_interoperate(tmp_path, h5_path):
    with th5.EmbeddingReader(h5_path) as r:
        jr = jh5.EmbeddingReader(h5_path)
        assert sorted(r.stems()) == sorted(STEMS) and r.checkpoint == CKPT
        for stem in STEMS:
            np.testing.assert_array_equal(r.features(stem), jr.features(stem))
            for a, b in zip(r.sizes(stem), jr.sizes(stem)):
                np.testing.assert_array_equal(a, b)
        jr.close()
    path = tmp_path / "port.h5"
    feats = np.arange(16 * 64, dtype=np.float32).reshape(1, 16, 8, 8)
    with th5.EmbeddingWriter(path, CKPT, img_encoder_img_size=128) as w:
        w.write("x", feats, ORIGINAL_SIZE, INPUT_SIZE)
    with th5.EmbeddingWriter(path, CKPT, img_encoder_img_size=128, append=True) as w:
        assert w.existing_stems() == {"x"}
    jr = jh5.EmbeddingReader(path)
    np.testing.assert_array_equal(jr.features("x"), feats)
    assert jr.img_encoder_img_size == 128 and tuple(jr.sizes("x")[1]) == INPUT_SIZE
    jr.close()
    with pytest.raises(ValueError, match="different checkpoint"):
        th5.EmbeddingWriter(path, "other.npz", append=True)


def _round_prompts(bool_mask, prompts):
    arrays = jprompts.extract_prompt_arrays(jnp.asarray(bool_mask))
    table, valid = jprompts.neg_seed_table(arrays["pos_seeds"], arrays["pos_valid"])
    return JaxRefiner._build_prompts(arrays, table, valid, prompts, SEG_HW,
                                     jnp.asarray(INPUT_SIZE))


def test_decode_batched_both_rounds(heads):
    jax_head, torch_head = heads
    bool_mask = seg_probs(4) > 0.5
    c1, l1 = _round_prompts(bool_mask, ["box"])
    c2, l2 = _round_prompts(bool_mask, ["pos_points", "neg_points"])
    feats = jax_head.features("img_a")
    tfeats = torch_head.features("img_a")
    np.testing.assert_array_equal(_np(tfeats), np.asarray(feats))
    g4 = CFG.prompt_encoder.image_embedding_size[0] * 4
    n = c1.shape[0]
    low1, iou1 = jax_head._decode(feats, c1, l1, jnp.zeros((n, 1, g4, g4)), jnp.zeros((n,), bool),
                                  image_shared=True)
    t_low1, t_iou1 = torch_head._decode(tfeats, torch.from_numpy(np.array(c1)),
                                        torch.from_numpy(np.array(l1)), None, None,
                                        image_shared=True)
    np.testing.assert_allclose(_np(t_low1), np.asarray(low1), atol=1e-4)
    np.testing.assert_allclose(_np(t_iou1), np.asarray(iou1), atol=1e-4)
    # round 1 without the shared-image path agrees too
    t_low1b, _ = torch_head.decode_batched(tfeats, np.asarray(c1), np.asarray(l1))
    np.testing.assert_allclose(_np(t_low1b), np.asarray(low1), atol=1e-4)
    low2, iou2 = jax_head.decode_batched(feats, c2, l2, low1)
    t_low2, t_iou2 = torch_head.decode_batched(tfeats, np.asarray(c2), np.asarray(l2),
                                               np.asarray(low1))
    np.testing.assert_allclose(_np(t_low2), np.asarray(low2), atol=1e-4)
    np.testing.assert_allclose(_np(t_iou2), np.asarray(iou2), atol=1e-4)


def test_predict_mask(heads):
    jax_head, torch_head = heads
    bool_mask = seg_probs(5) > 0.5
    p_t = tprompts.PromptExtractor(bool_mask).extract()[1]
    p_j = jprompts.PromptExtractor(bool_mask).extract()[1]
    m_t, iou_t, low_t = torch_head.predict_mask("img_b", p_t, ["box"])
    m_j, iou_j, low_j = jax_head.predict_mask("img_b", p_j, ["box"])
    assert m_t.shape == (1, 1, *ORIGINAL_SIZE) and m_t.dtype == torch.bool
    np.testing.assert_allclose(_np(low_t), np.asarray(low_j), atol=1e-4)
    np.testing.assert_allclose(_np(iou_t), np.asarray(iou_j), atol=1e-4)
    m2_t, iou2_t, low2_t = torch_head.predict_mask("img_b", p_t, ["pos_points", "neg_points"],
                                                   mask_prev_iter=low_t)
    m2_j, iou2_j, low2_j = jax_head.predict_mask("img_b", p_j, ["pos_points", "neg_points"],
                                                 mask_prev_iter=low_j)
    np.testing.assert_allclose(_np(low2_t), np.asarray(low2_j), atol=1e-4)
    np.testing.assert_allclose(_np(iou2_t), np.asarray(iou2_j), atol=1e-4)
    for got, want in ((m_t, m_j), (m2_t, m2_j)):
        assert (_np(got) != np.asarray(want)).mean() < 1e-3


def test_head_from_jax_checkpoint(tmp_path, heads, jax_params, h5_path):
    """A JAX-package .npz checkpoint builds the same head; the embeddings
    store must name it."""
    _, torch_head = heads
    path = modelio.save_params(tmp_path / CKPT, jax_params)
    head = TorchHead(path, "vit_t", h5_path, device="cpu")
    coords = torch.tensor([[[10.0, 12.0], [40.0, 60.0]]])
    labels = torch.tensor([[2, 3]])
    feats = torch_head.features("img_a")
    for a, b in zip(head.decode_batched(feats, coords, labels),
                    torch_head.decode_batched(feats, coords, labels)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="checkpoint mismatch"):
        TorchHead(tmp_path / "other.npz", "vit_t", h5_path, device="cpu")


# ---------------------------------------------------------------------------
# the refiner and SegEnhance
# ---------------------------------------------------------------------------

TWO_ROUNDS = [["box"], ["pos_points", "neg_points"]]


def _assert_refined_equal(got, want):
    refined, est = got
    j_refined, j_est = want
    np.testing.assert_array_equal(_np(refined), np.asarray(j_refined))
    est, j_est = _np(est), np.asarray(j_est)
    np.testing.assert_array_equal(np.isnan(est), np.isnan(j_est))
    np.testing.assert_allclose(est, j_est, atol=1e-4)


@pytest.mark.parametrize("prompts", [TWO_ROUNDS, ["pos_points"]], ids=["two_rounds", "points"])
def test_refiner_refine(heads, prompts):
    jax_head, torch_head = heads
    seg = seg_probs(6) > 0.5
    got = TorchRefiner(torch_head, prompts2use=prompts).refine(seg, "img_a")
    want = JaxRefiner(jax_head, prompts2use=prompts).refine(seg, "img_a")
    assert got[0].dtype == torch.bool and got[0].shape == (N_CLASSES, *SEG_HW)
    _assert_refined_equal(got, want)
    assert np.isnan(_np(got[1])[-2:]).all() and not _np(got[0])[-2:].any()


def test_seg_enhance(heads):
    jax_head, torch_head = heads
    seg = seg_probs(7)
    t_enh = TorchEnhance(TorchRefiner(torch_head, prompts2use=TWO_ROUNDS),
                         "highest_probability", "dilation", "square", 8)
    j_enh = JaxEnhance(JaxRefiner(jax_head, prompts2use=TWO_ROUNDS),
                       "highest_probability", "dilation", "square", 8)
    _assert_refined_equal(t_enh.enhance(seg, "img_b"), j_enh.enhance(seg, "img_b"))
    np.testing.assert_array_equal(_np(t_enh.last_preprocessed_seg),
                                  np.asarray(j_enh.last_preprocessed_seg))


def test_seg_enhance_batch(heads):
    jax_head, torch_head = heads
    segs = np.stack([seg_probs(8), seg_probs(9)])
    t_enh = TorchEnhance(TorchRefiner(torch_head, prompts2use=TWO_ROUNDS),
                         "largest", "erosion", "disk", 2)
    j_enh = JaxEnhance(JaxRefiner(jax_head, prompts2use=TWO_ROUNDS),
                       "largest", "erosion", "disk", 2)
    got = t_enh.enhance_batch(segs, list(STEMS))
    _assert_refined_equal(got, j_enh.enhance_batch(segs, list(STEMS)))
    assert got[0].shape == (2, N_CLASSES, *SEG_HW) and got[1].shape == (2, N_CLASSES)
    np.testing.assert_array_equal(_np(t_enh.last_preprocessed_seg),
                                  np.asarray(j_enh.last_preprocessed_seg))
    # the batch is the per-image loop
    for i, stem in enumerate(STEMS):
        refined, est = t_enh.enhance(segs[i], stem)
        np.testing.assert_array_equal(_np(got[0][i]), _np(refined))
        np.testing.assert_allclose(_np(got[1][i]), _np(est), atol=1e-6)


def test_seg_enhance_identity_morph(heads):
    _, torch_head = heads
    seg = seg_probs(10)
    for struct, radius in (("square", 0), ("square", 1), ("disk", 0)):
        enh = TorchEnhance(TorchRefiner(torch_head), None, "erosion", struct, radius)
        enh.enhance(seg, "img_b")
        np.testing.assert_array_equal(_np(enh.last_preprocessed_seg), seg)
