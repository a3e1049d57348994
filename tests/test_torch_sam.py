"""The port's SAM prompt/decode leg and serving encoder against the reference
goldens and the JAX package, at the tiny vit_t config in fp32 on the CPU."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samcarriestheburden_torch.config import N_CLASSES, sam_vit_t_config
from samcarriestheburden_torch.engine.embeddings import make_serving_encoder
from samcarriestheburden_torch.models.convert import sam_state_dict_from_torch
from samcarriestheburden_torch.models.mask_decoder import MaskDecoder
from samcarriestheburden_torch.models.prompt_encoder import PromptEncoder
from samcarriestheburden_torch.models.sam import build_sam, two_round_decode
from samcarriestheburden_torch.ops import resize as tresize
from samcarriestheburden_tpu.config import sam_vit_t_config as jax_vit_t_config
from samcarriestheburden_tpu.engine.embeddings import make_encode_batch
from samcarriestheburden_tpu.models import convert as jconvert
from samcarriestheburden_tpu.models import mask_decoder as jmd
from samcarriestheburden_tpu.models import prompt_encoder as jpe
from samcarriestheburden_tpu.models.sam import SamModel as JaxSamModel
from samcarriestheburden_tpu.models.sam import postprocess_masks as jax_postprocess
from samcarriestheburden_tpu.ops import resize as jresize

# the tier-1 command runs six xdist workers on the machine's cores: one
# intra-op thread each, or their thread pools oversubscribe the cores
torch.set_num_threads(1)

GOLDEN = Path(__file__).parent / "golden"
CFG = sam_vit_t_config()
JCFG = jax_vit_t_config()


def load_golden(name):
    data = np.load(GOLDEN / f"{name}.npz")
    sd = sam_state_dict_from_torch({k[3:]: data[k] for k in data.files if k.startswith("sd/")})
    return sd, {k: data[k] for k in data.files if not k.startswith("sd/")}


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def shared_weights():
    """Seeded random SAM weights for both packages: the port's state dict and
    the JAX params converted from it by the JAX package's own loader."""
    sd = build_sam(CFG, device="cpu", seed=5).state_dict()
    sd_np = {k: v.numpy().copy() for k, v in sd.items()}
    return sd, jconvert.sam_params_from_torch(sd_np, JCFG)


# ---------------------------------------------------------------------------
# reference goldens (tolerances of tests/test_models_parity.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["pts", "box", "all"])
def test_prompt_encoder_matches_golden(case):
    sd, g = load_golden("prompt_encoder")
    pe = PromptEncoder(CFG.prompt_encoder)
    pe.load_state_dict(sd)
    points = (_t(g["coords"]), _t(g["labels"]))
    kwargs = {"pts": dict(points=points),
              "box": dict(boxes=_t(g["boxes"])),
              "all": dict(points=points, boxes=_t(g["boxes"]), masks=_t(g["mask_in"]))}[case]
    with torch.no_grad():
        sparse, dense = pe(**kwargs)
    np.testing.assert_allclose(sparse.numpy(), g[f"sp_{case}"], atol=1e-5)
    np.testing.assert_allclose(dense.detach().numpy(), g[f"dn_{case}"], atol=1e-5)


def test_dense_pe_matches_golden():
    sd, g = load_golden("prompt_encoder")
    pe = PromptEncoder(CFG.prompt_encoder)
    pe.load_state_dict(sd)
    with torch.no_grad():
        np.testing.assert_allclose(pe.get_dense_pe().numpy(), g["dense_pe"], atol=1e-5)


@pytest.mark.parametrize("multi", [True, False])
def test_mask_decoder_matches_golden(multi):
    sd, g = load_golden("mask_decoder")
    md = MaskDecoder(CFG.mask_decoder)
    md.load_state_dict(sd)
    with torch.no_grad():
        masks, iou = md(*(_t(g[k]) for k in ("img_emb", "img_pe", "sparse", "dense")),
                        multimask_output=multi)
    suffix = "multi" if multi else "single"
    np.testing.assert_allclose(masks.numpy(), g[f"masks_{suffix}"], atol=1e-5)
    np.testing.assert_allclose(iou.numpy(), g[f"iou_{suffix}"], atol=2e-5)


def test_sam_end_to_end_matches_golden():
    sd, g = load_golden("sam_e2e")
    model = build_sam(CFG, device="cpu", state_dict=sd)
    out = model([{"image": _t(g["image"]), "original_size": (200, 256),
                  "point_coords": _t(g["pt"]), "point_labels": _t(g["lbl"]),
                  "boxes": _t(g["box"])}], multimask_output=False)[0]
    np.testing.assert_allclose(out["low_res_logits"].numpy(), g["low_res"], atol=5e-4)
    np.testing.assert_allclose(out["iou_predictions"].numpy(), g["iou"], atol=1e-4)
    assert (out["masks"].numpy() == g["masks"]).mean() > 0.999


# ---------------------------------------------------------------------------
# the JAX package
# ---------------------------------------------------------------------------


def _refine_inputs(rng):
    size = CFG.image_encoder.img_size
    n_points = 1 + (N_CLASSES - 1) + 1                    # pos + negs + pad
    coords = rng.uniform(0, size, (N_CLASSES, n_points, 2)).astype(np.float32)
    labels = np.concatenate([np.ones((N_CLASSES, 1)), np.zeros((N_CLASSES, N_CLASSES - 1)),
                             -np.ones((N_CLASSES, 1))], axis=1).astype(np.int32)
    return coords, labels


def test_two_round_decode_matches_jax(rng, shared_weights):
    """The 17-class refinement decode of bench.py:311-327: round 1 with the
    image side shared, round 2 with round 1's logits as the mask prompt."""
    sd, params = shared_weights
    model = build_sam(CFG, device="cpu", state_dict=sd)
    g = CFG.prompt_encoder.image_embedding_size
    features = rng.standard_normal((1, CFG.mask_decoder.transformer_dim, *g)).astype(np.float32)
    coords, labels = _refine_inputs(rng)

    pp, mp = params["prompt_encoder"], params["mask_decoder"]
    sparse = jpe.embed_unified_points(pp, JCFG.prompt_encoder, coords, labels)
    image_pe = jpe.get_dense_pe(pp, JCFG.prompt_encoder)
    dense = jpe.no_mask_dense(pp, JCFG.prompt_encoder, 1)
    low1, _ = jmd.apply(mp, JCFG.mask_decoder, features, image_pe, sparse, dense, False,
                        image_shared=True)
    dense2 = jpe.embed_masks(pp, JCFG.prompt_encoder, low1)
    ref_low, ref_iou = jmd.apply(mp, JCFG.mask_decoder, features, image_pe, sparse, dense2,
                                 False)

    low, iou = two_round_decode(model, _t(features), _t(coords), _t(labels).long())
    assert tuple(low.shape) == (N_CLASSES, 1, 4 * g[0], 4 * g[1])
    np.testing.assert_allclose(low.numpy(), np.asarray(ref_low), atol=5e-4)
    np.testing.assert_allclose(iou.numpy(), np.asarray(ref_iou), atol=1e-4)

    input_size, original_size = (128, 90), (200, 141)
    ref = jax_postprocess(JCFG, ref_low, input_size, original_size)
    ours = model.postprocess_masks(low, input_size, original_size)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=5e-4)


def test_serving_encoder_matches_jax(rng, shared_weights):
    """make_serving_encoder on a zero-padded uint8 batch == JAX
    make_encode_batch: normalise, then mask the padding, then encode."""
    sd, params = shared_weights
    model = build_sam(CFG, device="cpu", state_dict=sd)
    size = CFG.image_encoder.img_size
    input_sizes = np.array([[128, 90], [100, 128]], np.int32)
    imgs = np.zeros((2, 3, size, size), np.uint8)
    for i, (h, w) in enumerate(input_sizes):
        imgs[i, :, :h, :w] = rng.integers(0, 256, (3, h, w))

    ref = make_encode_batch(JaxSamModel(cfg=JCFG, params=params), jnp.float32)(
        params, jnp.asarray(imgs), jnp.asarray(input_sizes))
    encode, packed = make_serving_encoder(model, torch.float32)
    ours = encode(packed, _t(imgs), _t(input_sizes))
    assert tuple(ours.shape) == (2, CFG.image_encoder.out_chans, 8, 8)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=2e-4)


@pytest.mark.parametrize("out_hw", [(256, 256), (37, 53), (5, 3)])
def test_resize_bilinear_matches_jax(rng, out_hw):
    x = rng.standard_normal((2, 3, 32, 24)).astype(np.float32)
    ref = jresize.resize_bilinear(jnp.asarray(x), out_hw)
    ours = tresize.resize_bilinear(_t(x), out_hw)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)


def test_preprocess_helpers_match_jax(rng):
    for hw in ((1600, 1119), (200, 256), (777, 333)):
        assert tresize.get_preprocess_shape(*hw, 1024) == jresize.get_preprocess_shape(*hw, 1024)
    x = rng.standard_normal((3, 20, 17)).astype(np.float32)
    np.testing.assert_array_equal(tresize.pad_bottom_right(_t(x), (32, 32)).numpy(),
                                  np.asarray(jresize.pad_bottom_right(jnp.asarray(x), (32, 32))))
    img = rng.integers(0, 256, (90, 61, 3)).astype(np.uint8)
    ref = jresize.resize_longest_side_np(img, 64)          # PIL's antialiased bilinear
    ours = tresize.resize_longest_side_np(img, 64)
    assert ours.shape == ref.shape == (64, 43, 3)
    assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1
