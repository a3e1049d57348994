"""The port's predictor and automatic mask generation (``engine/predictor.py``,
``engine/amg.py``) and their ops (``ops/nms.py``, ``ops/rle.py``,
``ops/regions.py``, ``native.py``, ``ops/mask_ops.py``, ``ops/resize.py``)
against the JAX package on the CPU: the golden vit_t (and seeded random
weights, whose masks are not empty) on the 200 x 256 image of
``tests/test_predictor_amg.py``, the port in fp32 on ``device="cpu"``.

Tolerances: embeddings and logits 1e-5 absolute (fp32 CPU arithmetic in two
frameworks; read: 3e-7); IoU predictions 1e-5; stability scores equal to
1e-6 (ratios of integer counts); boxes, points, areas and RLEs equal, except
that a pixel may differ where the port's logit lies within ``LOGIT_TIE``
(1e-5) of the mask threshold.  NMS, RLE, the native CCL and the index
rules are exact."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from samcarriestheburden_torch import native
from samcarriestheburden_torch.cli import amg as tcli
from samcarriestheburden_torch.config import sam_vit_t_config
from samcarriestheburden_torch.engine.amg import MaskData, SamAutomaticMaskGenerator
from samcarriestheburden_torch.engine.predictor import SamPredictor
from samcarriestheburden_torch.models.convert import sam_state_dict_from_torch
from samcarriestheburden_torch.models.sam import build_sam
from samcarriestheburden_torch.ops import mask_ops as tmo
from samcarriestheburden_torch.ops import nms as tnms
from samcarriestheburden_torch.ops import regions as tregions
from samcarriestheburden_torch.ops import resize as tresize
from samcarriestheburden_torch.ops import rle as trle
from samcarriestheburden_tpu.cli import amg as jcli
from samcarriestheburden_tpu.config import sam_vit_t_config as jax_vit_t_config
from samcarriestheburden_tpu.engine.amg import SamAutomaticMaskGenerator as JaxAMG
from samcarriestheburden_tpu.engine.predictor import SamPredictor as JaxPredictor
from samcarriestheburden_tpu.models import convert as jconvert
from samcarriestheburden_tpu.models import prompt_encoder as jpe
from samcarriestheburden_tpu.models.sam import SamModel as JaxSamModel
from samcarriestheburden_tpu.ops import mask_ops as jmo
from samcarriestheburden_tpu.ops import nms as jnms
from samcarriestheburden_tpu.ops import regions as jregions
from samcarriestheburden_tpu.ops import resize as jresize
from samcarriestheburden_tpu.ops import rle as jrle

# the tier-1 command runs six xdist workers on the machine's cores: one
# intra-op thread each, or their thread pools oversubscribe the cores
torch.set_num_threads(1)

GOLDEN = Path(__file__).parent / "golden"
LOGIT_TIE = 1e-5
TOL = 1e-5


def _raw_golden():
    data = np.load(GOLDEN / "sam_e2e.npz")
    return {k[3:]: data[k] for k in data.files if k.startswith("sd/")}


@pytest.fixture(scope="module", params=["golden", "seeded"])
def models(request):
    """(port SamModel, JAX SamModel) on the same weights: the golden vit_t,
    and seeded random ones (seed 1) whose AMG masks are not empty."""
    if request.param == "golden":
        raw = _raw_golden()
        tm = build_sam(sam_vit_t_config(), device="cpu", state_dict=sam_state_dict_from_torch(raw))
    else:
        tm = build_sam(sam_vit_t_config(), device="cpu", seed=1)
        raw = {k: v.numpy().copy() for k, v in tm.state_dict().items()}
    jm = JaxSamModel(cfg=jax_vit_t_config(),
                     params=jconvert.sam_params_from_torch(raw, jax_vit_t_config()))
    return tm, jm


@pytest.fixture(scope="module")
def image():
    rng = np.random.default_rng(11)
    img = rng.integers(0, 255, (200, 256, 3)).astype(np.uint8)
    img[60:140, 80:180] = 240  # bright blob
    return img


@pytest.fixture(scope="module")
def generators(models):
    """One AMG per package and model, reused (its knobs set per test) so the
    JAX package compiles its encoder and decoder once."""
    tm, jm = models
    return SamAutomaticMaskGenerator(tm, points_per_side=4), JaxAMG(jm, points_per_side=4)


def _set(gens, **knobs):
    for g in gens:
        for k, v in knobs.items():
            setattr(g, k, v)
    if "points_per_side" in knobs or "crop_n_layers" in knobs:
        grids = tmo.build_all_layer_point_grids(knobs.get("points_per_side", 4),
                                                gens[0].crop_n_layers, 1)
        for g in gens:
            g.point_grids = grids


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _assert_masks_equal_off_ties(got, want, logits, thr):
    """Boolean masks equal except where ``logits`` is within LOGIT_TIE of ``thr``."""
    differ = np.asarray(got) != np.asarray(want)
    assert (np.abs(logits[differ] - thr) <= LOGIT_TIE).all(), int(differ.sum())


# ---------------------------------------------------------------------------
# predictor
# ---------------------------------------------------------------------------


def test_predictor_against_jax(models, generators, image):
    tm, jm = models
    pred, jpred = (g.predictor for g in generators)     # the JAX encoder compiles once
    assert isinstance(pred, SamPredictor) and isinstance(jpred, JaxPredictor)
    pred.reset_image()
    with pytest.raises(RuntimeError):
        pred.predict(box=np.array([0, 0, 10, 10]))
    assert pred.dtype == torch.float32            # the CPU's default
    pred.set_image(image)
    jpred.set_image(image)
    assert pred.original_size == (200, 256) and pred.input_size == (100, 128)
    emb = pred.get_image_embedding()
    assert tuple(emb.shape) == (1, 16, 8, 8)
    np.testing.assert_allclose(_np(emb), np.asarray(jpred.features), atol=TOL, rtol=0)

    pt, lbl, box = np.array([[128.0, 100.0]]), np.array([1]), np.array([80.0, 60.0, 180.0, 140.0])
    cases = [dict(point_coords=pt, point_labels=lbl, box=box, multimask_output=False),
             dict(point_coords=pt, point_labels=lbl)]
    thr = tm.mask_threshold
    for kw in cases:
        masks, iou, low = pred.predict(**kw)
        logits, _, _ = pred.predict(**kw, return_logits=True)
        # JAX's masks are its logits above the threshold (one JAX call per case)
        jlogits, jiou, jlow = jpred.predict(**kw, return_logits=True)
        assert masks.dtype == bool and masks.shape == jlogits.shape
        assert logits.dtype == np.float32 and np.array_equal(masks, logits > thr)
        np.testing.assert_allclose(logits, jlogits, atol=TOL, rtol=0)
        np.testing.assert_allclose(low, jlow, atol=TOL, rtol=0)
        np.testing.assert_allclose(iou, jiou, atol=TOL, rtol=0)
        _assert_masks_equal_off_ties(masks, np.asarray(jlogits) > thr, logits, thr)
    # round 2 with the low-res logits as the mask prompt
    _, _, low = pred.predict(point_coords=pt, point_labels=lbl, multimask_output=False)
    got = pred.predict(point_coords=pt, point_labels=lbl, mask_input=low,
                       multimask_output=False, return_logits=True)
    want = jpred.predict(point_coords=pt, point_labels=lbl, mask_input=low,
                         multimask_output=False, return_logits=True)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), atol=TOL, rtol=0)
    pred.reset_image()
    assert not pred.is_image_set


def test_predictor_bgr_transform_and_batched(generators, image):
    pred = generators[0].predictor
    pred.set_image(np.ascontiguousarray(image[..., ::-1]), image_format="BGR")
    feats_bgr = _np(pred.get_image_embedding())
    pred.set_image(image)
    assert np.array_equal(feats_bgr, _np(pred.get_image_embedding()))
    with pytest.raises(ValueError):
        pred.set_image(image, image_format="HSV")
    tr = pred.transform
    assert tr.get_preprocess_shape(200, 256, 128) == (100, 128)
    np.testing.assert_array_equal(tr.apply_coords(np.array([[256.0, 200.0]]), (200, 256)),
                                  [[128.0, 100.0]])
    np.testing.assert_array_equal(tr.apply_boxes(np.array([[0.0, 0.0, 256.0, 200.0]]),
                                                 (200, 256)), [[0.0, 0.0, 128.0, 100.0]])
    # predict_torch is predict_batched, input-frame tensors on the model's device
    masks, iou, low = pred.predict_torch(torch.tensor([[[64.0, 50.0]]]),
                                         torch.tensor([[1]]), multimask_output=True)
    assert masks.dtype == torch.bool and tuple(masks.shape) == (1, 3, 200, 256)
    assert tuple(iou.shape) == (1, 3) and tuple(low.shape) == (1, 3, 32, 32)


def test_pe_with_coords_and_image_format(models):
    tm, jm = models
    coords = np.random.default_rng(3).uniform(0, 128, (2, 5, 2)).astype(np.float32)
    got = tm.prompt_encoder.pe_with_coords(torch.from_numpy(coords), (100, 128))
    want = jpe.pe_with_coords(jm.params["prompt_encoder"], coords, (100, 128))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL, rtol=0)
    assert tm.image_format == jm.image_format == "RGB"


# ---------------------------------------------------------------------------
# automatic mask generation
# ---------------------------------------------------------------------------


def test_mask_data_container():
    d = MaskData(a=np.arange(5), b=list("abcde"))
    d.filter(np.array([True, False, True, False, True]))
    assert d["a"].tolist() == [0, 2, 4] and d["b"] == ["a", "c", "e"]
    d.cat(MaskData(a=np.arange(2), b=list("xy")))
    assert len(d) == 5 and d["b"] == ["a", "c", "e", "x", "y"]
    d.filter(np.array([4, 0]))
    assert d["a"].tolist() == [1, 0]
    with pytest.raises(TypeError):
        MaskData(bad=3)


@pytest.mark.parametrize("crop", [False, True], ids=["full", "crop"])
def test_process_batch_against_jax(generators, image, crop):
    """One batch of grid points through both packages' ``_process_batch``:
    every record (thresholds off) equal, in order; a mask pixel may differ
    only where the port's logit ties the threshold."""
    gen, jgen = generators
    _set((gen, jgen), pred_iou_thresh=-10.0, stability_score_thresh=0.0)
    orig = image.shape[:2]
    crop_box = [64, 40, 256, 200] if crop else [0, 0, orig[1], orig[0]]
    cropped = image[crop_box[1]:crop_box[3], crop_box[0]:crop_box[2]]
    points = tmo.build_point_grid(4) * np.array(cropped.shape[:2])[None, ::-1]
    gen.predictor.set_image(cropped)
    jgen.predictor.set_image(cropped)
    got = gen._process_batch(points[:11], cropped.shape[:2], crop_box, orig)
    want = jgen._process_batch(points[:11], cropped.shape[:2], crop_box, orig)
    # the golden vit_t's masks are empty: in the crop their boxes sit on the
    # crop's edge, and the filter drops them all
    assert len(got) == len(want) and (len(got) > 0 or crop)
    np.testing.assert_allclose(got["iou_preds"], want["iou_preds"], atol=TOL, rtol=0)
    np.testing.assert_allclose(got["stability_score"], want["stability_score"], atol=1e-6,
                               rtol=0)
    np.testing.assert_array_equal(got["points"], want["points"])
    # the logits of the same points, for the threshold ties
    coords = gen.predictor.transform.apply_coords(points[:11], cropped.shape[:2])
    logits, _, _ = gen.predictor.predict_batched(torch.from_numpy(coords[:, None]),
                                                 torch.ones((11, 1), dtype=torch.int32),
                                                 return_logits=True)
    logits = _np(logits).reshape(-1, *cropped.shape[:2])
    thr = gen.predictor.model.mask_threshold
    x0, y0, x1, y1 = crop_box
    for i in range(len(got)):
        m, jm_ = trle.rle_to_mask(got["rles"][i]), jrle.rle_to_mask(want["rles"][i])
        assert m.shape == orig
        _assert_masks_equal_off_ties(m[y0:y1, x0:x1], jm_[y0:y1, x0:x1], logits[i], thr)
        if np.array_equal(m, jm_):
            assert got["rles"][i] == want["rles"][i]
            np.testing.assert_array_equal(got["boxes"][i], want["boxes"][i])
    # the batch's masks died with its device leg: the records hold RLEs only
    assert "masks" not in dict(got.items()) and "packed" not in dict(got.items())


def _records_match(got, want, image_hw):
    """Generate's records, matched by point and predicted IoU: equal fields,
    the floats within the file's tolerances."""
    def key(r):
        return (tuple(r["point_coords"][0]), round(r["predicted_iou"], 4))

    got, want = sorted(got, key=key), sorted(want, key=key)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a["point_coords"] == b["point_coords"] and a["crop_box"] == b["crop_box"]
        assert abs(a["predicted_iou"] - b["predicted_iou"]) <= TOL
        assert abs(a["stability_score"] - b["stability_score"]) <= 1e-6
        assert a["area"] == b["area"] and a["bbox"] == b["bbox"]
        sa, sb = a["segmentation"], b["segmentation"]
        if isinstance(sa, np.ndarray):
            assert sa.dtype == bool and sa.shape == image_hw and np.array_equal(sa, sb)
        else:
            assert sa == sb


@pytest.mark.parametrize("mode", ["binary_mask", "uncompressed_rle", "coco_rle"])
def test_generate_against_jax(generators, image, mode):
    gen, jgen = generators
    _set((gen, jgen), pred_iou_thresh=-10.0, stability_score_thresh=0.0, box_nms_thresh=0.9,
         crop_n_layers=0, min_mask_region_area=0, output_mode=mode, points_per_side=4)
    got, want = gen.generate(image), jgen.generate(image)
    assert len(got) > 0
    _records_match(got, want, image.shape[:2])
    if mode == "coco_rle":
        assert isinstance(got[0]["segmentation"]["counts"], str)


def test_generate_crops_and_small_regions_against_jax(generators, image):
    gen, jgen = generators
    _set((gen, jgen), pred_iou_thresh=-10.0, stability_score_thresh=0.0, box_nms_thresh=0.7,
         crop_n_layers=1, min_mask_region_area=10, output_mode="uncompressed_rle",
         points_per_side=2)
    got, want = gen.generate(image), jgen.generate(image)
    assert len(got) > 0
    _records_match(got, want, image.shape[:2])


def test_strict_thresholds_filter_everything(generators, image):
    gen, _ = generators
    _set((gen,), pred_iou_thresh=100.0, stability_score_thresh=0.95, crop_n_layers=0,
         min_mask_region_area=0, output_mode="binary_mask", points_per_side=2)
    assert gen.generate(image) == []


# ---------------------------------------------------------------------------
# NMS: against JAX and a brute-force greedy NMS, ties and valid included
# ---------------------------------------------------------------------------


def _iou(a, b):
    inter = (max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
             * max(0.0, min(a[3], b[3]) - max(a[1], b[1])))
    union = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / union if union > 0 else 0.0


def _greedy(boxes, scores, thr, valid=None):
    """torchvision's NMS, one box at a time, in float64."""
    order = sorted(range(len(boxes)), key=lambda i: (-scores[i], i))
    keep = np.zeros(len(boxes), bool)
    kept = []
    for i in order:
        if valid is not None and not valid[i]:
            continue
        if all(_iou(boxes[i].astype(float), boxes[j].astype(float)) <= thr for j in kept):
            keep[i] = True
            kept.append(i)
    return keep


def _boxes(rng, n):
    xy = rng.uniform(0, 50, (n, 2))
    wh = rng.uniform(5, 30, (n, 2))
    return np.concatenate([xy, xy + wh], axis=1).astype(np.float32)


@pytest.mark.parametrize("seed", range(2))
def test_nms_against_jax_and_brute_force(seed):
    rng = np.random.default_rng(seed)
    n = 60
    boxes = _boxes(rng, n)
    boxes[5] = boxes[3]                       # an identical box
    scores = rng.uniform(0, 1, n).astype(np.float32)
    scores[10:20] = 0.5                       # ties: input order decides
    valid = rng.uniform(0, 1, n) > 0.2
    cats = rng.integers(0, 3, n).astype(np.int32)
    for thr in (0.0, 0.3, 0.7):
        got = _np(tnms.nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores), thr))
        assert np.array_equal(got, np.asarray(jnms.nms_mask(boxes, scores, thr)))
        assert np.array_equal(got, _greedy(boxes, scores, thr))
        got_v = _np(tnms.nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores), thr,
                                  torch.from_numpy(valid)))
        assert np.array_equal(got_v, np.asarray(jnms.nms_mask(boxes, scores, thr, valid)))
        assert np.array_equal(got_v, _greedy(boxes, scores, thr, valid))
        got_b = _np(tnms.batched_nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores),
                                          torch.from_numpy(cats), thr))
        assert np.array_equal(got_b, np.asarray(jnms.batched_nms_mask(boxes, scores, cats, thr)))
    iou = _np(tnms.box_iou(torch.from_numpy(boxes), torch.from_numpy(boxes)))
    np.testing.assert_allclose(iou, np.asarray(jnms.box_iou(boxes, boxes)), atol=1e-7, rtol=0)
    assert np.array_equal(iou, iou.T)         # the greedy pass relies on it, bit for bit
    assert _np(tnms.batched_nms_mask(torch.zeros((0, 4)), torch.zeros(0),
                                     torch.zeros(0, dtype=torch.int32), 0.5)).shape == (0,)


# ---------------------------------------------------------------------------
# RLE, small regions, the native CCL
# ---------------------------------------------------------------------------


def _masks(rng, b=5, h=37, w=29):
    m = rng.uniform(0, 1, (b, h, w)) > 0.6
    m[0] = False
    m[1] = True
    return m


@pytest.mark.parametrize("use_native", [True, False])
def test_rle_against_jax(use_native):
    rng = np.random.default_rng(0)
    masks = _masks(rng)
    got = trle.mask_to_rle(masks, use_native=use_native)
    assert got == jrle.mask_to_rle(masks, use_native=False)
    for m, r in zip(masks, got):
        assert np.array_equal(trle.rle_to_mask(r), m)
        assert trle.area_from_rle(r) == jrle.area_from_rle(r) == int(m.sum())
        coco = trle.coco_encode_rle(r)
        assert coco == jrle.coco_encode_rle(r)
        assert trle.coco_decode_rle(coco) == jrle.coco_decode_rle(coco) == r
        assert np.array_equal(native.rle_decode(r["counts"], *m.shape), m)


def test_rle_native_build_fails_loudly(monkeypatch):
    """With the native codec asked for and unbuildable, the call raises; it
    does not drop to numpy."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "library_path", lambda: Path("/nonexistent/lib.so"))
    monkeypatch.setattr(native, "SOURCE", Path("/nonexistent/sctb_native.cpp"))
    with pytest.raises(RuntimeError, match="missing"):
        trle.mask_to_rle(np.ones((1, 4, 4), bool))
    assert trle.mask_to_rle(np.ones((1, 4, 4), bool), use_native=False)[0]["counts"] == [0, 16]
    with pytest.raises(RuntimeError, match="cv2"):
        tregions.remove_small_regions(np.ones((4, 4), bool), 3, "holes")


@pytest.mark.parametrize("mode", ["holes", "islands"])
@pytest.mark.parametrize("thresh", [3, 20, 10_000])
def test_remove_small_regions_against_jax(mode, thresh):
    rng = np.random.default_rng(7)
    for m in _masks(rng, b=4, h=41, w=33):
        got, changed = tregions.remove_small_regions(m, thresh, mode)
        want, jchanged = jregions.remove_small_regions(m, thresh, mode)
        assert changed == jchanged and np.array_equal(got, want)


def test_native_ccl_areas_against_scipy():
    from scipy import ndimage

    rng = np.random.default_rng(3)
    for m in _masks(rng, b=6, h=53, w=47):
        labels, areas = native.connected_components_with_areas(m)
        ref, n = ndimage.label(m, structure=np.ones((3, 3), int))
        assert len(areas) == n + 1 and areas[0] == int((~m).sum())
        assert sorted(areas[1:].tolist()) == sorted(np.bincount(ref.ravel())[1:].tolist())
        # the same partition: label pairs correspond one to one
        pairs = set(zip(labels[m].tolist(), ref[m].tolist()))
        assert len(pairs) == n and (labels[~m] == 0).all()


def test_the_library_lives_in_the_port():
    assert native.library_path().parent == Path(tmo.__file__).resolve().parent.parent / "_build"
    assert native.SOURCE.read_bytes() == (Path(jrle.__file__).resolve().parent.parent.parent
                                          / "native" / "sctb_native.cpp").read_bytes()


# ---------------------------------------------------------------------------
# mask ops and resize
# ---------------------------------------------------------------------------


def test_mask_ops_against_jax():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((3, 4, 20, 24)).astype(np.float32)
    logits[0, 0] = -5.0                        # an empty union: 0/0
    got = _np(tmo.calculate_stability_score(torch.from_numpy(logits), 0.0, 1.0))
    want = np.asarray(jmo.calculate_stability_score(logits, 0.0, 1.0))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~np.isnan(got)], want[~np.isnan(want)])
    boxes = rng.integers(0, 200, (30, 4)).astype(np.int32)
    for crop, orig in (([0, 0, 256, 200], [0, 0, 256, 200]), ([64, 40, 256, 200],
                                                               [0, 0, 256, 200])):
        assert np.array_equal(_np(tmo.is_box_near_crop_edge(torch.from_numpy(boxes), crop, orig)),
                              np.asarray(jmo.is_box_near_crop_edge(boxes, crop, orig)))
        assert np.array_equal(_np(tmo.uncrop_boxes_xyxy(torch.from_numpy(boxes), crop)),
                              np.asarray(jmo.uncrop_boxes_xyxy(boxes, crop)))
        pts = rng.uniform(0, 100, (7, 2)).astype(np.float32)
        assert np.array_equal(_np(tmo.uncrop_points(torch.from_numpy(pts), crop)),
                              np.asarray(jmo.uncrop_points(pts, crop)))
        m = rng.uniform(0, 1, (2, crop[3] - crop[1], crop[2] - crop[0])) > 0.5
        assert np.array_equal(_np(tmo.uncrop_masks(torch.from_numpy(m), crop, 200, 256)),
                              np.asarray(jmo.uncrop_masks(m, crop, 200, 256)))
    assert np.array_equal(_np(tmo.box_xyxy_to_xywh(torch.from_numpy(boxes))),
                          np.asarray(jmo.box_xyxy_to_xywh(boxes)))
    for n, layers, scale in ((32, 0, 1), (16, 2, 2), (5, 1, 1)):
        for a, b in zip(tmo.build_all_layer_point_grids(n, layers, scale),
                        jmo.build_all_layer_point_grids(n, layers, scale)):
            assert np.array_equal(a, b)
    for size, layers, ratio in (((200, 256), 1, 512 / 1500), ((1024, 716), 2, 0.3)):
        assert tmo.generate_crop_boxes(size, layers, ratio) == \
            jmo.generate_crop_boxes(size, layers, ratio)
    assert [list(map(list, b)) for b in tmo.batch_iterator(3, list(range(7)), list("abcdefg"))] \
        == [list(map(list, b)) for b in jmo.batch_iterator(3, list(range(7)), list("abcdefg"))]
    with pytest.raises(ValueError):
        list(tmo.batch_iterator(2, [1, 2], [1]))


# (in, out) sizes where ``F.interpolate``'s nearest-exact indices are not
# JAX's fp32 rule (found by search), and sizes of the pipeline
NEAREST_SIZES = [((2, 2), (141, 159)), ((2, 3), (165, 5)), ((200, 120), (384, 224)),
                 ((384, 224), (1024, 597)), ((37, 29), (13, 11))]


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("in_hw, out_hw", NEAREST_SIZES)
def test_resize_nearest_against_jax(in_hw, out_hw, exact):
    x = np.arange(in_hw[0] * in_hw[1], dtype=np.float32).reshape(1, *in_hw)
    got = _np(tresize.resize_nearest(torch.from_numpy(x), out_hw, exact=exact))
    assert np.array_equal(got, np.asarray(jresize.resize_nearest(x, out_hw, exact=exact)))


def test_the_index_rule_is_not_interpolates():
    x = torch.arange(2, dtype=torch.float32).reshape(1, 1, 1, 2)
    ours = tresize.resize_nearest(x, (1, 141))
    theirs = torch.nn.functional.interpolate(x, size=(1, 141), mode="nearest-exact")
    assert not torch.equal(ours, theirs)


def test_apply_coords_and_boxes_against_jax():
    rng = np.random.default_rng(2)
    coords = rng.uniform(0, 300, (4, 3, 2)).astype(np.float32)
    boxes = rng.uniform(0, 300, (5, 4)).astype(np.float32)
    for size in ((200, 256), (1600, 1119), (333, 77)):
        assert np.array_equal(_np(tresize.apply_coords(coords, size, 1024)),
                              np.asarray(jresize.apply_coords(coords, size, 1024)))
        assert np.array_equal(_np(tresize.apply_boxes(boxes, size, 1024)),
                              np.asarray(jresize.apply_boxes(boxes, size, 1024)))


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_cli_amg_cpu_both_output_modes(tmp_path, image):
    import cv2

    ckpt = tmp_path / "vit_t.pth"
    torch.save({k: torch.from_numpy(v) for k, v in _raw_golden().items()}, ckpt)
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    cv2.imwrite(str(imgs / "a.png"), image[..., ::-1])
    (imgs / "notes.txt").write_text("not an image")
    knobs = ["--points-per-side", "4", "--pred-iou-thresh", "-10", "--stability-score-thresh",
             "0", "--box-nms-thresh", "0.9"]
    base = ["--input", str(imgs), "--model-type", "vit_t", "--checkpoint", str(ckpt), *knobs]
    tcli.main([*base, "--output", str(tmp_path / "png"), "--cpu"])
    jcli.main([*base, "--output", str(tmp_path / "png_jax"), "--cpu"])
    got = (tmp_path / "png" / "a" / "metadata.csv").read_text().splitlines()
    want = (tmp_path / "png_jax" / "a" / "metadata.csv").read_text().splitlines()
    assert len(got) == len(want) > 1 and got[0] == want[0]
    for row, jrow in zip(got[1:], want[1:]):
        np.testing.assert_allclose(np.array(row.split(","), float),
                                   np.array(jrow.split(","), float), atol=TOL, rtol=0)
    for i in range(len(got) - 1):
        assert np.array_equal(cv2.imread(str(tmp_path / "png" / "a" / f"{i}.png")),
                              cv2.imread(str(tmp_path / "png_jax" / "a" / f"{i}.png")))
    tcli.main([*base, "--output", str(tmp_path / "rle"), "--cpu", "--convert-to-rle"])
    recs = json.loads((tmp_path / "rle" / "a.json").read_text())
    assert len(recs) == len(got) - 1 and isinstance(recs[0]["segmentation"]["counts"], str)
    # --multihost without a coordinator or torchrun's environment: no group to join
    with pytest.raises(ValueError, match="torchrun"):
        tcli.main([*base, "--output", str(tmp_path / "x"), "--multihost"])
