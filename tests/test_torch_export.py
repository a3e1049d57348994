"""The port's decoder export (``samcarriestheburden_torch/export/``,
``cli/export_decoder.py``) against the JAX package's (``export/``,
``cli/export_decoder.py``) on the CPU.

* the wire codec's round trips (the cases of ``tests/test_onnx_export.py``);
* ``models/convert.py:sam_params_from_state_dict`` the exact inverse of
  ``sam_state_dict_from_jax``;
* the ONNX graph's bytes equal to the JAX package's for the same weights,
  in the three flag cases and int8 (``quantize_min_size=64``: the golden
  vit_t has no weight above the default gate of 1024 elements);
* the eager program against JAX ``make_decoder_fn`` at atol = rtol = 3e-4
  (the JAX ONNX test's tolerance between two fp32 programs), the pre-padding
  size and the areas exact;
* one symbolic ``torch.export`` artifact at (b, n) = (1, 2), (3, 5), (2, 7)
  against the eager program at 1e-5;
* the bf16 and int8 weight modes: the dequantized weights bit for bit equal
  to JAX ``dequantize_params(quantize_params(p))``, the masks of the
  quantized artifacts (the cases of ``tests/test_embeddings_export.py:154``);
* the CLI in both formats with ``--validate --cpu``; its ``.onnx`` bytes
  equal to the JAX CLI's.

The golden vit_t weights (``tests/golden/sam_e2e.npz``) serve every case but
two, which need weights above the int8 gate and an artifact whose weights
outweigh its graph: the decoder at its published width (transformer 256,
64 x 64 embeddings), with seeded weights and a tiny image encoder.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samcarriestheburden_torch.cli import export_decoder as tcli
from samcarriestheburden_torch.config import MaskDecoderConfig, PromptEncoderConfig
from samcarriestheburden_torch.config import sam_vit_t_config
from samcarriestheburden_torch.export import onnx_proto as P
from samcarriestheburden_torch.export import program as tprog
from samcarriestheburden_torch.export.onnx_eval import evaluate_graph, evaluate_model
from samcarriestheburden_torch.export.onnx_graph import GraphBuilder, build_decoder_graph
from samcarriestheburden_torch.models.convert import (sam_params_from_state_dict,
                                                      sam_state_dict_from_jax,
                                                      sam_state_dict_from_torch)
from samcarriestheburden_torch.models.sam import build_sam
from samcarriestheburden_tpu.cli import export_decoder as jcli
from samcarriestheburden_tpu.config import sam_vit_t_config as jax_vit_t_config
from samcarriestheburden_tpu.export import stablehlo as jprog
from samcarriestheburden_tpu.export.onnx_graph import build_decoder_graph as jax_build_graph
from samcarriestheburden_tpu.models import convert as jconvert
from samcarriestheburden_tpu.models.sam import SamModel as JaxSamModel

# the tier-1 command runs six xdist workers on the machine's cores: one
# intra-op thread each, or their thread pools oversubscribe the cores
torch.set_num_threads(1)

GOLDEN = Path(__file__).parent / "golden"
FLAGS = [(False, False, False), (True, False, False), (True, True, True)]
PROGRAM_TOL = 3e-4
ARTIFACT_TOL = 1e-5
DECODER = ("prompt_encoder.", "mask_decoder.")


def _names(extra):
    return ["masks", "prepadded_size", "iou_predictions"] \
        + (["stability_scores", "areas"] if extra else []) + ["low_res_masks"]


@pytest.fixture(scope="module")
def golden():
    """(port SamModel on the CPU, JAX SamModel) on the golden vit_t weights."""
    data = np.load(GOLDEN / "sam_e2e.npz")
    sd = {k[3:]: data[k] for k in data.files if k.startswith("sd/")}
    port = build_sam(sam_vit_t_config(), device="cpu", state_dict=sam_state_dict_from_torch(sd))
    jax_model = JaxSamModel(cfg=jax_vit_t_config(),
                            params=jconvert.sam_params_from_torch(sd, jax_vit_t_config()))
    return port, jax_model


@pytest.fixture(scope="module")
def full_width():
    """The decoder at its published width (seeded weights, seed 3) behind a
    tiny image encoder, on the CPU."""
    base = sam_vit_t_config(img_size=1024)
    cfg = base.replace(image_encoder=base.image_encoder.replace(out_chans=256),
                       prompt_encoder=PromptEncoderConfig(), mask_decoder=MaskDecoderConfig())
    return build_sam(cfg, device="cpu", seed=3)


def _feeds(b, n, model, rng):
    """Seeded decoder inputs (``tests/test_onnx_export.py:_feeds``): labels
    in -1..3 as float (the ONNX interface), random masks and gates."""
    emb = model.cfg.prompt_encoder.image_embedding_size
    g4 = emb[0] * 4
    td = model.cfg.mask_decoder.transformer_dim
    return {
        "image_embeddings": rng.standard_normal((1, td, *emb)).astype(np.float32),
        "point_coords": rng.uniform(0, model.img_size, (b, n, 2)).astype(np.float32),
        "point_labels": rng.integers(-1, 4, (b, n)).astype(np.float32),
        "mask_input": rng.standard_normal((b, 1, g4, g4)).astype(np.float32),
        "has_mask_input": (rng.random(b) > 0.5).astype(np.float32),
        "orig_im_size": np.asarray([200, 150], np.int32),
    }


def _args(feeds):
    """The program's positional inputs as tensors (labels int32)."""
    a = [torch.from_numpy(feeds[k]) for k in tprog.INPUT_NAMES]
    a[2] = a[2].to(torch.int32)
    return tuple(a)


def _run(fn, feeds):
    with torch.no_grad():
        return [o.numpy() for o in fn(*_args(feeds))]


# ---------------------------------------------------------------------------
# the wire codec (tests/test_onnx_export.py:33,49,70)
# ---------------------------------------------------------------------------


def test_tensor_roundtrip_dtypes_and_scalars():
    rng = np.random.default_rng(0)
    for arr in [rng.standard_normal((3, 4)).astype(np.float32),
                rng.integers(-5, 5, (2, 2, 2)).astype(np.int64),
                np.asarray(0.25, np.float32), np.asarray(-7, np.int64),
                (rng.random(8) > 0.5), rng.integers(0, 255, (5,)).astype(np.uint8),
                np.float16(rng.standard_normal((4,)))]:
        name, back = P.parse_tensor(P.make_tensor("t", np.asarray(arr)))
        assert name == "t"
        assert back.shape == np.asarray(arr).shape
        assert back.dtype == np.asarray(arr).dtype
        np.testing.assert_array_equal(back, arr)


def test_model_roundtrip_full_graph():
    g = GraphBuilder("round")
    x = g.input("x", np.float32, ("b", 4))
    w = g.const(np.arange(8, dtype=np.float32).reshape(4, 2), "w")
    y = g.op("Relu", g.op("MatMul", x, w), out="y")
    g.output("y", np.float32, ("b", 2))
    m = P.parse_model(g.model_bytes(opset=17, doc="d"))
    assert m["ir_version"] == 8 and m["opset_import"] == [("", 17)]
    graph = m["graph"]
    assert graph["name"] == "round"
    assert [n["op_type"] for n in graph["nodes"]] == ["MatMul", "Relu"]
    assert graph["inputs"][0]["shape"] == ["b", 4]
    assert graph["outputs"][0]["name"] == y
    np.testing.assert_array_equal(graph["initializers"]["w"],
                                  np.arange(8, dtype=np.float32).reshape(4, 2))
    out = evaluate_graph(graph, {"x": np.asarray([[1., 1., 1., 1.]], np.float32)})
    np.testing.assert_allclose(out["y"], [[12.0, 16.0]])


def test_attribute_roundtrip():
    node = P.make_node("Op", ["a"], ["b"], f=0.5, i=-3, s="mode", ints=[1, -2, 3],
                       floats=[0.25, 0.5], strings=["x", "y"], t=np.asarray([[1, 2]], np.int64))
    at = P._parse_node(node)["attrs"]
    assert at["f"] == 0.5 and at["i"] == -3 and at["s"] == "mode"
    assert at["ints"] == [1, -2, 3] and at["floats"] == [0.25, 0.5]
    assert at["strings"] == ["x", "y"]
    np.testing.assert_array_equal(at["t"], [[1, 2]])


# ---------------------------------------------------------------------------
# the parameter tree and the ONNX bytes
# ---------------------------------------------------------------------------


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        assert all(isinstance(k, str) for k in tree)
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def test_params_from_state_dict_inverts_state_dict_from_jax():
    data = np.load(GOLDEN / "sam_e2e.npz")
    sd = {k[3:]: data[k] for k in data.files if k.startswith("sd/")}
    p = jconvert.sam_params_from_torch(sd, jax_vit_t_config())
    back = sam_params_from_state_dict(sam_state_dict_from_jax(p, sam_vit_t_config()),
                                      sam_vit_t_config())
    want, got = list(_leaves(p)), list(_leaves(back))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (path, a), (_, b) in zip(want, got):
        assert np.asarray(a).dtype == b.dtype == np.float32, path
        np.testing.assert_array_equal(b, a, err_msg=str(path))


@pytest.mark.parametrize("single,stab,extra,quantize", [
    *[(*f, None) for f in FLAGS], (True, False, False, "int8")])
def test_onnx_bytes_equal_the_jax_package(golden, single, stab, extra, quantize):
    port, jax_model = golden
    kw = dict(return_single_mask=single, use_stability_score=stab, return_extra_metrics=extra,
              quantize=quantize, quantize_min_size=64)
    got = build_decoder_graph(port, **kw).model_bytes()
    assert got == jax_build_graph(jax_model, **kw).model_bytes()
    if quantize:
        assert any(n["op_type"] == "DequantizeLinear"
                   for n in P.parse_model(got)["graph"]["nodes"])


def test_onnx_graph_matches_the_eager_program(golden):
    port, _ = golden
    feeds = _feeds(3, 5, port, np.random.default_rng(0))
    got = evaluate_model(build_decoder_graph(port, True, True, True).model_bytes(), feeds)
    ref = _run(tprog.make_decoder_fn(port, True, True, True), feeds)
    for name, r in zip(_names(True), ref):
        np.testing.assert_allclose(np.asarray(got[name], np.float64), r.astype(np.float64),
                                   atol=PROGRAM_TOL, rtol=PROGRAM_TOL, err_msg=name)


# ---------------------------------------------------------------------------
# the program against the JAX program, and the torch.export artifact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("single,stab,extra", FLAGS)
def test_program_matches_jax_make_decoder_fn(golden, single, stab, extra):
    port, jax_model = golden
    feeds = _feeds(3, 5, port, np.random.default_rng(0))
    fn = jprog.make_decoder_fn(jax_model, return_single_mask=single, use_stability_score=stab,
                               return_extra_metrics=extra)
    jargs = [jnp.asarray(feeds[k]) for k in tprog.INPUT_NAMES]
    jargs[2] = jargs[2].astype(jnp.int32)
    ref = [np.asarray(r) for r in fn(jax_model.params, *jargs)]
    got = _run(tprog.make_decoder_fn(port, single, stab, extra), feeds)
    names = _names(extra)
    assert len(got) == len(ref) == len(names)
    for name, g, r in zip(names, got, ref):
        assert g.shape == r.shape, name
        if name in ("prepadded_size", "areas"):
            np.testing.assert_array_equal(g, r, err_msg=name)
        else:
            np.testing.assert_allclose(g, r, atol=PROGRAM_TOL, rtol=PROGRAM_TOL, err_msg=name)


def test_symbolic_artifact_runs_at_three_shapes(golden, tmp_path):
    port, _ = golden
    path = tprog.export_decoder(port, tmp_path / "dec.pt2", return_single_mask=True,
                                use_stability_score=True, return_extra_metrics=True)
    loaded = tprog.load_exported(path)
    eager = tprog.make_decoder_fn(port, True, True, True)
    for i, (b, n) in enumerate([(1, 2), (3, 5), (2, 7)]):
        feeds = _feeds(b, n, port, np.random.default_rng(10 + i))
        got, ref = _run(loaded, feeds), _run(eager, feeds)
        assert got[0].shape == (b, 1, port.img_size, port.img_size)
        for name, g, r in zip(_names(True), got, ref):
            assert g.shape == r.shape and g.dtype == r.dtype, name
            np.testing.assert_allclose(g, r, atol=ARTIFACT_TOL, rtol=ARTIFACT_TOL, err_msg=name)


# ---------------------------------------------------------------------------
# the weight modes
# ---------------------------------------------------------------------------


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_numpy(v) for v in tree]
    return np.asarray(tree)


@pytest.mark.parametrize("weights", ["golden", "full_width"])
@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_dequantized_weights_equal_the_jax_package(golden, full_width, weights, mode):
    model = golden[0] if weights == "golden" else full_width
    sd = {k: v for k, v in model.state_dict().items() if k.startswith(DECODER)}
    qsd = tprog.quantize_state_dict(sd, mode)
    if weights == "full_width" and mode == "int8":
        grouped = [k for k, v in qsd.items() if isinstance(v, dict)
                   and "output_hypernetworks_mlps" in k]
        assert len(grouped) == 4 * 3       # four tokens' three layers, one scale a layer
    got = tprog.dequantize_state_dict(qsd)
    p = sam_params_from_state_dict(model.state_dict(), model.cfg)
    jq = jprog.dequantize_params(jprog.quantize_params(p, mode))
    want = sam_state_dict_from_jax(_to_numpy(jq), model.cfg)
    assert sorted(got) == sorted(k for k in want if k.startswith(DECODER))
    for k in got:
        assert got[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k]), k


def test_bf16_artifact_is_smaller(full_width, tmp_path):
    f32 = tprog.export_decoder(full_width, tmp_path / "f32.pt2", return_single_mask=True,
                               batch=1, num_points=2)
    bf16 = tprog.export_decoder(full_width, tmp_path / "bf16.pt2", return_single_mask=True,
                                batch=1, num_points=2, quantize="bf16")
    assert bf16.stat().st_size < 0.75 * f32.stat().st_size, \
        (bf16.stat().st_size, f32.stat().st_size)


def test_quantized_artifacts_agree_with_fp32(golden, tmp_path):
    port, _ = golden
    rng = np.random.default_rng(0)
    feeds = {"image_embeddings": rng.standard_normal((1, 16, 8, 8)).astype(np.float32),
             "point_coords": rng.uniform(0, 128, (1, 2, 2)).astype(np.float32),
             "point_labels": np.ones((1, 2), np.float32),
             "mask_input": np.zeros((1, 1, 32, 32), np.float32),
             "has_mask_input": np.zeros((1,), np.float32),
             "orig_im_size": np.asarray([600, 800], np.int32)}
    # the fp32 reference is the eager program, which the fp32 artifact equals
    # (test_symbolic_artifact_runs_at_three_shapes)
    ref = _run(tprog.make_decoder_fn(port, True), feeds)
    assert ref[1].tolist() == [96, 128]
    for mode in ("bf16", "int8"):
        outs = _run(tprog.load_exported(tprog.export_decoder(
            port, tmp_path / f"{mode}.pt2", return_single_mask=True, batch=1, num_points=2,
            quantize=mode)), feeds)
        thr = port.mask_threshold
        agree = ((outs[0] > thr) == (ref[0] > thr)).mean()
        assert agree >= 0.99, f"{mode}: mask agreement {agree:.4f}"
        np.testing.assert_allclose(outs[2], ref[2], atol=0.1)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_cli_both_formats_against_the_jax_cli(golden, tmp_path):
    """A JAX-format ``.npz`` written by the JAX package's ``save_params``
    (``tests/test_onnx_export.py:268`` writes ``sam.init``'s weights, which
    take JAX ~17 s to draw on the CPU; the golden weights here)."""
    from samcarriestheburden_tpu.models.modelio import save_params

    ckpt = tmp_path / "tiny.npz"
    save_params(ckpt, golden[1].params)
    base = ["--checkpoint", str(ckpt), "--model-type", "vit_t", "--return-single-mask", "--cpu"]
    onnx = tcli.main(base + ["--output", str(tmp_path / "port.onnx"), "--format", "onnx",
                             "--validate"])
    jcli.main(base + ["--output", str(tmp_path / "jax.onnx"), "--format", "onnx"])
    assert onnx.read_bytes() == (tmp_path / "jax.onnx").read_bytes()
    m = P.parse_model(onnx.read_bytes())
    assert [i["name"] for i in m["graph"]["inputs"]] == list(tprog.INPUT_NAMES)
    assert [o["name"] for o in m["graph"]["outputs"]] == _names(False)

    pt2 = tcli.main(base + ["--output", str(tmp_path / "port.pt2"), "--validate"])
    assert pt2.exists() and pt2.stat().st_size > 1000
    with pytest.raises(SystemExit):
        tcli.main(base + ["--output", str(tmp_path / "x.onnx"), "--format", "onnx",
                          "--quantize", "bf16"])
