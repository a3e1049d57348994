"""The port's profiling and timing tools (``samcarriestheburden_torch/tools/
profile_enhance.py``, ``exp_ccl.py``, ``refine_roofline.py``,
``encoder_ab.py``, ``rect_overhead.py``, ``bench_configs.py``) on the CPU at
vit_t sizes: their inputs against the JAX scripts' where those scripts run
here (``tools/exp_ccl.py:make_masks``, loaded by path), their counts against
the shapes the decode really makes, their groupings on recorded CPU
profiles, and the JSON of ``bench_configs --smoke --cpu`` against the JAX
tool's keys.  Times here are the CPU's and are not checked.
"""

import ast
import functools
import importlib.util
import inspect
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from samcarriestheburden_torch.config import N_CLASSES, sam_vit_t_config
from samcarriestheburden_torch.kernels import attention as attn_k
from samcarriestheburden_torch.kernels import ccl as kccl
from samcarriestheburden_torch.models.sam import build_sam
from samcarriestheburden_torch.ops import ccl as tccl
from samcarriestheburden_torch.tools import (bench_configs, encoder_ab, exp_ccl,
                                             profile_enhance, rect_overhead, refine_roofline)

# the tier-1 command runs six xdist workers on the machine's cores: one
# intra-op thread each, or their thread pools oversubscribe the cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


def _load_script(name: str, monkeypatch):
    """The JAX script ``tools/<name>.py`` as a module of its own (its
    ``sys.path`` inserts undone when ``monkeypatch`` ends)."""
    monkeypatch.setattr(sys, "path", list(sys.path))
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def model():
    return build_sam(sam_vit_t_config(), device="cpu", seed=0)


def _line_of(module, text: str) -> str:
    """``<file in the package>:<line>`` of the first source line holding ``text``."""
    path = Path(inspect.getsourcefile(module))
    n = next(i for i, line in enumerate(path.read_text().splitlines(), 1) if text in line)
    return f"{path.relative_to(ROOT / 'samcarriestheburden_torch').as_posix()}:{n}"


# ---------------------------------------------------------------------------
# 6b: exp_ccl
# ---------------------------------------------------------------------------


def test_exp_ccl_masks_are_the_jax_tools(monkeypatch):
    jax_tool = _load_script("exp_ccl", monkeypatch)
    for batch, hw in ((2, (384, 224)), (1, (48, 32))):
        np.testing.assert_array_equal(exp_ccl.make_masks(batch, N_CLASSES, hw),
                                      jax_tool.make_masks(batch, N_CLASSES, hw))


def test_exp_ccl_methods_give_equal_labels():
    res = exp_ccl.exp_ccl(CPU, batch=1, iters=1, hw=(48, 32))
    assert list(res) == list(exp_ccl.METHODS)
    assert all(r["labels_equal"] and r["ms"] > 0 for r in res.values())
    masks = torch.from_numpy(exp_ccl.make_masks(1, N_CLASSES, (48, 32))).reshape(-1, 48, 32)
    labels = [exp_ccl.method_fn(m)(masks, 48 * 32) for m in exp_ccl.METHODS]
    assert labels[0].max() > 0 and all(torch.equal(labels[0], x) for x in labels[1:])
    assert torch.equal(labels[0], tccl.connected_components(masks, 48 * 32))


# ---------------------------------------------------------------------------
# 6a: profile_enhance
# ---------------------------------------------------------------------------


def test_profile_enhance_groups_a_recorded_cpu_profile_by_port_line(model):
    enh, probs, stems = profile_enhance.make_enhance(model, 2, CPU, grid=(48, 32))
    assert probs.shape == (2, N_CLASSES, 48, 32)
    res = profile_enhance.profile_call(lambda: enh.enhance_batch(probs, stems), CPU, top=8)
    by_line = res["by_line"]
    pool = _line_of(kccl, "cur = F.max_pool2d(cur, 3")
    hist = _line_of(tccl, "areas = torch.bincount(")
    assert "aten::max_pool2d_with_indices" in by_line[pool], by_line.get(pool)
    assert "aten::bincount" in by_line[hist], by_line.get(hist)
    assert all(not line.startswith("tools/") and ":" in line for line in by_line)
    assert 0 < res["attributed_ms"] <= res["busy_lines_ms"]
    assert res["lines"][0][1] == max(sum(v.values()) for v in by_line.values())
    assert set(res["families"]) == set(profile_enhance.FAMILIES)
    # the launchers of an operator name are the lines that ran it
    assert dict(profile_enhance.launchers(by_line, "aten::bincount"))[hist] > 0


def test_line_mode_names_the_innermost_port_frame():
    from torch.profiler import ProfilerActivity, profile

    x = torch.rand(1, 3, 6, 5)
    with profile(activities=[ProfilerActivity.CPU]) as prof, profile_enhance.LineMode():
        tccl.remove_all_but_one_connected_component(x, "largest", 4)
    recs = profile_enhance.line_records(prof.events(), "cpu")
    lines = {line for line, _, _ in recs}
    assert _line_of(tccl, "areas = torch.bincount(") in lines
    assert all(us > 0 for _, _, us in recs)
    grouped = profile_enhance.group_by_line([("a.py:1", "k", 1500.0), ("a.py:1", "k", 500.0),
                                             ("b.py:2", "j", 250.0)])
    assert grouped == {"a.py:1": {"k": 2.0}, "b.py:2": {"j": 0.25}}


# ---------------------------------------------------------------------------
# 6c: refine_roofline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,n", [(N_CLASSES, refine_roofline.N_POINTS), (3, 5)])
def test_roofline_flops_equal_the_analytic_count(model, b, n):
    inputs = refine_roofline.decode_inputs(model, CPU, b, n)
    counted = refine_roofline.count_flops(model, inputs)
    analytic = refine_roofline.analytic_flops(model.cfg, b, n)
    assert counted == sum(analytic.values()), (counted, analytic)
    assert all(p.requires_grad for p in model.parameters())     # restored after counting


class _Outputs(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else [out]):
            if isinstance(t, torch.Tensor):
                self.seen.add((tuple(t.shape), t.dtype))
        return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roofline_bytes_count_the_tensors_the_decode_makes(model, dtype):
    b = N_CLASSES
    inputs = refine_roofline.decode_inputs(model, CPU, b)
    mode = _Outputs()
    with torch.no_grad(), mode:
        refine_roofline.decode(model, *inputs, dtype=dtype)
    tensors = refine_roofline.dominant_tensors(model.cfg, b, dtype)
    for rnd, named in tensors.items():
        for name, (shape, dt, _) in named.items():
            assert (shape, dt) in mode.seen, (rnd, name, shape, dt)
    counted = refine_roofline.hand_bytes(model.cfg, b, dtype)
    for rnd, named in tensors.items():
        for name, (shape, dt, accesses) in named.items():
            assert counted[rnd][name] == int(np.prod(shape)) * dt.itemsize * accesses


def test_roofline_on_the_cpu_counts_without_a_device_rate(model):
    res = refine_roofline.refine_roofline(CPU, model=model, dtypes=("fp32",))["fp32"]
    assert res["flops"] == res["analytic_flops"] and res["bytes"] > 0
    assert "ms" not in res and "tflops" not in res


# ---------------------------------------------------------------------------
# 6d: encoder_ab; 6e: rect_overhead
# ---------------------------------------------------------------------------


def test_encoder_ab_turns_and_layouts(model):
    assert encoder_ab.combos(encoder_ab.FORMULATIONS, ("on", "off"), ("int8", "none")) == [
        ("flat", "on", "int8"), ("flat", "on", "none"), ("flat", "off", "int8"),
        ("flat", "off", "none"), ("v1", "off", "none"), ("v2", "off", "none"),
        ("v3", "off", "none")]
    res = encoder_ab.encoder_ab(CPU, model=model, batch=2, formulations=encoder_ab.FORMULATIONS,
                                iters=1, input_hw=(128, 90))
    assert len(res) == 7 and all(len(r["ms"]) == 2 for r in res.values())
    # the layouts the port's tests hold equal (tests/test_torch_compact.py,
    # test_torch_variants.py): compact against flat in fp32, and every
    # formulation against the flat path
    assert res["flat off none"]["max_diff"] <= 2e-5
    for key in ("v1 off none", "v2 off none", "v3 off none"):
        assert res[key]["max_diff"] <= 2e-5, (key, res[key]["max_diff"])
    emb = res["flat on none"]["embedding"]
    assert emb.shape == (2, 16, 8, 8) and torch.isfinite(emb).all()


def test_encoder_parts(model):
    res = encoder_ab.parts(CPU, model=model, batch=2, iters=1)
    groups = [k for k in res if k.startswith(("K5 compact", "K6 compact"))]
    assert len(groups) == 3 and res["compact attention total"] == pytest.approx(
        sum(res[k] for k in groups))
    for name in ("bf16", "int8"):
        assert {f"{name} ln+qkv flat 256 rows", f"{name} mlp compact 160 rows"} <= set(res)
    assert {"partition flat", "partition compact", "unpartition flat",
            "unpartition compact"} <= set(res)


def test_rect_overhead_windows_and_their_materialised_form():
    cases = [(5, 3, 4), (3, 5, 2), (3, 3, 2)]
    assert rect_overhead.serving_cases() == [(14, 8, 8), (8, 14, 10)]
    res = rect_overhead.rect_overhead(CPU, cases=cases, heads=2, hd=16, ws=5, iters=1)
    assert list(res) == ["5x3, 4 windows", "3x5, 2 windows", "3x3, 2 windows"]
    assert all(r["k6_device_ms"] is None and r["k6_ms"] > 0 for r in res.values())
    for rh, rw, wb in cases:    # K6 equals K5 on the materialised windows at the live cells
        qkv, tables, bias = rect_overhead.inputs(rh, rw, wb, CPU, heads=2, hd=16, ws=5,
                                                 dtype=torch.float32)
        k6 = attn_k.rel_attention_window_rect(qkv, tables, bias, ws=5, rh=rh, rw=rw, heads=2,
                                              hd=16)
        k5 = attn_k.rel_attention_window(rect_overhead.materialised(qkv, bias, 5, rh, rw),
                                         tables, ws=5, heads=2, hd=16)
        live = k5[:, :25].view(wb, 5, 5, -1)[:, :rh, :rw].reshape(wb, rh * rw, -1)
        torch.testing.assert_close(k6[:, :rh * rw], live, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# 6f: bench_configs
# ---------------------------------------------------------------------------


def _jax_keys():
    """The string keys of every dict literal and subscript in the JAX tool,
    and the f-string prefix of its training keys."""
    tree = ast.parse((ROOT / "tools" / "bench_configs.py").read_text())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            keys |= {k.value for k in node.keys if isinstance(k, ast.Constant)}
        elif isinstance(node, ast.Subscript) and isinstance(node.slice, ast.Constant) \
                and isinstance(node.slice.value, str):
            keys.add(node.slice.value)
    return keys


def test_bench_configs_smoke_prints_the_jax_tools_keys(monkeypatch, capsys):
    from samcarriestheburden_torch import config

    # the U-Net at base 4 (the training CLIs' tests do the same): the smoke
    # run's shapes and keys, not its width, are under test
    monkeypatch.setattr(config, "UNetConfig", functools.partial(config.UNetConfig,
                                                                base_channels=4))
    out = bench_configs.main(["--smoke", "--cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == out
    want = {"platform", "model", "config3_refinement_sweep", "config4_unet_training",
            "config5_amg", "images_per_sec", "images_per_sec_batched", "img_batch",
            "n_images", "seg_hw", "sec_per_image", "points_per_side"}
    assert want <= _jax_keys()
    got = set(out) | {k for v in out.values() if isinstance(v, dict) for k in v}
    assert want <= got, want - got
    assert {"ms_per_step_aug0", "ms_per_step_aug0.5"} <= set(out["config4_unet_training"])
    assert out["platform"] == "cpu" and out["model"] == "vit_t"
    assert out["config3_refinement_sweep"]["seg_hw"] == [48, 32]
    assert out["config5_amg"]["points_per_side"] == 8
    assert "images_per_sec_h5" in out["config3_refinement_sweep"]     # h5py is here
