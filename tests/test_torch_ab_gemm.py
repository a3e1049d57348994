"""The GEMM A/B tool (``samcarriestheburden_torch/tools/ab_gemm.py``), the
encoder profile tool (``tools/profile_encoder.py``) and K12's cluster and
head sum (``kernels/attention.py:window_block_geometry``) on the CPU.

The tool's kernels run only on the card; here its input builder, its cases
(each kernel's wrapper, which takes its plain version for a CPU tensor) and
its digest are held at a small size: the inputs are the same for the same
seed, every case is the plain function on those inputs (K13 ``x * 2.0`` bit
for bit), the int8 product's digest is
the digest of the exact integer product, and a one-step change of one
output changes the digest.  K12's cluster gives every head to one block and
the output columns to the blocks once, in ranges of multiples of 8, at every
preset's widths; the kernel's order of arithmetic (every head's output
rounded to bf16, then one fp32 product over K = E in head order, rounded
once) stays within K12's tolerance of the plain version on vit_t's windows.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from samcarriestheburden_torch.config import (sam_vit_b_config, sam_vit_h_config,
                                              sam_vit_l_config, sam_vit_t_config)
from samcarriestheburden_torch.kernels import attention as attn_k
from samcarriestheburden_torch.kernels import gemm as gemm_k
from samcarriestheburden_torch.kernels import quant as quant_k
from samcarriestheburden_torch.tools import ab_attention, ab_gemm, profile_encoder

torch.set_num_threads(1)

SMALL = dict(t=40, e=64, m=256, o=48, rows=(16, 40))
MLP_ROWS = (24, 40)


def small_cases(v):
    return ab_gemm.cases(v, t=SMALL["t"], rows=SMALL["rows"], mlp_rows=MLP_ROWS)


def test_the_inputs_are_the_seeds():
    a, b = ab_gemm.inputs("cpu", **SMALL), ab_gemm.inputs("cpu", **SMALL)
    other = ab_gemm.inputs("cpu", **SMALL, seed=1)
    assert list(a) == list(b)
    for k in a:
        x, y = (a[k], b[k]) if isinstance(a[k], tuple) else ((a[k],), (b[k],))
        assert all(torch.equal(p, q) for p, q in zip(x, y)), k
    assert not torch.equal(a["x"], other["x"])
    assert a["x"].shape == (40, 64) and a["x"].dtype == torch.bfloat16
    assert a["wqkv"][0].shape == (48, 64) and a["wqkv"][0].dtype == torch.int8
    assert a["w2"][0].shape == (64, 256) and a["w2"][1].shape == (64,)
    assert 0.0 < a["mask"].float().mean().item() < 1.0


def test_the_weights_are_quantized_as_the_port_quantizes():
    v = ab_gemm.inputs("cpu", **SMALL)
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.standard_normal((48, 64), dtype=np.float32))
    s = w.abs().amax(dim=1, keepdim=True).clamp(min=1e-12) / 127.0
    ours = torch.round(w / s).clamp(-127, 127).to(torch.int8), s[:, 0]
    theirs = quant_k.quantize_weight(w)
    assert torch.equal(ours[0], theirs[0]) and torch.equal(ours[1], theirs[1])
    wq, sw = v["w1"]
    assert wq.abs().max().item() == 127 and (sw > 0).all()


def test_every_case_is_its_plain_version_on_the_cpu():
    v = ab_gemm.inputs("cpu", **SMALL)
    calls = small_cases(v)
    mlp_cases = [f"K{k} {r}" for r in MLP_ROWS for k in (1, 3)]
    assert list(calls) == ["K14 bf16->fp32", "K14 bf16->bf16", "K14 int8->int32",
                           "K2 16", "K4 16", "K2 40", "K4 40", "K15 2 chunks erf div",
                           "K15 8 chunks erf div", "K15 8 chunks sigmoid recip",
                           *mlp_cases, "K13 128x128"]
    mlp = (v["g"], v["b"], *v["w1"], v["b1"], *v["w2"], v["b2"])
    want = {
        "K14 bf16->fp32": gemm_k.dot_plain(v["a"], v["w"], torch.float32),
        "K14 int8->int32": gemm_k.dot_plain(v["aq"], v["wq"], torch.int32),
        "K2 16": quant_k.ln_masked_linear_int8_plain(v["x"][:16], v["mask"][:16], v["g"],
                                                     v["b"], *v["wqkv"], v["bqkv"]),
        "K4 40": quant_k.ln_mlp_residual_int8_plain(v["x"], *mlp, add=v["add"]),
        "K15 8 chunks sigmoid recip": quant_k.ln_mlp_residual_int8_exp_plain(
            v["x"], *mlp, chunks=8, act="sigmoid", rq="recip"),
    }
    for name, ref in want.items():
        out = calls[name]()
        assert out.dtype == ref.dtype and torch.equal(out, ref), name
    assert calls["K2 40"]().shape == (40, 48) and calls["K4 16"]().shape == (16, 64)


def test_the_k1_k3_and_k13_cases_are_their_plain_versions_on_the_cpu():
    """K1 (with the pad mask) and K3 (with ``add``) on the first rows of the
    seeded inputs, and K13 on its (128, 128) probe: each the plain version on those inputs, bit for bit
    (K13: ``x * 2.0``); K1 and K3 on the row counts asked for."""
    from samcarriestheburden_torch.kernels import mlp as mlp_k

    v = ab_gemm.inputs("cpu", **SMALL)
    assert v["wqkv_bf"].shape == (48, 64) and v["wqkv_bf"].dtype == torch.bfloat16
    assert v["w1_bf"].shape == (256, 64) and v["w2_bf"].shape == (64, 256)
    assert v["probe"].shape == ab_gemm.K13_SHAPE and v["probe"].dtype == torch.bfloat16
    calls = small_cases(v)
    bf = (v["g"], v["b"], v["w1_bf"], v["b1"], v["w2_bf"], v["b2"])
    for r in MLP_ROWS:
        k1 = mlp_k.ln_masked_linear_plain(v["x"][:r], v["mask"][:r], v["g"], v["b"],
                                          v["wqkv_bf"], v["bqkv"])
        k3 = mlp_k.ln_mlp_residual_plain(v["x"][:r], *bf, add=v["add"][:r])
        assert k1.shape == (r, 48) and k3.shape == (r, 64) and k3.dtype == torch.bfloat16
        assert torch.equal(calls[f"K1 {r}"](), k1), r
        assert torch.equal(calls[f"K3 {r}"](), k3), r
    probe = calls["K13 128x128"]()
    assert torch.equal(probe.view(torch.int16), (v["probe"] * 2.0).view(torch.int16))


def test_the_digest_is_the_sum_of_the_raw_bits():
    v = ab_gemm.inputs("cpu", **SMALL)
    calls = small_cases(v)
    exact = v["aq"].numpy().astype(np.int64) @ v["wq"].numpy().astype(np.int64).T
    assert ab_gemm.digest(calls["K14 int8->int32"]()) == int(exact.astype(np.int32).sum())
    out = calls["K2 40"]()
    assert ab_gemm.digest(out) == int(out.view(torch.int16).long().sum())
    moved = out.clone()
    moved.view(torch.int16)[3, 5] += 1                  # one bf16 step
    assert ab_gemm.digest(moved) == ab_gemm.digest(out) + 1
    f = calls["K14 bf16->fp32"]()
    assert ab_gemm.digest(f) == int(f.view(torch.int32).long().sum())


def test_the_ab_tool_runs_on_the_card_only(monkeypatch):
    """``ab_gemm`` raises before it starts a turn when there is no card, as
    the turn runner it shares with ``ab_attention`` does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(ab_attention.subprocess, "run", None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ab_gemm.run(".")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ab_attention.run_turns(ab_gemm.TURN, ".", ".", "ab_gemm", 1)


def test_the_encoder_profile_runs_on_the_card_only(monkeypatch):
    """``tools/profile_encoder`` (the serving encoder's device time by kernel)
    raises before it builds a model when there is no card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(profile_encoder, "build_sam", None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_encoder.main(["--batch", "1", "--quantize", "int8"])


def vit_t_windows():
    """vit_t's windowed attention: 8 windows of 5 x 5 tokens (two images of
    an 8 x 8 grid, padded to 10 x 10), width 32 in 2 heads, fp32, seeded."""
    enc = sam_vit_t_config().image_encoder
    ws, e, heads = enc.window_size, enc.embed_dim, enc.num_heads
    grid = enc.img_size // enc.patch_size
    wb = 2 * (-(-grid // ws)) ** 2
    rng = np.random.default_rng(0)

    def normal(*shape, std=1.0):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * std)

    return (normal(wb, ws * ws, e), normal(3 * e, e, std=e ** -0.5), normal(3 * e, std=0.1),
            normal(e, e, std=e ** -0.5), normal(2 * (2 * ws - 1), e // heads, std=0.3)), \
        dict(ws=ws, heads=heads)


#: K12's tolerance against its plain version (chip_smoke.py: KERNEL_TOL["K12"])
K12_TOL = 1.6e-2
PRESETS = {"vit_h": sam_vit_h_config, "vit_l": sam_vit_l_config, "vit_b": sam_vit_b_config,
           "vit_t": sam_vit_t_config}


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_k12_cluster_owns_every_head_and_column_once(preset):
    """Block r of a window's cluster owns heads r * HB .. and output columns
    r * E / C ..: every head in exactly one block, the column ranges tiling E
    once, each a multiple of 8 wide (the wgmma N); the preset's head dim and
    heads per block are one of the kernel's instances, and the cluster fits
    one (portable) cluster of at most 8 blocks."""
    enc = PRESETS[preset]().image_encoder
    e, heads = enc.embed_dim, enc.num_heads
    c, per_block, cols = attn_k.window_block_geometry(e, heads)
    assert 1 <= c <= 8 and heads % c == 0 and per_block * c == heads
    owners = [h // per_block for h in range(heads)]
    assert sorted(set(owners)) == list(range(c))
    assert all(owners.count(r) == per_block for r in range(c))
    ranges = [range(r * cols, (r + 1) * cols) for r in range(c)]
    assert sorted(x for r in ranges for x in r) == list(range(e))
    assert cols % 8 == 0 and cols == per_block * (e // heads)
    assert (e // heads, per_block) in attn_k.BLOCK_INSTANCES and e % 32 == 0
    # block r's output columns are its own heads' columns of O
    for r in range(c):
        assert ranges[r][0] // (e // heads) == r * per_block


def test_k12_order_of_arithmetic_is_within_its_tolerance():
    """On vit_t's windows in bf16: every head's output rounded to bf16 (the
    plain version with the identity as projection: each head's output in its
    own columns, exactly), then one fp32 product over K = E in head order,
    rounded once, as the kernel's cluster computes it, lies within K12's
    tolerance of the plain version, which sums the heads' products one by
    one; ``window_block_attention`` on CPU tensors is the plain version."""
    (xn, qkv_w, qkv_b, proj_w, tables), kw = vit_t_windows()
    bf = torch.bfloat16
    xn, qkv_w, proj_w, tables = (t.to(bf) for t in (xn, qkv_w, proj_w, tables))
    e = xn.shape[-1]
    heads_out = attn_k.window_block_attention_plain(xn, qkv_w, qkv_b, torch.eye(e, dtype=bf),
                                                    tables, **kw)
    assert heads_out.dtype == bf and heads_out.shape == xn.shape
    ours = (heads_out.float() @ proj_w.float().T).to(bf)
    want = attn_k.window_block_attention_plain(xn, qkv_w, qkv_b, proj_w, tables, **kw)
    ref = want.float().abs().max().item()
    err = (ours.float() - want.float()).abs().max().item()
    assert ref > 0.1 and err <= K12_TOL * ref, (err, ref)
    assert not torch.equal(heads_out, torch.zeros_like(heads_out))
    got = attn_k.window_block_attention(xn, qkv_w, qkv_b, proj_w, tables, **kw)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_k12_stack_frames_are_read_per_instance():
    """``chip_smoke.stack_frames`` reads each K12 instance's stack frame from
    ``-Xptxas -v``'s report (the "Function properties" line's, not the
    cumulative stack size) and no other kernel's; the build phase holds the
    three instances to ``K12_MAX_STACK``."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    k12 = "_ZN12_GLOBAL__N_122block_attention_kernelILi{}ELi{}EEEv14CUtensorMap_st"
    report = []
    for (hd, hb), frame in zip(attn_k.BLOCK_INSTANCES, (0, 16, 640)):
        f = k12.format(hd, hb)
        report += [f"ptxas info    : Compiling entry function '{f}' for 'sm_90a'",
                   f"ptxas info    : Function properties for {f}",
                   f"    {frame} bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
                   f"ptxas info    : Used 255 registers, used 1 barriers, {frame + 8} bytes "
                   "cumulative stack size"]
    report += ["ptxas info    : Compiling entry function '_Z11round_kernelPKfPfi' for 'sm_90a'",
               "ptxas info    : Function properties for _Z11round_kernelPKfPfi",
               "    96 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"]
    frames = cs.stack_frames("\n".join(report), "block_attention_kernel")
    assert frames == {k12.format(80, 2): 640, k12.format(64, 2): 16, k12.format(16, 1): 0}
    assert cs.K12_MAX_STACK == 0
