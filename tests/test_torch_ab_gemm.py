"""The GEMM A/B tool (``samcarriestheburden_torch/tools/ab_gemm.py``), the
encoder profile tool (``tools/profile_encoder.py``) and K12's head-sum scratch
(``kernels/attention.py:window_block_scratch``) on the CPU.

The tool's kernels run only on the card; here its input builder, its cases
(each kernel's wrapper, which takes its plain version for a CPU tensor) and
its digest are held at a small size: the inputs are the same for the same
seed, every case is the plain function on those inputs (K13 ``x * 2.0`` bit
for bit), the int8 product's digest is
the digest of the exact integer product, and a one-step change of one
output changes the digest.  K12's scratch is sized and strided as the
kernel writes it, and its head slices summed in head order, as the kernel's
rounding pass sums them, give the plain version's output bit for bit (fp32,
vit_t's widths).
"""

import numpy as np
import pytest
import torch

from samcarriestheburden_torch.config import sam_vit_t_config
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


def test_k12_scratch_is_one_slice_per_head_in_the_kernels_layout():
    (xn, *_), kw = vit_t_windows()
    wb, n, e = xn.shape
    heads = kw["heads"]
    acc = attn_k.window_block_scratch(wb, n, e, heads, xn.device)
    assert acc.shape == (heads, wb, n, e) and acc.dtype == torch.float32
    assert acc.is_contiguous() and acc.stride() == (wb * n * e, n * e, e, 1)
    # the block of (window w, head h) writes from element (h * nwin + w) * n * E
    for h in range(heads):
        for w in (0, wb - 1):
            assert acc[h, w].data_ptr() - acc.data_ptr() == (h * wb + w) * n * e * 4


def test_k12_head_slices_summed_in_order_are_the_plain_version():
    """Each head's share (the plain version with the projection's other heads'
    columns zeroed: exact in fp32) in its slice of the scratch, summed in
    head order from 0 as the rounding pass sums them: the plain version's
    output, bit for bit."""
    (xn, qkv_w, qkv_b, proj_w, tables), kw = vit_t_windows()
    wb, n, e = xn.shape
    heads, hd = kw["heads"], e // kw["heads"]
    acc = attn_k.window_block_scratch(wb, n, e, heads, xn.device)
    for h in range(heads):
        wp = torch.zeros_like(proj_w)
        wp[:, h * hd:(h + 1) * hd] = proj_w[:, h * hd:(h + 1) * hd]
        acc[h] = attn_k.window_block_attention_plain(xn, qkv_w, qkv_b, wp, tables, **kw)
    total = torch.zeros((wb, n, e))
    for h in range(heads):
        total = total + acc[h]
    want = attn_k.window_block_attention_plain(xn, qkv_w, qkv_b, proj_w, tables, **kw)
    assert torch.equal(total, want)
    assert torch.equal(attn_k.window_block_attention(xn, qkv_w, qkv_b, proj_w, tables, **kw),
                       want)
