"""The port's compact ragged-window layout (the groups, the partition and its
masks, K6's plain version, the compact encoder in fp32 and in int8 mode, the
MedSAM encode entry point) against the JAX package on the CPU, its Pallas
kernels run in interpret mode.

Inputs are made with numpy from a seed and handed to both, in fp32 unless a
case says bf16.  Tolerances: atol 2e-4 in fp32 wherever two frameworks meet
(the JAX kernel tests' own bound, ``tests/test_kernels.py``); the int8
encoder as ``tests/test_torch_quant.py`` holds the flat one (flipped rounding
ties move single entries by up to ~1e-3 of a unit-scale output: max 5e-3,
median 2e-5); bf16 K6 at two bf16 ulps of the largest output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from samcarriestheburden_torch import kernels
from samcarriestheburden_torch.config import sam_vit_t_config
from samcarriestheburden_torch.engine.embeddings import (make_encode_batch,
                                                         make_encode_batch_medsam,
                                                         make_serving_encoder)
from samcarriestheburden_torch.kernels import attention as attn_k
from samcarriestheburden_torch.kernels import build
from samcarriestheburden_torch.models import image_encoder as tie
from samcarriestheburden_torch.models.convert import (encoder_pack_from_jax_prequantized,
                                                      sam_state_dict_from_jax)
from samcarriestheburden_torch.models.sam import build_sam
from samcarriestheburden_tpu.config import sam_vit_t_config as jax_vit_t_config
from samcarriestheburden_tpu.engine import embeddings as jemb
from samcarriestheburden_tpu.kernels import attention as jattn
from samcarriestheburden_tpu.models import convert as jconvert
from samcarriestheburden_tpu.models import image_encoder as jie
from samcarriestheburden_tpu.models import quantize as jq
from samcarriestheburden_tpu.models.sam import SamModel as JaxSamModel

# the tier-1 command runs six xdist workers on the machine's cores: one
# intra-op thread each, or their thread pools oversubscribe the cores
torch.set_num_threads(1)

ATOL = 2e-4
INT8_MAX, INT8_MEDIAN = 5e-3, 2e-5
CFG = sam_vit_t_config()
ENC = CFG.image_encoder
JCFG = jax_vit_t_config()
SIZE = ENC.img_size


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_numpy(v) for v in tree]
    return np.asarray(tree)


def _jax_params_and_model(seed, cfg=CFG, jcfg=JCFG, qkv_bias_mean=0.0):
    """Seeded random SAM weights as the JAX params pytree and as the port's
    model, the same numbers in both; rel tables large enough to matter, and
    a qkv bias that gives the pad keys real weight."""
    sd = {k: v.numpy().copy() for k, v in build_sam(cfg, device="cpu", seed=seed)
          .state_dict().items()}
    rs = np.random.default_rng(seed + 100)
    for k in sd:
        if k.endswith(("rel_pos_h", "rel_pos_w")):
            sd[k] *= 15.0
        if k.endswith("attn.qkv.bias"):
            sd[k] = (qkv_bias_mean + 0.3 * rs.standard_normal(sd[k].shape)).astype(np.float32)
    params = jconvert.sam_params_from_torch(sd, jcfg)
    model = build_sam(cfg, device="cpu", state_dict=sam_state_dict_from_jax(
        {k: _to_numpy(v) for k, v in params.items()}, cfg))
    return params, model


# ---------------------------------------------------------------------------
# the layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hww", [(64, 64, 14), (8, 8, 5), (12, 9, 5), (10, 15, 5), (3, 8, 5)],
                         ids=["vit_h", "vit_t", "ragged", "multiple", "short"])
def test_compact_window_groups_match_jax(hww):
    assert tie.compact_window_groups(*hww) == jie.compact_window_groups(*hww)


def test_compact_window_groups_at_vit_h_and_vit_t():
    groups = tie.compact_window_groups(64, 64, 14)
    assert [(g["rh"], g["rw"], g["nh"] * g["nw"], g["np"]) for g in groups] == \
        [(14, 14, 16, 200), (14, 8, 4, 112), (8, 14, 5, 112)]
    assert sum(g["nh"] * g["nw"] * g["np"] for g in groups) == 4208
    assert [r1 - r0 for _, r0, r1 in tie.compact_spans(groups, 2)] == [6400, 896, 1120]
    small = tie.compact_window_groups(8, 8, 5)
    assert [(g["rh"], g["rw"], g["nh"] * g["nw"], g["np"]) for g in small] == \
        [(5, 5, 1, 32), (5, 3, 1, 16), (3, 5, 2, 16)]
    assert len(tie.compact_window_groups(10, 15, 5)) == 1        # nothing ragged: interior only


@pytest.mark.parametrize("bhwc_ws", [(2, 8, 8, 6, 5), (2, 12, 9, 4, 5), (1, 64, 64, 2, 14),
                                     (3, 3, 8, 4, 5)],
                         ids=["vit_t", "ragged", "vit_h", "short"])
def test_partition_masks_and_unpartition_match_jax(rng, bhwc_ws):
    b, h, w, c, ws = bhwc_ws
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    groups = tie.compact_window_groups(h, w, ws)
    ref = jie.window_partition_compact(jnp.asarray(x), ws, jie.compact_window_groups(h, w, ws))
    ours = tie.window_partition_compact(_t(x), groups)
    assert len(ours) == len(ref) == len(groups)
    total = 0
    for g, x3, (ref3, ref_mask) in zip(groups, ours, ref):
        np.testing.assert_array_equal(x3.numpy(), np.asarray(ref3))
        mask = tie.compact_group_mask(g, h, w, torch.float32, "cpu")
        np.testing.assert_array_equal(mask.numpy(), jie._compact_group_mask(g, h, w))
        np.testing.assert_array_equal(mask.repeat(b, 1).reshape(-1, g["np"], 1).numpy(),
                                      np.asarray(ref_mask))
        assert (x3.reshape(-1, c)[mask.repeat(b, 1)[:, 0] == 0] == 0).all()
        total += b * int(mask.sum())
    assert total == b * h * w
    back = tie.window_unpartition_compact(ours, groups, b, (h, w))
    np.testing.assert_array_equal(back.numpy(), x)
    ref_back = jie.window_unpartition_compact([r for r, _ in ref], ws, groups, b, (h, w))
    np.testing.assert_array_equal(back.numpy(), np.asarray(ref_back))


def test_mask_zeroes_the_bottom_strips_slots_beyond_the_image():
    """ViT-H's bottom strip: window 5 holds columns 56-69, of which 64-69 are
    not image.  Its 112 slots are all carried (no alignment slot is dead), so
    only a mask that knows the image's width zeroes them."""
    strip = tie.compact_window_groups(64, 64, 14)[2]
    assert (strip["rh"], strip["rw"], strip["nw"], strip["np"]) == (8, 14, 5, 112)
    mask = tie.compact_group_mask(strip, 64, 64, torch.float32, "cpu").reshape(5, 8, 14)
    assert mask[:4].all()
    assert mask[4, :, :8].all() and not mask[4, :, 8:].any()


# ---------------------------------------------------------------------------
# K6
# ---------------------------------------------------------------------------


def _k6_case(rng, ws, rh, rw, heads, hd, wb=3, bias_mean=0.5):
    np_ = -(-(rh * rw) // 8) * 8
    qkv = rng.standard_normal((wb, np_, heads * 3 * hd)).astype(np.float32)
    rel_h = (0.3 * rng.standard_normal((2 * ws - 1, hd))).astype(np.float32)
    rel_w = (0.3 * rng.standard_normal((2 * ws - 1, hd))).astype(np.float32)
    bias = (bias_mean + 0.5 * rng.standard_normal(heads * 3 * hd)).astype(np.float32)
    return qkv, rel_h, rel_w, bias


def _pad_heads(a, heads, hd):
    """(..., heads*3*hd) -> the JAX layout, each head's group zero-padded to
    a multiple of 128 columns."""
    p = jattn._headmajor_pad(hd)
    x = a.reshape(*a.shape[:-1], heads, 3 * hd)
    x = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, p - 3 * hd)])
    return x.reshape(*a.shape[:-1], heads * p)


K6_SHAPES = [(5, 5, 3, 2, 16), (5, 3, 5, 2, 16), (14, 14, 8, 2, 80), (14, 8, 14, 2, 80)]
K6_IDS = ["ws5_5x3", "ws5_3x5", "ws14_14x8", "ws14_8x14"]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("shape", K6_SHAPES, ids=K6_IDS)
def test_k6_plain_matches_pallas(rng, shape, dtype):
    """vit_t's windows have 15 live of 16 slots (one dead query row, one dead
    key slot); ViT-H's 112 of 112.  bf16: both sides round q, k, v, the rel
    terms and the real keys' probabilities to bf16 at the same points; the
    sums between differ in order, so a value may land on the neighbouring
    bf16: two ulps of the largest output."""
    ws, rh, rw, heads, hd = shape
    qkv, rel_h, rel_w, bias = _k6_case(rng, ws, rh, rw, heads, hd)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    tcat = jattn.prepare_rel_tables_window3d(
        {"rel_pos_h": jnp.asarray(rel_h), "rel_pos_w": jnp.asarray(rel_w)}, ws, jdt)
    p = jattn._headmajor_pad(hd)
    ref = jattn.fused_rel_attention_window_rect(
        jnp.asarray(_pad_heads(qkv, heads, hd), jdt), tcat,
        jnp.asarray(_pad_heads(bias, heads, hd).reshape(heads, p), jdt),
        ws=ws, rh=rh, rw=rw, heads=heads, hd=hd, interpret=True)
    ref = np.asarray(ref.astype(jnp.float32)).transpose(1, 2, 0, 3).reshape(
        qkv.shape[0], qkv.shape[1], heads * hd)

    tables = attn_k.prepare_rel_tables(_t(rel_h), _t(rel_w), ws, ws, tdt)
    ours = attn_k.rel_attention_window_rect(_t(qkv).to(tdt), tables, _t(bias), ws=ws, rh=rh,
                                            rw=rw, heads=heads, hd=hd)
    assert ours.dtype == tdt and tuple(ours.shape) == ref.shape
    n = rh * rw
    atol = ATOL if dtype == "fp32" else 2 * 2.0 ** -8 * np.abs(ref[:, :n]).max()
    np.testing.assert_allclose(ours.float().numpy()[:, :n], ref[:, :n], atol=atol, rtol=0)
    assert torch.isfinite(ours).all()                      # dead query rows too


def _materialised_window(qkv, bias, ws, rh, rw):
    """The flat layout's window of a compact one: the carried slots at their
    cells, the qkv bias (a zero-masked row's projection) at every other cell,
    zeros in the 8-alignment dead slots."""
    wb, _, c = qkv.shape
    n = ws * ws
    full = np.zeros((wb, -(-n // 8) * 8, c), np.float32)
    full[:, :n] = bias
    grid = full[:, :n].reshape(wb, ws, ws, c)
    grid[:, :rh, :rw] = qkv[:, :rh * rw].reshape(wb, rh, rw, c)
    return full


@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("shape", K6_SHAPES, ids=K6_IDS)
def test_k6_plain_equals_k5_plain_on_the_padded_window(rng, shape, with_bias):
    """Same keys, reordered: the carried slots then the pad cells.  Without
    a qkv bias the pad keys are zero vectors and still take weight."""
    ws, rh, rw, heads, hd = shape
    qkv, rel_h, rel_w, bias = _k6_case(rng, ws, rh, rw, heads, hd)
    if not with_bias:
        bias = np.zeros_like(bias)
    tables = attn_k.prepare_rel_tables(_t(rel_h), _t(rel_w), ws, ws, torch.float32)
    ours = attn_k.rel_attention_window_rect_plain(_t(qkv), tables, _t(bias), ws=ws, rh=rh, rw=rw,
                                                  heads=heads, hd=hd)
    full = attn_k.rel_attention_window_plain(_t(_materialised_window(qkv, bias, ws, rh, rw)),
                                             tables, ws=ws, heads=heads, hd=hd)
    wb = qkv.shape[0]
    live = full[:, :ws * ws].reshape(wb, ws, ws, -1)[:, :rh, :rw].reshape(wb, rh * rw, -1)
    torch.testing.assert_close(ours[:, :rh * rw], live, rtol=0, atol=1e-5)
    # the pad keys carry real weight here: dropping them would not pass
    alone = attn_k.rel_attention_plain(_t(qkv), tables, heads=heads, hd=hd, kh=rh, kw=rw,
                                       nkeys=rh * rw) if rh == rw else None
    assert alone is None or not torch.allclose(alone, ours, atol=1e-3)


def test_k6_pad_keys_need_their_own_cells(rng):
    """Each pad key has its own rel terms: giving all of them one cell's, or
    none, moves the output far beyond the tolerance."""
    ws, rh, rw, heads, hd = 5, 5, 3, 2, 16
    qkv, rel_h, rel_w, bias = _k6_case(rng, ws, rh, rw, heads, hd)
    tables = attn_k.prepare_rel_tables(_t(rel_h), _t(rel_w), ws, ws, torch.float32)
    kw = dict(ws=ws, rh=rh, rw=rw, heads=heads, hd=hd)
    ours = attn_k.rel_attention_window_rect_plain(_t(qkv), tables, _t(bias), **kw)
    no_rel = attn_k.rel_attention_window_rect_plain(_t(qkv), torch.zeros_like(tables),
                                                    _t(bias), **kw)
    assert (ours - no_rel).abs().max() > 100 * ATOL
    assert attn_k.rect_pad_cells(5, 5, 3) == [(p, q) for p in range(5) for q in (3, 4)]
    assert len(attn_k.rect_pad_cells(14, 8, 14)) == len(attn_k.rect_pad_cells(14, 14, 8)) == 84


def test_k6_with_a_full_window_equals_k5(rng):
    ws, heads, hd = 5, 2, 16
    qkv, rel_h, rel_w, bias = _k6_case(rng, ws, ws, ws, heads, hd)
    tables = attn_k.prepare_rel_tables(_t(rel_h), _t(rel_w), ws, ws, torch.float32)
    k6 = attn_k.rel_attention_window_rect(_t(qkv), tables, _t(bias), ws=ws, rh=ws, rw=ws,
                                          heads=heads, hd=hd)
    k5 = attn_k.rel_attention_window(_t(qkv), tables, ws=ws, heads=heads, hd=hd)
    torch.testing.assert_close(k6, k5, rtol=0, atol=1e-6)
    assert attn_k.rect_pad_cells(ws, ws, ws) == []


def test_k6_wrapper_takes_the_plain_version_for_a_cpu_tensor_only(rng, monkeypatch):
    """A CPU tensor runs the plain version, writes into ``out`` where given,
    counts nothing and never reaches the build (which would raise here: no
    ``nvcc``); the kernel's argument check refuses what is not on the card."""
    def refuse(*a, **k):
        raise AssertionError("the CUDA build was reached for a CPU tensor")

    monkeypatch.setattr(build, "load", refuse)
    monkeypatch.setattr(build, "build", refuse)
    kernels.reset_launches()
    ws, rh, rw, heads, hd = 5, 3, 5, 2, 16
    qkv, rel_h, rel_w, bias = _k6_case(rng, ws, rh, rw, heads, hd)
    tables = attn_k.prepare_rel_tables(_t(rel_h), _t(rel_w), ws, ws, torch.float32)
    kw = dict(ws=ws, rh=rh, rw=rw, heads=heads, hd=hd)
    plain = attn_k.rel_attention_window_rect_plain(_t(qkv), tables, _t(bias), **kw)
    buf = torch.zeros(2 * plain.shape[0], *plain.shape[1:])
    view = buf[plain.shape[0]:]
    got = attn_k.rel_attention_window_rect(_t(qkv), tables, _t(bias), out=view, **kw)
    assert got.data_ptr() == view.data_ptr()
    torch.testing.assert_close(view, plain, rtol=0, atol=0)
    assert buf[:plain.shape[0]].abs().sum() == 0
    assert "K6" in kernels.LAUNCHES and all(v == 0 for v in kernels.LAUNCHES.values())
    with pytest.raises(ValueError, match="CUDA"):
        kernels.check_cuda("qkv_bias", _t(bias), bias.shape, torch.float32)
    assert tie.KERNEL_OPS.rel_attention_window_rect is attn_k.rel_attention_window_rect
    assert tie.KERNEL_OPS_INT8.rel_attention_window_rect is attn_k.rel_attention_window_rect
    for ops in (tie.PLAIN_OPS, tie.PLAIN_OPS_INT8):
        assert ops.rel_attention_window_rect is attn_k.rel_attention_window_rect_plain


# ---------------------------------------------------------------------------
# the compact encoder
# ---------------------------------------------------------------------------


def test_compact_encoder_matches_jax(rng):
    """vit_t in fp32, the port's compact path against JAX
    ``apply(compact_windows=True)`` (K1, K3, K5, K6, K7 as Pallas kernels in
    interpret mode); 8x8 tokens at ws=5 has every kind of group."""
    params, model = _jax_params_and_model(0, qkv_bias_mean=0.3)
    x = rng.standard_normal((2, 3, SIZE, SIZE)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = jie.apply(params["image_encoder"], JCFG.image_encoder, jnp.asarray(x),
                        fused_mlp=True, fused_qkv=True, scan_blocks=False,
                        compact_windows=True)
    ours = model.image_encoder(_t(x), compact_windows=True)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL)


def test_compact_int8_encoder_matches_jax_on_carried_weights(rng):
    """The int8 serving mode on the compact layout: a JAX prequantized pytree
    carried across (its fp32 qkv bias is K6's b_k, b_v), against JAX
    ``apply(quantize="int8", compact_windows=True)`` in interpret mode."""
    params, model = _jax_params_and_model(0, qkv_bias_mean=0.3)
    jpq = jq.prequantize_image_encoder(params["image_encoder"], JCFG.image_encoder)
    x = rng.standard_normal((1, 3, SIZE, SIZE)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jie.apply(jpq, JCFG.image_encoder, jnp.asarray(x), fused_mlp=True,
                                   fused_qkv=True, quantize="int8", scan_blocks=False,
                                   compact_windows=True))
    packed = encoder_pack_from_jax_prequantized(_to_numpy(jpq), ENC, torch.float32)
    assert packed[0]["qkv_b"].dtype == torch.float32
    ours = model.image_encoder(_t(x), packed=packed, ops=tie.KERNEL_OPS_INT8,
                               compact_windows=True).numpy()
    diff = np.abs(ours - ref)
    assert diff.max() <= INT8_MAX and np.median(diff) <= INT8_MEDIAN, \
        (diff.max(), np.median(diff))
    fp = model.image_encoder(_t(x), compact_windows=True).numpy()
    rel = np.abs(ours - fp).max() / np.abs(fp).max()
    assert 1e-5 < rel < 0.06, rel                          # quantization happened


@pytest.mark.parametrize("quantize", [None, "int8"], ids=["fp32", "int8"])
def test_compact_matches_flat(rng, quantize):
    """The port's compact path against its flat path: the same function at
    every image position (fp32: rounding only; int8: the two paths' softmax
    sums differ in order, so a rounding tie may flip)."""
    _, model = _jax_params_and_model(1, qkv_bias_mean=0.3)
    x = _t(rng.standard_normal((2, 3, SIZE, SIZE)).astype(np.float32))
    ops = tie.default_ops(quantize)
    packed = model.image_encoder.pack(torch.float32, quantize=quantize)
    flat = model.image_encoder(x, packed=packed, ops=ops, compact_windows=False)
    compact = model.image_encoder(x, packed=packed, ops=ops, compact_windows=True)
    diff = (flat - compact).abs().numpy()
    if quantize is None:
        assert diff.max() <= 2e-5, diff.max()
    else:
        assert diff.max() <= INT8_MAX and np.median(diff) <= INT8_MEDIAN, \
            (diff.max(), np.median(diff))


def _counting_ops(ops, calls):
    def counted(name, fn):
        def call(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        return call
    return tie.EncoderOps(*(counted(n, f) for n, f in zip(tie.EncoderOps._fields[:5], ops)),
                          int8=ops.int8)


def test_compact_windows_none_means_on_and_false_is_the_flat_path(rng):
    """``compact_windows=None`` (the default) runs the compact layout, as the
    JAX package does on its accelerator; ``False`` gives the flat path's
    result bit for bit."""
    _, model = _jax_params_and_model(2)
    imgs = _t(rng.integers(0, 256, (2, 3, SIZE, SIZE)).astype(np.uint8))
    sizes = _t(np.array([[SIZE, 96], [100, SIZE]], np.int32))
    packed = model.image_encoder.pack(torch.float32)
    outs, calls = {}, {}
    for cw in (None, True, False):
        calls[cw] = {}
        encode = make_encode_batch(model, torch.float32, compact_windows=cw,
                                   ops=_counting_ops(tie.KERNEL_OPS, calls[cw]))
        outs[cw] = encode(packed, imgs, sizes)
    torch.testing.assert_close(outs[None], outs[True], rtol=0, atol=0)
    assert calls[None] == calls[True] and calls[None]["rel_attention_window_rect"] == 2
    assert calls[None]["rel_attention_window"] == 1 and calls[None]["ln_masked_linear"] == 2
    assert "rel_attention_window_rect" not in calls[False]

    mean = torch.tensor(CFG.pixel_mean).view(1, 3, 1, 1)
    std = torch.tensor(CFG.pixel_std).view(1, 3, 1, 1)
    ih = torch.arange(SIZE)
    valid = (ih[None, :, None] < sizes[:, 0, None, None]) & (ih[None, None, :]
                                                             < sizes[:, 1, None, None])
    x = ((imgs.float() - mean) / std) * valid[:, None]
    torch.testing.assert_close(outs[False], model.image_encoder(x), rtol=0, atol=0)
    torch.testing.assert_close(outs[None], outs[False], rtol=0, atol=2e-5)

    serve, served = make_serving_encoder(model, torch.float32)
    torch.testing.assert_close(serve(served, imgs, sizes), outs[None], rtol=0, atol=0)
    serve, served = make_serving_encoder(model, torch.float32, compact_windows=False)
    torch.testing.assert_close(serve(served, imgs, sizes), outs[False], rtol=0, atol=0)


def test_a_grid_that_is_a_window_multiple_takes_the_flat_path(rng):
    """10x10 tokens at ws=5: no pad token to drop, so ``compact_windows``
    changes nothing and K6 is never called (JAX ``apply``: ``h % ws or w % ws``)."""
    cfg = sam_vit_t_config(img_size=160)
    assert cfg.image_encoder.grid_size % cfg.image_encoder.window_size == 0
    model = build_sam(cfg, device="cpu", seed=4)
    x = _t(rng.standard_normal((1, 3, 160, 160)).astype(np.float32))
    calls = {}
    ops = _counting_ops(tie.KERNEL_OPS, calls)
    compact = model.image_encoder(x, ops=ops, compact_windows=True)
    assert "rel_attention_window_rect" not in calls and calls["rel_attention_window"] == 1
    torch.testing.assert_close(compact, model.image_encoder(x, compact_windows=False),
                               rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the MedSAM encode entry point
# ---------------------------------------------------------------------------


def _medsam_images(rng):
    imgs = rng.integers(30, 220, (2, 3, SIZE, SIZE)).astype(np.uint8)
    imgs[1] = 77                                            # a constant image: hi == lo
    return imgs


def test_medsam_encoder_matches_jax(rng):
    """Per-image min-max to [0, 1], no padding mask, then the same stack."""
    params, model = _jax_params_and_model(0, qkv_bias_mean=0.3)
    imgs = _medsam_images(rng)
    sizes = np.full((2, 2), SIZE, np.int32)
    ref = jemb.make_encode_batch_medsam(JaxSamModel(cfg=JCFG, params=params), jnp.float32)(
        params, jnp.asarray(imgs), jnp.asarray(sizes))
    encode, packed = make_serving_encoder(model, torch.float32, medsam=True)
    ours = encode(packed, _t(imgs), _t(sizes))
    assert tuple(ours.shape) == (2, ENC.out_chans, ENC.grid_size, ENC.grid_size)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL)
    # the same stack behind other preprocessing
    x = _t(imgs).float()
    lo, hi = x.amin(dim=(1, 2, 3), keepdim=True), x.amax(dim=(1, 2, 3), keepdim=True)
    same = model.image_encoder((x - lo) / (hi - lo).clamp(min=1e-8), compact_windows=True)
    torch.testing.assert_close(ours, same, rtol=0, atol=0)
    flat = make_encode_batch_medsam(model, torch.float32, compact_windows=False)(
        packed, _t(imgs))
    torch.testing.assert_close(flat, ours, rtol=0, atol=2e-5)
    standard, _ = make_serving_encoder(model, torch.float32)
    assert (standard(packed, _t(imgs), _t(sizes)) - ours).abs().max() > 1e-3


def test_medsam_int8_encoder_matches_jax(rng, monkeypatch):
    """The MedSAM int8 encoder: JAX ``make_serving_encoder(medsam=True,
    quantize="int8")`` as it runs on its accelerator (fused kernels, compact
    layout), here with the kernels in interpret mode."""
    params, model = _jax_params_and_model(0, qkv_bias_mean=0.3)
    imgs = _medsam_images(rng)[:1]
    sizes = np.full((1, 2), SIZE, np.int32)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    jencode, jparams = jemb.make_serving_encoder(
        JaxSamModel(cfg=JCFG, params=params), jnp.float32, quantize="int8", medsam=True,
        unroll_blocks=True)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jencode(jparams, jnp.asarray(imgs), jnp.asarray(sizes)))
    monkeypatch.undo()
    encode, packed = make_serving_encoder(model, torch.float32, quantize="int8", medsam=True)
    ours = encode(packed, _t(imgs), _t(sizes)).numpy()
    diff = np.abs(ours - ref)
    assert diff.max() <= INT8_MAX and np.median(diff) <= INT8_MEDIAN, \
        (diff.max(), np.median(diff))
    fp_encode, fp_packed = make_serving_encoder(model, torch.float32, medsam=True)
    fp = fp_encode(fp_packed, _t(imgs), _t(sizes)).numpy()
    rel = np.abs(ours - fp).max() / np.abs(fp).max()
    assert 1e-5 < rel < 0.06, rel
