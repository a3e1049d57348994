"""The port's int8 serving mode (K2, K4, K7-int8 plain versions, the weight
prequantization and the whole int8 encoder) against the JAX package on the
CPU: its plain-jnp mirrors and its Pallas kernels with ``interpret=True``.

Inputs are made with numpy from a seed and handed to both, in fp32.

Tolerances.  Both sides do the same arithmetic, and the integer products are
exact on both, but the fp32 values that get rounded to int8 (LayerNorm
outputs, GELU outputs, scaled queries) differ in their last bits between the
two frameworks (summation order of the statistics, fused multiply-adds).  A
value that sits on a rounding tie can then land one int8 step apart, which
moves an output by one step of one term of a 32- to 128-term product: at most
~2e-3 of max |JAX| here.  So each kernel is held to ``STEP_TOL`` x max |JAX|;
nearly all entries agree to fp32 rounding (checked as a median).  Quantization
itself moves the result by ~1e-2 of the maximum (checked: more than 1e-6, less
than ``QUANT_TOL``), so a missing or a wrong quantization step cannot pass.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from samcarriestheburden_torch import kernels
from samcarriestheburden_torch.config import sam_vit_t_config
from samcarriestheburden_torch.engine.embeddings import make_encode_batch, make_serving_encoder
from samcarriestheburden_torch.kernels import attention as attn_k
from samcarriestheburden_torch.kernels import mlp as mlp_k
from samcarriestheburden_torch.kernels import quant as quant_k
from samcarriestheburden_torch.models import image_encoder as tie
from samcarriestheburden_torch.models import quantize as tquant
from samcarriestheburden_torch.models.convert import (encoder_pack_from_jax_prequantized,
                                                      sam_state_dict_from_jax)
from samcarriestheburden_torch.models.sam import build_sam
from samcarriestheburden_tpu.config import sam_vit_t_config as jax_vit_t_config
from samcarriestheburden_tpu.kernels import attention as jattn
from samcarriestheburden_tpu.kernels import quant as jquant
from samcarriestheburden_tpu.models import convert as jconvert
from samcarriestheburden_tpu.models import image_encoder as jie
from samcarriestheburden_tpu.models import quantize as jq

# the tier-1 command runs six xdist workers on the machine's cores: one
# intra-op thread each, or their thread pools oversubscribe the cores
torch.set_num_threads(1)

STEP_TOL = 2e-3        # x max |JAX|: one flipped rounding tie
MEDIAN_TOL = 1e-5      # x max |JAX|: the typical entry agrees to fp32 rounding
QUANT_TOL = 0.06       # x max |fp|: the quantization error itself (JAX tests: 0.05-0.06)
CFG = sam_vit_t_config()
ENC = CFG.image_encoder
HEADS, HD, E = ENC.num_heads, ENC.head_dim, ENC.embed_dim
EPS = ENC.layer_norm_eps


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(ours, ref, what=""):
    """ours == ref up to flipped rounding ties (see the module docstring)."""
    ours, ref = np.asarray(ours, np.float32), np.asarray(ref, np.float32)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    scale = np.abs(ref).max()
    diff = np.abs(ours - ref)
    assert diff.max() <= STEP_TOL * scale, (what, diff.max(), scale)
    assert np.median(diff) <= MEDIAN_TOL * scale, (what, np.median(diff), scale)


def _quantized(ours_int8, ours_fp):
    """The int8 result differs from the floating-point one, by quantization error."""
    rel = np.abs(np.asarray(ours_int8) - np.asarray(ours_fp)).max() / np.abs(ours_fp).max()
    assert 1e-6 < rel < QUANT_TOL, rel


def _ln_params(rng, e):
    return (1 + 0.1 * rng.standard_normal(e)).astype(np.float32), \
        (0.1 * rng.standard_normal(e)).astype(np.float32)


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------


def test_quantize_weight_matches_jax(rng):
    w = (rng.standard_normal((E, 4 * E)) * rng.uniform(0.01, 2.0, 4 * E)).astype(np.float32)
    w[:, 3] = 0.0                                        # an all-zero channel: scale 1e-12 / 127
    w[5, 7] = np.abs(w[:, 7]).max() * 4                  # an outlier sets its channel's scale
    jwq, js = jquant.quantize_weight(jnp.asarray(w))     # JAX: (in, out)
    wq, s = quant_k.quantize_weight(_t(w.T))             # port: (out, in)
    assert wq.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(wq.numpy().T, np.asarray(jwq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js)[0])
    assert np.abs(wq.numpy()).max() == 127 and (wq.numpy()[3] == 0).all()


def test_row_quant_matches_jax(rng):
    x = (rng.standard_normal((24, 64)) * rng.uniform(0.01, 30.0, (24, 1))).astype(np.float32)
    x[2] = 0.0
    x[3, :4] = [0.5, 1.5, 2.5, -3.5]                     # ties once scaled: half to even
    x[3, 4] = 127.0
    x[3, 5:] = 0.0
    jxq, js = jquant._row_quant(jnp.asarray(x))
    xq, s = quant_k.row_quant(_t(x))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq).astype(np.float32))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(xq.numpy()[3, :5], [0, 2, 2, -4, 127])


@pytest.mark.parametrize("impl", ["poly", "erf"])
def test_gelu_matches_jax(rng, impl):
    h = np.concatenate([rng.standard_normal(4096) * 3, [-8.0, -4.5, 0.0, 4.5, 8.0]]
                       ).astype(np.float32)
    ref = np.asarray(jquant._gelu(jnp.asarray(h), impl))
    ours = quant_k.gelu_phi_poly(_t(h), impl).numpy()
    np.testing.assert_allclose(ours, ref, atol=2e-6)     # fp32 rounding of a 7-term Horner
    exact = torch.nn.functional.gelu(_t(h)).numpy()
    # the fit's own error (JAX: max 6.7e-4); the A&S erf is at fp32 resolution
    np.testing.assert_allclose(ours, exact, atol=1e-3 if impl == "poly" else 3e-6)


def test_gelu_rejects_unknown_impl():
    with pytest.raises(ValueError, match="gelu"):
        quant_k.gelu_phi_poly(torch.zeros(4), "tanh")
    with pytest.raises(ValueError, match="gelu"):
        quant_k.ln_mlp_residual_int8(torch.zeros(2, 4), *[None] * 8, gelu="tanh")


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------


def _k2_case(rng, masked):
    t, o = 96, 3 * E
    x = (rng.standard_normal((t, E)) * rng.uniform(0.1, 10.0, (t, 1))).astype(np.float32)
    mask = (rng.random((t, 1)) > 0.3).astype(np.float32) if masked \
        else np.ones((t, 1), np.float32)
    g, b = _ln_params(rng, E)
    w = (rng.standard_normal((E, o)) / np.sqrt(E)).astype(np.float32)
    bias = rng.standard_normal(o).astype(np.float32)
    return x, mask, g, b, w, bias


@pytest.mark.parametrize("reference", ["mirror", "pallas"])
@pytest.mark.parametrize("masked", [True, False])
def test_k2_plain_matches_jax(rng, masked, reference):
    x, mask, g, b, w, bias = _k2_case(rng, masked)
    jwq, js = jquant.quantize_weight(jnp.asarray(w))
    if reference == "mirror":
        ref = jquant.ln_masked_linear_int8_xla(x, mask, g, b, jwq, js, bias, eps=EPS)
    else:
        ref = jquant.fused_ln_masked_linear_int8(x, mask, g, b, jwq, js, bias, eps=EPS,
                                                 interpret=True)
    wq, s = quant_k.quantize_weight(_t(w.T))
    ours = quant_k.ln_masked_linear_int8(_t(x), _t(mask) if masked else None, _t(g), _t(b),
                                         wq, s, _t(bias), EPS)
    _close(ours.numpy(), ref, "K2")
    fp = mlp_k.ln_masked_linear(_t(x), _t(mask), _t(g), _t(b), _t(w.T), _t(bias), EPS)
    _quantized(ours.numpy(), fp.numpy())
    if masked:  # an all-zero row quantizes to zeros: its projection is the bias, exactly
        dead = mask[:, 0] == 0
        assert dead.any()
        np.testing.assert_array_equal(ours.numpy()[dead],
                                      np.broadcast_to(bias, (dead.sum(), bias.size)))


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reference", ["mirror", "pallas"])
@pytest.mark.parametrize("gelu", ["poly", "erf"])
@pytest.mark.parametrize("with_add", [False, True])
def test_k4_plain_matches_jax(rng, with_add, gelu, reference):
    t, m = 96, 4 * E
    x = (rng.standard_normal((t, E)) * rng.uniform(0.1, 10.0, (t, 1))).astype(np.float32)
    add = rng.standard_normal((t, E)).astype(np.float32) if with_add else None
    g, b = _ln_params(rng, E)
    w1 = (rng.standard_normal((E, m)) / np.sqrt(E)).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(m)).astype(np.float32)
    w2 = (rng.standard_normal((m, E)) / np.sqrt(m)).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(E)).astype(np.float32)
    jw1, js1 = jquant.quantize_weight(jnp.asarray(w1))
    jw2, js2 = jquant.quantize_weight(jnp.asarray(w2))
    jadd = None if add is None else jnp.asarray(add)
    if reference == "mirror":
        ref = jquant.ln_mlp_residual_int8_xla(jnp.asarray(x), g, b, jw1, js1, b1, jw2, js2, b2,
                                              jadd, eps=EPS, gelu=gelu)
    else:
        ref = jquant.fused_ln_mlp_residual_int8(jnp.asarray(x), g, b, jw1, js1, b1, jw2, js2,
                                                b2, jadd, eps=EPS, gelu=gelu, interpret=True)
    w1q, s1 = quant_k.quantize_weight(_t(w1.T))
    w2q, s2 = quant_k.quantize_weight(_t(w2.T))
    tadd = None if add is None else _t(add)
    ours = quant_k.ln_mlp_residual_int8(_t(x), _t(g), _t(b), w1q, s1, _t(b1), w2q, s2, _t(b2),
                                        add=tadd, eps=EPS, gelu=gelu)
    _close(ours.numpy(), ref, "K4")
    # against the MLP branch alone, so the residual does not hide the error
    s = x if add is None else x + add
    fp = mlp_k.ln_mlp_residual(_t(x), _t(g), _t(b), _t(w1.T), _t(b1), _t(w2.T), _t(b2),
                               add=tadd, eps=EPS)
    _quantized(ours.numpy() - s, fp.numpy() - s)


def test_k4_requantizes_a_zero_hidden_row_without_nan(rng):
    """lin1's weights and bias zero: the hidden is all zeros, its row scale
    the 1e-12 guard, and the output s + b2 exactly."""
    t, m = 8, 4 * E
    x = rng.standard_normal((t, E)).astype(np.float32)
    g, b = _ln_params(rng, E)
    w1q, s1 = quant_k.quantize_weight(torch.zeros(m, E))
    w2q, s2 = quant_k.quantize_weight(_t(rng.standard_normal((E, m)).astype(np.float32)))
    b2 = rng.standard_normal(E).astype(np.float32)
    out = quant_k.ln_mlp_residual_int8(_t(x), _t(g), _t(b), w1q, s1, torch.zeros(m), w2q, s2,
                                       _t(b2))
    np.testing.assert_array_equal(out.numpy(), x + b2)


# ---------------------------------------------------------------------------
# K7-int8
# ---------------------------------------------------------------------------


def _rel_tables(rng, kh, kw):
    return {"rel_pos_h": (0.3 * rng.standard_normal((2 * kh - 1, HD))).astype(np.float32),
            "rel_pos_w": (0.3 * rng.standard_normal((2 * kw - 1, HD))).astype(np.float32)}


def _to_jax_qkv(qkv):
    """(S, n, heads*3*hd) per-head [q|k|v] -> the JAX head-major layout with
    each head's group zero-padded to a multiple of 128 columns."""
    s, n, _ = qkv.shape
    p = jattn._headmajor_pad(HD)
    x = qkv.reshape(s, n, HEADS, 3 * HD)
    x = np.pad(x, ((0, 0), (0, 0), (0, 0), (0, p - 3 * HD)))
    return x.reshape(s, n, HEADS * p)


@pytest.mark.parametrize("reference", ["mirror", "pallas"])
def test_k7_int8_plain_matches_jax(rng, reference):
    kh = kw = ENC.grid_size
    b, n = 2, kh * kw
    # channels and rows of very different scale: the per-channel key scales and
    # the per-row query scales both matter
    qkv = (rng.standard_normal((b, n, HEADS, 3 * HD))
           * rng.uniform(0.2, 3.0, (1, 1, HEADS, 3 * HD))
           * rng.uniform(0.3, 2.0, (b, n, 1, 1))).astype(np.float32).reshape(b, n, -1)
    rel = _rel_tables(rng, kh, kw)
    jqkv = jnp.asarray(_to_jax_qkv(qkv))
    if reference == "pallas":
        tcat = jattn.prepare_rel_tables_window3d({k: jnp.asarray(v) for k, v in rel.items()},
                                                 kh, jnp.float32, ws_w=kw)
        ref = jattn.fused_rel_attention_global3d(jqkv, tcat, kh=kh, kw=kw, heads=HEADS, hd=HD,
                                                 q_block=32, int8_qk=True, interpret=True)
    else:
        rel_h, rel_w = jie._rel_bias_headmajor(
            jqkv.reshape(b * n, -1), {k: jnp.asarray(v) for k, v in rel.items()}, heads=HEADS,
            pad=jattn._headmajor_pad(HD), hd=HD, b=b, gh=kh, gw=kw, dtype=jnp.float32)
        ref = jie._headmajor_attention_xla(jqkv, rel_h, rel_w, heads=HEADS, hd=HD, kh=kh,
                                           kw=kw, int8_qk=True)
    ref = np.asarray(ref).transpose(1, 2, 0, 3).reshape(b, n, HEADS * HD)

    tables = attn_k.prepare_rel_tables(_t(rel["rel_pos_h"]), _t(rel["rel_pos_w"]), kh, kw,
                                       torch.float32)
    ours = attn_k.rel_attention_global(_t(qkv), tables, kh=kh, kw=kw, heads=HEADS, hd=HD,
                                       int8_qk=True)
    _close(ours.numpy(), ref, "K7-int8")
    fp = attn_k.rel_attention_global(_t(qkv), tables, kh=kh, kw=kw, heads=HEADS, hd=HD)
    _quantized(ours.numpy(), fp.numpy())


def test_k7_int8_product_is_the_folded_scale_arithmetic(rng):
    """Holds the port's product to the definition written out in numpy: key
    scales per (sequence, channel) over all keys, folded into q before its
    per-row quantization; an integer product; one row scale to undo both."""
    q = rng.standard_normal((2, 40, HD)).astype(np.float32) * 3
    k = (rng.standard_normal((2, 64, HD)) * rng.uniform(0.1, 4.0, HD)).astype(np.float32)
    sk = np.abs(k).max(1, keepdims=True) / np.float32(127.0) + np.float32(1e-12)
    ki = np.round(k / sk)
    qs = q * sk
    sq = np.abs(qs).max(-1, keepdims=True) / np.float32(127.0) + np.float32(1e-12)
    qi = np.round(qs / sq)
    want = np.einsum("snc,smc->snm", qi, ki) * sq
    got = attn_k.int8_qk_plain(_t(q), _t(k)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert np.abs(ki).max() == 127 and np.abs(qi).max() == 127
    err = np.abs(got - np.einsum("snc,smc->snm", q, k)).max()
    assert 1e-6 < err < 0.05 * np.abs(want).max()


# ---------------------------------------------------------------------------
# weights carried across, and the int8 encoder as a whole
# ---------------------------------------------------------------------------


def _jax_params_and_model(seed):
    """Seeded random SAM weights (rel tables large enough to matter) as the
    JAX params pytree and as the port's model, the same numbers in both."""
    sd = {k: v.numpy().copy() for k, v in build_sam(CFG, device="cpu", seed=seed)
          .state_dict().items()}
    for k in sd:
        if k.endswith(("rel_pos_h", "rel_pos_w")):
            sd[k] *= 15.0
    params = jconvert.sam_params_from_torch(sd, jax_vit_t_config())
    model = build_sam(CFG, device="cpu", state_dict=sam_state_dict_from_jax(
        {k: _to_numpy(v) for k, v in params.items()}, CFG))
    return params, model


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_numpy(v) for v in tree]
    return np.asarray(tree)


def _assert_packs_equal(a, b, scale_ulps=0):
    """Every entry equal; with ``scale_ulps`` the fp32 scales may differ by
    that many ulps and, where they do, an int8 weight by one step."""
    assert len(a) == len(b)
    for pa, pb in zip(a, b):
        assert sorted(pa) == sorted(pb)
        for k in pa:
            assert pa[k].dtype == pb[k].dtype and pa[k].shape == pb[k].shape, k
            if scale_ulps and k.endswith("_s"):
                torch.testing.assert_close(pa[k], pb[k], rtol=scale_ulps * 1.2e-7, atol=0)
            elif scale_ulps and k.endswith("_wq"):
                off = (pa[k].int() - pb[k].int()).abs()
                assert off.max() <= 1 and off.float().mean() < 1e-4, k
            else:
                assert torch.equal(pa[k], pb[k]), k


def test_prequantized_weights_carry_across_both_ways():
    """JAX quantized pytree -> port pack, and JAX fp params -> port model ->
    the port's own prequantization: the same int8 values and scales.

    Bit for bit against the JAX quantization as written (``_quantize_block``
    run op by op).  ``prequantize_image_encoder`` runs the same function under
    ``jit``, where XLA rewrites the division by the constant 127 into a
    product with its rounded reciprocal: its scales are within one ulp of
    those, and an int8 weight can differ by one step where a scale does."""
    params, model = _jax_params_and_model(0)
    jcfg = jax_vit_t_config().image_encoder
    own = tquant.prequantize_image_encoder(model.image_encoder, torch.float32)
    assert tquant.is_prequantized(own) and tquant.is_prequantized(own[0])
    assert not tquant.is_prequantized(model.image_encoder.pack(torch.float32))

    eager = dict(params["image_encoder"], blocks=[
        jq._quantize_block(b, jcfg.num_heads) for b in params["image_encoder"]["blocks"]])
    assert jq.is_prequantized(eager["blocks"][0])
    _assert_packs_equal(encoder_pack_from_jax_prequantized(_to_numpy(eager), ENC, torch.float32),
                        own)
    jitted = jq.prequantize_image_encoder(params["image_encoder"], jcfg)
    _assert_packs_equal(encoder_pack_from_jax_prequantized(_to_numpy(jitted), ENC, torch.float32),
                        own, scale_ulps=1)
    _assert_packs_equal(own, tquant.prequantize_sam(model, torch.float32))
    pk = own[0]
    assert pk["qkv_wq"].dtype == torch.int8 and tuple(pk["qkv_wq"].shape) == (3 * E, E)
    assert tuple(pk["lin1_wq"].shape) == (4 * E, E) and tuple(pk["lin2_wq"].shape) == (E, 4 * E)
    assert pk["qkv_s"].dtype == torch.float32 and tuple(pk["qkv_s"].shape) == (3 * E,)
    assert "qkv_w" not in pk and "lin1_w" not in pk and "lin2_w" not in pk
    for k in ("proj_w", "tables", "norm1_w", "lin1_b"):   # these stay floating point
        assert pk[k].dtype == torch.float32


def test_qkv_is_quantized_after_the_head_regrouping():
    """Per output channel, so regrouping and quantizing commute: the pack's
    qkv equals the regrouped quantization of the module's weight."""
    _, model = _jax_params_and_model(1)
    at = model.image_encoder.blocks[0].attn
    wq, s = quant_k.quantize_weight(at.qkv.weight.detach())
    gw, gs = attn_k.group_qkv_per_head(wq.float(), s, HEADS)
    pk = model.image_encoder.pack(torch.float32, quantize="int8")[0]
    assert torch.equal(pk["qkv_wq"], gw.to(torch.int8)) and torch.equal(pk["qkv_s"], gs)


@pytest.mark.parametrize("weights", ["carried", "own"])
def test_int8_encoder_matches_jax(rng, weights):
    """The int8 mode as a whole: the vit_t encoder in fp32 through
    ``make_serving_encoder(..., quantize="int8")`` against the JAX encoder on
    its prequantized pytree through the plain-jnp mirror path.  Tolerance:
    the output is LayerNorm2d'd (unit scale); flipped rounding ties in two
    blocks move single entries by up to ~1e-3, the typical entry by fp32
    rounding (2e-5, as the bf16-mode encoder test's 2e-4 bound)."""
    params, model = _jax_params_and_model(0)
    jcfg = jax_vit_t_config().image_encoder
    jpq = jq.prequantize_image_encoder(params["image_encoder"], jcfg)
    size = ENC.img_size
    imgs = rng.integers(0, 256, (2, 3, size, size)).astype(np.uint8)
    sizes = np.array([[size, 96], [100, size]], np.int32)
    imgs[0, :, :, 96:] = 0
    imgs[1, :, 100:] = 0

    encode, packed = make_serving_encoder(model, torch.float32, quantize="int8")
    assert tquant.is_prequantized(packed)
    if weights == "carried":
        packed = encoder_pack_from_jax_prequantized(_to_numpy(jpq), ENC, torch.float32)
    kernels.reset_launches()
    ours = encode(packed, _t(imgs), _t(sizes)).numpy()
    assert all(v == 0 for v in kernels.LAUNCHES.values())      # CPU tensors: plain versions

    mean = np.asarray(CFG.pixel_mean, np.float32).reshape(1, 3, 1, 1)
    std = np.asarray(CFG.pixel_std, np.float32).reshape(1, 3, 1, 1)
    ih = np.arange(size)
    valid = (ih[None, :, None] < sizes[:, 0, None, None]) & (ih[None, None, :]
                                                             < sizes[:, 1, None, None])
    x = ((imgs.astype(np.float32) - mean) / std) * valid[:, None]
    ref = np.asarray(jie.apply(jpq, jcfg, jnp.asarray(x), fused_mlp=True, fused_qkv=True,
                               quantize="int8_xla"))
    assert ours.shape == ref.shape == (2, ENC.out_chans, ENC.grid_size, ENC.grid_size)
    diff = np.abs(ours - ref)
    assert diff.max() <= 5e-3 and np.median(diff) <= 2e-5, (diff.max(), np.median(diff))

    # quantization happened, and by no more than quantization error
    fp_encode, fp_packed = make_serving_encoder(model, torch.float32)
    fp = fp_encode(fp_packed, _t(imgs), _t(sizes)).numpy()
    rel = np.abs(ours - fp).max() / np.abs(fp).max()
    assert 1e-5 < rel < 0.06, rel


def test_int8_encoder_matches_jax_pallas(rng):
    """The same against the JAX Pallas kernels (K2, K4, K5, K7 with int8_qk)
    in interpret mode, on one image."""
    params, model = _jax_params_and_model(0)
    jcfg = jax_vit_t_config().image_encoder
    jpq = jq.prequantize_image_encoder(params["image_encoder"], jcfg)
    x = rng.standard_normal((1, 3, ENC.img_size, ENC.img_size)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jie.apply(jpq, jcfg, jnp.asarray(x), fused_mlp=True, fused_qkv=True,
                                   quantize="int8", scan_blocks=False))
    ours = model.image_encoder(_t(x), ops=tie.KERNEL_OPS_INT8).numpy()
    diff = np.abs(ours - ref)
    assert diff.max() <= 5e-3 and np.median(diff) <= 2e-5, (diff.max(), np.median(diff))


def test_int8_weights_and_ops_must_agree(rng):
    """``forward`` refuses int8 weights on the bf16-mode ops and
    floating-point weights on the int8 ops (JAX ``apply`` asserts the same)."""
    model = build_sam(CFG, device="cpu", seed=3)
    enc = model.image_encoder
    x = _t(rng.standard_normal((1, 3, ENC.img_size, ENC.img_size)).astype(np.float32))
    int8_pack = enc.pack(torch.float32, quantize="int8")
    with pytest.raises(ValueError, match="int8 weights"):
        enc(x, packed=int8_pack, ops=tie.KERNEL_OPS)
    with pytest.raises(ValueError, match="floating-point weights"):
        enc(x, packed=enc.pack(torch.float32), ops=tie.KERNEL_OPS_INT8)
    with pytest.raises(ValueError, match="quantize"):
        enc.pack(torch.float32, quantize="int4")
    with pytest.raises(ValueError, match="quantize"):
        make_serving_encoder(model, torch.float32, quantize="fp8")
    a = enc(x, packed=int8_pack, ops=tie.KERNEL_OPS_INT8)
    b = make_encode_batch(model, torch.float32, ops=tie.PLAIN_OPS_INT8)
    assert torch.isfinite(a).all() and callable(b)
    torch.testing.assert_close(a, enc(x, ops=tie.PLAIN_OPS_INT8), rtol=0, atol=0)


def test_int8_serving_encoder_defaults_to_the_card(monkeypatch):
    """No card: building the model raises; only ``device="cpu"`` runs here."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_serving_encoder(build_sam(CFG, seed=0), torch.bfloat16, quantize="int8")


def test_int8_wrappers_take_the_plain_version_on_cpu_only(rng):
    """A CPU tensor runs the plain version and counts nothing; the kernels'
    argument check refuses what is not a CUDA tensor."""
    kernels.reset_launches()
    x = _t(rng.standard_normal((8, E)).astype(np.float32))
    g, b = (_t(a) for a in _ln_params(rng, E))
    wq, s = quant_k.quantize_weight(_t(rng.standard_normal((3 * E, E)).astype(np.float32)))
    bias = _t(rng.standard_normal(3 * E).astype(np.float32))
    out = quant_k.ln_masked_linear_int8(x, None, g, b, wq, s, bias)
    torch.testing.assert_close(out, quant_k.ln_masked_linear_int8_plain(x, None, g, b, wq, s, bias),
                               rtol=0, atol=0)
    assert set(kernels.LAUNCHES) >= {"K2", "K4", "K7-int8"}
    assert all(v == 0 for v in kernels.LAUNCHES.values())
    with pytest.raises(ValueError, match="CUDA"):
        kernels.check_cuda("wq", wq, tuple(wq.shape), torch.int8)
