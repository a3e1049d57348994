"""The encoder's other block formulations in the port (v1 unfused with K9, v2
the fused window block with K12, v3 head-major with K10 and K11) against the
JAX package on the CPU, its Pallas kernels run with ``interpret=True``.

Where a JAX module or ``apply`` reaches a Pallas kernel that it gives no
``interpret`` flag (the fused MLP, the head-major qkv and attention, the
fused window block), the reference is the same function's XLA path (those
options off), which computes the same output; the kernels themselves are
held to the port's plain versions in interpret mode in the kernel tests
above.  Nothing here runs under ``pltpu.force_tpu_interpret_mode()``: its TPU
interpreter's callback threads left an xdist worker hung on this file.

Inputs are made with numpy from a seed and handed to both, in fp32, at the
tiny vit_t config (E = 32, 2 heads of 16, ws = 5 on an 8x8 grid).
Tolerances: 2e-5 for a kernel's plain version against its Pallas kernel on
the same operands (the JAX kernel tests' own bound for K9); 2e-4 wherever a
module with its projections meets its JAX counterpart; 5e-4 for the whole
encoder, as ``tests/test_kernels.py`` holds JAX ``apply`` to itself.
"""

import functools
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samcarriestheburden_torch import kernels
from samcarriestheburden_torch.config import sam_vit_t_config
from samcarriestheburden_torch.engine import embeddings as temb
from samcarriestheburden_torch.kernels import attention as attn_k
from samcarriestheburden_torch.kernels import build
from samcarriestheburden_torch.models import image_encoder as tie
from samcarriestheburden_torch.models.convert import (sam_state_dict_from_jax,
                                                      sam_state_dict_from_torch)
from samcarriestheburden_torch.models.sam import build_sam
from samcarriestheburden_tpu.config import sam_vit_t_config as jax_vit_t_config
from samcarriestheburden_tpu.kernels import attention as jattn
from samcarriestheburden_tpu.models import convert as jconvert
from samcarriestheburden_tpu.models import image_encoder as jie
from samcarriestheburden_tpu.models.common import layer_norm as jax_layer_norm

# the tier-1 command runs six xdist workers on the machine's cores: one
# intra-op thread each, or their thread pools oversubscribe the cores
torch.set_num_threads(1)

KERNEL_ATOL = 2e-5
MODULE_ATOL = 2e-4
ENCODER_ATOL = 5e-4
CFG = sam_vit_t_config()
ENC = CFG.image_encoder
JENC = jax_vit_t_config().image_encoder
HEADS, HD, E, WS = ENC.num_heads, ENC.head_dim, ENC.embed_dim, ENC.window_size
GOLDEN = Path(__file__).parent / "golden"


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_numpy(v) for v in tree]
    return np.asarray(tree)


@functools.lru_cache(maxsize=None)
def _both(seed=0):
    """Seeded random SAM weights as the JAX params pytree and as the port's
    model (carried across by ``sam_state_dict_from_jax``), with rel tables
    and a qkv bias large enough to move the output."""
    sd = {k: v.numpy().copy() for k, v in build_sam(CFG, device="cpu", seed=seed)
          .state_dict().items()}
    rs = np.random.default_rng(seed + 100)
    for k in sd:
        if k.endswith(("rel_pos_h", "rel_pos_w")):
            sd[k] *= 15.0
        if k.endswith("attn.qkv.bias"):
            sd[k] = (0.3 * rs.standard_normal(sd[k].shape)).astype(np.float32)
    params = jconvert.sam_params_from_torch(sd, jax_vit_t_config())
    model = build_sam(CFG, device="cpu", state_dict=sam_state_dict_from_jax(
        {k: _to_numpy(v) for k, v in params.items()}, CFG))
    return params["image_encoder"], model, model.image_encoder.pack(torch.float32)


def _windows(rng, wb=4):
    xw = rng.standard_normal((wb, WS, WS, E)).astype(np.float32)
    pad_valid = np.ones((wb, WS, WS, 1), np.float32)
    pad_valid[-1, :, -2:] = 0.0                       # a masked window
    return xw, pad_valid


# ---------------------------------------------------------------------------
# the four kernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------


def _k9_inputs(rng, g, kh, kw, d):
    n = kh * kw
    q, k, v = (rng.standard_normal((g, n, d)).astype(np.float32) for _ in range(3))
    rel_h = (0.1 * rng.standard_normal((g, n, kh))).astype(np.float32)
    rel_w = (0.1 * rng.standard_normal((g, n, kw))).astype(np.float32)
    return q, k, v, rel_h, rel_w


def _dense_reference(q, k, v, rel_h, rel_w, kh, kw):
    logits = np.einsum("gqd,gkd->gqk", q, k) / np.sqrt(q.shape[-1])
    logits = logits + np.repeat(rel_h, kw, axis=-1) + np.tile(rel_w, (1, 1, kh))
    w = torch.softmax(torch.from_numpy(logits), dim=-1).numpy()
    return np.einsum("gqk,gkd->gqd", w, v)


@pytest.mark.parametrize("body", ["loop", "cat", "phased"])
@pytest.mark.parametrize("shape", [(3, 4, 4, 32, None), (2, 4, 8, 16, None), (2, 8, 8, 16, 16)],
                         ids=["3x4x4x32", "2x4x8x16", "q_block16"])
def test_k9_plain_matches_pallas(rng, shape, body):
    g, kh, kw, d, q_block = shape
    q, k, v, rel_h, rel_w = _k9_inputs(rng, g, kh, kw, d)
    ref = np.asarray(jattn.fused_rel_attention(q, k, v, rel_h, rel_w, kh=kh, kw=kw,
                                               q_block=q_block, cat_bias=body, interpret=True))
    kernels.reset_launches()
    ours = attn_k.rel_attention_pre(_t(q), _t(k), _t(v), _t(rel_h), _t(rel_w), kh=kh, kw=kw)
    assert kernels.LAUNCHES["K9"] == 0                 # a CPU tensor launches nothing
    np.testing.assert_allclose(ours.numpy(), ref, atol=KERNEL_ATOL)
    np.testing.assert_allclose(ours.numpy(), _dense_reference(q, k, v, rel_h, rel_w, kh, kw),
                               atol=KERNEL_ATOL)


def _headmajor_inputs(rng, s, kh, kw):
    """Tokens through the JAX head-padded qkv projection and through the
    port's unpadded grouping of the same weights; the rel terms random."""
    n = kh * kw
    x = rng.standard_normal((s * n, E)).astype(np.float32)
    w = (rng.standard_normal((E, 3 * E)) / np.sqrt(E)).astype(np.float32)   # JAX (in, out)
    b = (0.3 * rng.standard_normal(3 * E)).astype(np.float32)
    jw, jb = jattn.prepare_qkv_headmajor({"qkv": {"w": jnp.asarray(w), "b": jnp.asarray(b)}},
                                         HEADS, jnp.float32)
    qkv_jax = (x @ np.asarray(jw) + np.asarray(jb)).reshape(s, n, -1)
    tw, tb = attn_k.group_qkv_per_head(_t(w.T), _t(b), HEADS)
    qkv = (_t(x) @ tw.T + tb).reshape(s, n, HEADS * 3 * HD)
    rel_h = (0.1 * rng.standard_normal((HEADS, s, n, kh))).astype(np.float32)
    rel_w = (0.1 * rng.standard_normal((HEADS, s, n, kw))).astype(np.float32)
    return qkv_jax, qkv, rel_h, rel_w


def test_k10_plain_matches_pallas(rng):
    wb = 4
    qkv_jax, qkv, rel_h, rel_w = _headmajor_inputs(rng, wb, WS, WS)
    ref = np.asarray(jattn.fused_rel_attention_headmajor(
        jnp.asarray(qkv_jax), rel_h, rel_w, kh=WS, kw=WS, heads=HEADS, hd=HD, interpret=True))
    ref = ref.transpose(1, 2, 0, 3).reshape(wb, WS * WS, HEADS * HD)      # token-major
    ours = attn_k.rel_attention_headmajor(qkv, _t(rel_h), _t(rel_w), kh=WS, kw=WS,
                                          heads=HEADS, hd=HD)
    np.testing.assert_allclose(ours.numpy(), ref, atol=KERNEL_ATOL)


@pytest.mark.parametrize("grid", [(8, 8), (6, 3)], ids=["square", "nonsquare"])
def test_k11_plain_matches_pallas(rng, grid):
    kh, kw = grid
    b = 2
    qkv_jax, qkv, rel_h, rel_w = _headmajor_inputs(rng, b, kh, kw)
    ref = np.asarray(jattn.fused_rel_attention_headmajor_global(
        jnp.asarray(qkv_jax), rel_h, rel_w, kh=kh, kw=kw, heads=HEADS, hd=HD, q_block=32,
        interpret=True))
    ref = ref.transpose(1, 2, 0, 3).reshape(b, kh * kw, HEADS * HD)
    ours = attn_k.rel_attention_headmajor_global(qkv, _t(rel_h), _t(rel_w), kh=kh, kw=kw,
                                                 heads=HEADS, hd=HD)
    np.testing.assert_allclose(ours.numpy(), ref, atol=KERNEL_ATOL)


def test_k12_plain_matches_pallas(rng):
    """Through ``prepare_block_attn_weights`` on the JAX side and the pack's
    grouped qkv weight, whole projection and stacked tables on the port's;
    the masked window's pad tokens are zero rows of xn, so their k and v are
    the bias."""
    jparams, _, packed = _both()
    blk, pk = jparams["blocks"][0], packed[0]
    xw, pad_valid = _windows(rng)
    xn = np.asarray(jax_layer_norm(blk["norm1"], xw, JENC.layer_norm_eps)) * pad_valid
    xn = xn.reshape(-1, WS * WS, E)
    wts = jattn.prepare_block_attn_weights(blk["attn"], HEADS, WS, dtype=jnp.float32)
    ref = np.asarray(jattn.fused_window_block_attention(
        jnp.asarray(xn), wts["wq"], wts["wk"], wts["wv"], wts["bqkv"], wts["wp"],
        wts["texp_h"], wts["texp_w"], ws=WS, heads=HEADS, interpret=True))
    kernels.reset_launches()
    ours = attn_k.window_block_attention(_t(xn), pk["qkv_w"], pk["qkv_b"], pk["proj_w"],
                                         pk["tables"], ws=WS, heads=HEADS)
    assert kernels.LAUNCHES["K12"] == 0
    np.testing.assert_allclose(ours.numpy(), ref, atol=MODULE_ATOL)
    unrounded = attn_k.window_block_attention_plain(
        _t(xn), pk["qkv_w"], pk["qkv_b"], pk["proj_w"], pk["tables"], ws=WS, heads=HEADS,
        round_qk=False)
    torch.testing.assert_close(unrounded, ours, rtol=0, atol=0)     # fp32 rounds nothing


def test_k10_and_k9_agree_with_k5_on_a_window(rng):
    """The three windowed attentions are one function: K5 makes the rel terms
    itself, K10 and K9 take them from ``rel_bias_headmajor``."""
    wb, n = 3, WS * WS
    np_ = -(-n // 8) * 8
    qkv = _t(rng.standard_normal((wb, n, HEADS * 3 * HD)))
    tables = _t(0.3 * rng.standard_normal((2 * (2 * WS - 1), HD)))
    k5 = attn_k.rel_attention_window(torch.nn.functional.pad(qkv, (0, 0, 0, np_ - n)), tables,
                                     ws=WS, heads=HEADS, hd=HD)[:, :n]
    rel_h, rel_w = tie.rel_bias_headmajor(qkv.reshape(wb * n, -1), tables, heads=HEADS, hd=HD,
                                          b=wb, gh=WS, gw=WS)
    k10 = attn_k.rel_attention_headmajor(qkv, rel_h, rel_w, kh=WS, kw=WS, heads=HEADS, hd=HD)
    np.testing.assert_allclose(k10.numpy(), k5.numpy(), atol=KERNEL_ATOL)
    x = qkv.reshape(wb, n, HEADS, 3, HD).permute(3, 2, 0, 1, 4).reshape(3, HEADS * wb, n, HD)
    k9 = attn_k.rel_attention_pre(x[0], x[1], x[2], rel_h.reshape(-1, n, WS),
                                  rel_w.reshape(-1, n, WS), kh=WS, kw=WS)
    k9 = k9.reshape(HEADS, wb, n, HD).permute(1, 2, 0, 3).reshape(wb, n, HEADS * HD)
    np.testing.assert_allclose(k9.numpy(), k5.numpy(), atol=KERNEL_ATOL)


# ---------------------------------------------------------------------------
# the modules against their JAX counterparts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("block", [0, 1], ids=["window", "global"])
def test_attention_apply_matches_jax(rng, block):
    jparams, _, packed = _both()
    side = WS if block == 0 else ENC.grid_size
    x = rng.standard_normal((2, side, side, E)).astype(np.float32)
    ref = np.asarray(jie.attention_apply(jparams["blocks"][block]["attn"], x, HEADS, True))
    ours = tie.attention_apply(packed[block], _t(x), HEADS, True)
    np.testing.assert_allclose(ours.numpy(), ref, atol=MODULE_ATOL)
    no_rel = tie.attention_apply(packed[block], _t(x), HEADS, False)
    ref = np.asarray(jie.attention_apply(jparams["blocks"][block]["attn"], x, HEADS, False))
    np.testing.assert_allclose(no_rel.numpy(), ref, atol=MODULE_ATOL)


@pytest.mark.parametrize("block", [0, 1], ids=["window", "global"])
def test_attention_apply_kernel_matches_pallas(rng, block):
    jparams, _, packed = _both()
    side = WS if block == 0 else ENC.grid_size
    x = rng.standard_normal((2, side, side, E)).astype(np.float32)
    ref = np.asarray(jattn.attention_apply_pallas(jparams["blocks"][block]["attn"], x, HEADS,
                                                  True, interpret=True))
    ours = tie.attention_apply_kernel(packed[block], _t(x), HEADS, True)
    np.testing.assert_allclose(ours.numpy(), ref, atol=MODULE_ATOL)
    oracle = tie.attention_apply(packed[block], _t(x), HEADS, True)
    np.testing.assert_allclose(ours.numpy(), oracle.numpy(), atol=MODULE_ATOL)


@pytest.mark.parametrize("block", [0, 1], ids=["window", "global"])
def test_attention_apply_kernel_without_rel_pos_still_runs_k9(rng, block):
    """Without rel-pos the JAX function leaves its kernel; the port's runs K9
    on zero rel terms, which is the same function."""
    jparams, _, packed = _both()
    side = WS if block == 0 else ENC.grid_size
    x = rng.standard_normal((2, side, side, E)).astype(np.float32)
    ref = np.asarray(jattn.attention_apply_pallas(jparams["blocks"][block]["attn"], x, HEADS,
                                                  False, interpret=True))
    calls = []

    def k9(q, k, v, rel_h, rel_w, **kw):
        calls.append((tuple(rel_h.shape), tuple(rel_w.shape), float(rel_h.abs().max()),
                      float(rel_w.abs().max()), kw))
        return attn_k.rel_attention_pre(q, k, v, rel_h, rel_w, **kw)

    ours = tie.attention_apply_kernel(packed[block], _t(x), HEADS, False,
                                      tie.KERNEL_OPS._replace(rel_attention_pre=k9))
    n = side * side
    assert calls == [((2 * HEADS, n, side), (2 * HEADS, n, side), 0.0, 0.0,
                      dict(kh=side, kw=side))]
    np.testing.assert_allclose(ours.numpy(), ref, atol=MODULE_ATOL)
    oracle = tie.attention_apply(packed[block], _t(x), HEADS, False)
    np.testing.assert_allclose(ours.numpy(), oracle.numpy(), atol=MODULE_ATOL)


def test_k9_comes_from_the_ops_like_the_other_kernels(rng):
    """v1's K9 is a field of ``EncoderOps``: the plain ops carry its plain
    version, and a forward hands its ops down to ``attention_impl``."""
    assert tie.KERNEL_OPS.rel_attention_pre is attn_k.rel_attention_pre
    assert tie.PLAIN_OPS.rel_attention_pre is attn_k.rel_attention_pre_plain
    assert tie.PLAIN_OPS_INT8.rel_attention_pre is attn_k.rel_attention_pre_plain
    _, model, packed = _both()
    lengths = []

    def k9(q, *rest, **kw):
        lengths.append(q.shape[1])
        return attn_k.rel_attention_pre_plain(q, *rest, **kw)

    x = _t(rng.standard_normal((1, 3, ENC.img_size, ENC.img_size)))
    v1 = dict(fused_qkv=False, attention_impl=tie.attention_apply_kernel)
    out = model.image_encoder(x, packed=packed, **v1,
                              ops=tie.KERNEL_OPS._replace(rel_attention_pre=k9))
    windowed = ENC.depth - len(ENC.global_attn_indexes)
    assert sorted(lengths) == [WS * WS] * windowed + \
        [ENC.grid_size ** 2] * len(ENC.global_attn_indexes)
    torch.testing.assert_close(out, model.image_encoder(x, packed=packed, **v1), rtol=0, atol=0)


@pytest.mark.parametrize("grid", [(WS, WS), (6, 3)], ids=["window", "nonsquare"])
def test_rel_bias_headmajor_matches_jax(rng, grid):
    gh, gw = grid
    b = 3
    qkv_jax, qkv, _, _ = _headmajor_inputs(rng, b, gh, gw)
    p_attn = {"rel_pos_h": (0.3 * rng.standard_normal((2 * gh - 1, HD))).astype(np.float32),
              "rel_pos_w": (0.3 * rng.standard_normal((2 * gw - 1, HD))).astype(np.float32)}
    pad = jattn._headmajor_pad(HD)
    ref_h, ref_w = jie._rel_bias_headmajor(
        jnp.asarray(qkv_jax.reshape(-1, HEADS * pad)), {k: jnp.asarray(v) for k, v in p_attn.items()},
        heads=HEADS, pad=pad, hd=HD, b=b, gh=gh, gw=gw, dtype=jnp.float32)
    tables = attn_k.prepare_rel_tables(_t(p_attn["rel_pos_h"]), _t(p_attn["rel_pos_w"]), gh, gw,
                                       torch.float32)
    rel_h, rel_w = tie.rel_bias_headmajor(qkv.reshape(b * gh * gw, -1), tables, heads=HEADS,
                                          hd=HD, b=b, gh=gh, gw=gw)
    assert tuple(rel_h.shape) == (HEADS, b, gh * gw, gh) and rel_h.is_contiguous()
    assert tuple(rel_w.shape) == (HEADS, b, gh * gw, gw) and rel_w.is_contiguous()
    np.testing.assert_allclose(rel_h.numpy(), np.asarray(ref_h), atol=KERNEL_ATOL)
    np.testing.assert_allclose(rel_w.numpy(), np.asarray(ref_w), atol=KERNEL_ATOL)


def test_windowed_attention_headmajor_matches_jax(rng):
    jparams, _, packed = _both()
    xw, pad_valid = _windows(rng)
    ref = np.asarray(jie._windowed_attention_headmajor(jparams["blocks"][0], xw, pad_valid, JENC,
                                                       interpret=True))
    ours = tie.windowed_attention_headmajor(packed[0], _t(xw), _t(pad_valid), ENC)
    np.testing.assert_allclose(ours.numpy(), ref, atol=MODULE_ATOL)


def test_global_attention_rel_outside_matches_the_oracle_and_k7(rng):
    """K11's caller has no JAX counterpart: it is held to JAX
    ``attention_apply`` on the LayerNormed grid and to the port's K7 path."""
    jparams, _, packed = _both()
    g = ENC.grid_size
    x = rng.standard_normal((2, g, g, E)).astype(np.float32)
    blk = jparams["blocks"][1]
    xn = jax_layer_norm(blk["norm1"], x, JENC.layer_norm_eps)
    ref = np.asarray(jie.attention_apply(blk["attn"], xn, HEADS, True)).reshape(-1, E)
    ours = tie.global_attention_rel_outside(packed[1], _t(x), ENC)
    np.testing.assert_allclose(ours.numpy(), ref, atol=MODULE_ATOL)
    k7 = tie.global_attention(packed[1], _t(x), ENC, tie.KERNEL_OPS)
    np.testing.assert_allclose(ours.numpy(), k7.numpy(), atol=KERNEL_ATOL)


@pytest.mark.parametrize("variant", ["v1_xla", "v1_kernel", "v1_kernel_fused_mlp", "v3"])
def test_block_apply_windowed_matches_jax(rng, variant):
    jparams, _, packed = _both()
    xw, pad_valid = _windows(rng)
    fused_mlp = variant in ("v1_kernel_fused_mlp", "v3")
    fused_qkv = variant == "v3"
    jimpl = jie.attention_apply if variant == "v1_xla" else \
        functools.partial(jattn.attention_apply_pallas, interpret=True)
    timpl = tie.attention_apply if variant == "v1_xla" else tie.attention_apply_kernel
    # the fused MLP and qkv take no interpret flag here: their XLA path
    ref = np.asarray(jie._block_apply_windowed(jparams["blocks"][0], xw, pad_valid, JENC,
                                               jimpl, False, False))
    ours = tie.block_apply_windowed(packed[0], _t(xw), _t(pad_valid), ENC, timpl, fused_mlp,
                                    fused_qkv)
    np.testing.assert_allclose(ours.numpy(), ref, atol=MODULE_ATOL)


def test_block_apply_windowed_fused_matches_jax(rng):
    jparams, _, packed = _both()
    xw, pad_valid = _windows(rng)
    ref = np.asarray(jie._block_apply_windowed_fused(jparams["blocks"][0], xw, pad_valid, JENC,
                                                     interpret=True))
    ours = tie.block_apply_windowed_fused(packed[0], _t(xw), _t(pad_valid), ENC)
    np.testing.assert_allclose(ours.numpy(), ref, atol=MODULE_ATOL)
    unfused = tie.block_apply_windowed(packed[0], _t(xw), _t(pad_valid), ENC)
    np.testing.assert_allclose(ours.numpy(), unfused.numpy(), atol=MODULE_ATOL)


@pytest.mark.parametrize("window_size", [WS, 0], ids=["windowed", "global"])
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_block_apply_matches_jax(rng, window_size, fused):
    jparams, _, packed = _both()
    i = 0 if window_size else 1
    g = ENC.grid_size
    x = rng.standard_normal((2, g, g, E)).astype(np.float32)
    # the fused MLP and head-major attention take no interpret flag: their XLA path
    ref = np.asarray(jie.block_apply(jparams["blocks"][i], x, JENC, window_size,
                                     jie.attention_apply, False, False))
    ours = tie.block_apply(packed[i], _t(x), ENC, window_size, tie.attention_apply, fused,
                           fused and not window_size)
    np.testing.assert_allclose(ours.numpy(), ref, atol=MODULE_ATOL)


# ---------------------------------------------------------------------------
# the whole encoder on each formulation
# ---------------------------------------------------------------------------

VARIANTS = {
    "v1_xla": dict(fused_qkv=False, fused_mlp=False),
    "v1_kernel": dict(fused_qkv=False, fused_mlp=False, attention_impl="kernel"),
    "v1_kernel_fused_mlp": dict(fused_qkv=False, fused_mlp=True, attention_impl="kernel"),
    "v2": dict(fused_window_blocks=True, fused_mlp=True, fused_qkv=True),
    "not_persistent": dict(persistent_windows=False, fused_mlp=True, fused_qkv=True),
    "not_persistent_v1": dict(persistent_windows=False, fused_mlp=False, fused_qkv=False,
                              attention_impl="kernel"),
    "flat_unfused_mlp": dict(fused_qkv=True, fused_mlp=False),
}


#: ``apply``'s options that reach a Pallas kernel with no ``interpret`` flag;
#: the JAX reference runs with them off (its XLA path, the same output)
NO_INTERPRET_FLAG = ("fused_mlp", "fused_qkv", "fused_window_blocks")


def _impls(kw):
    """The keywords for JAX ``apply`` and for the port's ``forward``."""
    jkw, tkw = dict(kw), dict(kw)
    for key in NO_INTERPRET_FLAG:
        jkw.pop(key, None)
    if kw.get("attention_impl") == "kernel":
        jkw["attention_impl"] = functools.partial(jattn.attention_apply_pallas, interpret=True)
        tkw["attention_impl"] = tie.attention_apply_kernel
    return jkw, tkw


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_encoder_variants_match_jax_and_the_flat_path(rng, name):
    jparams, model, packed = _both()
    x = rng.standard_normal((2, 3, ENC.img_size, ENC.img_size)).astype(np.float32)
    jkw, tkw = _impls(VARIANTS[name])
    ref = np.asarray(jie.apply(jparams, JENC, jnp.asarray(x), scan_blocks=False, **jkw))
    ours = model.image_encoder(_t(x), packed=packed, **tkw)
    np.testing.assert_allclose(ours.numpy(), ref, atol=ENCODER_ATOL)
    flat = model.image_encoder(_t(x), packed=packed)
    np.testing.assert_allclose(ours.numpy(), flat.numpy(), atol=ENCODER_ATOL)


@pytest.mark.parametrize("name", ["v1_kernel", "v2", "not_persistent"])
def test_encoder_variants_match_golden(name):
    data = np.load(GOLDEN / "image_encoder.npz")
    sd = sam_state_dict_from_torch({k[3:]: data[k] for k in data.files if k.startswith("sd/")})
    enc = tie.ImageEncoderViT(ENC)
    enc.load_state_dict(sd)
    out = enc(torch.from_numpy(data["x"]), **_impls(VARIANTS[name])[1])
    np.testing.assert_allclose(out.numpy(), data["out"], atol=MODULE_ATOL)


def test_entry_points_take_the_variant_keywords(rng):
    """``make_encode_batch`` and ``make_serving_encoder`` hand JAX ``apply``'s
    keywords on to ``forward``; with none given they run the serving
    formulation, whatever ``attention_impl`` says."""
    _, model, _ = _both()
    imgs = torch.from_numpy(rng.integers(0, 256, (2, 3, ENC.img_size, ENC.img_size),
                                         dtype=np.uint8))
    sizes = torch.tensor([[ENC.img_size, 100], [90, ENC.img_size]])
    serve, packed = temb.make_serving_encoder(model, torch.float32)
    want = serve(packed, imgs, sizes)

    def refuse(*a, **k):
        raise AssertionError("the serving formulation called attention_impl")

    same = temb.make_encode_batch(model, torch.float32, attention_impl=refuse)(
        packed, imgs, sizes)
    torch.testing.assert_close(same, want, rtol=0, atol=0)
    for kw in (dict(fused_qkv=False, attention_impl=tie.attention_apply_kernel),
               dict(fused_window_blocks=True), dict(persistent_windows=False),
               dict(fused_qkv=False, fused_mlp=False)):
        encode, weights = temb.make_serving_encoder(model, torch.float32, **kw)
        np.testing.assert_allclose(encode(weights, imgs, sizes).numpy(), want.numpy(),
                                   atol=ENCODER_ATOL)
    with pytest.raises(ValueError, match="MedSAM"):
        temb.make_serving_encoder(model, torch.float32, medsam=True, fused_qkv=False)


def test_default_attention_impl_follows_the_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert temb.default_attention_impl() is tie.attention_apply
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert temb.default_attention_impl() is tie.attention_apply_kernel


# ---------------------------------------------------------------------------
# the refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(fused_qkv=False), dict(fused_mlp=False),
                                dict(fused_window_blocks=True), dict(persistent_windows=False)],
                         ids=["fused_qkv_off", "fused_mlp_off", "fused_window_blocks",
                              "not_persistent"])
def test_int8_weights_run_only_on_the_fused_flat_path(rng, kw):
    """JAX ``apply`` asserts ``fused_mlp and fused_qkv`` for int8; K12 and the
    per-block partition have no int8 form either."""
    _, model, _ = _both()
    x = _t(rng.standard_normal((1, 3, ENC.img_size, ENC.img_size)))
    packed8 = model.image_encoder.pack(torch.float32, quantize="int8")
    model.image_encoder(x, packed=packed8, ops=tie.KERNEL_OPS_INT8)          # the fused path runs
    with pytest.raises(ValueError, match="int8"):
        model.image_encoder(x, packed=packed8, ops=tie.KERNEL_OPS_INT8, **kw)
    xw, pad_valid = _windows(rng)
    for fn in (tie.block_apply_windowed, tie.block_apply_windowed_fused):
        with pytest.raises(ValueError, match="floating-point"):
            fn(packed8[0], _t(xw), _t(pad_valid), ENC)


def test_the_new_wrappers_never_reach_the_compiler_on_cpu(rng, monkeypatch):
    """On CPU tensors K9-K12 run their plain versions: the build is not
    touched (it would raise here: there is no ``nvcc``) and nothing counts."""
    def refuse(*a, **k):
        raise AssertionError("the CUDA build was reached for a CPU tensor")

    monkeypatch.setattr(build, "load", refuse)
    monkeypatch.setattr(build, "build", refuse)
    kernels.reset_launches()
    _, _, packed = _both()
    q, k, v, rel_h, rel_w = (_t(a) for a in _k9_inputs(rng, 2, 4, 4, HD))
    out = attn_k.rel_attention_pre(q, k, v, rel_h, rel_w, kh=4, kw=4)
    torch.testing.assert_close(out, attn_k.rel_attention_pre_plain(q, k, v, rel_h, rel_w,
                                                                   kh=4, kw=4), rtol=0, atol=0)
    _, qkv, rh, rw = _headmajor_inputs(rng, 2, 4, 4)
    for fn in (attn_k.rel_attention_headmajor, attn_k.rel_attention_headmajor_global):
        out = fn(qkv, _t(rh), _t(rw), kh=4, kw=4, heads=HEADS, hd=HD)
        torch.testing.assert_close(out, attn_k.rel_attention_headmajor_plain(
            qkv, _t(rh), _t(rw), kh=4, kw=4, heads=HEADS, hd=HD), rtol=0, atol=0)
    xw, pad_valid = _windows(rng)
    out = tie.block_apply_windowed_fused(packed[0], _t(xw), _t(pad_valid), ENC)
    assert torch.isfinite(out).all()
    assert all(n == 0 for n in kernels.LAUNCHES.values())


def test_rel_tables_must_fit_the_grid(rng):
    """The encoder's tables are sized for their grid; the JAX package's table
    resampling is not ported, so another grid is refused."""
    _, _, packed = _both()
    with pytest.raises(ValueError, match="rows"):
        tie.attention_apply(packed[0], _t(rng.standard_normal((1, 4, 4, E))), HEADS, True)
    with pytest.raises(ValueError, match="rows"):
        tie.attention_apply_kernel(packed[1], _t(rng.standard_normal((1, WS, WS, E))), HEADS)
