"""The port's kernel modules (plain PyTorch versions, as they run on the CPU)
against the JAX package's Pallas kernels run with ``interpret=True``.

Inputs are made with numpy from a seed and handed to both.  Tolerance: atol
2e-4 in fp32, as the JAX kernel tests hold their kernels to the XLA path.
The JAX kernels' GELU uses the Abramowitz & Stegun erf (|err| <= 1.5e-7), the
port's the exact erf; the difference is far inside the tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samcarriestheburden_torch import kernels
from samcarriestheburden_torch.config import sam_vit_t_config
from samcarriestheburden_torch.kernels import attention as attn_k
from samcarriestheburden_torch.kernels import mlp as mlp_k
from samcarriestheburden_tpu.kernels import attention as jattn
from samcarriestheburden_tpu.kernels import mlp as jmlp

# the tier-1 command runs six xdist workers on the machine's cores: one
# intra-op thread each, or their thread pools oversubscribe the cores
torch.set_num_threads(1)

ATOL = 2e-4
CFG = sam_vit_t_config().image_encoder
HEADS, HD = CFG.num_heads, CFG.head_dim
E = CFG.embed_dim


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _ln_params(rng, e):
    return (1 + 0.1 * rng.standard_normal(e)).astype(np.float32), \
        (0.1 * rng.standard_normal(e)).astype(np.float32)


@pytest.mark.parametrize("masked", [True, False])
def test_k1_plain_matches_pallas(rng, masked):
    t, o = 3 * 32, 3 * E
    x = rng.standard_normal((t, E)).astype(np.float32)
    mask = (rng.random((t, 1)) > 0.3).astype(np.float32) if masked \
        else np.ones((t, 1), np.float32)
    g, b = _ln_params(rng, E)
    w = (rng.standard_normal((E, o)) / np.sqrt(E)).astype(np.float32)
    bias = rng.standard_normal(o).astype(np.float32)

    ref = np.asarray(jmlp.fused_ln_masked_linear(x, mask, g, b, w, bias,
                                                 eps=CFG.layer_norm_eps, interpret=True))
    ours = mlp_k.ln_masked_linear(_t(x), _t(mask) if masked else None, _t(g), _t(b),
                                  _t(w.T), _t(bias), CFG.layer_norm_eps)
    np.testing.assert_allclose(ours.numpy(), ref, atol=ATOL)
    if masked:  # a pad token's projection is the bias alone
        dead = mask[:, 0] == 0
        np.testing.assert_allclose(ours.numpy()[dead], np.broadcast_to(bias, (dead.sum(), o)),
                                   atol=1e-6)


@pytest.mark.parametrize("with_add", [False, True])
def test_k3_plain_matches_pallas(rng, with_add):
    t, m = 96, 4 * E
    x = rng.standard_normal((t, E)).astype(np.float32)
    add = rng.standard_normal((t, E)).astype(np.float32) if with_add else None
    g, b = _ln_params(rng, E)
    w1 = (rng.standard_normal((E, m)) / np.sqrt(E)).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(m)).astype(np.float32)
    w2 = (rng.standard_normal((m, E)) / np.sqrt(m)).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(E)).astype(np.float32)

    ref = np.asarray(jmlp.fused_ln_mlp_residual(x, g, b, w1, b1, w2, b2, add,
                                                eps=CFG.layer_norm_eps, interpret=True))
    ours = mlp_k.ln_mlp_residual(_t(x), _t(g), _t(b), _t(w1.T), _t(b1), _t(w2.T), _t(b2),
                                 add=None if add is None else _t(add),
                                 eps=CFG.layer_norm_eps)
    np.testing.assert_allclose(ours.numpy(), ref, atol=ATOL)


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


def test_k5_plain_matches_pallas(rng):
    ws = CFG.window_size
    n = ws * ws
    np_ = -(-n // 8) * 8                                  # 25 live + 7 dead slots
    wb = 4
    qkv = rng.standard_normal((wb, np_, HEADS * 3 * HD)).astype(np.float32)
    rel = _rel_tables(rng, ws, ws)

    tcat = jattn.prepare_rel_tables_window3d({k: jnp.asarray(v) for k, v in rel.items()},
                                             ws, jnp.float32)
    ref = np.asarray(jattn.fused_rel_attention_window3d(
        jnp.asarray(_to_jax_qkv(qkv)), tcat, ws=ws, heads=HEADS, hd=HD, interpret=True))
    ref = ref.transpose(1, 2, 0, 3).reshape(wb, np_, HEADS * HD)

    tables = attn_k.prepare_rel_tables(_t(rel["rel_pos_h"]), _t(rel["rel_pos_w"]), ws, ws,
                                       torch.float32)
    ours = attn_k.rel_attention_window(_t(qkv), tables, ws=ws, heads=HEADS, hd=HD)
    assert tuple(ours.shape) == (wb, np_, HEADS * HD)
    np.testing.assert_allclose(ours.numpy()[:, :n], ref[:, :n], atol=ATOL)


# K7-int8's tolerance (tests/test_torch_quant.py:_close): both sides' integer
# products are exact, but a scaled query on an int8 rounding tie can land one
# step apart, which moves an output by one step of one term (x max |JAX|);
# the typical entry agrees to fp32 rounding (the median)
INT8_STEP_TOL, INT8_MEDIAN_TOL = 2e-3, 1e-5


# the grids whose rel path the global kernel takes apart: vit_t's 8x8 (the
# shared table, one block), 2x64 (64-wide: rw in registers, one rh per tile),
# 3x40 (rows not a multiple of the 64-key tile, kh odd)
@pytest.mark.parametrize("int8_qk", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("kh,kw", [(8, 8), (2, 64), (3, 40)], ids=["8x8", "2x64", "3x40"])
def test_k7_plain_matches_pallas(rng, kh, kw, int8_qk):
    b = 2
    qkv = rng.standard_normal((b, kh * kw, HEADS * 3 * HD)).astype(np.float32)
    rel = _rel_tables(rng, kh, kw)

    tcat = jattn.prepare_rel_tables_window3d({k: jnp.asarray(v) for k, v in rel.items()},
                                             kh, jnp.float32, ws_w=kw)
    ref = np.asarray(jattn.fused_rel_attention_global3d(
        jnp.asarray(_to_jax_qkv(qkv)), tcat, kh=kh, kw=kw, heads=HEADS, hd=HD,
        q_block=32, int8_qk=int8_qk, interpret=True))
    ref = ref.transpose(1, 2, 0, 3).reshape(b, kh * kw, HEADS * HD)

    tables = attn_k.prepare_rel_tables(_t(rel["rel_pos_h"]), _t(rel["rel_pos_w"]), kh, kw,
                                       torch.float32)
    ours = attn_k.rel_attention_global(_t(qkv), tables, kh=kh, kw=kw, heads=HEADS, hd=HD,
                                       int8_qk=int8_qk).numpy()
    if not int8_qk:
        np.testing.assert_allclose(ours, ref, atol=ATOL)
        return
    scale, diff = np.abs(ref).max(), np.abs(ours - ref)
    assert diff.max() <= INT8_STEP_TOL * scale, (diff.max(), scale)
    assert np.median(diff) <= INT8_MEDIAN_TOL * scale, (np.median(diff), scale)


def test_qkv_grouping_matches_jax_headmajor(rng):
    w = rng.standard_normal((E, 3 * E)).astype(np.float32)           # JAX (in, out)
    bias = rng.standard_normal(3 * E).astype(np.float32)
    jw, jb = jattn.prepare_qkv_headmajor({"qkv": {"w": jnp.asarray(w), "b": jnp.asarray(bias)}},
                                         HEADS, jnp.float32)
    p = jattn._headmajor_pad(HD)
    jw = np.asarray(jw).reshape(E, HEADS, p)[:, :, :3 * HD].reshape(E, 3 * E)
    jb = np.asarray(jb).reshape(HEADS, p)[:, :3 * HD].reshape(3 * E)
    ours_w, ours_b = attn_k.group_qkv_per_head(_t(w.T), _t(bias), HEADS)
    np.testing.assert_array_equal(ours_w.numpy().T, jw)
    np.testing.assert_array_equal(ours_b.numpy(), jb)


def test_rel_tables_must_fit_the_grid():
    tab = torch.zeros(2 * 5 - 1, HD)
    assert tuple(attn_k.prepare_rel_tables(tab, tab, 5, 5, torch.float32).shape) == (18, HD)
    with pytest.raises(ValueError, match="rows"):
        attn_k.prepare_rel_tables(tab, tab, 8, 8, torch.float32)


def test_cpu_tensors_take_the_plain_version_and_count_nothing(rng):
    kernels.reset_launches()
    x = _t(rng.standard_normal((8, E)))
    g, b = (_t(a) for a in _ln_params(rng, E))
    w, bias = _t(rng.standard_normal((3 * E, E))), _t(rng.standard_normal(3 * E))
    out = mlp_k.ln_masked_linear(x, None, g, b, w, bias)
    torch.testing.assert_close(out, mlp_k.ln_masked_linear_plain(x, None, g, b, w, bias),
                               rtol=0, atol=0)
    assert all(v == 0 for v in kernels.LAUNCHES.values())


def test_check_cuda_rejects_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        kernels.check_cuda("x", torch.zeros(4, 8), (4, 8), torch.bfloat16)
