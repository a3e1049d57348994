"""K7-pv and K7-int8pv: the plain versions of the port's K7 with
``int8_pv=True`` against the JAX package's Pallas kernel
``fused_rel_attention_global3d(..., int8_pv=True)`` in interpret mode, on the
CPU at a small shape (8 x 8 grid, 2 heads, head dim 16, query blocks of 32),
and the arithmetic written out in numpy.  The CUDA kernel itself runs on the
card only (``chip_smoke.py`` holds it against these plain versions)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samcarriestheburden_torch import kernels
from samcarriestheburden_torch.kernels import attention as attn_k
from samcarriestheburden_torch.kernels import build
from samcarriestheburden_tpu.kernels import attention as jattn

# the tier-1 command runs six xdist workers on the machine's cores: one
# intra-op thread each, or their thread pools oversubscribe the cores
torch.set_num_threads(1)

KH = KW = 8
HEADS, HD, B = 2, 16, 2
Q_BLOCK = 32
# x max |Pallas|, fp32 inputs.  The plain version and the Pallas body compute
# the same integers but for a probability within an fp32 rounding of a .5 step
# of the 127 scale, where exp's last bit decides; readings at these inputs
# 2.6e-8 to 6.7e-8 (no step flipped), for K7-pv and K7-int8pv alike.  Without
# int8_pv the output moves by 6.2-7.1 % of its max here (q and k of std 0.7: a
# flat softmax, whose small probabilities the fixed scale flushes), so the
# check sees the flag: that must miss by FAULT_MARGIN x TOL.
TOL = 1e-2
FAULT_MARGIN = 4.0


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _inputs(seed):
    rng = np.random.default_rng(seed)
    n = KH * KW
    qkv = (rng.standard_normal((B, n, HEADS, 3 * HD)) * 0.7).astype(np.float32)
    qkv[..., 2 * HD:] *= rng.uniform(0.2, 3.0, HD).astype(np.float32)   # v channels of other scales
    qkv = qkv.reshape(B, n, -1)
    rel = {"rel_pos_h": (0.3 * rng.standard_normal((2 * KH - 1, HD))).astype(np.float32),
           "rel_pos_w": (0.3 * rng.standard_normal((2 * KW - 1, HD))).astype(np.float32)}
    return qkv, rel


def _pallas(qkv, rel, int8_qk, int8_pv):
    s, n, _ = qkv.shape
    p = jattn._headmajor_pad(HD)
    x = np.pad(qkv.reshape(s, n, HEADS, 3 * HD), ((0, 0), (0, 0), (0, 0), (0, p - 3 * HD)))
    tcat = jattn.prepare_rel_tables_window3d({k: jnp.asarray(v) for k, v in rel.items()}, KH,
                                             jnp.float32, ws_w=KW)
    out = jattn.fused_rel_attention_global3d(jnp.asarray(x.reshape(s, n, -1)), tcat, kh=KH,
                                             kw=KW, heads=HEADS, hd=HD, q_block=Q_BLOCK,
                                             int8_qk=int8_qk, int8_pv=int8_pv, interpret=True)
    return np.asarray(out).transpose(1, 2, 0, 3).reshape(s, n, HEADS * HD)


def _ours(qkv, rel, int8_qk, int8_pv):
    tables = attn_k.prepare_rel_tables(_t(rel["rel_pos_h"]), _t(rel["rel_pos_w"]), KH, KW,
                                       torch.float32)
    return attn_k.rel_attention_global(_t(qkv), tables, kh=KH, kw=KW, heads=HEADS, hd=HD,
                                       int8_qk=int8_qk, int8_pv=int8_pv).numpy()


@pytest.mark.parametrize("int8_qk", [False, True], ids=["K7-pv", "K7-int8pv"])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_the_pallas_kernel(int8_qk, seed):
    qkv, rel = _inputs(seed)
    ref = _pallas(qkv, rel, int8_qk, True)
    scale = np.abs(ref).max()
    err = np.abs(_ours(qkv, rel, int8_qk, True) - ref).max()
    assert err <= TOL * scale, (err, scale)
    # the check sees the flag: the same call without int8_pv misses by far more
    miss = np.abs(_ours(qkv, rel, int8_qk, False) - ref).max()
    assert miss >= FAULT_MARGIN * TOL * scale, (miss, scale)


def test_int8_pv_plain_is_the_written_out_arithmetic():
    """Normalised probabilities at the fixed scale 127, values per channel,
    an exact integer product, one dequantization by ``sv / 127``."""
    rng = np.random.default_rng(2)
    logits = (rng.standard_normal((2, 24, 40)) * 3).astype(np.float32)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p = (p / p.sum(-1, keepdims=True)).astype(np.float32)
    v = (rng.standard_normal((2, 40, HD)) * rng.uniform(0.1, 4.0, HD)).astype(np.float32)
    sv = np.abs(v).max(1, keepdims=True) / np.float32(127.0) + np.float32(1e-12)
    want = np.einsum("snm,smc->snc", np.round(p * np.float32(127.0)), np.round(v / sv)) \
        * (sv / np.float32(127.0))
    got = attn_k.int8_pv_plain(_t(p), _t(v)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # probabilities below half a step (1/254) vanish: the fixed scale's flush
    tiny = np.full((1, 1, 40), 1.0 / 300, np.float32)
    assert not attn_k.int8_pv_plain(_t(tiny), _t(v[:1])).any()


def test_the_global_window_shape_of_the_ab_tool_runs_on_the_plain_version():
    """The tool's window shape (14 x 14 tokens as a global grid) through the
    wrapper: n = 196 is not a multiple of the kernel's 64-key tile."""
    rng = np.random.default_rng(3)
    n, heads, hd = 196, 2, 16
    qkv = _t(rng.standard_normal((3, n, heads * 3 * hd)).astype(np.float32)).bfloat16()
    tables = _t((0.1 * rng.standard_normal((2 * 27, hd))).astype(np.float32)).bfloat16()
    outs = [attn_k.rel_attention_global(qkv, tables, kh=14, kw=14, heads=heads, hd=hd,
                                        int8_qk=qk, int8_pv=pv)
            for qk, pv in ((False, False), (True, False), (False, True), (True, True))]
    for o in outs:
        assert o.shape == (3, n, heads * hd) and o.dtype == torch.bfloat16
        assert torch.isfinite(o).all()
    assert not torch.equal(outs[0], outs[2]) and not torch.equal(outs[1], outs[3])


def test_the_wrappers_take_the_plain_version_on_cpu_without_counting(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the CUDA build was reached for a CPU tensor")

    monkeypatch.setattr(build, "load", refuse)
    kernels.reset_launches()
    qkv, rel = _inputs(4)
    _ours(qkv, rel, False, True)
    _ours(qkv, rel, True, True)
    assert kernels.LAUNCHES["K7-pv"] == kernels.LAUNCHES["K7-int8pv"] == 0
