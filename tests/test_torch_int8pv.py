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


# The register fragments of wgmma (PTX ISA, "Register Fragments" of
# wgmma.mma_async) that the global kernel's SM_PV instance reads, for the
# thread at quad lane ``tig`` of its warp: entry x of the m64nN accumulator S
# lies at row half (x >> 1) & 1 (row groupID + 8 half) and column 8 (x >> 2) +
# 2 tig + (x & 1); byte b of register r of the 8-bit A operand of m64nNk32 at
# row half r & 1 and column 16 (r >> 1) + 4 tig + b.
def _s_entry(x, tig):
    return (x >> 1) & 1, 8 * (x >> 2) + 2 * tig + (x & 1)


def _a_byte(r, b, tig):
    return r & 1, 16 * (r >> 1) + 4 * tig + b


def test_vq_key_order_is_a_permutation_of_each_chunk():
    order = attn_k.pv_key_order()
    assert order.shape == (32,) and sorted(order.tolist()) == list(range(32))
    entries = attn_k.pv_fragment_entries()
    assert entries.shape == (2, 4, 4)
    # each k-step's 16 bytes of each row half are 16 distinct entries of S, and
    # the two k-steps take every entry once
    for half in (0, 1):
        taken = entries[:, half::2].flatten().tolist()
        assert sorted(taken) == sorted(x for x in range(32) if (x >> 1) & 1 == half)


def _keys_read(tig):
    """For the thread at quad lane tig: per row half, the tile keys of the
    probabilities it packs (accumulator order) and the vq positions its A
    bytes meet (fragment order), both over the 64 keys of a tile."""
    order, entries = attn_k.pv_key_order(), attn_k.pv_fragment_entries()
    keys, pos = {0: [], 1: []}, {0: [], 1: []}
    for kk in range(2):
        for r in range(4):
            for b in range(4):
                half, key = _s_entry(int(entries[kk, r, b]), tig)
                a_half, col = _a_byte(r, b, tig)
                assert half == a_half
                keys[half].append(key)
                pos[half].append(32 * kk + col)
    return keys, pos


@pytest.mark.parametrize("n", [196, 4096])
def test_fragment_order_against_vq_gives_the_exact_int8_product(n):
    """A thread's int8 probabilities read in accumulator order, packed as the A
    fragment, against vq's rows written in :func:`pv_key_order`: summed over
    the quad's lanes, every row gets ``int8_pv_plain``'s exact integer product
    (the keys past n read zeros on both sides)."""
    rng = np.random.default_rng(5)
    rows, hd = 16, HD
    nkp = -(-n // 64) * 64
    logits = (rng.standard_normal((1, rows, n)) * 2.5).astype(np.float32)
    p = torch.softmax(_t(logits), -1)
    v = _t((rng.standard_normal((1, n, hd)) * rng.uniform(0.1, 4.0, hd)).astype(np.float32))
    sv = v.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
    vi = torch.round(v / sv)[0]                                   # (n, hd)
    pi = torch.round(p * 127.0)[0]                                # (rows, n)
    # vq as v_quant_kernel writes it: (hd, nkp), position kp of chunk c holds
    # key 32 c + pv_key_order()[kp], zero past n
    vpad = torch.cat([vi, torch.zeros(nkp - n, hd)])
    key_of_pos = (torch.arange(nkp) // 32) * 32 + attn_k.pv_key_order().repeat(nkp // 32)
    vq = vpad[key_of_pos].T.to(torch.int8)
    ppad = torch.cat([pi, torch.zeros(rows, nkp - n)], 1)
    tiles = torch.arange(nkp // 64)[:, None] * 64
    got = torch.zeros(rows, hd, dtype=torch.float64)
    for tig in range(4):
        keys, pos = _keys_read(tig)
        for row in range(rows):
            half = row // 8
            k_idx = (tiles + torch.tensor(keys[half])[None]).flatten()
            v_idx = (tiles + torch.tensor(pos[half])[None]).flatten()
            got[row] += ppad[row, k_idx].double() @ vq[:, v_idx].double().T
    want = attn_k.int8_pv_plain(p, v)[0]
    assert torch.equal((got.float() * (sv / 127.0))[0], want)
