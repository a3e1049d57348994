"""The window attention kernel's host-side helpers (``csrc/window_attention.cuh``:
K5, K6, K9 on windows, K10 and K16 on windows) against the JAX package on the
CPU: the key selectors E that put the rel terms into the tensor-core product
(the TPU kernels' ``ehT``/``ewT`` and K6's ``sel``/``dead``), the selector
form ``q . k + R . E^T`` of the logits against the plain versions' gather
form, and the persistent blocks' item lists.  The CUDA kernel itself runs on
the card only (``chip_smoke.py`` holds every instance against its plain
version at every shape class)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samcarriestheburden_torch.kernels import attention as attn_k
from samcarriestheburden_tpu.kernels import attention as jattn

# the tier-1 command runs six xdist workers on the machine's cores: one
# intra-op thread each, or their thread pools oversubscribe the cores
torch.set_num_threads(1)

# the selector form and the gather form sum the same fp32 terms in another
# order: x max |logits|
LOGIT_RTOL = 1e-6

# (ws, slots): ViT-H's 14 x 14 windows in 200 slots, vit_t's 5 x 5 in 32 (the
# port pads to 8; JAX to 8 as well), a 7 x 7 window in 56
WINDOWS = [(14, 200), (7, 56), (5, 32)]
# (ws, rh, rw): the compact layout's edge windows, ViT-H's and vit_t's
RECTS = [(14, 14, 8), (14, 8, 14), (5, 5, 3), (5, 3, 5)]


def _jax_window3d_selectors(ws, np_):
    """``_attn_kernel_window3d``'s ehT and ewT (JAX kernels/attention.py:461-468),
    the kernel body's own numpy-able lines: key slot j's one at column ws-1-kh
    and ws-1-kw, the dead slots' ewT row zero."""
    n = ws * ws
    key = np.arange(np_)[:, None]
    col = np.arange(ws)[None, :]
    eh = key // ws == ws - 1 - col
    ew = (key % ws == ws - 1 - col) & (key < n)
    return eh.astype(np.float32), ew.astype(np.float32)


def _jax_rect_selectors(monkeypatch, ws, rh, rw):
    """``fused_rel_attention_window_rect``'s ``sel`` and ``dead`` operands, taken
    from its ``pallas_call`` (JAX kernels/attention.py:796-809)."""
    heads, hd = 1, 16
    np_ = -(-rh * rw // 8) * 8
    p = jattn._headmajor_pad(hd)
    captured = {}

    def fake_pallas_call(kernel, **spec):
        def run(*operands):
            captured["sel"], captured["dead"] = operands[3], operands[4]
            out = spec["out_shape"]
            return jnp.zeros(out.shape, out.dtype)
        return run

    monkeypatch.setattr(jattn.pl, "pallas_call", fake_pallas_call)
    with jax.disable_jit():
        jattn.fused_rel_attention_window_rect(
            jnp.zeros((1, np_, heads * p), jnp.float32), jnp.zeros((hd, 256), jnp.float32),
            jnp.zeros((heads, p), jnp.float32), ws=ws, rh=rh, rw=rw, heads=heads, hd=hd)
    return np.asarray(captured["sel"], np.float32), np.asarray(captured["dead"])[0]


@pytest.mark.parametrize("ws,nslots", WINDOWS)
def test_window_selectors_are_jax_window3d_selectors(ws, nslots):
    e, live = attn_k.window_selectors(ws, ws, nslots=nslots)
    eh, ew = _jax_window3d_selectors(ws, nslots)
    # the same ones, each zone's columns reversed (JAX's lane j is cell ws-1-j)
    np.testing.assert_array_equal(e[:, :ws].numpy(), eh[:, ::-1])
    np.testing.assert_array_equal(e[:, ws:].numpy(), ew[:, ::-1])
    np.testing.assert_array_equal(live.numpy(), np.arange(nslots) < ws * ws)


@pytest.mark.parametrize("ws,rh,rw", RECTS)
def test_window_selectors_are_jax_rect_selectors(monkeypatch, ws, rh, rw):
    np_ = -(-rh * rw // 8) * 8
    sel, dead = _jax_rect_selectors(monkeypatch, ws, rh, rw)
    e, live = attn_k.window_selectors(ws, ws, nslots=np_, qh=rh, qw=rw)
    ncols = np_ + ws * ws - rh * rw
    assert e.shape == (ncols, 2 * ws) and ncols <= sel.shape[0]
    # the carried slots, the dead slots, then the pad cells in JAX's coords
    # order; JAX's extra alignment columns past them select nothing
    np.testing.assert_array_equal(e[:, :ws].numpy(), sel[:ncols, :ws][:, ::-1])
    np.testing.assert_array_equal(e[:, ws:].numpy(), sel[:ncols, ws:][:, ::-1])
    assert not sel[ncols:].any()
    np.testing.assert_array_equal(live.numpy(), dead[:ncols] == 0)
    assert (dead[ncols:] < -1e29).all()


def _gather_logits(q, k, tables, ws):
    """``rel_attention_plain``'s unscaled logits (K5): q . k plus the rel terms
    gathered per (query, key) from g = round(q . [Rh; Rw] / scale)."""
    n, hd = q.shape[-2:]
    nk = k.shape[-2]
    scale = hd ** -0.5
    tok = torch.arange(n)
    ph, pw = (tok // ws).clamp(max=ws - 1), tok % ws
    key = torch.arange(nk)
    idx_h = (ph[:, None] - (key // ws).clamp(max=ws - 1)[None] + ws - 1).expand(n, nk)
    idx_w = (pw[:, None] - (key % ws)[None] + ws - 1 + 2 * ws - 1).expand(n, nk)
    g = (q @ tables.T * (1.0 / scale)).to(q.dtype).float()
    return q @ k.T + g.gather(1, idx_h) + g.gather(1, idx_w)


def _gather_logits_rect(q, k, bk, tables, ws, rh, rw):
    """``rel_attention_window_rect_plain``'s unscaled logits (K6): the carried
    keys, then the pad cells (k = b_k), each key's rel terms gathered."""
    n, hd = q.shape
    nreal = rh * rw
    scale = hd ** -0.5
    tok = torch.arange(n)
    ph, pw = (tok // rw).clamp(max=rh - 1), tok % rw
    pad = torch.tensor(attn_k.rect_pad_cells(ws, rh, rw)).reshape(-1, 2)
    key_h = torch.cat([tok[:nreal] // rw, pad[:, 0]])
    key_w = torch.cat([tok[:nreal] % rw, pad[:, 1]])
    nk = key_h.numel()
    idx_h = (ph[:, None] - key_h[None] + ws - 1).expand(n, nk)
    idx_w = (pw[:, None] - key_w[None] + ws - 1 + 2 * ws - 1).expand(n, nk)
    g = (q @ tables.T * (1.0 / scale)).to(q.dtype).float()
    qk = torch.cat([q @ k[:nreal].T, (q @ bk)[:, None].expand(n, nk - nreal)], 1)
    return qk + g.gather(1, idx_h) + g.gather(1, idx_w)


def _inputs(seed, n, nk, hd, ws):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((n, hd)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((nk, hd)).astype(np.float32))
    tables = torch.from_numpy((0.3 * rng.standard_normal((4 * ws - 2, hd))).astype(np.float32))
    return q, k, tables


@pytest.mark.parametrize("ws,nslots", WINDOWS)
@pytest.mark.parametrize("rel", ["full", "base0"])
def test_selector_form_is_the_gather_form(ws, nslots, rel):
    hd = 16
    q, k, tables = _inputs(ws, nslots, nslots, hd, ws)
    e, live = attn_k.window_selectors(ws, ws, nslots=nslots)
    r = attn_k.window_rel_terms(q, tables, kh=ws, kw=ws, rel=rel)
    got = (q @ k.T + r @ e.T)[:, live]
    if rel == "full":
        want = _gather_logits(q, k, tables, ws)[:, live]
    else:   # every query at cell (0, 0): the plain version's rel="base0"
        g = (q @ tables.T * (1.0 / hd ** -0.5)).float()
        key = torch.arange(nslots)[live]
        want = (q @ k.T)[:, live] + g[:, ws - 1 - key // ws] + g[:, 3 * ws - 2 - key % ws]
    assert got.shape == (nslots, ws * ws)
    err = (got - want).abs().max().item()
    assert err <= LOGIT_RTOL * want.abs().max().item(), err


@pytest.mark.parametrize("ws,rh,rw", RECTS)
def test_selector_form_is_the_gather_form_with_pad_cells(ws, rh, rw):
    hd = 16
    nslots = -(-rh * rw // 8) * 8
    q, k, tables = _inputs(rh * 10 + rw, nslots, nslots, hd, ws)
    bk = torch.from_numpy(np.random.default_rng(7).standard_normal(hd).astype(np.float32))
    e, live = attn_k.window_selectors(ws, ws, nslots=nslots, qh=rh, qw=rw)
    r = attn_k.window_rel_terms(q, tables, kh=ws, kw=ws, qh=rh, qw=rw)
    # the kernel's S: q . k over the slots (the pad cells' k rows are zeros),
    # R . E^T over every column, q . b_k added to the pad columns
    kk = torch.cat([k, torch.zeros(ws * ws - rh * rw, hd)])
    s = q @ kk.T + r @ e.T
    s[:, nslots:] += (q @ bk)[:, None]
    got = s[:, live]
    want = _gather_logits_rect(q, k, bk, tables, ws, rh, rw)
    assert got.shape == want.shape == (nslots, ws * ws)
    err = (got - want).abs().max().item()
    assert err <= LOGIT_RTOL * want.abs().max().item(), err


@pytest.mark.parametrize("nitems,grid", [(44, 132), (132, 132), (264, 132), (271, 132),
                                         (1, 132), (800, 132), (3200, 264)])
def test_window_items_cover_each_item_once(nitems, grid):
    items = attn_k.window_items(nitems, grid)
    assert len(items) == min(grid, nitems)
    flat = sorted(i for block in items for i in block)
    assert flat == list(range(nitems))
    # a strided walk: the blocks' loads differ by one item at most
    sizes = [len(b) for b in items]
    assert max(sizes) - min(sizes) <= 1
