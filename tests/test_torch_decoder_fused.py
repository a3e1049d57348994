"""D1, the decoder's image-to-token branch in one kernel (``kernels/decoder.py``).

CPU: the plain version against the block's unfused branch (one image row for
G = 1 or 17 items, row-contiguous and channel-major keys, Nq 7 and 23), the
dispatch (``decoder.fused_applies``) and its counters, what the wrapper
refuses, the operator's flop formula, the block's transposed weights, and
the blocks' own code off the card bit for bit.  On the card only (``-m
chip``, skipped here): D1 against its plain version at the refine cell's
shapes, its bits over three calls, and its launches per
``SamSegRefiner._refine_batched``.  This file does
not import JAX: the decoder's parity with the JAX package is held by
``test_torch_sam.py`` and ``test_torch_refine_batch.py``, unchanged.
"""

import pytest
import torch

from samcarriestheburden_torch import kernels, profiling
from samcarriestheburden_torch.config import MaskDecoderConfig, sam_vit_t_config
from samcarriestheburden_torch.models.sam import build_sam
from samcarriestheburden_torch.tools import refine_roofline
from samcarriestheburden_torch.kernels import decoder
from samcarriestheburden_torch.models import transformer
from samcarriestheburden_torch.models.common import norm, random_init_
from samcarriestheburden_torch.models.transformer import TwoWayAttentionBlock, TwoWayTransformer

torch.set_num_threads(1)

C, HW = 256, 64


def block(seed: int = 0, whole: bool = False, skip_first_layer_pe: bool = False):
    """A block (``whole``: the two-way transformer) at the decoder's widths
    with seeded weights and LayerNorms that are not the identity."""
    cfg = MaskDecoderConfig()
    mod = TwoWayTransformer(cfg) if whole else TwoWayAttentionBlock(cfg, skip_first_layer_pe)
    random_init_(mod, torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in mod.modules():
            if isinstance(m, torch.nn.LayerNorm):
                m.weight.copy_(1 + 0.2 * torch.randn(m.weight.shape, generator=gen))
                m.bias.copy_(0.2 * torch.randn(m.bias.shape, generator=gen))
    return mod.eval()


def operands(n_img: int, g: int, nq: int, layout: str, seed: int = 2, dtype=torch.float32):
    """keys (n_img, HW, C) in ``layout`` ('contiguous' or 'channel_major', the
    view ``src.flatten(2).transpose(1, 2)`` makes), key_pe (1, HW, C), queries
    and query_pe (n_img * g, nq, C)."""
    gen = torch.Generator().manual_seed(seed)
    src = torch.randn((n_img, C, HW), generator=gen)
    keys = src.transpose(1, 2) if layout == "channel_major" else src.transpose(1, 2).contiguous()
    key_pe = torch.randn((1, HW, C), generator=gen)
    queries = torch.randn((n_img * g, nq, C), generator=gen)
    query_pe = torch.randn((n_img * g, nq, C), generator=gen)
    return tuple(t.to(dtype) for t in (keys, key_pe, queries, query_pe))


def unfused(blk, keys, key_pe, queries, query_pe):
    """The block's image-to-token branch as it is written in
    ``TwoWayAttentionBlock`` (G = 1) and ``forward_image_shared`` (G > 1)."""
    attn = blk.cross_attn_image_to_token
    g = queries.shape[0] // keys.shape[0]
    if g == 1:
        out = attn(keys + key_pe, queries + query_pe, queries)
        return norm(blk.norm4, keys + out)
    out = attn.forward_shared_queries(keys + key_pe, queries + query_pe, queries)
    return norm(blk.norm4, keys.repeat_interleave(g, dim=0) + out)


def rel_err(a, b) -> float:
    return ((a - b).abs().max() / b.abs().max()).item()


@pytest.mark.parametrize("layout", ["contiguous", "channel_major"])
@pytest.mark.parametrize("g,nq", [(1, 7), (1, 23), (17, 7), (17, 23)])
def test_plain_version_equals_the_unfused_branch(g, nq, layout):
    """q split as keys . Wq^T + (key_pe . Wq^T + b_q), the image row shared
    by G items with no repeat: the same function within 1e-6 relative."""
    blk = block()
    ops = operands(2, g, nq, layout)
    with torch.no_grad():
        got = decoder.image_to_token_plain(*ops, blk._i2t_weights())
        want = unfused(blk, *ops)
    assert got.shape == (2 * g, HW, C)
    assert rel_err(got, want) <= 1e-6


def test_the_wrapper_takes_the_plain_version_on_cpu(monkeypatch):
    """A CPU tensor never reaches the build (there is no nvcc here) and
    launches nothing."""
    def refuse(*a, **k):
        raise AssertionError("the CUDA build was reached for a CPU tensor")

    monkeypatch.setattr(decoder.build, "load", refuse)
    blk = block()
    ops = operands(2, 3, 7, "channel_major")
    before = kernels.LAUNCHES["D1"]
    with torch.no_grad():
        got = decoder.image_to_token(*ops, blk._i2t_weights())
        want = decoder.image_to_token_plain(*ops, blk._i2t_weights())
    assert torch.equal(got, want) and kernels.LAUNCHES["D1"] == before


def test_dispatch_takes_the_kernel_only_for_fp32_on_the_card(monkeypatch):
    assert decoder.fused_applies("cuda", torch.float32)
    assert not decoder.fused_applies("cpu", torch.float32)
    assert not decoder.fused_applies("cuda", torch.bfloat16)
    monkeypatch.setattr(torch.compiler, "is_exporting", lambda: True)
    assert not decoder.fused_applies("cuda", torch.float32)


def _refused(change):
    """The operands of ``operands(2, 3, 7, 'channel_major')`` and a block's
    weights, with ``change(ops, weights)`` applied; returns the error."""
    blk = block()
    ops, w = list(operands(2, 3, 7, "channel_major")), blk._i2t_weights()
    ops, w = change(ops, w)
    with torch.no_grad(), pytest.raises(ValueError) as err:
        decoder.image_to_token(*ops, w)
    return str(err.value)


def test_the_wrapper_raises_on_what_d1_does_not_take():
    """No fallback: the toy widths of the test configuration, bf16, a grid
    that is no multiple of 64 rows, too many tokens, other strides, and a
    call that could need a backward all raise, on the CPU as on the card."""
    toy = TwoWayAttentionBlock(sam_vit_t_config().mask_decoder, False)
    gen = torch.Generator().manual_seed(0)
    toy_ops = [torch.randn(s, generator=gen) for s in ((2, 64, 16), (1, 64, 16), (2, 7, 16),
                                                        (2, 7, 16))]
    with torch.no_grad(), pytest.raises(ValueError, match="width"):
        decoder.image_to_token(*toy_ops, toy._i2t_weights())
    assert "fp32" in _refused(lambda o, w: ([t.bfloat16() for t in o], w))
    assert "multiple of 64" in _refused(lambda o, w: ([o[0][:, :48], o[1][:, :48]] + o[2:], w))
    assert "tokens" in _refused(lambda o, w: (o[:2] + [t.repeat(1, 21, 1) for t in o[2:]], w))
    assert "strides" in _refused(lambda o, w: ([torch.randn(2, HW, C + 1)[..., :C]] + o[1:], w))
    blk = block()     # parameters that require grad, outside no_grad
    with pytest.raises(ValueError, match="backward"):
        decoder.image_to_token(*operands(2, 3, 7, "channel_major"), blk._i2t_weights())


def test_the_flop_counter_counts_the_products_inside_d1():
    """``FlopCounterMode`` over the operator counts its flop formula (q over
    the image rows, q.k, p.v, the out projection) and nothing it runs
    inside; over the wrapper it adds the projections made before it."""
    from torch.utils.flop_counter import FlopCounterMode

    blk, (n_img, g, nq) = block(), (2, 3, 7)
    ops, w = operands(n_img, g, nq, "channel_major"), blk._i2t_weights()
    b, d = n_img * g, 128
    inside = 2 * (n_img * HW * C * d + 2 * b * HW * nq * d + b * HW * d * C)
    before = 2 * (HW * C * d + 2 * b * nq * C * d)            # the table, k and v
    peq, kt, vt = decoder._projections(*ops, w)
    with torch.no_grad(), FlopCounterMode(display=False) as op:
        decoder.d1_image_to_token(ops[0], peq, w.wq_t, kt, vt, w.wo_t, w.bo, w.gamma, w.beta,
                                  w.eps, w.heads)
    with torch.no_grad(), FlopCounterMode(display=False) as whole:
        decoder.image_to_token(*ops, w)
    assert op.get_total_flops() == inside
    assert whole.get_total_flops() == inside + before


def test_refine_roofline_counts_the_fused_decode(monkeypatch):
    """The roofline tool's count with every block on D1 (the operator's CPU
    implementation) equals the analytic count with D1's positional table;
    unfused it stays the analytic count without it."""
    model = build_sam(sam_vit_t_config(sam_decoder=True), device="cpu", seed=0)
    inputs = refine_roofline.decode_inputs(model, torch.device("cpu"))
    b, n = inputs[2].shape
    plain = refine_roofline.count_flops(model, inputs)
    monkeypatch.setattr(transformer.decoder, "fused_applies", lambda dev, dt: True)
    with profiling.recording() as rec:
        fused = refine_roofline.count_flops(model, inputs)
    assert rec.counters == {"decode.i2t_fused": 4}
    assert plain == sum(refine_roofline.analytic_flops(model.cfg, b, n).values())
    assert fused == sum(refine_roofline.analytic_flops(model.cfg, b, n, fused=True).values())
    assert fused - plain == 4 * 2 * HW * C * 128


def test_the_blocks_transposed_weights_follow_their_weights():
    """The block copies Wq^T and Wout^T once, and again after a weight
    changes in place or is replaced."""
    blk = block()
    attn = blk.cross_attn_image_to_token
    first = blk._i2t_weights()
    assert blk._i2t_weights().wq_t is first.wq_t
    assert torch.equal(first.wq_t, attn.q_proj.weight.t())
    with torch.no_grad():
        attn.q_proj.weight.mul_(2)
    second = blk._i2t_weights()
    assert second.wq_t is not first.wq_t and torch.equal(second.wq_t, attn.q_proj.weight.t())
    attn.out_proj.weight = torch.nn.Parameter(attn.out_proj.weight.detach() + 1)
    assert torch.equal(blk._i2t_weights().wo_t, attn.out_proj.weight.t())


def test_items_per_block_splits_g_evenly():
    assert [decoder.items_per_block(g) for g in (1, 6, 7, 17, 64)] == [1, 6, 4, 6, 6]


def test_transformer_routes_and_counts_every_block_call(monkeypatch):
    """With the dispatch forced to D1 (whose CPU path is the plain version),
    the two-way transformer's output stays within 1e-6 relative of the
    unfused one, in the shared first round and the per-item second; each
    block call counts once under its route."""
    tf = block(3, whole=True)
    gen = torch.Generator().manual_seed(4)
    img = torch.randn((2, C, 8, 8), generator=gen)
    pe = torch.randn((1, C, 8, 8), generator=gen)
    pts = torch.randn((2 * 17, 7, C), generator=gen)
    src2 = torch.randn((2 * 17, C, 8, 8), generator=gen)
    pts2 = torch.randn((2 * 17, 23, C), generator=gen)
    runs = {}
    for route in ("plain", "fused"):
        monkeypatch.setattr(transformer.decoder, "fused_applies",
                            lambda dev, dt, r=route: r == "fused")
        with torch.no_grad(), profiling.recording() as rec:
            runs[route] = (tf(img, pe, pts, image_shared=True), tf(src2, pe, pts2))
        assert rec.counters == {f"decode.i2t_{route}": 4}, rec.counters
    for got, want in zip(runs["fused"], runs["plain"]):
        for a, b in zip(got, want):
            assert rel_err(a, b) <= 1e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shared", [False, True])
def test_blocks_keep_todays_code_off_the_card(dtype, shared):
    """CPU tensors (fp32 and the bf16 decode) run the branch as written, bit
    for bit."""
    blk = block(5, skip_first_layer_pe=shared)
    keys, key_pe, queries, query_pe = operands(2, 3 if shared else 1, 7, "channel_major",
                                               dtype=dtype)
    with torch.no_grad(), profiling.recording() as rec:
        if shared:
            q_out, k_out = blk.forward_image_shared(queries, keys, query_pe, key_pe)
            q_in = q_out
        else:
            q_out, k_out = blk(queries, keys, query_pe, key_pe)
            q_in = q_out
        want = unfused(blk, keys, key_pe, q_in, query_pe)
    assert rec.counters == {"decode.i2t_plain": 1}
    assert k_out.dtype == dtype and torch.equal(k_out, want)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    """Skip unless a CUDA device is present (decided in the test, never at
    import), with fp32 products in full fp32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = saved


#: the refine cell's shapes: 16 images x 17 classes, 64 x 64 rows of 256; the
#: first block of round 1 (G = 17, Nq 7, channel-major src), the second (G = 1,
#: Nq 7, contiguous), round 2's two (G = 1, Nq 23, channel-major then contiguous)
CELL_CASES = [(17, 7, "channel_major"), (1, 7, "contiguous"), (1, 23, "channel_major"),
              (1, 23, "contiguous")]
#: D1 against the plain version on the card (cuBLAS fp32 products): the sums
#: run in other orders, so the LayerNorm'd rows (|y| up to ~5) part by a few
#: fp32 ulps of the pre-norm row
CARD_TOL = 2e-5


def cell_operands(g, nq, layout, dev, seed=11):
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_img = 16 if g > 1 else 16 * 17
    src = torch.randn((n_img, C, 64, 64), generator=gen, device=dev)
    keys = src.flatten(2).transpose(1, 2)
    if layout == "contiguous":
        keys = keys.contiguous()
    key_pe = torch.randn((1, 4096, C), generator=gen, device=dev).expand(16 * 17, -1, -1)
    queries = torch.randn((16 * 17, nq, C), generator=gen, device=dev)
    query_pe = torch.randn((16 * 17, nq, C), generator=gen, device=dev)
    return keys, key_pe, queries, query_pe


@pytest.mark.chip
@pytest.mark.parametrize("g,nq,layout", CELL_CASES)
def test_d1_equals_its_plain_version_at_the_cells_shapes(g, nq, layout, card):
    from torch.utils.flop_counter import FlopCounterMode

    blk = block(7).to(card)
    ops, w = cell_operands(g, nq, layout, card), blk._i2t_weights()
    with torch.no_grad():
        want = decoder.image_to_token_plain(*ops, w)
        before = kernels.LAUNCHES["D1"]
        with FlopCounterMode(display=False) as fc:
            outs = [decoder.image_to_token(*ops, w)]
        outs += [decoder.image_to_token(*ops, w) for _ in range(2)]
        torch.cuda.synchronize()
    assert kernels.LAUNCHES["D1"] - before == 3
    assert decoder._lib().d1_max_tokens() == decoder.MAX_TOKENS
    b, n_img, d = 16 * 17, ops[0].shape[0], 128
    assert fc.get_total_flops() == 2 * (4096 * C * d + 2 * b * nq * C * d + n_img * 4096 * C * d
                                        + 2 * b * 4096 * nq * d + b * 4096 * d * C)
    assert all(torch.equal(o, outs[0]) for o in outs[1:]), "D1 is not deterministic"
    err = (outs[0] - want).abs().max().item()
    assert outs[0].shape == want.shape and err <= CARD_TOL, err


@pytest.mark.chip
def test_d1_launches_four_times_per_refine_batch(card):
    """One ``refine_batch`` (one ``_refine_batched``) of 2 images x 17 classes
    at ViT-H's decoder: two rounds of two blocks, every block on D1, none on
    the unfused branch."""
    import numpy as np

    from samcarriestheburden_torch.config import sam_vit_h_config
    from samcarriestheburden_torch.data.h5io import MemoryEmbeddings
    from samcarriestheburden_torch.engine.decoder_head import SamMaskDecoderHead
    from samcarriestheburden_torch.engine.refinement import SamSegRefiner
    from samcarriestheburden_torch.models.sam import build_sam

    model = build_sam(sam_vit_h_config(), device=card, seed=0)
    n, classes, hw = 2, 17, (96, 64)
    store = MemoryEmbeddings(1024)
    rng = np.random.default_rng(0)
    for i in range(n):
        store.write(f"img{i}", rng.standard_normal((1, C, 64, 64)), (384, 256), (1024, 683))
    head = SamMaskDecoderHead(None, "vit_h", store, device=card, params=model)
    ref = SamSegRefiner(head, prompts2use=[["box"], ["pos_points", "neg_points", "box"]])
    masks = torch.zeros((n, classes, *hw), dtype=torch.bool)
    for c in range(classes):
        masks[:, c, 4 + c * 5: 9 + c * 5, 10:30] = True
    before = kernels.LAUNCHES["D1"]
    with profiling.recording() as rec:
        ref.refine_batch(masks, [f"img{i}" for i in range(n)])
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["D1"] - before == 4
    assert rec.counters.get("decode.i2t_fused") == 4 and "decode.i2t_plain" not in rec.counters
    spans = [s.name for s in rec.spans]
    assert spans.count("kernels.D1") == 4


@pytest.mark.chip
def test_an_fp32_decode_at_other_widths_raises_on_the_card(card):
    """No fallback on the card: a block at the test configuration's toy
    widths sends its fp32 branch to D1, which refuses it."""
    blk = TwoWayAttentionBlock(sam_vit_t_config().mask_decoder, False).to(card)
    gen = torch.Generator(device=card).manual_seed(0)
    keys, key_pe = (torch.randn((1, 64, 16), generator=gen, device=card) for _ in range(2))
    queries, query_pe = (torch.randn((1, 7, 16), generator=gen, device=card) for _ in range(2))
    with torch.no_grad(), pytest.raises(ValueError, match="width"):
        blk(queries, keys, query_pe, key_pe)
