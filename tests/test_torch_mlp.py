"""K1 and K3 (``kernels/mlp.py``) on ragged row counts and at the shapes their
TMA + wgmma GEMMs cannot take, and K13 (``kernels/cost_probe.py``) as the
operator ``samcarriestheburden::cost_probe`` is registered, on the CPU.

K1's and K3's plain versions are held against the JAX package's Pallas
kernels run with ``interpret=True`` at row counts that are no multiple of the
kernels' 128-row tile (200: one Pallas block; 300: a full block of 256 and a
ragged one), with the tolerance of ``test_torch_kernels.py`` (atol 2e-4 in
fp32).  The wrappers must refuse a shape TMA cannot take (a width that is no
multiple of 8 bf16, no row) before any build, on tensors that are not on the CPU (``meta`` ones here).  K13 must
count exactly its declared cost under ``FlopCounterMode``, give ``x * 2.0``
bit for bit (inf and NaN included) on the CPU, and give the input's shape
and type through its fake kernel, with no Python autograd layer registered.
"""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from samcarriestheburden_torch import kernels
from samcarriestheburden_torch.config import sam_vit_t_config
from samcarriestheburden_torch.kernels import build
from samcarriestheburden_torch.kernels import cost_probe as k13
from samcarriestheburden_torch.kernels import mlp as mlp_k
from samcarriestheburden_tpu.kernels import mlp as jmlp

torch.set_num_threads(1)

ATOL = 2e-4
CFG = sam_vit_t_config().image_encoder
E = CFG.embed_dim
EPS = CFG.layer_norm_eps


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _ln_params(rng, e):
    return (1 + 0.1 * rng.standard_normal(e)).astype(np.float32), \
        (0.1 * rng.standard_normal(e)).astype(np.float32)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("t", [200, 300])
def test_k1_plain_matches_pallas_on_ragged_rows(t, masked):
    rng = np.random.default_rng(t + masked)
    o = 3 * E
    x = rng.standard_normal((t, E)).astype(np.float32)
    mask = (rng.random((t, 1)) > 0.3).astype(np.float32) if masked \
        else np.ones((t, 1), np.float32)
    g, b = _ln_params(rng, E)
    w = (rng.standard_normal((E, o)) / np.sqrt(E)).astype(np.float32)
    bias = rng.standard_normal(o).astype(np.float32)

    ref = np.asarray(jmlp.fused_ln_masked_linear(x, mask, g, b, w, bias, eps=EPS,
                                                 interpret=True))
    ours = mlp_k.ln_masked_linear(_t(x), _t(mask) if masked else None, _t(g), _t(b),
                                  _t(w.T), _t(bias), EPS)
    assert ours.shape == (t, o)
    np.testing.assert_allclose(ours.numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("with_add", [False, True])
def test_k3_plain_matches_pallas_on_ragged_rows(with_add):
    t, m = 300, 4 * E
    rng = np.random.default_rng(7 + with_add)
    x = rng.standard_normal((t, E)).astype(np.float32)
    add = rng.standard_normal((t, E)).astype(np.float32) if with_add else None
    g, b = _ln_params(rng, E)
    w1 = (rng.standard_normal((E, m)) / np.sqrt(E)).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(m)).astype(np.float32)
    w2 = (rng.standard_normal((m, E)) / np.sqrt(m)).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(E)).astype(np.float32)

    ref = np.asarray(jmlp.fused_ln_mlp_residual(x, g, b, w1, b1, w2, b2, add, eps=EPS,
                                                interpret=True))
    ours = mlp_k.ln_mlp_residual(_t(x), _t(g), _t(b), _t(w1.T), _t(b1), _t(w2.T), _t(b2),
                                 add=None if add is None else _t(add), eps=EPS)
    assert ours.shape == (t, E)
    np.testing.assert_allclose(ours.numpy(), ref, atol=ATOL)


@pytest.fixture
def no_compiler(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the CUDA build was reached")

    monkeypatch.setattr(build, "load", refuse)
    monkeypatch.setattr(build, "build", refuse)
    kernels.reset_launches()
    yield
    assert not any(kernels.LAUNCHES.values()), kernels.LAUNCHES


def _k1_operands(t, e, o, device="meta"):
    bf, f = torch.bfloat16, torch.float32
    return (torch.empty((t, e), dtype=bf, device=device), torch.empty((t, 1), dtype=bf,
                                                                      device=device),
            torch.empty(e, dtype=f, device=device), torch.empty(e, dtype=f, device=device),
            torch.empty((o, e), dtype=bf, device=device), torch.empty(o, dtype=f, device=device))


def _k3_operands(t, e, m, device="meta"):
    bf, f = torch.bfloat16, torch.float32
    return (torch.empty((t, e), dtype=bf, device=device), torch.empty(e, dtype=f, device=device),
            torch.empty(e, dtype=f, device=device), torch.empty((m, e), dtype=bf, device=device),
            torch.empty(m, dtype=f, device=device), torch.empty((e, m), dtype=bf, device=device),
            torch.empty(e, dtype=f, device=device))


@pytest.mark.parametrize("t, e, o, what", [
    (64, 36, 96, "E"),          # x's and w's rows: 72 bytes, no 16-byte pitch
    (64, 32, 100, "O"),         # the output's rows and the bias
    (64, 4, 96, "E"),           # less than one 16-byte row
    (0, 32, 96, "one row"),     # no rows: nothing to launch
])
def test_k1_refuses_what_tma_cannot_take_before_any_build(no_compiler, t, e, o, what):
    with pytest.raises(ValueError, match=what):
        mlp_k.ln_masked_linear(*_k1_operands(t, e, o))


@pytest.mark.parametrize("t, e, m, what", [
    (64, 36, 128, "E"),
    (64, 32, 100, "M"),         # the hidden's rows: lin2's contraction
    (0, 32, 128, "one row"),
])
def test_k3_refuses_what_tma_cannot_take_before_any_build(no_compiler, t, e, m, what):
    with pytest.raises(ValueError, match=what):
        mlp_k.ln_mlp_residual(*_k3_operands(t, e, m))


def test_shapes_tma_takes_reach_the_device_check(no_compiler):
    """A shape TMA takes, ragged rows included, gets past the shape check to
    the device check, which refuses a tensor that is not on the card, still
    before any build."""
    for t in (1, 300):
        with pytest.raises(ValueError, match="CUDA"):
            mlp_k.ln_masked_linear(*_k1_operands(t, 32, 96))
        with pytest.raises(ValueError, match="CUDA"):
            mlp_k.ln_mlp_residual(*_k3_operands(t, 32, 128))


def test_the_probe_counts_its_declared_cost_and_keeps_special_values():
    """K13 as the operator is registered: one call counts exactly the
    declared cost, the output is ``x * 2.0`` bit for bit with inf, NaN and an
    overflow to inf among the values, a ragged size included, and the CPU
    call launches nothing."""
    rng = np.random.default_rng(13)
    kernels.reset_launches()
    for shape in ((128, 128), (1001, 7)):
        x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * 100).bfloat16()
        x.view(-1)[:4] = torch.tensor([float("inf"), float("-inf"), float("nan"), 3.0e38])
        with FlopCounterMode(display=False) as fc:
            out = k13.cost_probe(x, 1234567)
        assert fc.get_total_flops() == 1234567
        assert torch.equal(out.view(torch.int16), (x * 2.0).view(torch.int16))
        assert out.dtype == torch.bfloat16 and out.shape == x.shape
    assert kernels.LAUNCHES["K13"] == 0


def test_the_probe_is_a_plain_operator_with_a_fake_kernel():
    """``torch.ops.samcarriestheburden.cost_probe`` has kernels for the CPU
    and CUDA keys and no autograd kernel of its own (no Python layer before
    the device's kernel), and is ``cost_probe`` itself;
    its fake kernel gives the input's shape and type on ``meta`` tensors and
    under ``FakeTensorMode``, where FlopCounterMode still counts the declared
    cost."""
    op = torch.ops.samcarriestheburden.cost_probe
    assert k13.cost_probe is op.default
    x = torch.arange(6.0).bfloat16()
    assert torch.equal(op(x, 1), k13.cost_probe(x, 1)) and torch.equal(op(x, 1), x * 2.0)
    name = "samcarriestheburden::cost_probe"
    assert torch._C._dispatch_has_kernel_for_dispatch_key(name, "CPU")
    assert torch._C._dispatch_has_kernel_for_dispatch_key(name, "CUDA")
    assert not torch._C._dispatch_has_kernel_for_dispatch_key(name, "AutogradCUDA")
    meta = op(torch.empty((3, 40), dtype=torch.bfloat16, device="meta"), 5)
    assert meta.shape == (3, 40) and meta.dtype == torch.bfloat16 and meta.device.type == "meta"
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        fake = torch.empty((5, 8), dtype=torch.bfloat16)
        with FlopCounterMode(display=False) as fc:
            out = k13.cost_probe(fake, 99)
        assert out.shape == (5, 8) and out.dtype == torch.bfloat16
    assert fc.get_total_flops() == 99
