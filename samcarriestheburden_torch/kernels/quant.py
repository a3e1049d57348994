"""K2, K4 and K15: the int8 variants of the encoder's LayerNorm + matrix
product kernels, over prequantized weights (JAX ``kernels/quant.py``), and
K4's experimental variants.

K2 ``ln_masked_linear_int8`` is K1 (``(LN(x) * mask) @ w.T + b``) and K4
``ln_mlp_residual_int8`` is K3 (``s + lin2(GELU(lin1(LN(s))))``, ``s = x
(+ add)``) in dynamic post-training int8:

* weights: symmetric per-output-channel int8 (:func:`quantize_weight`),
  quantized once outside the serving loop (``models/quantize.py``);
* activations: symmetric per-row (per-token) int8 (:func:`row_quant`), taken
  after the LayerNorm; K4 requantizes its hidden activation per row, from its
  fp32 value, between the two products;
* products accumulate in int32 and are dequantized by the rank-1 product of
  row and channel scales; LayerNorm statistics, GELU and residuals are fp32.

The row quantization needs no clip: with ``s = absmax / 127`` the scaled
magnitudes round to at most 127.  Weights are int8 ``(out, in)`` like
``nn.Linear``, their scales fp32 ``(out,)``.

K15 ``ln_mlp_residual_int8_exp`` is K4 (without ``add``) with the variants
of the JAX experiment tools (``tools/exp_int8.py:mk_chunked``, ``mk_diag``,
``tools/exp_mlp2.py:mk``): the hidden split into column chunks, each
requantized per (row, chunk) and its lin2 partial dequantized and summed in
fp32; other activations; the row quantization by the reciprocal; a fixed
hidden scale.

The plain versions do the integer products in float64: K2's and K4's
accumulants reach 127^2 * 1280 and 127^2 * 5120, beyond float32's 2^24, and
PyTorch has no integer ``matmul`` on CUDA; float64 is exact for both and the
same on the CPU and the card.  The CUDA kernels (``csrc/quant.cu``) take bf16
activations.
"""

from __future__ import annotations

import ctypes

import torch

from samcarriestheburden_torch.kernels import (LAUNCHES, build, check_cuda, ptr,
                                               raise_on_error, stream)
from samcarriestheburden_torch.profiling import span

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

#: odd-polynomial fit of Phi(x) = 0.5 (1 + erf(x / sqrt 2)), degree 13 in x,
#: Horner coefficients in u = x^2 from the highest power down, tails
#: saturated by the clip in :func:`gelu_phi_poly` (JAX ``_PHI_POLY``)
PHI_POLY = (1.0962050526e-08, -9.3423034307e-07, 3.3436889582e-05,
            -6.5934551371e-04, 7.9518464564e-03, -6.2628257803e-02,
            3.9645120080e-01)

GELU_IMPLS = ("poly", "erf")
#: K15's activations and row quantizations, in the order of their C codes
ACTS = ("poly", "erf", "sigmoid", "relu")
ROW_QUANTS = ("div", "recip")
#: K15's hidden scale with ``fixed_hscale``; a timing variant with wrong numbers
FIXED_HSCALE = 8.0


def _lib():
    lib = build.load("quant")
    if not getattr(lib, "_typed", False):
        lib.k2_ln_masked_linear_int8.argtypes = [_VP] * 10 + [_I, _I, _I, _F, _VP]
        lib.k2_ln_masked_linear_int8.restype = _I
        lib.k4_ln_mlp_residual_int8.argtypes = [_VP] * 16 + [_I, _I, _I, _F, _I, _VP]
        lib.k4_ln_mlp_residual_int8.restype = _I
        lib.k15_ln_mlp_residual_int8_exp.argtypes = [_VP] * 16 + [_I, _I, _I, _F] + [_I] * 4 \
            + [_VP]
        lib.k15_ln_mlp_residual_int8_exp.restype = _I
        lib._typed = True
    return lib


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------


def quantize_weight(w: torch.Tensor):
    """(O, I) -> int8 (O, I) weights + (O,) fp32 per-output-channel scales."""
    wf = w.float()
    scale = wf.abs().amax(dim=1, keepdim=True).clamp(min=1e-12) / 127.0
    wq = torch.round(wf / scale).clamp(-127, 127)
    return wq.to(torch.int8), scale[:, 0].contiguous()


def row_quant(x: torch.Tensor):
    """fp32 (T, I) -> integer-valued fp32 rows + (T, 1) fp32 scales
    (symmetric absmax; rounding half to even; no clip)."""
    s = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-12) / 127.0
    return torch.round(x / s), s


def row_quant_recip(x: torch.Tensor):
    """:func:`row_quant` by the row's reciprocal: ``rint(x * (127 / a))`` with
    the scale ``a * fp32(1/127)``, ``a = max(absmax, 1e-12)`` (JAX
    ``tools/exp_mlp2.py:_rq_recip``)."""
    a = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-12)
    return torch.round(x * (a.new_full((), 127.0) / a)), a * (1.0 / 127.0)


def _int8_product(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Integer-valued (T, I) x int8 (O, I) -> their exact product in fp32
    (every int32 accumulant below 2^31 is a float64, and rounds once)."""
    return (xq.double() @ wq.double().T).float()


def _erf(x: torch.Tensor) -> torch.Tensor:
    """Abramowitz & Stegun 7.1.26 (|error| <= 1.5e-7), the JAX kernels' erf."""
    a = x.abs()
    t = 1.0 / (1.0 + 0.3275911 * a)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    return torch.sign(x) * (1.0 - poly * torch.exp(-a * a))


def gelu_phi_poly(h: torch.Tensor, impl: str = "poly") -> torch.Tensor:
    """K4's GELU in fp32: ``h * clip(0.5 + h * P(h^2), 0, 1)`` with the
    :data:`PHI_POLY` fit (``'poly'``), or ``0.5 h (1 + erf(h / sqrt 2))`` with
    the Abramowitz & Stegun erf (``'erf'``)."""
    if impl == "erf":
        return 0.5 * h * (1.0 + _erf(h * 0.7071067811865476))
    if impl != "poly":
        raise ValueError(f"gelu must be one of {GELU_IMPLS}, got {impl!r}")
    u = h * h
    p = torch.full_like(h, PHI_POLY[0])
    for c in PHI_POLY[1:]:
        p = p * u + c
    return h * torch.clamp(0.5 + h * p, 0.0, 1.0)


def _layer_norm_f32(xf, ln_weight, ln_bias, eps):
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    xn = (xf - mean) * torch.rsqrt(var + eps)
    return xn * ln_weight.float() + ln_bias.float()


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------


def ln_masked_linear_int8_plain(x, mask, ln_weight, ln_bias, wq, s, b,
                                eps: float = 1e-6):
    """Plain version of K2.  x (T, E); mask (T, 1) or None; wq (O, E) int8;
    s, b (O,) fp32.  A fully masked row quantizes to zeros: its output is b."""
    xn = _layer_norm_f32(x.float(), ln_weight, ln_bias, eps)
    if mask is not None:
        xn = xn * mask.float()
    xq, sx = row_quant(xn)
    y = _int8_product(xq, wq) * (sx * s.float()) + b.float()
    return y.to(x.dtype)


def ln_masked_linear_int8(x, mask, ln_weight, ln_bias, wq, s, b, eps: float = 1e-6):
    """K2: plain version for a CPU tensor, the CUDA kernel for a CUDA tensor."""
    if x.device.type == "cpu":
        return ln_masked_linear_int8_plain(x, mask, ln_weight, ln_bias, wq, s, b, eps)
    t, e = x.shape
    o = wq.shape[0]
    bf = torch.bfloat16
    check_cuda("x", x, (t, e), bf)
    if mask is not None:
        check_cuda("mask", mask, (t, 1), bf)
    check_cuda("ln_weight", ln_weight, (e,), torch.float32)
    check_cuda("ln_bias", ln_bias, (e,), torch.float32)
    check_cuda("wq", wq, (o, e), torch.int8)
    check_cuda("s", s, (o,), torch.float32)
    check_cuda("b", b, (o,), torch.float32)
    if e % 16 or o % 8:
        raise ValueError(f"K2 needs E divisible by 16 and O by 8, got {e}, {o}")
    xq = torch.empty((t, e), dtype=torch.int8, device=x.device)
    sx = torch.empty((t,), dtype=torch.float32, device=x.device)
    out = torch.empty((t, o), dtype=bf, device=x.device)
    code = _lib().k2_ln_masked_linear_int8(
        ptr(x), ptr(mask), ptr(ln_weight), ptr(ln_bias), ptr(wq), ptr(s), ptr(b),
        ptr(xq), ptr(sx), ptr(out), t, e, o, eps, stream())
    raise_on_error("K2 ln_masked_linear_int8", code)
    LAUNCHES["K2"] += 1
    return out


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------


def ln_mlp_residual_int8_plain(x, ln_weight, ln_bias, w1q, s1, b1, w2q, s2, b2,
                               add=None, eps: float = 1e-6, gelu: str = "poly"):
    """Plain version of K4.  x, add (T, E); w1q (M, E), w2q (E, M) int8;
    s1, b1 (M,), s2, b2 (E,) fp32.  ``add`` arrives in x's dtype."""
    xf = x.float() if add is None else x.float() + add.to(x.dtype).float()
    xq, sx = row_quant(_layer_norm_f32(xf, ln_weight, ln_bias, eps))
    h = _int8_product(xq, w1q) * (sx * s1.float()) + b1.float()
    hq, sh = row_quant(gelu_phi_poly(h, gelu))
    y = _int8_product(hq, w2q) * (sh * s2.float())
    return (xf + y + b2.float()).to(x.dtype)


def ln_mlp_residual_int8(x, ln_weight, ln_bias, w1q, s1, b1, w2q, s2, b2,
                         add=None, eps: float = 1e-6, gelu: str = "poly"):
    """K4: plain version for a CPU tensor, the CUDA kernel for a CUDA tensor;
    a launch is the span ``kernels.K4`` (``profiling.span``)."""
    if gelu not in GELU_IMPLS:
        raise ValueError(f"gelu must be one of {GELU_IMPLS}, got {gelu!r}")
    if x.device.type == "cpu":
        return ln_mlp_residual_int8_plain(x, ln_weight, ln_bias, w1q, s1, b1,
                                          w2q, s2, b2, add, eps, gelu)
    with span("kernels.K4"):
        t, e = x.shape
        m = w1q.shape[0]
        bf = torch.bfloat16
        check_cuda("x", x, (t, e), bf)
        if add is not None:
            check_cuda("add", add, (t, e), bf)
        check_cuda("ln_weight", ln_weight, (e,), torch.float32)
        check_cuda("ln_bias", ln_bias, (e,), torch.float32)
        check_cuda("w1q", w1q, (m, e), torch.int8)
        check_cuda("s1", s1, (m,), torch.float32)
        check_cuda("b1", b1, (m,), torch.float32)
        check_cuda("w2q", w2q, (e, m), torch.int8)
        check_cuda("s2", s2, (e,), torch.float32)
        check_cuda("b2", b2, (e,), torch.float32)
        if e % 16 or m % 16:
            raise ValueError(f"K4 needs E and M divisible by 16, got {e}, {m}")
        dev = x.device
        xq = torch.empty((t, e), dtype=torch.int8, device=dev)
        sx = torch.empty((t,), dtype=torch.float32, device=dev)
        hidden = torch.empty((t, m), dtype=torch.float32, device=dev)
        hmax = torch.empty((t,), dtype=torch.float32, device=dev)
        hq = torch.empty((t, m), dtype=torch.int8, device=dev)
        out = torch.empty_like(x)
        code = _lib().k4_ln_mlp_residual_int8(
            ptr(x), ptr(add), ptr(ln_weight), ptr(ln_bias), ptr(w1q), ptr(s1), ptr(b1),
            ptr(w2q), ptr(s2), ptr(b2), ptr(xq), ptr(sx), ptr(hidden), ptr(hmax),
            ptr(hq), ptr(out), t, e, m, eps, GELU_IMPLS.index(gelu), stream())
        raise_on_error("K4 ln_mlp_residual_int8", code)
        LAUNCHES["K4"] += 1
        return out


# ---------------------------------------------------------------------------
# K15
# ---------------------------------------------------------------------------


def activation(h: torch.Tensor, act: str) -> torch.Tensor:
    """K15's activation in fp32: K4's GELU (``'poly'``, ``'erf'``),
    ``h * sigmoid(1.702 h)`` (``'sigmoid'``) or ``max(h, 0)`` (``'relu'``)."""
    if act in GELU_IMPLS:
        return gelu_phi_poly(h, act)
    if act == "sigmoid":
        return h * torch.sigmoid(1.702 * h)
    if act == "relu":
        return torch.clamp_min(h, 0.0)
    raise ValueError(f"act must be one of {ACTS}, got {act!r}")


def _check_exp_flags(m: int, chunks: int, act: str, rq: str) -> int:
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}, got {act!r}")
    if rq not in ROW_QUANTS:
        raise ValueError(f"rq must be one of {ROW_QUANTS}, got {rq!r}")
    if chunks < 1 or m % chunks:
        raise ValueError(f"chunks must divide the hidden width {m}, got {chunks}")
    return m // chunks


def ln_mlp_residual_int8_exp_plain(x, ln_weight, ln_bias, w1q, s1, b1, w2q, s2, b2, *,
                                   chunks: int = 1, act: str = "poly", rq: str = "div",
                                   fixed_hscale: bool = False, eps: float = 1e-6):
    """Plain version of K15.  x (T, E); w1q (M, E), w2q (E, M) int8; s1, b1
    (M,), s2, b2 (E,) fp32.  For each chunk j of ``M // chunks`` hidden
    columns, in order: ``h = act(int32(xq @ w1q[j].T) * (sx * s1[j]) + b1[j])``,
    ``hq, sh = rq(h)`` (or ``sat_s8(rint(8 h))``, ``1/8`` with
    ``fixed_hscale``), ``acc += int32(hq @ w2q[:, j].T) * (sh * s2)``; then
    ``(x + acc) + b2`` in x's dtype.  At ``chunks=1, rq='div'``, no fixed scale
    and a GELU it is :func:`ln_mlp_residual_int8_plain` without ``add``."""
    ch = _check_exp_flags(w1q.shape[0], chunks, act, rq)
    quant = row_quant if rq == "div" else row_quant_recip
    xf = x.float()
    xq, sx = quant(_layer_norm_f32(xf, ln_weight, ln_bias, eps))
    acc = None
    for j in range(chunks):
        cols = slice(j * ch, (j + 1) * ch)
        h = activation(_int8_product(xq, w1q[cols]) * (sx * s1[cols].float())
                       + b1[cols].float(), act)
        if fixed_hscale:
            hq = torch.clamp(torch.round(h * FIXED_HSCALE), -128, 127)
            sh = torch.full_like(sx, 1.0 / FIXED_HSCALE)
        else:
            hq, sh = quant(h)
        part = _int8_product(hq, w2q[:, cols]) * (sh * s2.float())
        acc = part if acc is None else acc + part
    return (xf + acc + b2.float()).to(x.dtype)


def ln_mlp_residual_int8_exp(x, ln_weight, ln_bias, w1q, s1, b1, w2q, s2, b2, *,
                             chunks: int = 1, act: str = "poly", rq: str = "div",
                             fixed_hscale: bool = False, eps: float = 1e-6):
    """K15: plain version for a CPU tensor, the CUDA kernel for a CUDA tensor
    (which needs ``M // chunks`` a multiple of 128)."""
    ch = _check_exp_flags(w1q.shape[0], chunks, act, rq)
    if x.device.type == "cpu":
        return ln_mlp_residual_int8_exp_plain(x, ln_weight, ln_bias, w1q, s1, b1, w2q, s2, b2,
                                              chunks=chunks, act=act, rq=rq,
                                              fixed_hscale=fixed_hscale, eps=eps)
    t, e = x.shape
    m = w1q.shape[0]
    check_cuda("x", x, (t, e), torch.bfloat16)
    check_cuda("ln_weight", ln_weight, (e,), torch.float32)
    check_cuda("ln_bias", ln_bias, (e,), torch.float32)
    check_cuda("w1q", w1q, (m, e), torch.int8)
    check_cuda("s1", s1, (m,), torch.float32)
    check_cuda("b1", b1, (m,), torch.float32)
    check_cuda("w2q", w2q, (e, m), torch.int8)
    check_cuda("s2", s2, (e,), torch.float32)
    check_cuda("b2", b2, (e,), torch.float32)
    if e % 16 or ch % 128:
        raise ValueError(f"K15 needs E divisible by 16 and M / chunks by 128, got {e}, {ch}")
    dev = x.device
    xq = torch.empty((t, e), dtype=torch.int8, device=dev)
    sx = torch.empty((t,), dtype=torch.float32, device=dev)
    hidden = torch.empty((t, m), dtype=torch.float32, device=dev)
    hmax = torch.empty((t, chunks), dtype=torch.float32, device=dev)
    sh = torch.empty((t, chunks), dtype=torch.float32, device=dev)
    hq = torch.empty((t, m), dtype=torch.int8, device=dev)
    out = torch.empty_like(x)
    code = _lib().k15_ln_mlp_residual_int8_exp(
        ptr(x), ptr(ln_weight), ptr(ln_bias), ptr(w1q), ptr(s1), ptr(b1), ptr(w2q), ptr(s2),
        ptr(b2), ptr(xq), ptr(sx), ptr(hidden), ptr(hmax), ptr(sh), ptr(hq), ptr(out), t, e, m,
        eps, chunks, ACTS.index(act), ROW_QUANTS.index(rq), int(fixed_hscale), stream())
    raise_on_error("K15 ln_mlp_residual_int8_exp", code)
    LAUNCHES["K15"] += 1
    return out
