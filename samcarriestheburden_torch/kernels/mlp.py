"""K1 and K3: the encoder's LayerNorm + matrix product kernels.

K1 ``ln_masked_linear`` = ``(LN(x) * mask) @ w.T + b``, the qkv projection
with the pad re-zeroing folded in (JAX ``kernels/mlp.py:fused_ln_masked_linear``).
K3 ``ln_mlp_residual`` = ``s + lin2(GELU(lin1(LN(s))))`` with ``s = x (+ add)``
(JAX ``kernels/mlp.py:fused_ln_mlp_residual``).

Numerics of both versions, as the JAX kernels: LayerNorm statistics in fp32,
the normalised rows rounded to x's dtype before the product, fp32
accumulation, fp32 biases, K3's hidden rounded to x's dtype before lin2.
Weights are (out, in) like ``nn.Linear``.  The CUDA kernels
(``csrc/mlp.cu``: a LayerNorm row pass, then each product on the TMA + wgmma
mainloop of ``csrc/gemm_sm90.cuh``) take bf16 activations and weights; TMA
needs 16-byte row pitches, so E, O and M must be multiples of 8.
"""

from __future__ import annotations

import ctypes

import torch

from samcarriestheburden_torch.kernels import (LAUNCHES, build, check_cuda, ptr,
                                               raise_on_error, stream)
from samcarriestheburden_torch.models.common import layer_norm

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib():
    lib = build.load("mlp")
    if not getattr(lib, "_typed", False):
        lib.k1_ln_masked_linear.argtypes = [_VP] * 8 + [_I, _I, _I, _F, _VP]
        lib.k1_ln_masked_linear.restype = _I
        lib.k3_ln_mlp_residual.argtypes = [_VP] * 11 + [_I, _I, _I, _F, _VP]
        lib.k3_ln_mlp_residual.restype = _I
        lib._typed = True
    return lib


def check_tma_shapes(kernel: str, t: int, **widths: int) -> None:
    """Raise unless the kernel's GEMMs can take these shapes through TMA: at
    least one row, and every width (the contraction and the outputs) a
    positive multiple of 8 bf16, TMA's 16-byte row pitch."""
    if t < 1:
        raise ValueError(f"{kernel} needs at least one row, got {t}")
    bad = {k: v for k, v in widths.items() if v < 8 or v % 8}
    if bad:
        raise ValueError(f"{kernel}: TMA needs 16-byte row pitches, so every width must be a "
                         f"positive multiple of 8; got {bad}")


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------


def ln_masked_linear_plain(x, mask, ln_weight, ln_bias, w, b, eps: float = 1e-6):
    """Plain version of K1.  x (T, E); mask (T, 1) or None; w (O, E); b (O,)."""
    xn = layer_norm(x.float(), ln_weight, ln_bias, eps)
    if mask is not None:
        xn = xn * mask.float()
    y = xn.to(x.dtype).float() @ w.float().T + b.float()
    return y.to(x.dtype)


def ln_masked_linear(x, mask, ln_weight, ln_bias, w, b, eps: float = 1e-6):
    """K1: plain version for a CPU tensor, the CUDA kernel for a CUDA tensor."""
    if x.device.type == "cpu":
        return ln_masked_linear_plain(x, mask, ln_weight, ln_bias, w, b, eps)
    t, e = x.shape
    o = w.shape[0]
    check_tma_shapes("K1", t, E=e, O=o)
    bf = torch.bfloat16
    check_cuda("x", x, (t, e), bf)
    if mask is not None:
        check_cuda("mask", mask, (t, 1), bf)
    check_cuda("ln_weight", ln_weight, (e,), torch.float32)
    check_cuda("ln_bias", ln_bias, (e,), torch.float32)
    check_cuda("w", w, (o, e), bf)
    check_cuda("b", b, (o,), torch.float32)
    xn = torch.empty_like(x)
    out = torch.empty((t, o), dtype=bf, device=x.device)
    code = _lib().k1_ln_masked_linear(
        ptr(x), ptr(mask), ptr(ln_weight), ptr(ln_bias), ptr(w), ptr(b),
        ptr(xn), ptr(out), t, e, o, eps, stream())
    raise_on_error("K1 ln_masked_linear", code)
    LAUNCHES["K1"] += 1
    return out


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------


def ln_mlp_residual_plain(x, ln_weight, ln_bias, w1, b1, w2, b2, add=None,
                          eps: float = 1e-6):
    """Plain version of K3.  x, add (T, E); w1 (M, E); w2 (E, M)."""
    s = x.float() if add is None else x.float() + add.float()
    xn = layer_norm(s, ln_weight, ln_bias, eps).to(x.dtype)
    h = xn.float() @ w1.float().T + b1.float()
    h = torch.nn.functional.gelu(h).to(x.dtype)
    y = h.float() @ w2.float().T + b2.float()
    return (s + y).to(x.dtype)


def ln_mlp_residual(x, ln_weight, ln_bias, w1, b1, w2, b2, add=None,
                    eps: float = 1e-6):
    """K3: plain version for a CPU tensor, the CUDA kernel for a CUDA tensor."""
    if x.device.type == "cpu":
        return ln_mlp_residual_plain(x, ln_weight, ln_bias, w1, b1, w2, b2,
                                     add, eps)
    t, e = x.shape
    m = w1.shape[0]
    check_tma_shapes("K3", t, E=e, M=m)
    bf = torch.bfloat16
    check_cuda("x", x, (t, e), bf)
    if add is not None:
        check_cuda("add", add, (t, e), bf)
    check_cuda("ln_weight", ln_weight, (e,), torch.float32)
    check_cuda("ln_bias", ln_bias, (e,), torch.float32)
    check_cuda("w1", w1, (m, e), bf)
    check_cuda("b1", b1, (m,), torch.float32)
    check_cuda("w2", w2, (e, m), bf)
    check_cuda("b2", b2, (e,), torch.float32)
    xn = torch.empty_like(x)
    hidden = torch.empty((t, m), dtype=bf, device=x.device)
    out = torch.empty_like(x)
    code = _lib().k3_ln_mlp_residual(
        ptr(x), ptr(add), ptr(ln_weight), ptr(ln_bias), ptr(w1), ptr(b1),
        ptr(w2), ptr(b2), ptr(xn), ptr(hidden), ptr(out), t, e, m, eps,
        stream())
    raise_on_error("K3 ln_mlp_residual", code)
    LAUNCHES["K3"] += 1
    return out
