"""Is the int8 product twice the bf16 one on the card, and where does K4's
time go?  The port of the JAX package's ``tools/exp_int8.py``.

    python -m samcarriestheburden_torch.tools.exp_int8 [name ...]   (default: all)

Times the script's experiments at its shapes, the ViT-H encoder MLP over 100
windows of a batch of 4 (T=19600 tokens, E=1280, M=5120), and prints each
one's device time per call (CUDA events over ``ITERS`` calls) and a summary:

* ``xla_dot_bf16``, ``xla_dot_int8``: the library's products, ``torch.matmul``
  (bf16 out) and ``torch._int_mm`` (int32 out), the yardstick;
* ``pallas_dot_bf16``, ``pallas_dot_int8``: K14, the port's GEMM mainloop
  with a store-only epilogue (bf16 -> fp32, int8 -> int32);
* ``mlp_bf16``, ``mlp_int8_preq``: K3 and K4, the fused MLP kernels;
* ``mlp_int8_chunk*``: K15 with erf GELU and the hidden in 2, 4 or 8
  chunks, each requantized per (row, chunk);
* ``diag_*``: K15 in one chunk with each activation, and the fixed hidden
  scale 1/8 (wrong numbers on purpose: it times K4 without its per-row
  hidden scale).

``t_block`` is the TPU kernels' row block; on the card the row tile is the
GEMMs' 128, so ``mlp_int8_chunk4_t512`` and ``diag_poly_t512`` run the same
launches as ``mlp_int8_chunk4`` and ``diag_poly``.  Inputs are the script's,
from ``np.random.default_rng(0)`` in its draw order; the weights are
quantized by :func:`quantize_weight` (the JAX package's eager scales) and
laid out ``(out, in)`` once, outside the timed calls.
"""

from __future__ import annotations

import sys
from functools import partial
from typing import Dict

import numpy as np
import torch

from samcarriestheburden_torch.device import resolve_device
from samcarriestheburden_torch.kernels.gemm import dot
from samcarriestheburden_torch.kernels.mlp import ln_mlp_residual
from samcarriestheburden_torch.kernels.quant import (ln_mlp_residual_int8,
                                                     ln_mlp_residual_int8_exp, quantize_weight)
from samcarriestheburden_torch.tools.timing import print_summary, run_experiments

T, E, M = 19600, 1280, 5120

#: the names that run the same launches as another, and why
NOTES = {"mlp_int8_chunk4_t512": "t_block 512 is the TPU's row block: the same launch as "
                                 "mlp_int8_chunk4",
         "diag_poly_t512": "t_block 512 is the TPU's row block: the same launch as diag_poly"}

#: K15's flags for each of its experiments
K15_EXPERIMENTS = {
    "mlp_int8_chunk2": dict(chunks=2, act="erf"),
    "mlp_int8_chunk4": dict(chunks=4, act="erf"),
    "mlp_int8_chunk4_t512": dict(chunks=4, act="erf"),
    "mlp_int8_chunk8": dict(chunks=8, act="erf"),
    "diag_poly": dict(act="poly"),
    "diag_poly_t512": dict(act="poly"),
    "diag_erf": dict(act="erf"),
    "diag_sigmoid": dict(act="sigmoid"),
    "diag_relu": dict(act="relu"),
    "diag_erf_fixedscale": dict(act="erf", fixed_hscale=True),
    "diag_relu_fixedscale": dict(act="relu", fixed_hscale=True),
}
NAMES = ("xla_dot_bf16", "xla_dot_int8", "pallas_dot_bf16", "pallas_dot_int8", "mlp_bf16",
         "mlp_int8_preq") + tuple(K15_EXPERIMENTS)


def out_in(w: np.ndarray, device, dtype=torch.float32) -> torch.Tensor:
    """A JAX-layout ``(in, out)`` weight as the port's contiguous ``(out, in)``."""
    return torch.from_numpy(np.ascontiguousarray(w.T)).to(device, dtype)


def inputs(device, t: int = T, e: int = E, m: int = M) -> Dict[str, torch.Tensor]:
    """The script's operands: ``xb`` (bf16) and ``xq`` (int8, ``clip(rint(10
    x), +-127)``) of the fp32 draw x (t, e); lin1, lin2 in bf16 ``w1b``, ``w2b``
    and int8 ``w1q``, ``w2q`` with scales ``s1``, ``s2``, all ``(out, in)``;
    the LayerNorm affine ``g``, ``b`` and biases ``b1``, ``b2``."""
    rng = np.random.default_rng(0)
    x32 = torch.from_numpy(rng.standard_normal((t, e)).astype(np.float32)).to(device)
    w1 = (rng.standard_normal((e, m)) * 0.02).astype(np.float32)
    w2 = (rng.standard_normal((m, e)) * 0.02).astype(np.float32)
    w1t, w2t = out_in(w1, device), out_in(w2, device)
    w1q, s1 = quantize_weight(w1t)
    w2q, s2 = quantize_weight(w2t)
    return {"xb": x32.to(torch.bfloat16),
            "xq": torch.clamp(torch.round(x32 * 10), -127, 127).to(torch.int8),
            "w1b": w1t.to(torch.bfloat16), "w2b": w2t.to(torch.bfloat16),
            "w1q": w1q, "s1": s1, "w2q": w2q, "s2": s2,
            "g": torch.ones(e, device=device), "b": torch.zeros(e, device=device),
            "b1": torch.zeros(m, device=device), "b2": torch.zeros(e, device=device)}


def experiments(device=None, T: int = T, E: int = E, M: int = M) -> Dict[str, tuple]:
    """``{name: (fn, args)}`` for every experiment of the script."""
    v = inputs(resolve_device(device), T, E, M)
    mlp_w = (v["g"], v["b"])
    int8_w = (v["w1q"], v["s1"], v["b1"], v["w2q"], v["s2"], v["b2"])
    exps = {
        "xla_dot_bf16": (lambda a, w: torch.matmul(a, w.t()), (v["xb"], v["w1b"])),
        "xla_dot_int8": (lambda a, w: torch._int_mm(a, w.t()), (v["xq"], v["w1q"])),
        "pallas_dot_bf16": (partial(dot, out_dtype=torch.float32), (v["xb"], v["w1b"])),
        "pallas_dot_int8": (partial(dot, out_dtype=torch.int32), (v["xq"], v["w1q"])),
        "mlp_bf16": (lambda a: ln_mlp_residual(a, *mlp_w, v["w1b"], v["b1"], v["w2b"], v["b2"]),
                     (v["xb"],)),
        "mlp_int8_preq": (lambda a: ln_mlp_residual_int8(a, *mlp_w, *int8_w), (v["xb"],)),
    }
    for name, flags in K15_EXPERIMENTS.items():
        exps[name] = (lambda a, flags=flags: ln_mlp_residual_int8_exp(a, *mlp_w, *int8_w,
                                                                      **flags), (v["xb"],))
    return exps


def run(names=None) -> Dict[str, Dict]:
    """The named experiments (default: all) on the card; raises without one.
    Returns ``{name: {"us", "first_s", "sum", "launches"}}``."""
    exps = experiments(resolve_device(None))
    results = run_experiments(
        exps, names or NAMES,
        lambda n, r: [f"[{n}] first call in {r['first_s']:.1f}s sum={r['sum']:.3e}",
                      f"--- {n}: device total {r['us']:.1f} us/iter ---"], NOTES)
    print_summary("summary (us/iter):", results)
    return results


if __name__ == "__main__":
    run(sys.argv[1:])
