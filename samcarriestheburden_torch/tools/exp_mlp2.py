"""The int8 MLP's row quantization by a divide or by the row's reciprocal,
in 1, 2 or 4 hidden chunks: the port of the JAX package's
``tools/exp_mlp2.py``.

    python -m samcarriestheburden_torch.tools.exp_mlp2

Times K15 with the polynomial GELU at the script's shapes (T=19600, E=1280,
M=5120) in its five settings and prints each one's device time per call
(CUDA events over ``ITERS`` calls) and a summary:

* ``div_c1_t512``: ``rq='div'``, ``q = rint(x / (a / 127))``: K4's arithmetic;
* ``recip_c1_t512``, ``recip_c2_t512``, ``recip_c4_t512``: ``rq='recip'``,
  ``q = rint(x * (127 / a))``, scale ``a * (1/127)``, in 1, 2 or 4 chunks;
* ``recip_c4_t1024``: the same launch as ``recip_c4_t512`` (``t_block`` is
  the TPU's row block; the card's row tile is the GEMMs' 128).

Inputs are the script's, from ``np.random.default_rng(0)`` in its draw order
(x drawn straight into bf16); the weights quantized by
:func:`quantize_weight` and laid out ``(out, in)`` once.
"""

from __future__ import annotations

import sys
from typing import Dict

import numpy as np
import torch

from samcarriestheburden_torch.device import resolve_device
from samcarriestheburden_torch.kernels.quant import ln_mlp_residual_int8_exp, quantize_weight
from samcarriestheburden_torch.tools.exp_int8 import out_in
from samcarriestheburden_torch.tools.timing import print_summary, run_experiments

T, E, M = 19600, 1280, 5120

#: K15's flags for each experiment (the script's ``mk(n_chunks, t_block, rq)``)
K15_EXPERIMENTS = {
    "div_c1_t512": dict(chunks=1, act="poly", rq="div"),
    "recip_c1_t512": dict(chunks=1, act="poly", rq="recip"),
    "recip_c2_t512": dict(chunks=2, act="poly", rq="recip"),
    "recip_c4_t512": dict(chunks=4, act="poly", rq="recip"),
    "recip_c4_t1024": dict(chunks=4, act="poly", rq="recip"),
}
NAMES = tuple(K15_EXPERIMENTS)
NOTES = {"recip_c4_t1024": "t_block 1024 is the TPU's row block: the same launch as "
                           "recip_c4_t512"}


def inputs(device, t: int = T, e: int = E, m: int = M) -> tuple:
    """The script's ``args``: x (t, e) bf16, the LayerNorm affine, and K15's
    int8 ``(out, in)`` weights, scales and biases."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((t, e))).to(device, torch.bfloat16)
    w1 = (rng.standard_normal((e, m)) * 0.02).astype(np.float32)
    w2 = (rng.standard_normal((m, e)) * 0.02).astype(np.float32)
    w1q, s1 = quantize_weight(out_in(w1, device))
    w2q, s2 = quantize_weight(out_in(w2, device))
    return (x, torch.ones(e, device=device), torch.zeros(e, device=device), w1q, s1,
            torch.zeros(m, device=device), w2q, s2, torch.zeros(e, device=device))


def experiments(device=None, T: int = T, E: int = E, M: int = M) -> Dict[str, tuple]:
    """``{name: (fn, args)}`` for every experiment of the script."""
    args = inputs(resolve_device(device), T, E, M)
    return {name: (lambda *a, flags=flags: ln_mlp_residual_int8_exp(*a, **flags), args)
            for name, flags in K15_EXPERIMENTS.items()}


def run(names=None) -> Dict[str, Dict]:
    """The named experiments (default: all) on the card; raises without one.
    Returns ``{name: {"us", "first_s", "sum", "launches"}}``."""
    exps = experiments(resolve_device(None))
    results = run_experiments(
        exps, names or NAMES,
        lambda n, r: [f"[{n}] first call in {r['first_s']:.1f}s sum={r['sum']:.6e}",
                      f"--- {n}: kernel device {r['us']:.1f} us/iter ---"], NOTES)
    print_summary("summary (kernel us/iter):", results, width=16)
    return results


if __name__ == "__main__":
    run(sys.argv[1:])
