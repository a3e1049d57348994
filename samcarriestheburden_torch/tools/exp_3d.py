"""The windowed MLP product over (windows, tokens, E) as a 3-D block, as an
in-kernel reshape and as 2-D rows: the port of the JAX package's
``tools/exp_3d.py``.

    python -m samcarriestheburden_torch.tools.exp_3d [dot3d dotreshape dot2d]

The script asked whether Mosaic lowers a (4, 196, 1280) x (1280, 5120)
block product and an in-kernel reshape.  On the card the three are one
product over the same 100 x 196 rows, K14 in bf16 -> bf16 (fp32 accumulate,
one rounding): the 3-D and reshaped inputs are views of the 2-D rows, so
each name runs one K14 launch and returns the script's output shape.
Prints each name's device time per call (CUDA events over ``ITERS`` calls).
Inputs are the script's, ``np.random.default_rng(0)``: x (100, 196, 1280)
and w (1280, 5120) * 0.02, both drawn straight into bf16; w laid out
``(out, in)`` once.
"""

from __future__ import annotations

import sys
from typing import Dict

import numpy as np
import torch

from samcarriestheburden_torch.device import resolve_device
from samcarriestheburden_torch.kernels.gemm import dot
from samcarriestheburden_torch.tools.timing import run_experiments

WB, N, E, M = 100, 196, 1280, 5120
NAMES = ("dot3d", "dotreshape", "dot2d")


def dot3d(x3: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """(wb, n, e) x (m, e) -> (wb, n, m) bf16: the script's 3-D block product."""
    wb, n, e = x3.shape
    return dot(x3.view(wb * n, e), wt, torch.bfloat16).view(wb, n, wt.shape[0])


def dotreshape(x3: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """The script's in-kernel reshape: the same product, the same launch."""
    return dot3d(x3, wt)


def dot2d(x2: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """(wb n, e) x (m, e) -> (wb n, m) bf16: the script's 2-D product."""
    return dot(x2, wt, torch.bfloat16)


def experiments(device=None, WB: int = WB, N: int = N, E: int = E,
                M: int = M) -> Dict[str, tuple]:
    """``{name: (fn, args)}`` for the script's three products."""
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    x3 = torch.from_numpy(rng.standard_normal((WB, N, E))).to(device, torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((E, M)) * 0.02).to(torch.bfloat16)
    wt = w.t().contiguous().to(device)
    return {"dot3d": (dot3d, (x3, wt)), "dotreshape": (dotreshape, (x3, wt)),
            "dot2d": (dot2d, (x3.view(WB * N, E), wt))}


def run(names=None) -> Dict[str, Dict]:
    """The named products (default: all three) on the card; raises without
    one.  Returns ``{name: {"us", "first_s", "sum", "launches"}}``."""
    exps = experiments(resolve_device(None))
    return run_experiments(
        exps, names or NAMES,
        lambda n, r: [f"[{n}] OK kernel {r['us']:.0f} us/iter (first call {r['first_s']:.0f}s)"])


if __name__ == "__main__":
    run(sys.argv[1:])
