"""A/B of K7's int8 p.v opt-in on the card (the JAX package's
``tools/bench_int8pv.py``).

    python -m samcarriestheburden_torch.tools.bench_int8pv

Times ``rel_attention_global`` at the ViT-H global shape (16 heads, head dim
80, 64 x 64 tokens, 2 images) and at a window-sized shape (the same kernel
at 14 x 14 tokens, 50 windows) in four modes: bf16 (K7), int8 q.k (K7-int8,
the serving mode), int8 p.v (K7-pv) and both (K7-int8pv, the JAX tool's
candidate).  Inputs: seeded bf16 qkv of std 1 and rel tables of std 0.1.
Each mode's time is CUDA events over ``iters`` launches after 2 warm-ups;
its error is max |out - bf16 out| / max |bf16 out|.  Prints one line per
mode, and :func:`run` returns the numbers.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from samcarriestheburden_torch.device import resolve_device
from samcarriestheburden_torch.kernels.attention import rel_attention_global

#: (label, heads, hd, grid side, sequences): bench_int8pv.py's two shapes
SHAPES = (("ViT-H global layer", 16, 80, 64, 2), ("ViT-H window-shape", 16, 80, 14, 50))
#: mode: (int8_qk, int8_pv)
MODES = {"bf16 (K7)": (False, False), "int8 QK (K7-int8)": (True, False),
         "int8 P.V (K7-pv)": (False, True), "int8 QK + P.V (K7-int8pv)": (True, True)}


def _ms(fn, device, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


def inputs(heads: int, hd: int, side: int, b: int, device):
    """The seeded bf16 qkv (b, side^2, heads*3*hd) and rel tables of one shape."""
    rng = np.random.default_rng(0)
    qkv = torch.from_numpy(rng.standard_normal((b, side * side, heads * 3 * hd),
                                               dtype=np.float32)).to(device, torch.bfloat16)
    tables = torch.from_numpy(0.1 * rng.standard_normal((2 * (2 * side - 1), hd),
                                                        dtype=np.float32)
                              ).to(device, torch.bfloat16)
    return qkv, tables


def bench(label: str, heads: int, hd: int, side: int, b: int, device, iters: int) -> Dict:
    """The four modes at one shape: {mode: {"ms", "speedup_vs_bf16",
    "speedup_vs_int8_qk", "rel_err"}}."""
    n = side * side
    qkv, tables = inputs(heads, hd, side, b, device)
    out, res = {}, {}
    for mode, (qk, pv) in MODES.items():
        def call(qk=qk, pv=pv):
            return rel_attention_global(qkv, tables, kh=side, kw=side, heads=heads, hd=hd,
                                        int8_qk=qk, int8_pv=pv)
        out[mode] = call().float()
        res[mode] = {"ms": _ms(call, device, iters)}
    ref = out["bf16 (K7)"]
    scale = ref.abs().max().item()
    t_bf16, t_qk = res["bf16 (K7)"]["ms"], res["int8 QK (K7-int8)"]["ms"]
    print(f"{label} (n={n}, heads={heads}, b={b}):", flush=True)
    for mode, r in res.items():
        r["speedup_vs_bf16"] = t_bf16 / r["ms"]
        r["speedup_vs_int8_qk"] = t_qk / r["ms"]
        r["rel_err"] = (out[mode] - ref).abs().max().item() / scale
        print(f"  {mode:26s}: {r['ms']:8.4f} ms  ({r['speedup_vs_bf16']:.3f}x vs bf16, "
              f"{r['speedup_vs_int8_qk']:.3f}x vs int8 QK, rel-err {r['rel_err']:.4f})",
              flush=True)
    return res


def run(iters: int = 20) -> Dict[str, Dict]:
    """Both shapes on the card (raises without one): {label: {mode: numbers}}."""
    device = resolve_device(None)
    return {label: bench(label, heads, hd, side, b, device, iters)
            for label, heads, hd, side, b in SHAPES}


if __name__ == "__main__":
    run()
