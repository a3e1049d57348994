"""The int8 and bf16 GEMM kernels of two checkouts of the repository on one card, in turns.

    python -m samcarriestheburden_torch.tools.ab_gemm PARENT [CHANGE]

``PARENT`` and ``CHANGE`` (default: this checkout) are repository roots.
Each turn runs in a process of its own (the two packages share a name), in
the order parent, change, change, parent, through ``ab_attention``'s turn
runner: it builds that checkout's ``gemm`` and ``quant`` sources and runs,
on the inputs :func:`inputs` makes (seeded with numpy, the same in every
turn, whichever checkout's package runs them):

- K14 (``kernels/gemm.py:dot``) in its three modes at the experiment tools'
  shape, (19600, 1280) x (5120, 1280);
- K2 (``ln_masked_linear_int8``, the qkv projection, 3840 wide, with the
  pad mask) and K4 (``ln_mlp_residual_int8``, hidden 5120, with ``add``) on
  the compact int8 encoder's 8416 rows (B = 2) and the bench's 134,656 (batch
  32);
- K15 (``ln_mlp_residual_int8_exp``) at 19600 rows in 2 and 8 chunks (erf
  GELU, as ``tools/exp_int8.py:mk_chunked``) and in 8 chunks with the
  sigmoid and the reciprocal row quantization.

Each turn prints one JSON line: per case its milliseconds per call (CUDA
events around ``iters`` back-to-back calls after 3 warm-ups), its device
milliseconds per call (``torch.profiler``'s device time of every kernel the
call launches, over 5 calls), a digest of its output (:func:`digest`) and
the max |difference| from the first turn's output, which the first turn
saves in the temporary directory.  Equal digests and a difference of 0 mean
the two checkouts give the same bits.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path
from typing import Callable, Dict

import numpy as np
import torch

ITERS = 20
#: K14's shape (the experiment tools'): rows, contraction, output width
T, E, M = 19600, 1280, 5120
#: K2's output width (the qkv projection) and the rows of K2 and K4
QKV = 3840
ROWS = (8416, 134656)
#: K15's cases: (chunks, activation, row quantization)
K15_CASES = ((2, "erf", "div"), (8, "erf", "div"), (8, "sigmoid", "recip"))

TURN = r'''
import importlib.util, json, sys
sys.path.insert(0, sys.argv[1])
spec = importlib.util.spec_from_file_location("ab_gemm_cases", sys.argv[4])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
print(json.dumps(mod.turn(int(sys.argv[2]), sys.argv[3])))
'''


def inputs(device, *, t: int = T, e: int = E, m: int = M, o: int = QKV,
           rows=ROWS, seed: int = 0) -> Dict[str, object]:
    """Every operand of the cases, drawn with ``np.random.default_rng(seed)``
    and moved to ``device``: bf16 and int8 matrices for K14, token rows (the
    largest of ``rows``; smaller counts take their first rows) with a pad
    mask and an ``add``, LayerNorm affines, and int8 weights with their
    per-output-channel scales (the port's ``quantize_weight``) and biases."""
    rng = np.random.default_rng(seed)

    def normal(*shape, std=1.0, mean=0.0):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * std + mean)

    def ints(*shape):
        return torch.from_numpy(rng.integers(-128, 128, shape, dtype=np.int8))

    def quantized(w):
        s = w.abs().amax(dim=1, keepdim=True).clamp(min=1e-12) / 127.0
        return torch.round(w / s).clamp(-127, 127).to(torch.int8), s[:, 0].contiguous()

    n = max(rows)
    v = {"a": normal(t, e).bfloat16(), "w": normal(m, e, std=e ** -0.5).bfloat16(),
         "aq": ints(t, e), "wq": ints(m, e),
         "x": normal(n, e).bfloat16(), "add": normal(n, e, std=0.5).bfloat16(),
         "mask": torch.from_numpy(rng.random((n, 1)) > 0.05).bfloat16(),
         "g": normal(e, std=0.5, mean=1.0), "b": normal(e, std=0.5),
         "wqkv": quantized(normal(o, e, std=e ** -0.5)), "bqkv": normal(o, std=0.1),
         "w1": quantized(normal(m, e, std=e ** -0.5)), "b1": normal(m, std=0.1),
         "w2": quantized(normal(e, m, std=m ** -0.5)), "b2": normal(e, std=0.1)}
    return {k: tuple(x.to(device) for x in val) if isinstance(val, tuple) else val.to(device)
            for k, val in v.items()}


def cases(v: Dict[str, object], *, t: int = T, rows=ROWS,
          k15=K15_CASES) -> Dict[str, Callable[[], torch.Tensor]]:
    """{name: call} over the operands ``v``: each call runs the kernel's
    wrapper (its plain version on the CPU)."""
    from samcarriestheburden_torch.kernels import gemm, quant

    out = {"K14 bf16->fp32": lambda: gemm.dot(v["a"], v["w"], torch.float32),
           "K14 bf16->bf16": lambda: gemm.dot(v["a"], v["w"], torch.bfloat16),
           "K14 int8->int32": lambda: gemm.dot(v["aq"], v["wq"], torch.int32)}
    mlp = (v["g"], v["b"], *v["w1"], v["b1"], *v["w2"], v["b2"])
    for r in rows:
        out[f"K2 {r}"] = lambda r=r: quant.ln_masked_linear_int8(
            v["x"][:r], v["mask"][:r], v["g"], v["b"], *v["wqkv"], v["bqkv"])
        out[f"K4 {r}"] = lambda r=r: quant.ln_mlp_residual_int8(v["x"][:r], *mlp,
                                                                add=v["add"][:r])
    for chunks, act, rq in k15:
        out[f"K15 {chunks} chunks {act} {rq}"] = \
            lambda c=chunks, a=act, q=rq: quant.ln_mlp_residual_int8_exp(
                v["x"][:t], *mlp, chunks=c, act=a, rq=q)
    return out


def digest(out: torch.Tensor) -> int:
    """The sum of the output's raw 16- or 32-bit patterns, as an integer: the
    same for the same bits."""
    bits = torch.int16 if out.element_size() == 2 else torch.int32
    return int(out.contiguous().view(bits).long().sum())


def turn(iters: int, saved: str) -> Dict[str, Dict]:
    """One turn on the card, in the checkout whose package is first on the
    path: {case: {"ms", "device_ms", "digest", "max_diff", "max_abs"}}."""
    from torch.profiler import ProfilerActivity, profile

    from samcarriestheburden_torch.kernels import build

    build.build(["gemm", "quant"])
    calls = cases(inputs(torch.device("cuda")))
    first = torch.load(saved) if os.path.exists(saved) else None
    outs, res = {}, {}
    for name, fn in calls.items():
        out = fn()
        torch.cuda.synchronize()
        outs[name] = out.cpu()
        diff = None if first is None else \
            (outs[name].double() - first[name].double()).abs().max().item()
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        device_us = sum(e.self_device_time_total for e in prof.key_averages())
        res[name] = {"ms": start.elapsed_time(end) / iters, "device_ms": device_us / 5 / 1e3,
                     "digest": digest(out), "max_diff": diff,
                     "max_abs": out.double().abs().max().item()}
        del out
    if first is None:
        torch.save(outs, saved)
    return res


def run(parent: str, change: str = str(Path(__file__).resolve().parents[2])):
    """``[(checkout, {case: {...}}), ...]`` for the four turns; raises without
    a card or when a turn fails."""
    from samcarriestheburden_torch.tools.ab_attention import run_turns

    return run_turns(TURN, parent, change, "ab_gemm", ITERS, str(Path(__file__).resolve()))


if __name__ == "__main__":
    run(*sys.argv[1:])
