"""The int8 and bf16 GEMM kernels and the cost probe of two checkouts of the
repository on one card, in turns.

    python -m samcarriestheburden_torch.tools.ab_gemm PARENT [CHANGE]

``PARENT`` and ``CHANGE`` (default: this checkout) are repository roots.
Each turn runs in a process of its own (the two packages share a name), in
the order parent, change, change, parent, through ``ab_attention``'s turn
runner: it builds that checkout's ``gemm``, ``quant``, ``mlp`` and
``cost_probe`` sources and runs, on the inputs :func:`inputs` makes (seeded
with numpy, the same in every turn, whichever checkout's package runs them):

- K14 (``kernels/gemm.py:dot``) in its three modes at the experiment tools'
  shape, (19600, 1280) x (5120, 1280);
- K2 (``ln_masked_linear_int8``, the qkv projection, 3840 wide, with the
  pad mask) and K4 (``ln_mlp_residual_int8``, hidden 5120, with ``add``) on
  the compact int8 encoder's 8416 rows (B = 2) and the bench's 134,656 (batch
  32);
- K15 (``ln_mlp_residual_int8_exp``) at 19600 rows in 2 and 8 chunks (erf
  GELU, as ``tools/exp_int8.py:mk_chunked``) and in 8 chunks with the
  sigmoid and the reciprocal row quantization;
- K1 (``kernels/mlp.py:ln_masked_linear``, the bf16 qkv projection, with the
  pad mask) and K3 (``ln_mlp_residual``, hidden 5120, with ``add``) on the
  compact encoder's 8416 rows, the flat one's 10,000 (B = 2) and the bench's
  134,656;
- K13 (``kernels/cost_probe.py:cost_probe``, the bench's probe) at (128,
  128), and the host's microseconds for each step of its call
  (:func:`k13_steps`).

Each turn prints one JSON line: per case its milliseconds per call (CUDA
events around ``iters`` back-to-back calls after 3 warm-ups), the host's
microseconds per call (``time.perf_counter`` around ``HOST_CALLS`` calls
after a synchronize, ending in one), its device milliseconds per call
(``torch.profiler``'s device time of every kernel the call launches, over 5
calls) and by kernel, a digest of its output (:func:`digest`) and the max
|difference| from the first turn's output, which the first turn saves in the
temporary directory.  Equal digests and a difference of 0 mean the two checkouts give the
same bits.  The last lines are a summary: per case the four turns' ms and
whether their digests agree.
"""

from __future__ import annotations

import json
import os
import sys
import time
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
#: the rows of K1 and K3: compact (B = 2), flat (B = 2), the bench's batch 32
MLP_ROWS = (8416, 10000, 134656)
#: K13's shape and declared cost (the bench's), and its host calls per timing
K13_SHAPE, K13_DECLARED, K13_CALLS = (128, 128), 1234567, 2000
#: host calls per case for the host's time (default: ``iters``)
HOST_CALLS = {"K13 128x128": K13_CALLS}

TURN = r'''
import importlib.util, json, sys
sys.path.insert(0, sys.argv[1])
spec = importlib.util.spec_from_file_location("ab_gemm_cases", sys.argv[4])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
print(json.dumps(mod.turn(int(sys.argv[2]), sys.argv[3])))
'''


def inputs(device, *, t: int = T, e: int = E, m: int = M, o: int = QKV,
           rows=ROWS + MLP_ROWS, seed: int = 0, probe=K13_SHAPE) -> Dict[str, object]:
    """Every operand of the cases, drawn with ``np.random.default_rng(seed)``
    and moved to ``device``: bf16 and int8 matrices for K14, token rows (the
    largest of ``rows``; smaller counts take their first rows) with a pad
    mask and an ``add``, LayerNorm affines, int8 weights with their
    per-output-channel scales (the port's ``quantize_weight``) and biases,
    then K1 and K3's bf16 weights and K13's probe (of std 100)."""
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
    v.update({"wqkv_bf": normal(o, e, std=e ** -0.5).bfloat16(),
              "w1_bf": normal(m, e, std=e ** -0.5).bfloat16(),
              "w2_bf": normal(e, m, std=m ** -0.5).bfloat16(),
              "probe": normal(*probe, std=100.0).bfloat16()})
    return {k: tuple(x.to(device) for x in val) if isinstance(val, tuple) else val.to(device)
            for k, val in v.items()}


def cases(v: Dict[str, object], *, t: int = T, rows=ROWS, mlp_rows=MLP_ROWS,
          k15=K15_CASES) -> Dict[str, Callable[[], torch.Tensor]]:
    """{name: call} over the operands ``v``: each call runs the kernel's
    wrapper (its plain version on the CPU)."""
    from samcarriestheburden_torch.kernels import cost_probe, gemm, mlp as mlp_k, quant

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
    bf = (v["g"], v["b"], v["w1_bf"], v["b1"], v["w2_bf"], v["b2"])
    for r in mlp_rows:
        out[f"K1 {r}"] = lambda r=r: mlp_k.ln_masked_linear(
            v["x"][:r], v["mask"][:r], v["g"], v["b"], v["wqkv_bf"], v["bqkv"])
        out[f"K3 {r}"] = lambda r=r: mlp_k.ln_mlp_residual(v["x"][:r], *bf, add=v["add"][:r])
    out["K13 {}x{}".format(*v["probe"].shape)] = \
        lambda: cost_probe.cost_probe(v["probe"], K13_DECLARED)
    return out


def digest(out: torch.Tensor) -> int:
    """The sum of the output's raw 16- or 32-bit patterns, as an integer: the
    same for the same bits."""
    bits = torch.int16 if out.element_size() == 2 else torch.int32
    return int(out.contiguous().view(bits).long().sum())


def host_us(fn, calls: int) -> float:
    """The host's microseconds per call of ``fn`` over ``calls`` calls, after a
    synchronize and ending in one (the launch queue's back-pressure
    included: where the card is slower than the host, this is device time)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def k13_steps(calls: int = K13_CALLS, repeats: int = 3) -> Dict[str, float]:
    """The host's microseconds per call of each step of a K13 call at
    ``K13_SHAPE`` (the least of ``repeats`` timings of ``calls`` calls each):
    the call as the bench makes it, the operator through the dispatcher, the
    registered CUDA kernel called directly (so the dispatch costs the
    difference), and each step that kernel takes: the input check
    (``kernels.check_cuda``'s four), ``torch.empty_like``, ``_lib()``,
    ``kernels.stream()`` beside ``torch.cuda.current_stream()`` (a ``Stream``
    object) and the raw stream, and the ``ctypes`` call with its launch; then
    ``x * 2.0`` and an empty loop.  The names exist in both layouts of the
    module (``custom_op`` and ``torch.library.Library``)."""
    from samcarriestheburden_torch import kernels
    from samcarriestheburden_torch.kernels import cost_probe as k13

    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        K13_SHAPE, dtype=np.float32) * 100).bfloat16().cuda()
    out = torch.empty_like(x)
    launch = k13._lib().k13_cost_probe
    args = (x.data_ptr(), out.data_ptr(), x.numel(), kernels.stream())
    steps = {
        "call": lambda: k13.cost_probe(x, K13_DECLARED),
        "op": lambda: torch.ops.samcarriestheburden.cost_probe.default(x, K13_DECLARED),
        "cuda kernel alone": lambda: k13._cost_probe_cuda(x, K13_DECLARED),
        "check_cuda": lambda: kernels.check_cuda("x", x, x.shape, torch.bfloat16),
        "empty_like": lambda: torch.empty_like(x),
        "_lib()": k13._lib,
        "stream()": kernels.stream,
        "Stream object": lambda: torch.cuda.current_stream().cuda_stream,
        "raw stream": lambda: torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice()),
        "ctypes call + launch": lambda: launch(*args),
        "x * 2.0": lambda: x * 2.0,
        "empty loop": lambda: None,
    }
    res = {}
    for name, fn in steps.items():
        for _ in range(100):
            fn()
        res[name] = min(host_us(fn, calls) for _ in range(repeats))
    return res


def turn(iters: int, saved: str) -> Dict[str, Dict]:
    """One turn on the card, in the checkout whose package is first on the
    path: {case: {"ms", "host_us", "device_ms", "device_ms_by_kernel",
    "digest", "max_diff", "max_abs"}}, and K13's host steps."""
    from torch.profiler import ProfilerActivity, profile

    from samcarriestheburden_torch.kernels import build

    build.build(["gemm", "quant", "mlp", "cost_probe"])
    calls = cases(inputs(torch.device("cuda")))
    first = torch.load(saved) if os.path.exists(saved) else None
    outs, res = {}, {}
    for name, fn in calls.items():
        out = fn()
        torch.cuda.synchronize()
        ref = None if first is None or name not in first else first[name]
        kept = outs[name] = out.cpu()
        diff = None if ref is None else (kept.double() - ref.double()).abs().max().item()
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        host = host_us(fn, HOST_CALLS.get(name, iters))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        by_kernel = {e.key[:120]: e.self_device_time_total / 5 / 1e3
                     for e in prof.key_averages() if e.self_device_time_total > 0}
        res[name] = {"ms": start.elapsed_time(end) / iters, "host_us": host,
                     "device_ms": sum(by_kernel.values()), "device_ms_by_kernel": by_kernel,
                     "digest": digest(out), "max_diff": diff,
                     "max_abs": out.double().abs().max().item()}
        del out
    if first is None:
        torch.save(outs, saved)
    res["K13 host steps (us)"] = k13_steps()
    return res


def summary(results) -> None:
    """Per case, the four turns' ms (and host µs), and whether their digests
    agree; then K13's host steps in each turn."""
    names = [n for n in results[0][1] if n != "K13 host steps (us)"] + \
        [n for n in results[1][1] if n not in results[0][1]]
    for name in names:
        turns = [r.get(name) for _, r in results]
        ms = ", ".join("-" if t is None else f"{t['ms']:.4f}" for t in turns)
        host = ", ".join("-" if t is None else f"{t['host_us']:.2f}" for t in turns)
        digests = {t["digest"] for t in turns if t is not None}
        diffs = [t["max_diff"] for t in turns if t is not None and t["max_diff"] is not None]
        print(f"{name}: ms [{ms}] host us [{host}] digests "
              f"{'equal' if len(digests) == 1 else sorted(digests)}"
              f" max diff {max(diffs) if diffs else None}", flush=True)
    for tree, r in results:
        print(tree, "K13 host steps (us):", json.dumps(r["K13 host steps (us)"]), flush=True)


def run(parent: str, change: str = str(Path(__file__).resolve().parents[2])):
    """``[(checkout, {case: {...}}), ...]`` for the four turns; raises without
    a card or when a turn fails."""
    from samcarriestheburden_torch.tools.ab_attention import run_turns

    return run_turns(TURN, parent, change, "ab_gemm", ITERS, str(Path(__file__).resolve()))


if __name__ == "__main__":
    summary(run(*sys.argv[1:]))
