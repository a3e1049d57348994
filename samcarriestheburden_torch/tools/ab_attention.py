"""The attention kernels of two checkouts of the repository on one card, in turns.

    python -m samcarriestheburden_torch.tools.ab_attention PARENT [CHANGE]

``PARENT`` and ``CHANGE`` (default: this checkout) are repository roots.
Each turn runs in a process of its own (the two packages share a name), in
the order parent, change, change, parent: it builds that checkout's
``attention``, ``attention_forms`` and ``block_attention`` sources and times,
by CUDA events over ``ITERS`` calls after 3 warm-ups, at the ViT-H encoder's
shapes (16 heads of 80; seeded inputs of std 1, tables of std 0.02):

- the window family: K5 (``rel_attention_window``) on 50 windows of 14 x 14
  tokens in 200 slots and on the attention tools' 200; K6
  (``rel_attention_window_rect``) on 8 windows of 14 x 8 and 10 of 8 x 14
  carried tokens in 112 slots, with a seeded fp32 qkv bias (mean 0.5, std
  0.5); K9 (``rel_attention_pre``) on 800 sequences of 196 tokens; K10
  (``rel_attention_headmajor``) on 50 windows of 196 tokens; K16's window
  forms (``rel_attention_forms``: v1, v3, norel, noroll, noexp) on 200
  windows;
- on 2 grids of 64 x 64 tokens: K7, K7-int8, K7-pv and K7-int8pv
  (``rel_attention_global`` and its ``int8_qk``, ``int8_pv`` flags), K11
  (``rel_attention_headmajor_global``), K9 (``rel_attention_pre`` on the same
  q, k, v split per head) and K16's v1 and v3 (``rel_attention_forms``);
  K7-pv and K7-int8pv again on the int8 p.v tool's own inputs
  (``tools/bench_int8pv.inputs``: rel tables of std 0.1), whose softmax the
  fixed probability scale flushes less;
- K12 (``window_block_attention``, the v2 formulation's fused window block)
  on the inputs :func:`k12_case` makes: 50 windows of 14 x 14 tokens (two
  images' 64 x 64 grids, padded to 70 x 70), E 1280 in 16 heads, seeded with
  numpy (the same in every turn, whichever checkout's package runs them; the
  turn loads this module by path, so the parent need not have it).

Each turn prints one JSON line: per kernel its milliseconds per call (CUDA
events around back-to-back calls, which the host's launch path bounds for a
small kernel), its device milliseconds per call (``torch.profiler``'s device
time of every kernel the call launches, over 10 calls), a digest of its output (the sum of the output's raw 16-bit patterns, as int64),
its max |output| (the scale of the kernels' tolerances), and the max
|difference| from the first turn's output and the share of its entries
equal to it bit for bit, which the first turn saves in the temporary
directory (and the last turn removes).  Equal digests and a difference of 0
mean the two checkouts' kernels give the same bits.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from samcarriestheburden_torch.device import resolve_device

ITERS = 50

TURN = r'''
import importlib.util, json, os, sys
sys.path.insert(0, sys.argv[1])
import torch
from torch.profiler import ProfilerActivity, profile
from samcarriestheburden_torch.kernels import attention as A, build
from samcarriestheburden_torch.tools import bench_int8pv
spec = importlib.util.spec_from_file_location("ab_attention_cases", sys.argv[4])
cases_mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cases_mod)
PROFILED = 10
build.build(["attention", "attention_forms", "block_attention"])
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(0)
iters, saved = int(sys.argv[2]), sys.argv[3]
heads, hd, side = 16, 80, 64


def randn(*shape, std=1.0):
    return (torch.randn(shape, generator=g, device=dev) * std).bfloat16()


qkv_w, tab_w = randn(50, 200, 3 * heads * hd), randn(2 * (2 * 14 - 1), hd, std=0.02)
qkv_t = randn(200, 200, 3 * heads * hd)
qkv_r = {(14, 8): randn(8, 112, 3 * heads * hd), (8, 14): randn(10, 112, 3 * heads * hd)}
bias = torch.randn(3 * heads * hd, generator=g, device=dev) * 0.5 + 0.5
qw, kw_, vw = (randn(800, 196, hd) for _ in range(3))
rh_w, rw_w = randn(800, 196, 14), randn(800, 196, 14)
qkv_10 = randn(50, 196, 3 * heads * hd)
rh_10, rw_10 = randn(heads, 50, 196, 14), randn(heads, 50, 196, 14)
win = dict(kh=14, kw=14, heads=heads, hd=hd, nkeys=196)
forms = {"v1": dict(softmax="v1"), "v3": dict(softmax="v3"), "norel": dict(rel="none"),
         "noroll": dict(rel="base0"), "noexp": dict(exp=False)}
qkv, tab = randn(2, side * side, 3 * heads * hd), randn(2 * (2 * side - 1), hd, std=0.02)
rel_h, rel_w = randn(heads, 2, side * side, side), randn(heads, 2, side * side, side)
x = qkv.view(2, side * side, heads, 3, hd).permute(3, 2, 0, 1, 4).reshape(3, -1, side * side, hd)
q, k, v = (t.contiguous() for t in x)
grid = dict(kh=side, kw=side, heads=heads, hd=hd)
qkv_p, tab_p = bench_int8pv.inputs(heads, hd, side, 2, dev)
cases = {
    "K5": lambda: A.rel_attention_window(qkv_w, tab_w, ws=14, heads=heads, hd=hd),
    "K5 200": lambda: A.rel_attention_window(qkv_t, tab_w, ws=14, heads=heads, hd=hd),
    "K6 14x8": lambda: A.rel_attention_window_rect(qkv_r[14, 8], tab_w, bias, ws=14, rh=14, rw=8,
                                                   heads=heads, hd=hd),
    "K6 8x14": lambda: A.rel_attention_window_rect(qkv_r[8, 14], tab_w, bias, ws=14, rh=8, rw=14,
                                                   heads=heads, hd=hd),
    "K9 win": lambda: A.rel_attention_pre(qw, kw_, vw, rh_w, rw_w, kh=14, kw=14),
    "K10": lambda: A.rel_attention_headmajor(qkv_10, rh_10, rw_10, kh=14, kw=14, heads=heads,
                                             hd=hd),
    **{f"K16-{f} 200": (lambda f=f: A.rel_attention_forms(qkv_t, tab_w, **win, **forms[f]))
       for f in forms},
    "K7": lambda: A.rel_attention_global(qkv, tab, **grid),
    "K7-int8": lambda: A.rel_attention_global(qkv, tab, **grid, int8_qk=True),
    "K7-pv": lambda: A.rel_attention_global(qkv, tab, **grid, int8_pv=True),
    "K7-int8pv": lambda: A.rel_attention_global(qkv, tab, **grid, int8_qk=True, int8_pv=True),
    "K7-pv tool": lambda: A.rel_attention_global(qkv_p, tab_p, **grid, int8_pv=True),
    "K7-int8pv tool": lambda: A.rel_attention_global(qkv_p, tab_p, **grid, int8_qk=True,
                                                     int8_pv=True),
    "K11": lambda: A.rel_attention_headmajor_global(qkv, rel_h, rel_w, **grid),
    "K9": lambda: A.rel_attention_pre(q, k, v, rel_h.reshape(-1, side * side, side),
                                      rel_w.reshape(-1, side * side, side), kh=side, kw=side),
    "K16-v1": lambda: A.rel_attention_forms(qkv, tab, **grid, nkeys=side * side, softmax="v1"),
    "K16-v3": lambda: A.rel_attention_forms(qkv, tab, **grid, nkeys=side * side, softmax="v3"),
}
k12_args, k12_kw = cases_mod.k12_case(dev)
cases["K12"] = lambda: A.window_block_attention(*k12_args, **k12_kw)
first = torch.load(saved) if os.path.exists(saved) else None
outs, res = {}, {}
for name, fn in cases.items():
    out = fn()
    torch.cuda.synchronize()
    outs[name] = out.cpu()
    diff = equal = None
    if first is not None:
        diff = (out.float().cpu() - first[name].float()).abs().max().item()
        equal = (out.cpu().view(torch.int16) == first[name].view(torch.int16)).float().mean().item()
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
        for _ in range(PROFILED):
            fn()
        torch.cuda.synchronize()
    device_us = sum(e.self_device_time_total for e in prof.key_averages())
    res[name] = {"ms": start.elapsed_time(end) / iters, "device_ms": device_us / PROFILED / 1e3,
                 "digest": int(out.view(torch.int16).long().sum()), "max_diff": diff,
                 "equal": equal, "max_abs": out.float().abs().max().item()}
if first is None:
    torch.save(outs, saved)
print(json.dumps(res))
'''


def k12_case(device, *, wb: int = 50, ws: int = 14, e: int = 1280, heads: int = 16,
             grid: int = 64, seed: int = 0):
    """K12's inputs, seeded with numpy: ``wb`` windows of ``ws`` x ``ws``
    LayerNormed tokens of std 1 from images whose ``grid`` x ``grid`` tokens
    are padded to whole windows, the pad tokens zero (as the encoder masks
    them); the per-head-grouped qkv weight and bias, the projection and the
    stacked rel tables of std 0.02.  Returns ``(args, kwargs)`` of
    ``window_block_attention``."""
    rng = np.random.default_rng(seed)
    per_side = -(-grid // ws)
    w = np.arange(wb) % (per_side * per_side)
    rows = (w // per_side)[:, None] * ws + np.arange(ws)[None]        # (wb, ws) grid rows
    cols = (w % per_side)[:, None] * ws + np.arange(ws)[None]
    live = (rows[:, :, None] < grid) & (cols[:, None, :] < grid)      # (wb, ws, ws)
    xn = rng.standard_normal((wb, ws * ws, e), dtype=np.float32) * live.reshape(wb, -1, 1)

    def normal(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * 0.02

    bf = torch.bfloat16
    args = (torch.from_numpy(xn).to(device, bf), torch.from_numpy(normal(3 * e, e)).to(device, bf),
            torch.from_numpy(normal(3 * e)).to(device),
            torch.from_numpy(normal(e, e)).to(device, bf),
            torch.from_numpy(normal(2 * (2 * ws - 1), e // heads)).to(device, bf))
    return args, dict(ws=ws, heads=heads)


def run_turns(script: str, parent: str, change: str, name: str, iters: int, *args: str):
    """``script`` (a turn: argv ``tree iters saved *args``, its last line of
    output one JSON object) for the four turns parent, change, change,
    parent, each in a process of its own; the first turn saves its outputs
    at ``saved`` in the temporary directory, which is removed at the end.
    Returns ``[(checkout, result), ...]``; raises without a card or when a
    turn fails."""
    resolve_device(None)
    saved = os.path.join(tempfile.gettempdir(), f"{name}_{os.getpid()}.pt")
    results = []
    try:
        for tree in (parent, change, change, parent):
            proc = subprocess.run([sys.executable, "-c", script, tree, str(iters), saved, *args],
                                  capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                raise RuntimeError(f"the turn in {tree} failed:\n{proc.stderr[-4000:]}")
            results.append((tree, json.loads(proc.stdout.strip().splitlines()[-1])))
            print(tree, json.dumps(results[-1][1]), flush=True)
    finally:
        if os.path.exists(saved):
            os.remove(saved)
    return results


def run(parent: str, change: str = str(Path(__file__).resolve().parents[2])):
    """``[(checkout, {kernel: {"ms", "device_ms", "digest", "max_diff", "equal",
    "max_abs"}}), ...]`` for the four turns; raises without a card or when a
    turn fails."""
    return run_turns(TURN, parent, change, "ab_attention", ITERS, str(Path(__file__).resolve()))


if __name__ == "__main__":
    run(*sys.argv[1:])
