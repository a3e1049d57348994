"""K5 and K7 of two checkouts of the repository on one card, in turns.

    python -m samcarriestheburden_torch.tools.ab_attention PARENT [CHANGE]

``PARENT`` and ``CHANGE`` (default: this checkout) are repository roots.
Each turn runs in a process of its own (the two packages share a name), in
the order parent, change, change, parent: it builds that checkout's
``attention`` source, times ``rel_attention_window`` (K5) on 50 windows and
``rel_attention_global`` (K7) on 2 grids at the ViT-H encoder's shapes
(16 heads of 80, seeded inputs of std 1, tables of std 0.02) by CUDA events
over ``ITERS`` calls after 3 warm-ups, and prints one JSON line of
milliseconds per call.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

from samcarriestheburden_torch.device import resolve_device

ITERS = 50

TURN = r'''
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from samcarriestheburden_torch.kernels import attention as A, build
build.build(["attention"])
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(0)
iters = int(sys.argv[2])
res = {}
for name, s, n, side in (("K5", 50, 200, 14), ("K7", 2, 4096, 64)):
    qkv = torch.randn((s, n, 3840), generator=g, device=dev).bfloat16()
    tab = (torch.randn((2 * (2 * side - 1), 80), generator=g, device=dev) * 0.02).bfloat16()
    if name == "K5":
        def fn():
            return A.rel_attention_window(qkv, tab, ws=side, heads=16, hd=80)
    else:
        def fn():
            return A.rel_attention_global(qkv, tab, kh=side, kw=side, heads=16, hd=80)
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    res[name] = start.elapsed_time(end) / iters
print(json.dumps(res))
'''


def run(parent: str, change: str = str(Path(__file__).resolve().parents[2])):
    """``[(checkout, {"K5": ms, "K7": ms}), ...]`` for the four turns; raises
    without a card or when a turn fails."""
    resolve_device(None)
    results = []
    for tree in (parent, change, change, parent):
        proc = subprocess.run([sys.executable, "-c", TURN, tree, str(ITERS)],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"the turn in {tree} failed:\n{proc.stderr[-4000:]}")
        results.append((tree, json.loads(proc.stdout.strip().splitlines()[-1])))
        print(tree, json.dumps(results[-1][1]), flush=True)
    return results


if __name__ == "__main__":
    run(*sys.argv[1:])
