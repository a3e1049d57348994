"""K8 (``kernels/ccl.py:propagate``) of two checkouts of the repository on one
card, in turns.

    python -m samcarriestheburden_torch.tools.ab_ccl PARENT [CHANGE]

``PARENT`` and ``CHANGE`` (default: this checkout) are repository roots.
Each turn runs in a process of its own (the two packages share a name), in
the order parent, change, change, parent, through ``ab_attention``'s turn
runner: it builds that checkout's ``ccl`` source and runs its
``propagate`` on the inputs :func:`inputs` makes (the same in every turn:
the change's ``chip_smoke.py`` makes them from its seeds):

- the main path's input: the 272 maps (16 images x 17 classes) of 384 x 224
  probabilities that ``chip_smoke.py``'s enhance path labels in one K8 call,
  at its cap (86016) and check interval (16);
- the stressed maps of that shape (``chip_smoke.k8_stress_maps``: speckle,
  a spiral, diagonal chains, an empty and a full map) at caps 37, 43 and
  the full 86016, checked every 16 steps, and at 37 and the full cap every
  48;
- the stressed maps of the wide and tall shapes (512, 448), (1024, 224) and
  (8, 28928), at cap 37 and the full cap.

Each turn prints one JSON line: per input its milliseconds per call (CUDA
events around back-to-back calls after at least 0.2 s of warm-up calls: 10
calls, or 2 where one takes 20 ms or more), a digest of its labels (:func:`digest`), the steps
its maps ran and how many converged, and the max |difference| of its
labels from the first turn's, which the first turn saves in the temporary
directory.  Equal digests and a difference of 0 mean the two checkouts give
the same bits.  Then the whole enhance path of ``chip_smoke.py`` once
(:func:`enhance_profile`: ``enhance_batch`` on the same 16 images with the
fp32 decoder of a ViT-H SAM with random weights, seed 0, and 16 seeded
embeddings), its device time by kernel.  The last lines are a summary: per
input the four turns' ms and whether their digests agree, and per turn the
enhance path's device busy time, idle share, K8's and the selection
histogram's time.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
#: the enhance path's stack (``chip_smoke.py``: ENHANCE_N images of
#: N_CLASSES maps on the U-Net grid) and the seed of its probabilities
IMAGES, CLASSES, GRID, PROBS_SEED = 16, 17, (384, 224), 4
#: the stressed maps' seed, caps and check intervals on the path's grid
STRESS_SEED, STRESS_CAPS = 5, ((37, 16), (43, 16), (None, 16), (37, 48), (None, 48))
#: shapes the register kernel does not hold, at cap 37 and the full cap
OTHER_SHAPES = ((512, 448), (1024, 224), (8, 28928))
SLOW_MS = 20.0

TURN = r'''
import importlib.util, json, sys
sys.path.insert(0, sys.argv[1])
spec = importlib.util.spec_from_file_location("ab_ccl_cases", sys.argv[4])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
print(json.dumps(mod.turn(sys.argv[3])))
'''


def _smoke():
    """This checkout's ``chip_smoke.py`` (its input builders), loaded by path."""
    spec = importlib.util.spec_from_file_location("ab_ccl_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def inputs(device, *, images: int = IMAGES, grid=GRID, other=OTHER_SHAPES
           ) -> Dict[str, Tuple[torch.Tensor, int, int]]:
    """{name: (mask (M, H, W) float32 on ``device``, cap, check_every)}."""
    smoke = _smoke()
    h, w = grid
    probs = smoke.enhance_probs(np, np.random.default_rng(PROBS_SEED), images, CLASSES, grid)
    out = {f"main path {images * CLASSES}x{h}x{w}":
           (torch.from_numpy(probs.reshape(-1, h, w)).to(device), max(h, w, h * w), 16)}
    for hw, caps in [(grid, STRESS_CAPS)] + [(s, ((37, 16), (None, 16))) for s in other]:
        maps = torch.from_numpy(smoke.k8_stress_maps(np, np.random.default_rng(STRESS_SEED),
                                                     hw)).to(device)
        for cap, every in caps:
            cap = cap or hw[0] * hw[1]
            out[f"stressed {hw[0]}x{hw[1]} cap {cap} every {every}"] = (maps, cap, every)
    return out


def digest(labels: torch.Tensor) -> int:
    """The sum of the labels, as an integer: the same for the same labels."""
    return int(labels.long().sum())


def enhance_profile(top: int = 8) -> Dict[str, object]:
    """One ``enhance_batch`` of ``chip_smoke.py``'s enhance path (after one
    warm-up call) under ``torch.profiler``: the wall and device-busy ms, the
    idle share, the ms of K8's kernels and of the selection's histogram, and
    the ``top`` kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    from samcarriestheburden_torch.config import sam_vit_h_config
    from samcarriestheburden_torch.models.sam import build_sam

    smoke = _smoke()
    port = smoke.enhance_modules()
    dev = torch.device("cuda")
    model = build_sam(sam_vit_h_config(), device=dev, seed=0)
    gen = torch.Generator(device=dev).manual_seed(3)
    stems = [f"image{i:02d}" for i in range(IMAGES)]
    feats = {s: torch.randn((1, 256, 64, 64), generator=gen, device=dev) for s in stems}
    sizes = {s: (np.array(smoke.ENH_ORIGINAL_HW), np.array(smoke.ENH_INPUT_HW)) for s in stems}
    head = port.SamMaskDecoderHead(None, "vit_h",
                                   port.MemoryEmbeddings(model.img_size, feats, sizes),
                                   device=dev, params=model, cfg=model.cfg)
    enh = port.SegEnhance(port.SamSegRefiner(head, prompts2use=smoke.TWO_ROUNDS),
                          "highest_probability", "dilation", "square", 8)
    probs = torch.from_numpy(smoke.enhance_probs(np, np.random.default_rng(PROBS_SEED), IMAGES,
                                                 CLASSES, GRID)).to(dev)
    enh.enhance_batch(probs, stems)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        enh.enhance_batch(probs, stems)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_kernel = {e.key: e.device_time_total / 1e3 for e in prof.key_averages()
                 if e.device_time_total > 0 and e.device_type == torch.autograd.DeviceType.CUDA}
    busy = sum(by_kernel.values())
    ranked = sorted(by_kernel.items(), key=lambda kv: -kv[1])
    return {"wall_ms": wall, "device_busy_ms": busy, "idle_share": max(0.0, 1 - busy / wall),
            "K8_ms": sum(v for k, v in by_kernel.items() if "ccl_" in k),
            "histogram_ms": sum(v for k, v in by_kernel.items() if "Histogram" in k),
            "top_kernels_ms": {k[:100]: v for k, v in ranked[:top]}}


def turn(saved: str) -> Dict[str, Dict]:
    """One turn on the card, in the checkout whose package is first on the
    path: {input: {"ms", "digest", "steps", "converged", "max_diff"}}."""
    from samcarriestheburden_torch.kernels import build
    from samcarriestheburden_torch.kernels import ccl as kccl

    build.build(["ccl"])
    first = torch.load(saved) if os.path.exists(saved) else None
    outs, res = {}, {}
    for name, (mask, cap, every) in inputs(torch.device("cuda")).items():
        t0 = time.perf_counter()
        labels, converged, steps = kccl.propagate(mask, cap, every)
        torch.cuda.synchronize()
        iters = 2 if (time.perf_counter() - t0) * 1e3 >= SLOW_MS else 10
        warm = time.perf_counter()        # a warm-up of >= 0.2 s: the card's clocks up
        while time.perf_counter() - warm < 0.2:
            kccl.propagate(mask, cap, every)
            torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            kccl.propagate(mask, cap, every)
        end.record()
        torch.cuda.synchronize()
        kept = outs[name] = labels.cpu()
        ref = None if first is None else first.get(name)
        res[name] = {"ms": start.elapsed_time(end) / iters, "digest": digest(labels),
                     "steps": int(steps.long().sum()), "converged": int(converged.sum()),
                     "max_diff": None if ref is None
                     else int((kept.long() - ref.long()).abs().max())}
    if first is None:
        torch.save(outs, saved)
    res["enhance_batch"] = enhance_profile()
    return res


def summary(results) -> None:
    """Per input, the four turns' ms and whether their digests, steps and
    flags agree; per turn, the enhance path's profile."""
    for name in [n for n in results[0][1] if n != "enhance_batch"]:
        turns = [r[name] for _, r in results]
        ms = ", ".join(f"{t['ms']:.4f}" for t in turns)
        same = len({(t["digest"], t["steps"], t["converged"]) for t in turns}) == 1
        diffs = [t["max_diff"] for t in turns if t["max_diff"] is not None]
        print(f"{name}: ms [{ms}] digests, steps and flags {'equal' if same else 'DIFFER'} "
              f"max diff {max(diffs) if diffs else None}", flush=True)
    for tree, r in results:
        e = r.get("enhance_batch")
        if e is not None:
            print(f"{tree} enhance_batch: device busy {e['device_busy_ms']:.4f} ms of "
                  f"{e['wall_ms']:.4f} wall (idle share {e['idle_share']:.4f}), K8 "
                  f"{e['K8_ms']:.4f} ms, histogram {e['histogram_ms']:.4f} ms", flush=True)


def run(parent: str, change: str = str(ROOT)):
    """``[(checkout, {input: {...}}), ...]`` for the four turns; raises without
    a card or when a turn fails."""
    from samcarriestheburden_torch.tools.ab_attention import run_turns

    return run_turns(TURN, parent, change, "ab_ccl", 0, str(Path(__file__).resolve()))


if __name__ == "__main__":
    summary(run(*sys.argv[1:]))
