"""Connected-component propagation alone at the enhance shapes: K8 against
the plain ``method="pool"`` path and ``method="scan"`` (JAX
``tools/exp_ccl.py``).

    python -m samcarriestheburden_torch.tools.exp_ccl [--batch 8] [--iters 3]

Labels ``--batch`` x 17 maps of 384 x 224 (the JAX tool's masks: per map
three discs, a main blob and specks) to their fixpoint (at most H x W
steps, checked every 16) three ways and asserts the labels equal:

* ``K8``: ``kernels/ccl.py:propagate``, the CUDA kernel on the card;
* ``pool``: its plain version, ``propagate_plain`` (PyTorch's 3 x 3 max
  pool, only the maps still running stepped);
* ``scan``: ``ops/ccl.py:connected_components(method="scan")``, JAX's
  segmented running maxes, to the same fixpoint in fewer rounds.

Each is timed by CUDA events over ``--iters`` calls after one warm-up call;
ms per call and per image.  ``tools/ab_ccl.py`` compares two checkouts of
K8; this tool compares the methods.  Runs on the card; ``device="cpu"``
gives the CPU's times (K8 is its plain version there).
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from samcarriestheburden_torch.config import N_CLASSES, UNET_INPUT_HW
from samcarriestheburden_torch.device import resolve_device
from samcarriestheburden_torch.tools.timing import call_ms

METHODS = ("K8", "pool", "scan")


def make_masks(batch: int, classes: int, hw) -> np.ndarray:
    """Per-slot distinct multi-blob masks (the JAX tool's ``make_masks``)."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[: hw[0], : hw[1]]
    m = np.zeros((batch, classes) + tuple(hw), np.float32)
    for i in range(batch):
        for c in range(classes):
            for _ in range(3):  # a main blob + specks, like bone prob-masks
                cy = rng.uniform(0.15, 0.85) * hw[0]
                cx = rng.uniform(0.15, 0.85) * hw[1]
                r = rng.uniform(6, 40)
                m[i, c] += ((yy - cy) ** 2 + (xx - cx) ** 2 < r * r)
    return (m > 0).astype(np.float32)


def method_fn(method: str):
    """``fn(flat (M, H, W), num_iter) -> labels int32`` of one method."""
    from samcarriestheburden_torch.kernels import ccl as kccl
    from samcarriestheburden_torch.ops.ccl import connected_components

    if method == "K8":
        return lambda m, n: kccl.propagate(m, n, 16)[0]
    if method == "pool":
        return lambda m, n: kccl.propagate_plain(m, n, 16)[0]
    if method == "scan":
        return lambda m, n: connected_components(m, n, method="scan")
    raise ValueError(f"unknown method {method!r}")


def exp_ccl(device=None, *, batch: int = 8, iters: int = 3, hw=UNET_INPUT_HW,
            methods: Sequence[str] = METHODS) -> Dict[str, dict]:
    """{method: {"ms", "ms_per_image", "labels_equal"}}, printed as it goes;
    raises if a method's labels differ from the first method's."""
    dev = resolve_device(device)
    masks = torch.from_numpy(make_masks(batch, N_CLASSES, hw)).to(dev)
    flat = masks.reshape(-1, *hw).contiguous()
    num_iter = hw[0] * hw[1]                 # the wrapper's to-convergence bound
    first, out = None, {}
    for method in methods:
        fn = method_fn(method)
        labels = fn(flat, num_iter)          # warm-up, and the labels compared
        equal = True if first is None else bool(torch.equal(labels, first))
        if first is None:
            first = labels
        if not equal:
            raise AssertionError(f"{method}: labels differ from {methods[0]}'s")
        ms = call_ms(lambda: fn(flat, num_iter), iters, dev, warmup=0)
        out[method] = {"ms": ms, "ms_per_image": ms / batch, "labels_equal": equal}
        print(f"{method:5s}: {ms:9.4f} ms/call = {ms / batch:8.4f} ms/img "
              f"({batch}x{N_CLASSES} maps {hw[0]}x{hw[1]}, labels equal)", flush=True)
    return out


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--iters", type=int, default=3)
    args = p.parse_args(argv)
    exp_ccl(batch=args.batch, iters=args.iters)


if __name__ == "__main__":
    main()
