"""Where one call of the serving encoder spends the card's time, by kernel.

    python -m samcarriestheburden_torch.tools.profile_encoder [--batch 32]
        [--quantize int8 none] [--compact on off] [--top 12]

Builds ViT-H SAM with seeded random weights, makes the serving encoder
(``make_serving_encoder``: the compact layout, or the flat one with
``--compact off``, JAX ``tools/exp_profile_encoder.py``'s A/B; bf16, int8
weights and activations with ``int8``) and, after one warm-up call,
profiles one call of each mode and layout on ``--batch``
seeded uint8 images of input size 1024 x 716 (the bench's): the device time
of every kernel (``torch.profiler``), the call's wall time, the idle share
``1 - busy / wall``, and the ``--top`` kernels with their share of the busy
time.  Runs on the card only.
"""

from __future__ import annotations

import argparse
import time

import torch

from samcarriestheburden_torch.config import sam_vit_h_config
from samcarriestheburden_torch.device import resolve_device
from samcarriestheburden_torch.engine.embeddings import make_serving_encoder
from samcarriestheburden_torch.models.sam import build_sam
from samcarriestheburden_torch.tools.encoder_ab import INPUT_HW, images


def profile_encoder(batch: int = 32, quantize=("int8", "none"), top: int = 12,
                    compact=("on",)) -> dict:
    """{mode (with " flat" for ``compact`` off): (busy ms, wall ms, [(kernel,
    device ms, calls), ...])}, printed as it goes."""
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(None)
    model = build_sam(sam_vit_h_config(), device=dev, seed=0)
    imgs, sizes = images(batch, model.img_size, dev, INPUT_HW)
    out = {}
    for mode, layout in [(m, c) for c in compact for m in quantize]:
        encode, packed = make_serving_encoder(model, torch.bfloat16,
                                              quantize=None if mode == "none" else mode,
                                              compact_windows=layout == "on")
        encode(packed, imgs, sizes)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            encode(packed, imgs, sizes)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.key_averages() if e.device_time_total > 0
                  and e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.device_time_total for e in events) / 1e3
        kernels = [(e.key, e.device_time_total / 1e3, e.count)
                   for e in sorted(events, key=lambda e: -e.device_time_total)[:top]]
        name = mode if layout == "on" else f"{mode} flat"
        print(f"batch {batch} {name} encoder: device busy {busy:.2f} ms of {wall:.2f} ms wall "
              f"(idle share {max(0.0, 1 - busy / wall):.3f})", flush=True)
        for key, ms, n in kernels:
            print(f"  {ms:9.3f} ms {100 * ms / busy:5.1f} % {n:5d} x  {key[:100]}", flush=True)
        out[name] = (busy, wall, kernels)
        del encode, packed
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--quantize", nargs="+", choices=["int8", "none"], default=["int8", "none"])
    p.add_argument("--compact", nargs="+", choices=["on", "off"], default=["on"],
                   help="the compact layout (the serving default) and/or the flat one")
    p.add_argument("--top", type=int, default=12)
    args = p.parse_args(argv)
    profile_encoder(args.batch, args.quantize, args.top, args.compact)


if __name__ == "__main__":
    main()
