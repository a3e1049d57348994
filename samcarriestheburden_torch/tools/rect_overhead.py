"""K6's launch path against its body on edge and corner windows (JAX
``tools/exp_rect_overhead.py`` and ``tools/exp_corner.py``).

    python -m samcarriestheburden_torch.tools.rect_overhead [--iters 50]

For each case, (rh, rw) carried cells of a 14 x 14 window in ``wb``
windows of 8-aligned slots at ViT-H's heads (16 x 80): the ViT-H serving
path's two edge groups at batch 2 (14 x 8 and 8 x 14, the bottom strip
carrying the corner; ``models/image_encoder.py:compact_window_groups``) and
the JAX tools' shapes (14 x 8 in 128, 288 and 1024 windows, the 8 x 8
corner in 32):

* K6 by CUDA events over ``--iters`` back-to-back calls (the host's launch
  path included) and by its device time in a profile of the same calls
  (``torch.profiler``): the difference is the launch path's share;
* K5 on the same windows materialised as full 14 x 14 windows (the flat
  layout: the carried cells at their places, the projection's bias at the
  pad cells, ``chip_smoke.materialised_windows``), both ways.

Prints ms per call and the device ms per launch of each; ``PERF.md`` §6's
K6 row (0.0482 ms for a block's two launches by events against 0.0209 ms of
device time a launch) is the serving case.  Runs on the card;
``device="cpu"`` times the plain versions by the host clock (no device time).
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from samcarriestheburden_torch.device import resolve_device

HEADS, HD, WS = 16, 80, 14


def serving_cases(batch: int = 2, grid: int = 64, ws: int = WS) -> List[Tuple[int, int, int]]:
    """(rh, rw, wb) of the compact layout's edge groups at ``batch`` images."""
    from samcarriestheburden_torch.models.image_encoder import compact_window_groups

    return [(g["rh"], g["rw"], batch * g["nh"] * g["nw"])
            for g in compact_window_groups(grid, grid, ws) if (g["rh"], g["rw"]) != (ws, ws)]


#: the JAX tools' cases: (rh, rw, wb)
JAX_CASES = [(14, 8, 128), (14, 8, 288), (14, 8, 1024), (8, 8, 32)]


def inputs(rh: int, rw: int, wb: int, device, *, heads: int = HEADS, hd: int = HD, ws: int = WS,
           dtype=torch.bfloat16, seed: int = 0):
    """(qkv (wb, np, 3 heads hd), tables, qkv_bias fp32) of one case, seeded."""
    from samcarriestheburden_torch.kernels.attention import prepare_rel_tables

    gen = torch.Generator(device=device).manual_seed(seed)
    np_ = -(-rh * rw // 8) * 8
    c = 3 * heads * hd
    qkv = torch.randn((wb, np_, c), generator=gen, device=device).to(dtype)
    rel = [torch.randn((2 * ws - 1, hd), generator=gen, device=device) * 0.02 for _ in range(2)]
    tables = prepare_rel_tables(rel[0], rel[1], ws, ws, dtype)
    bias = torch.randn((c,), generator=gen, device=device) * 0.1
    return qkv, tables, bias


def materialised(qkv, bias, ws: int, rh: int, rw: int):
    """The flat layout's (wb, np, C) windows of K6's carried cells."""
    wb, _, c = qkv.shape
    n = ws * ws
    full = torch.zeros((wb, -(-n // 8) * 8, c), dtype=qkv.dtype, device=qkv.device)
    full[:, :n] = bias.to(qkv.dtype)
    full[:, :n].view(wb, ws, ws, c)[:, :rh, :rw] = qkv[:, :rh * rw].view(wb, rh, rw, c)
    return full


#: profiles of a case before its device time is given up as not measured: in
#: a long process the profiler has returned a session without its kernels
PROFILE_TRIES = 3


def _times(fn, iters: int, dev) -> Tuple[float, Optional[float]]:
    """(ms per call by events or the host clock, device ms per call or None:
    not measured on the CPU, nor when no profile of the calls holds their
    kernels)."""
    from samcarriestheburden_torch.tools.timing import call_ms

    ms = call_ms(fn, iters, dev, warmup=2)
    if dev.type != "cuda":
        return ms, None
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        device = sum(e.device_time_total for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        if device > 0:
            return ms, device / iters
    return ms, None


def rect_overhead(device=None, *, cases: Optional[Sequence[Tuple[int, int, int]]] = None,
                  heads: int = HEADS, hd: int = HD, ws: int = WS, iters: int = 50
                  ) -> Dict[str, dict]:
    """{"rh x rw, wb windows": {"k6_ms", "k6_device_ms", "k5_ms", "k5_device_ms",
    "k6_launch_ms"}}, printed; the launch path's share is ``k6_ms -
    k6_device_ms``."""
    from samcarriestheburden_torch.kernels import attention as attn_k

    dev = resolve_device(device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    if cases is None:
        cases = serving_cases() + JAX_CASES
    out = {}
    for rh, rw, wb in cases:
        qkv, tables, bias = inputs(rh, rw, wb, dev, heads=heads, hd=hd, ws=ws, dtype=dtype)
        full = materialised(qkv, bias, ws, rh, rw)
        k6 = _times(lambda: attn_k.rel_attention_window_rect(
            qkv, tables, bias, ws=ws, rh=rh, rw=rw, heads=heads, hd=hd), iters, dev)
        k5 = _times(lambda: attn_k.rel_attention_window(full, tables, ws=ws, heads=heads, hd=hd),
                    iters, dev)
        key = f"{rh}x{rw}, {wb} windows"
        rec = out[key] = {"k6_ms": k6[0], "k6_device_ms": k6[1], "k5_ms": k5[0],
                          "k5_device_ms": k5[1],
                          "k6_launch_ms": None if k6[1] is None else k6[0] - k6[1]}
        dev_txt = " (device not measured)" if k6[1] is None else (
            f" (device {k6[1]:.4f}, launch path {rec['k6_launch_ms']:.4f})")
        k5_txt = "" if k5[1] is None else f" (device {k5[1]:.4f})"
        print(f"{key}: K6 {k6[0]:.4f} ms{dev_txt}; K5 on the materialised windows "
              f"{k5[0]:.4f} ms{k5_txt}; {wb / k6[0] * 1e-3:.4f} windows/us", flush=True)
    return out


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--iters", type=int, default=50)
    args = p.parse_args(argv)
    rect_overhead(iters=args.iters)


if __name__ == "__main__":
    main()
