"""Where one ``SegEnhance.enhance_batch`` spends the card's time, by kernel
and by the port's own source line (JAX ``tools/exp_profile_enhance.py`` and
``tools/trace_enhance.py``).

    python -m samcarriestheburden_torch.tools.profile_enhance [--images 16]
        [--decoder fp32 bf16] [--top 12]

Builds ViT-H SAM with seeded random weights (seed 0) and the enhance path
of the bench: ``SegEnhance(SamSegRefiner(head, box, then points),
"highest_probability", "dilation", "square", 8)`` over ``--images`` seeded
embeddings held in memory and ``--images`` x 17 seeded probability maps of
384 x 224 (the JAX tools' elliptical blobs), the decoder in fp32 or bf16.
After one warm-up call it profiles one call (``torch.profiler``): the wall
and device-busy ms, the idle share, the ``--top`` kernels, and the device
time by the port line that called the PyTorch operator that launched each
kernel.  A dispatch mode (:class:`LineMode`) wraps every operator in a
``record_function`` span named after the innermost frame of this package
on the stack (``port:<file>:<line>``); each kernel is charged to the span
above the operator that launched it.  Kernels launched outside any
operator (the port's own CUDA kernels, K8 here) are in the busy time and in
no line.  The mode adds host time, not device time.  Runs on the card;
``device="cpu"`` groups the CPU operators' self time the same way.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from samcarriestheburden_torch.config import UNET_INPUT_HW, sam_vit_h_config
from samcarriestheburden_torch.device import resolve_device

PKG = "samcarriestheburden_torch"
TAG = "port:"
#: frames of this module are the caller's, not the port's
_SELF = __file__
#: the kernel families the records asked about (``PERF.md`` §5)
FAMILIES = ("elementwise_kernel", "direct_copy")


def make_enhance(model, images: int, device, compute_dtype=None, grid=UNET_INPUT_HW,
                 seed: int = 0):
    """(SegEnhance, probabilities (images, 17, H, W) on ``device``, stems):
    the bench's enhance path over ``images`` seeded embeddings held in
    memory and its maps (one soft elliptical blob a class, the JAX tools'),
    the original size the grid x 6 and its resize-longest-side input, as the
    JAX tools set them."""
    from samcarriestheburden_torch.bench import enhance_probs
    from samcarriestheburden_torch.data.h5io import MemoryEmbeddings
    from samcarriestheburden_torch.engine.decoder_head import SamMaskDecoderHead
    from samcarriestheburden_torch.engine.refinement import SamSegRefiner, SegEnhance

    size = model.img_size
    eh, ew = model.cfg.prompt_encoder.image_embedding_size
    td = model.cfg.mask_decoder.transformer_dim
    original = np.asarray([grid[0] * 6, grid[1] * 6])
    inp = np.asarray([size, int(size * grid[1] / grid[0])])
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    stems = [f"image{i:03d}" for i in range(images)]
    feats = {s: torch.randn((1, td, eh, ew), generator=gen, device=device) for s in stems}
    store = MemoryEmbeddings(size, feats, {s: (original, inp) for s in stems})
    head = SamMaskDecoderHead(None, "bench", store, device=device, params=model, cfg=model.cfg,
                              compute_dtype=compute_dtype)
    enh = SegEnhance(SamSegRefiner(head, prompts2use=[["box"], ["pos_points", "neg_points"]]),
                     "highest_probability", "dilation", "square", 8)
    probs = torch.from_numpy(enhance_probs(np.random.default_rng(seed), images, grid)).to(device)
    return enh, probs, stems


def _port_line() -> str:
    f = sys._getframe(2)
    while f is not None and (PKG not in f.f_code.co_filename or f.f_code.co_filename == _SELF):
        f = f.f_back
    if f is None:
        return TAG + "?"
    return f"{TAG}{f.f_code.co_filename.split(PKG + '/')[-1]}:{f.f_lineno}"


class LineMode(TorchDispatchMode):
    """Each operator in a ``record_function`` span named after the port line
    that called it."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.profiler import record_function

        with record_function(_port_line()):
            return func(*args, **(kwargs or {}))


def line_records(events, device_type: str) -> List[Tuple[str, str, float]]:
    """``[(line, name, us)]`` from a profile taken under :class:`LineMode`:
    on ``"cuda"`` each kernel, charged to the span above the operator that
    launched it; on ``"cpu"`` each operator's self time, charged to the span
    above it.  Events under no span are left out."""
    out = []
    for e in events:
        if e.name.startswith(TAG):
            continue
        p = e.cpu_parent
        while p is not None and not p.name.startswith(TAG):
            p = p.cpu_parent
        if p is None:
            continue
        line = p.name[len(TAG):]
        if device_type == "cuda":
            out += [(line, k.name, k.duration) for k in e.kernels]
        elif e.self_cpu_time_total > 0:
            out.append((line, e.name, e.self_cpu_time_total))
    return out


def group_by_line(records) -> Dict[str, Dict[str, float]]:
    """{line: {kernel or operator: ms}} of :func:`line_records`' output."""
    out: Dict[str, Dict[str, float]] = defaultdict(lambda: defaultdict(float))
    for line, name, us in records:
        out[line][name] += us / 1e3
    return {line: dict(names) for line, names in out.items()}


def launchers(by_line: Dict[str, Dict[str, float]], pattern: str, top: int = 8
              ) -> List[Tuple[str, float]]:
    """The lines that launched kernels whose name holds ``pattern``, by ms."""
    ms = {line: sum(v for k, v in names.items() if pattern in k)
          for line, names in by_line.items()}
    return sorted(((k, v) for k, v in ms.items() if v > 0), key=lambda kv: -kv[1])[:top]


def _profile(fn, device, mode: bool):
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with LineMode() if mode else contextlib.nullcontext():
            t0 = time.perf_counter()
            fn()
            if cuda:
                torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    if cuda:
        by_kernel = {e.key: e.device_time_total / 1e3 for e in prof.key_averages()
                     if e.device_time_total > 0
                     and e.device_type == torch.autograd.DeviceType.CUDA}
    else:
        by_kernel = defaultdict(float)
        for e in prof.events():
            if not e.name.startswith(TAG) and e.name != "PythonDispatchMode":
                by_kernel[e.name] += e.self_cpu_time_total / 1e3
    return wall, dict(by_kernel), prof.events()


def profile_call(fn, device, top: int = 12) -> dict:
    """One ``fn()`` after a warm-up call, profiled twice: alone, for the wall
    and busy ms, the idle share and the ``top`` kernels (or operators on the
    CPU); then under :class:`LineMode`, for each kernel's launching lines,
    the busy time by line and by family (``attributed_ms`` of that run's
    ``busy_lines_ms``)."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall, by_kernel, _ = _profile(fn, device, False)
    _, by_kernel_lines, events = _profile(fn, device, True)
    busy = sum(by_kernel.values())
    by_line = group_by_line(line_records(events, device.type))
    ranked = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:top]
    return {"wall_ms": wall, "busy_ms": busy, "idle_share": max(0.0, 1 - busy / wall),
            "attributed_ms": sum(sum(v.values()) for v in by_line.values()),
            "busy_lines_ms": sum(by_kernel_lines.values()),
            "top": [(k, ms, launchers(by_line, k, 4)) for k, ms in ranked],
            "lines": sorted(((line, sum(v.values())) for line, v in by_line.items()),
                            key=lambda kv: -kv[1])[:top],
            "families": {f: launchers(by_line, f) for f in FAMILIES},
            "by_line": by_line}


def profile_enhance(device=None, *, model=None, images: int = 16,
                    decoders: Sequence[str] = ("fp32", "bf16"), grid=UNET_INPUT_HW,
                    top: int = 12) -> Dict[str, dict]:
    """{decoder: :func:`profile_call` of one ``enhance_batch``}, printed as
    it goes.  ``model``: a ``SamModel`` on ``device`` (default: ViT-H with
    seeded weights)."""
    dev = resolve_device(device)
    if model is None:
        model = _vit_h(dev)
    out = {}
    for decoder in decoders:
        enh, probs, stems = make_enhance(model, images, dev,
                                         torch.bfloat16 if decoder == "bf16" else None, grid)
        res = out[decoder] = profile_call(lambda: enh.enhance_batch(probs, stems), dev, top)
        unit = "device" if dev.type == "cuda" else "CPU self"
        print(f"enhance_batch of {images} ({decoder} decoder): {unit} busy "
              f"{res['busy_ms']:.4f} ms of {res['wall_ms']:.4f} wall (idle share "
              f"{res['idle_share']:.4f}); {res['attributed_ms']:.4f} ms charged to port lines",
              flush=True)
        for name, ms, lines in res["top"]:
            print(f"  {ms:9.4f} ms {100 * ms / res['busy_ms']:5.1f} %  {name[:110]}", flush=True)
            for line, lms in lines:
                print(f"        {lms:9.4f} ms  {line}", flush=True)
        print("  by line:", flush=True)
        for line, ms in res["lines"]:
            print(f"  {ms:9.4f} ms  {line}", flush=True)
        for fam, lines in res["families"].items():
            print(f"  {fam}: " + "; ".join(f"{line} {ms:.4f} ms" for line, ms in lines),
                  flush=True)
    return out


def _vit_h(dev):
    from samcarriestheburden_torch.models.sam import build_sam

    return build_sam(sam_vit_h_config(), device=dev, seed=0)


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--images", type=int, default=16)
    p.add_argument("--decoder", nargs="+", choices=["fp32", "bf16"], default=["fp32", "bf16"])
    p.add_argument("--top", type=int, default=12)
    args = p.parse_args(argv)
    profile_enhance(images=args.images, decoders=args.decoder, top=args.top)


if __name__ == "__main__":
    main()
