#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. builds the port's CUDA kernels (K1, K3, K5, K7, K8) from
   ``samcarriestheburden_torch/csrc``, one ``nvcc`` per source, all at once;
2. drives the embed path once at full ViT-H width with seeded random
   weights: ``make_serving_encoder`` in bf16 on two padded 1024x1024 uint8
   images (input size 1024x716), then the 17-class two-round refinement
   decode and ``postprocess_masks`` on each embedding; K1, K3, K5 and K7
   must have launched in that run;
3. drives the enhance path once: ``SegEnhance.enhance_batch`` with
   ``SamSegRefiner`` (box, then points with round 1's logits) over 16
   images of 17 seeded U-Net-like probability maps on the 384x224 grid,
   reading the two embeddings just made and 14 seeded ones; K8 must have
   launched in that run;
4. holds each kernel against its plain PyTorch version on the card, on the
   inputs its path gives it and on stressed inputs of the same shapes
   (with planted faults that the check must be able to see), the whole
   kernel-path encoder against the plain-path encoder, with the random rel
   tables as they are and scaled up, and enhance on the card against
   enhance on the CPU and against itself image by image;
5. checks the outputs: finite and of the expected shape, the decode against
   the same decode on the CPU, and the kernels against the reference
   golden ``tests/golden/image_encoder.npz`` at the tiny config;
6. prints the kernels' numbers, the throughputs, the card's name and power
   limit, and as the last line ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, when there is no CUDA device or any
phase fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published dense peaks (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

B = 2                        # images per encoder call
INPUT_HW = (1024, 716)       # resized-longest-side input inside the 1024^2 pad
ORIGINAL_HW = (1600, 1119)   # the X-ray before resizing (1600 * 0.64 = 1024)

# kernel vs plain version on the card, both bf16 on identical inputs: the
# max abs difference must stay below TOL * max|plain|.  K1/K3 differ only
# in fp32 summation order before one bf16 rounding; K5/K7 also round the
# unnormalised probabilities to bf16 inside the online softmax where the
# plain version rounds normalised ones.  Readings on the H100 are one bf16
# ulp of the largest value (0.4-0.7 %); the tolerance is two (1.6 %).
KERNEL_TOL = {"K1": 1.6e-2, "K3": 1.6e-2, "K5": 1.6e-2, "K7": 1.6e-2}
# The random weights leave parts of each function nearly invisible at those
# inputs (near-uniform softmax, rel tables of std 0.02, qkv bias <= 0.03), so
# each kernel is held again at the same shapes on stressed inputs where every
# term moves the output far beyond bf16 rounding: qkv ~ 2 N(0,1) (peaked
# softmax) and rel tables of std 0.3 for K5/K7, non-zero-mean biases and
# LayerNorm affines for K1/K3.  There the kernel must agree with its plain
# version within STRESS_TOL x max|plain|, and every planted fault (the plain
# version with one term dropped or misindexed) must miss the plain version by
# at least FAULT_MARGIN x that tolerance, so the check would catch it.
# Readings on the H100 (x max|plain|): K1 0.32 %, K3 0.51 %, K5 0.79 %,
# K7 0.96 %; the smallest fault misses by 20x, 15x, 72x and 64x the tolerance.
STRESS_TOL = {"K1": 1e-2, "K3": 1e-2, "K5": 2e-2, "K7": 2e-2}
FAULT_MARGIN = 4.0
# the whole 32-layer encoder, kernel path vs plain path, both bf16: the
# per-layer differences above compound through 32 residual blocks; the
# output is LayerNorm2d'd, so unit scale.  Run twice: with the random weights
# as they are, and with every rel table scaled to std 0.3 (REL_STRESS x 0.02),
# where dropping the rel bias in the plain path must miss by FAULT_MARGIN x
# tol.  Readings on the H100: max 0.058 / 0.063, mean 0.0080 / 0.0093; the
# dropped rel bias misses by max 2.47, mean 0.248.
ENCODER_TOL_MAX, ENCODER_TOL_MEAN = 0.1, 0.015
REL_STRESS = 15.0
# vit_t in bf16 through the kernels vs the fp32 reference golden: the bf16
# plain path on the CPU is 2.5e-3 off it
GOLDEN_TOL = 0.02
# full-width decode on the card vs the CPU, both fp32 (TF32 off)
DECODE_RTOL = 1e-3
# estimated Dice, card vs CPU and batch vs image by image
DICE_TOL = 1e-4

# the enhance path (bench.py:223, 340-411): 16 images per enhance_batch, the
# U-Net grid, and the sizes bench.py gives its seeded embeddings
ENHANCE_N = 16
ENH_ORIGINAL_HW = (2304, 1344)   # the grid x 6
ENH_INPUT_HW = (1024, 597)       # its resize-longest-side to 1024
TWO_ROUNDS = [["box"], ["pos_points", "neg_points"]]
# K8 on stressed maps runs truncated at a cap that is not a multiple of the
# check interval (16), and to the fixpoint
K8_TRUNCATED = 37
# H100 SXM: 132 SMs of 64 INT32 lanes each (NVIDIA Hopper white paper)
H100_SMS, INT32_LANES = 132, 64

KERNELS = {  # name: (path, source, replaced TPU kernel)
    "K1": ("embed", "samcarriestheburden_torch/csrc/mlp.cu",
           "samcarriestheburden_tpu/kernels/mlp.py:135"),
    "K3": ("embed", "samcarriestheburden_torch/csrc/mlp.cu",
           "samcarriestheburden_tpu/kernels/mlp.py:75"),
    "K5": ("embed", "samcarriestheburden_torch/csrc/attention.cu",
           "samcarriestheburden_tpu/kernels/attention.py:492"),
    "K7": ("embed", "samcarriestheburden_torch/csrc/attention.cu",
           "samcarriestheburden_tpu/kernels/attention.py:639"),
    "K8": ("enhance", "samcarriestheburden_torch/csrc/ccl.cu",
           "samcarriestheburden_tpu/ops/ccl.py:211"),
}


class SmokeError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_ms(torch, fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float):
    """(bound_ms, bound_by): the larger of bf16 tensor-core time and HBM time."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def kernel_work(name: str, args, kw) -> tuple:
    """(flops, bytes) the kernel's function needs on these inputs: each input
    read once, each output written once."""
    if name == "K1":
        x, mask, g, b, w, bias = args[:6]
        t, e = x.shape
        o = w.shape[0]
        nbytes = 2 * (t * e + o * e + t * o) + 4 * (2 * e + o)
        nbytes += 2 * t if mask is not None else 0
        return 2.0 * t * e * o, nbytes
    if name == "K3":
        x, g, b, w1, b1, w2, b2 = args[:7]
        t, e = x.shape
        m = w1.shape[0]
        n_in = 2 if kw.get("add") is not None else 1
        nbytes = 2 * (n_in * t * e + 2 * m * e + t * e) + 4 * (3 * e + m)
        return 4.0 * t * e * m, nbytes
    qkv, tables = args[:2]
    s, n, _ = qkv.shape
    heads, hd = kw["heads"], kw["hd"]
    if name == "K5":
        kh = khw = kw["ws"]
    else:
        kh, khw = kw["kh"], kw["kw"]
    nkeys = kh * khw
    nt = tables.shape[0]
    flops = 2.0 * s * heads * n * (2 * nkeys * hd + nt * hd)
    nbytes = 2 * (qkv.numel() + tables.numel() + s * n * heads * hd)
    return flops, nbytes


def sdpa_inputs(torch, qkv, tables, heads, hd, kh, kw):
    """q, k, v (S, heads, n, hd) and the scaled rel-pos bias (S, heads, n, nkeys)
    as ``scaled_dot_product_attention`` takes them: the library yardstick of K5/K7."""
    s, n, _ = qkv.shape
    nkeys = kh * kw
    x = qkv.view(s, n, heads, 3, hd).permute(3, 0, 2, 1, 4)
    q, k, v = x[0].contiguous(), x[1][:, :, :nkeys].contiguous(), x[2][:, :, :nkeys].contiguous()
    scale = hd ** -0.5
    dev = qkv.device
    tok = torch.arange(n, device=dev)
    ph, pw = (tok // kw).clamp(max=kh - 1), tok % kw
    idx_h = ph[:, None] - torch.arange(kh, device=dev)[None] + kh - 1
    idx_w = pw[:, None] - torch.arange(kw, device=dev)[None] + kw - 1 + 2 * kh - 1
    g = (q.float() @ tables.float().T / scale).to(qkv.dtype).float()   # (S, h, n, R)
    rel_h = g.gather(3, idx_h.expand(s, heads, n, kh))
    rel_w = g.gather(3, idx_w.expand(s, heads, n, kw))
    bias = (rel_h[..., :, None] + rel_w[..., None, :]).reshape(s, heads, n, nkeys)
    return q, k, v, (bias * scale).to(qkv.dtype)


def stressed(torch, name, args, kw, gen):
    """(args, kw, faults) at the shapes of the recorded call ``args, kw``:
    stressed inputs, and the planted faults as {what: (args, kw)} of the
    plain version."""
    dev, bf = args[0].device, torch.bfloat16

    def randn(*shape, std=1.0, mean=0.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * std + mean).to(dtype)

    def sub(a, i, v):
        return a[:i] + (v,) + a[i + 1:]

    if name == "K1":
        x, mask, _, _, w, _ = args[:6]
        (t, e), o = x.shape, w.shape[0]
        a = (randn(t, e, std=2.0, mean=0.5, dtype=bf), mask, randn(e, std=0.5, mean=1.0),
             randn(e, std=0.5), randn(o, e, std=e ** -0.5, dtype=bf),
             randn(o, mean=1.0)) + tuple(args[6:])
        faults = {"qkv bias dropped": (sub(a, 5, torch.zeros_like(a[5])), kw),
                  "LayerNorm shift dropped": (sub(a, 3, torch.zeros_like(a[3])), kw)}
        if mask is not None:
            faults["pad mask ignored"] = (sub(a, 1, None), kw)
        return a, kw, faults
    if name == "K3":
        x, _, _, w1 = args[:4]
        (t, e), m = x.shape, w1.shape[0]
        a = (randn(t, e, dtype=bf), randn(e, std=0.5, mean=1.0), randn(e, std=0.5),
             randn(m, e, std=e ** -0.5, dtype=bf), randn(m, std=0.5),
             randn(e, m, std=m ** -0.5, dtype=bf), randn(e, mean=1.0))
        k = dict(kw, add=randn(t, e, dtype=bf))
        faults = {"add dropped": (a, dict(k, add=None)),
                  "lin1 bias dropped": (sub(a, 4, torch.zeros_like(a[4])), k),
                  "lin2 bias dropped": (sub(a, 6, torch.zeros_like(a[6])), k)}
        return a, k, faults
    qkv, tables = args[:2]
    kh = kw["ws"] if name == "K5" else kw["kh"]
    a = (randn(*qkv.shape, std=2.0, dtype=bf), randn(*tables.shape, std=0.3, dtype=bf))
    rh, rw = a[1][:2 * kh - 1], a[1][2 * kh - 1:]
    faults = {"rel bias dropped": ((a[0], torch.zeros_like(a[1])), kw),
              "rel tables reversed": ((a[0], torch.cat([rh.flip(0), rw.flip(0)])), kw)}
    if rh.shape == rw.shape:
        faults["Rh and Rw swapped"] = ((a[0], torch.cat([rw, rh])), kw)
    return a, kw, faults


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def phase_stress(torch, name, kern, plain, args, kw, gen) -> float:
    """The kernel vs its plain version on stressed inputs, and each planted
    fault vs the plain version; returns the kernel's max abs error."""
    a, k, faults = stressed(torch, name, args, kw, gen)
    out_p = plain(*a, **k)
    err = max_err(kern(*a, **k), out_p)
    tol = STRESS_TOL[name] * out_p.float().abs().max().item()
    misses = {what: max_err(plain(*fa, **fk), out_p) for what, (fa, fk) in faults.items()}
    log(f"{name} stressed: max abs err {err:.4g} (tol {tol:.4g}); planted faults miss by "
        + ", ".join(f"{what} {m:.4g}" for what, m in misses.items())
        + f" (must be >= {FAULT_MARGIN * tol:.4g})")
    check(err <= tol, f"{name} disagrees with its plain version on stressed inputs")
    for what, m in misses.items():
        check(m >= FAULT_MARGIN * tol, f"{name}: the stressed check cannot see '{what}'")
    return err


def nvidia_smi(query: str, units: bool = True) -> str:
    cmd = ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"
           + ("" if units else ",nounits")]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def gpu_identity() -> str:
    return nvidia_smi("name,power.limit")


def phase_build(build) -> None:
    t0 = time.perf_counter()
    logs = build.build(verbose=True)
    log(f"build: {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if any(word in line for word in ("entry function", "registers", "spill")):
                log(f"  ptxas {name}: {line.strip()}")


def phase_profile(torch, fn, what: str, top: int = 12) -> None:
    """Where one call's device time goes, by kernel (torch.profiler), and
    the card's idle share over the call's wall time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_time_total > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in events) / 1e3
    if busy_ms == 0:
        log(f"{what} profile: no device time recorded; not measured")
        return
    log(f"{what} profile: device busy {busy_ms:.2f} ms of {wall_ms:.2f} ms wall "
        f"(idle share {max(0.0, 1 - busy_ms / wall_ms):.3f})")
    for e in sorted(events, key=lambda e: -e.device_time_total)[:top]:
        log(f"  {e.device_time_total / 1e3:8.3f} ms  {e.count:4d} x  {e.key[:90]}")


def phase_golden(torch, np, cfg_t, ImageEncoderViT, KERNEL_OPS) -> float:
    """vit_t encoder in bf16 through the kernels on the card vs the golden."""
    data = np.load(ROOT / "tests" / "golden" / "image_encoder.npz")
    sd = {k[3:]: torch.from_numpy(data[k]) for k in data.files if k.startswith("sd/")}
    enc = ImageEncoderViT(cfg_t.image_encoder)
    enc.load_state_dict(sd)
    enc = enc.cuda()
    out = enc(torch.from_numpy(data["x"]).cuda(), dtype=torch.bfloat16, ops=KERNEL_OPS)
    torch.cuda.synchronize()
    err = (out.cpu() - torch.from_numpy(data["out"])).abs().max().item()
    log(f"golden vit_t (bf16 kernels vs fp32 reference): max abs err {err:.4g} "
        f"(tol {GOLDEN_TOL})")
    check(err <= GOLDEN_TOL, f"golden vit_t encoder off by {err}")
    return err


class MemoryEmbeddings:
    """Embeddings held on the card, read the way ``EmbeddingReader`` reads
    an h5 file (this machine need not have ``h5py``)."""

    checkpoint = "random-weights"

    def __init__(self, img_size: int, features: dict, sizes: dict):
        self.img_encoder_img_size = img_size
        self._features, self._sizes = features, sizes

    def features(self, stem):
        return self._features[stem]

    def sizes(self, stem):
        return self._sizes[stem]


def enhance_probs(np, rng, n: int, classes: int, hw) -> "np.ndarray":
    """(n, classes, H, W) U-Net-like probabilities: bench.py:393-400's soft
    elongated blob per class, a smaller second blob in every odd class (so
    the selection has a choice), and single-pixel specks at 0.6 (components
    that touch only through corners)."""
    h, w = hw
    yy, xx = np.mgrid[:h, :w]
    prob = np.zeros((n, classes, h, w), np.float32)
    for i in range(n):
        for c in range(classes):
            cy, cx = rng.uniform(0.2, 0.8) * h, rng.uniform(0.2, 0.8) * w
            ry, rx = rng.uniform(0.1, 0.3) * h, rng.uniform(0.05, 0.2) * w
            p = np.clip(1.2 - ((yy - cy) / ry) ** 2 - ((xx - cx) / rx) ** 2, 0, 1)
            if c % 2:
                cy, cx = rng.uniform(0.1, 0.9) * h, rng.uniform(0.1, 0.9) * w
                d2 = ((yy - cy) / (ry / 3)) ** 2 + ((xx - cx) / (rx / 3)) ** 2
                p = np.maximum(p, 0.9 * np.clip(1.2 - d2, 0, 1))
            specks = rng.random((h, w)) < 2e-3
            p[specks] = np.maximum(p[specks], 0.6)
            prob[i, c] = p
    return prob


def k8_stress_maps(np, rng, hw) -> "np.ndarray":
    """Maps of the main path's shape that stress K8: Bernoulli(0.45)
    speckle (thousands of components), a 1-pixel square spiral (a geodesic
    far beyond any small cap), 1-pixel diagonal chains (8-connected only),
    an empty and a full map."""
    h, w = hw
    spiral = np.zeros((h, w), np.float32)
    top, left, bottom, right = 0, 0, h - 1, w - 1
    while top <= bottom and left <= right:
        spiral[top, left:right + 1] = 1
        spiral[top:bottom + 1, right] = 1
        if bottom - top >= 2:
            spiral[bottom, left:right + 1] = 1
        if right - left >= 2 and bottom - top >= 4:
            spiral[top + 2:bottom + 1, left] = 1
            spiral[top + 2, left + 1] = 1               # on into the next ring
        top, left, bottom, right = top + 2, left + 2, bottom - 2, right - 2
    chains = np.zeros((h, w), np.float32)
    for i in range(0, h, 24):                     # parallel diagonal chains
        for j in range(min(h - i, w)):
            chains[i + j, j] = 1
    for j in range(min(h, w)):                    # one anti-diagonal across them
        chains[j, w - 1 - j] = 1
    speckle = (rng.random((4, h, w)) < 0.45).astype(np.float32)
    return np.concatenate([speckle, spiral[None], chains[None],
                           np.zeros((1, h, w), np.float32), np.ones((1, h, w), np.float32)])


def k8_faults(torch, kccl, maps, cap: int) -> dict:
    """Planted faults of K8's plain version on ``maps`` truncated at ``cap``:
    {what: labels}."""
    F = torch.nn.functional
    m, h, w = maps.shape
    fg = (maps > 0.5).float()
    init = torch.arange(1, h * w + 1, device=maps.device, dtype=torch.float32).view(h, w) * fg

    def hmax(rows):                                   # (M, W) -> 3-wide row max
        return F.max_pool1d(rows[:, None], 3, stride=1, padding=1)[:, 0]

    cross = init
    for _ in range(cap):                              # 4-connected Jacobi steps
        p = F.pad(cross, (1, 1, 1, 1))
        cross = torch.stack([cross, p[:, :-2, 1:-1], p[:, 2:, 1:-1], p[:, 1:-1, :-2],
                             p[:, 1:-1, 2:]]).amax(0) * fg
    seidel = init.clone()
    for _ in range(cap):                              # in place, row after row
        old = seidel.clone()
        for r in range(h):
            rows = [hmax(old[:, r])] + ([hmax(seidel[:, r - 1])] if r > 0 else []) \
                + ([hmax(old[:, r + 1])] if r + 1 < h else [])
            seidel[:, r] = torch.stack(rows).amax(0) * fg[:, r]
    return {"4-connected steps": cross.int(),
            "cap off by one": kccl.propagate_plain(maps, cap + 1)[0],
            "Gauss-Seidel steps": seidel.int()}


def k8_equal(torch, got, want) -> bool:
    return all(torch.equal(a, b) for a, b in zip(got, want))


def phase_k8(torch, np, kccl, recorded, gen_np) -> dict:
    """K8 against its plain version on the main path's recorded input and on
    stressed maps of the same shape; returns the kernel's numbers."""
    mask, cap, check_every = recorded
    out_k = kccl.propagate(mask, cap, check_every)
    out_p = kccl.propagate_plain(mask, cap, check_every)
    torch.cuda.synchronize()
    err = (out_k[0].long() - out_p[0].long()).abs().max().item()
    steps = out_p[2]
    log(f"K8 on {tuple(mask.shape)}, cap {cap}: labels max abs err {err} (tol 0); "
        f"converged {int(out_k[1].sum())} / {mask.shape[0]} maps (plain "
        f"{int(out_p[1].sum())}); steps per map {int(steps.min())}..{int(steps.max())}, "
        f"mean {steps.float().mean().item():.1f}")
    check(k8_equal(torch, out_k, out_p), "K8 disagrees with its plain version on the main path")

    maps = torch.from_numpy(k8_stress_maps(np, gen_np, mask.shape[-2:])).to(mask.device)
    for cap_s in (K8_TRUNCATED, maps[0].numel()):
        got = kccl.propagate(maps, cap_s)
        want = kccl.propagate_plain(maps, cap_s)
        log(f"K8 stressed, cap {cap_s}: labels, flags and steps equal: "
            f"{k8_equal(torch, got, want)}; converged {want[1].tolist()}; "
            f"steps {want[2].tolist()}")
        check(k8_equal(torch, got, want), f"K8 disagrees with its plain version on "
              f"stressed maps at cap {cap_s}")
        if cap_s == K8_TRUNCATED:
            truncated = want[0]
            check(not bool(want[1][4]), "the spiral must stay truncated")
    for what, labels in k8_faults(torch, kccl, maps, K8_TRUNCATED).items():
        misses = int((labels != truncated).sum())
        log(f"K8 planted fault '{what}': {misses} labels differ from the plain version")
        check(misses > 0, f"K8: the stressed check cannot see '{what}'")

    ms = card_ms(torch, lambda: kccl.propagate(mask, cap, check_every))
    plain_ms = card_ms(torch, lambda: kccl.propagate_plain(mask, cap, check_every),
                       iters=2, warmup=1)
    m, h, w = mask.shape
    clock_mhz = float(nvidia_smi("clocks.max.sm", units=False))
    int_rate = H100_SMS * INT32_LANES * clock_mhz * 1e6
    int_ops = float(steps.sum()) * h * w * 5
    nbytes = m * h * w * (4 + 4)
    t_ops, t_bytes = int_ops / int_rate * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    bound_ms, bound_by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    log(f"K8: {ms:.4f} ms (plain {plain_ms:.4f}, library None, bound {bound_ms:.4f} by "
        f"{bound_by}: {int_ops:.4g} int ops at {H100_SMS} SMs x {INT32_LANES} lanes x "
        f"{clock_mhz:.0f} MHz max SM clock = {int_rate / 1e12:.2f} Tops/s, {nbytes / 1e6:.1f} MB "
        f"at {PEAK_HBM_BYTES / 1e12} TB/s)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def enhance_modules():
    """The port's enhance path, as one namespace."""
    from types import SimpleNamespace

    from samcarriestheburden_torch import kernels
    from samcarriestheburden_torch.config import N_CLASSES, UNET_INPUT_HW
    from samcarriestheburden_torch.engine import refinement
    from samcarriestheburden_torch.engine.decoder_head import SamMaskDecoderHead
    from samcarriestheburden_torch.engine.prompts import extract_prompt_arrays
    from samcarriestheburden_torch.kernels import ccl as kccl
    from samcarriestheburden_torch.ops.ccl import remove_all_but_one_connected_component

    return SimpleNamespace(
        kernels=kernels, N_CLASSES=N_CLASSES, UNET_INPUT_HW=UNET_INPUT_HW,
        refinement=refinement, SegEnhance=refinement.SegEnhance,
        SamSegRefiner=refinement.SamSegRefiner, SamMaskDecoderHead=SamMaskDecoderHead,
        extract_prompt_arrays=extract_prompt_arrays, kccl=kccl,
        remove_all_but_one_connected_component=remove_all_but_one_connected_component)


def phase_enhance(torch, np, port, model, emb, embed_ips: float):
    """The enhance path at full width, counted; then its checks (card vs
    CPU, batch vs image by image, outputs), its throughput and profile.
    Returns the launches of the counted run and K8's recorded input."""
    dev = emb.device
    n_classes = port.N_CLASSES
    h, w = port.UNET_INPUT_HW
    stems = [f"image{i:02d}" for i in range(ENHANCE_N)]
    gen = torch.Generator(device=dev).manual_seed(3)
    feats, sizes = {}, {}
    for i, stem in enumerate(stems):
        if i < emb.shape[0]:            # the embeddings the encoder just made
            feats[stem] = emb[i:i + 1]
            sizes[stem] = (np.array(ORIGINAL_HW), np.array(INPUT_HW))
        else:
            feats[stem] = torch.randn((1, *emb.shape[1:]), generator=gen, device=dev)
            sizes[stem] = (np.array(ENH_ORIGINAL_HW), np.array(ENH_INPUT_HW))

    def make_enhance(head):
        return port.SegEnhance(port.SamSegRefiner(head, prompts2use=TWO_ROUNDS),
                               "highest_probability", "dilation", "square", 8)

    head = port.SamMaskDecoderHead(None, "vit_h", MemoryEmbeddings(model.img_size, feats, sizes),
                                   device=dev, params=model, cfg=model.cfg)
    enh = make_enhance(head)
    probs = torch.from_numpy(enhance_probs(np, np.random.default_rng(4), ENHANCE_N,
                                           n_classes, (h, w))).to(dev)

    # the path, counted, with K8's input recorded on the way
    recorded = []
    propagate = port.kccl.propagate

    def record(mask, num_iterations, check_every=16):
        recorded.append((mask, num_iterations, check_every))
        return propagate(mask, num_iterations, check_every)

    port.kccl.propagate = record
    try:
        port.kernels.reset_launches()
        t0 = time.perf_counter()
        refined, est = enh.enhance_batch(probs, stems)
        torch.cuda.synchronize()
        t_once = time.perf_counter() - t0
        launches = dict(port.kernels.LAUNCHES)
    finally:
        port.kccl.propagate = propagate
    log(f"enhance path launches: {launches} ({t_once * 1e3:.1f} ms for {ENHANCE_N} images, "
        f"first call)")
    for name, (path, _, _) in KERNELS.items():
        if path == "enhance":
            check(launches[name] > 0, f"{name} was not launched on the enhance path")
    check(len(recorded) == 1, "enhance_batch must label the whole stack in one K8 call")

    # outputs
    check(tuple(refined.shape) == (ENHANCE_N, n_classes, h, w) and refined.dtype == torch.bool,
          f"refined {tuple(refined.shape)} {refined.dtype}")
    check(tuple(est.shape) == (ENHANCE_N, n_classes) and est.dtype == torch.float32,
          f"est_dice {tuple(est.shape)} {est.dtype}")
    check(tuple(enh.last_preprocessed_seg.shape) == (ENHANCE_N, n_classes, h, w),
          f"last_preprocessed_seg {tuple(enh.last_preprocessed_seg.shape)}")
    kept = port.remove_all_but_one_connected_component(probs, "highest_probability", max(h, w))
    valid = torch.stack([port.extract_prompt_arrays(k.bool())["pos_valid"] for k in kept])
    check(torch.equal(torch.isnan(est), ~valid), "est_dice must be NaN exactly for seedless classes")
    check(bool(torch.isfinite(est[valid]).all()), "non-finite est_dice")
    log(f"enhance outputs: refined {tuple(refined.shape)} bool, {int(valid.sum())} of "
        f"{valid.numel()} classes seeded, {refined.float().mean().item():.4f} of pixels kept")

    # card vs CPU on image 0, and the batch vs image by image on the card
    calls = []
    post = port.refinement.postprocess_to_grid

    def record_post(*args, **kw):
        calls.append((args, kw))
        return post(*args, **kw)

    def logits(call):
        args, kw = call
        return post(*args, **dict(kw, threshold_only=False))

    cpu_sd = {k: v.cpu() for k, v in model.state_dict().items()
              if k.startswith(("prompt_encoder.", "mask_decoder."))}
    cpu_head = port.SamMaskDecoderHead(
        None, "vit_h", MemoryEmbeddings(model.img_size, {stems[0]: emb[:1].cpu()},
                                        {stems[0]: sizes[stems[0]]}),
        device="cpu", params=cpu_sd, cfg=model.cfg)
    enh_c = make_enhance(cpu_head)
    port.refinement.postprocess_to_grid = record_post
    try:
        out_g = enh.enhance(probs[0], stems[0])
        morph_g = enh.last_preprocessed_seg
        out_c = enh_c.enhance(probs[0].cpu(), stems[0])
        per_image = [enh.enhance(probs[i], stems[i]) for i in range(ENHANCE_N)]
    finally:
        port.refinement.postprocess_to_grid = post
    ccl_g = port.remove_all_but_one_connected_component(probs[0], "highest_probability", max(h, w))
    ccl_c = port.remove_all_but_one_connected_component(probs[0].cpu(), "highest_probability",
                                                        max(h, w))
    check(torch.equal(ccl_g.cpu(), ccl_c), "the CCL output differs between the card and the CPU")
    check(torch.equal(morph_g.cpu(), enh_c.last_preprocessed_seg),
          "the morphology differs between the card and the CPU")
    logit_g, logit_c = logits(calls[0]).cpu(), logits(calls[1])
    scale = max(1.0, logit_c.abs().max().item())
    tol = DECODE_RTOL * scale

    def compare(what, a, b, sure):
        miss = int(((a[0].cpu() != b[0].cpu()) & sure).sum())
        da, db = a[1].cpu(), b[1].cpu()
        same_nan = torch.equal(torch.isnan(da), torch.isnan(db))
        derr = (da - db).nan_to_num().abs().max().item()
        log(f"{what}: {miss} refined pixels differ where |logit| > {tol:.4g}; est_dice max "
            f"abs err {derr:.4g} (tol {DICE_TOL}), NaN in the same places: {same_nan}")
        check(miss == 0 and same_nan and derr <= DICE_TOL, f"{what}: disagreement")

    lerr = (logit_g - logit_c).abs().max().item()
    log(f"enhance card vs CPU, image 0: CCL output and morphology bit-identical; grid logits "
        f"max abs err {lerr:.4g} (tol {DECODE_RTOL} x {scale:.4g})")
    check(lerr <= tol, "enhance logits differ between the card and the CPU")
    compare("enhance card vs CPU, image 0", out_g, out_c, logit_c[:, 0].abs() > tol)
    for i, one in enumerate(per_image):
        sure = logits(calls[2 + i])[:, 0].abs().cpu() > tol
        compare(f"enhance_batch vs enhance, image {i}", (refined[i], est[i]), one, sure)

    # throughput and profile
    t_ms = card_ms(torch, lambda: enh.enhance_batch(probs, stems), iters=3, warmup=1)
    enhance_ips = ENHANCE_N / (t_ms / 1e3)
    log(f"enhance: {enhance_ips:.3f} images/s ({t_ms:.2f} ms per batch of {ENHANCE_N}, "
        f"fp32 decode)")
    log(f"embed + enhance: {1.0 / (1.0 / embed_ips + 1.0 / enhance_ips):.3f} images/s")
    phase_profile(torch, lambda: enh.enhance_batch(probs, stems), "enhance")
    return launches, recorded[0]


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as exc:
        raise SmokeError(f"missing dependency: {exc}") from exc
    check(torch.cuda.is_available(), "no CUDA device: the smoke test runs on the card only")
    try:
        from samcarriestheburden_torch import kernels
        from samcarriestheburden_torch.config import (N_CLASSES, sam_vit_h_config,
                                                      sam_vit_t_config)
        from samcarriestheburden_torch.engine.embeddings import (make_encode_batch,
                                                                 make_serving_encoder)
        from samcarriestheburden_torch.kernels import attention as attn_k
        from samcarriestheburden_torch.kernels import build
        from samcarriestheburden_torch.kernels import mlp as mlp_k
        from samcarriestheburden_torch.models.image_encoder import (KERNEL_OPS, PLAIN_OPS,
                                                                    EncoderOps,
                                                                    ImageEncoderViT)
        from samcarriestheburden_torch.models.sam import build_sam, two_round_decode
        port = enhance_modules()
    except ImportError as exc:
        raise SmokeError(f"the port is not importable here: {exc}") from exc

    # fp32 convolutions and products in full fp32 wherever fp32 is compared
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    identity = gpu_identity()
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 1. build -------------------------------------------------------------
    phase_build(build)

    # 2. the model and the inputs -------------------------------------------
    cfg = sam_vit_h_config()
    t0 = time.perf_counter()
    model = build_sam(cfg, device=dev, seed=0)
    encode, packed = make_serving_encoder(model, torch.bfloat16)
    torch.cuda.synchronize()
    log(f"ViT-H SAM with random weights (seed 0) on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=dev).manual_seed(1)
    size = model.img_size
    imgs = torch.randint(0, 256, (B, 3, size, size), generator=gen, device=dev,
                         dtype=torch.uint8)
    imgs[:, :, INPUT_HW[0]:] = 0
    imgs[:, :, :, INPUT_HW[1]:] = 0
    sizes = torch.tensor([INPUT_HW] * B, dtype=torch.int32, device=dev)
    n_points = 1 + (N_CLASSES - 1) + 1                    # pos + negs + pad
    coords = torch.rand((N_CLASSES, n_points, 2), generator=gen, device=dev) \
        * torch.tensor([INPUT_HW[1], INPUT_HW[0]], device=dev)
    labels = torch.cat([torch.ones(N_CLASSES, 1), torch.zeros(N_CLASSES, N_CLASSES - 1),
                        -torch.ones(N_CLASSES, 1)], 1).to(dev, torch.int64)
    encode(packed, imgs, sizes)                           # warm-up: libraries load
    torch.cuda.synchronize()

    # 3. the embed path, counted --------------------------------------------
    kernels.reset_launches()
    t0 = time.perf_counter()
    emb = encode(packed, imgs, sizes)
    torch.cuda.synchronize()
    t_embed = time.perf_counter() - t0
    t0 = time.perf_counter()
    results = []
    for i in range(B):
        low, iou = two_round_decode(model, emb[i:i + 1], coords, labels)
        masks = model.postprocess_masks(low, INPUT_HW, ORIGINAL_HW)
        results.append((low, iou, masks))
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    log(f"embed path launches: {launches}")
    for name, (path, _, _) in KERNELS.items():
        if path == "embed":
            check(launches[name] > 0, f"{name} was not launched on the embed path")

    g = cfg.prompt_encoder.image_embedding_size
    check(tuple(emb.shape) == (B, 256, *g) and emb.dtype == torch.float32,
          f"embedding shape {tuple(emb.shape)} {emb.dtype}")
    check(bool(torch.isfinite(emb).all()), "non-finite embedding")
    for low, iou, masks in results:
        check(tuple(low.shape) == (N_CLASSES, 1, 4 * g[0], 4 * g[1]), f"low-res {low.shape}")
        check(tuple(iou.shape) == (N_CLASSES, 1), f"iou {iou.shape}")
        check(tuple(masks.shape) == (N_CLASSES, 1, *ORIGINAL_HW), f"masks {masks.shape}")
        for t in (low, iou, masks):
            check(bool(torch.isfinite(t).all()), "non-finite decode output")

    # throughput, steady state
    t_enc_ms = card_ms(torch, lambda: encode(packed, imgs, sizes), iters=5, warmup=1)
    t_dec_ms = card_ms(torch, lambda: two_round_decode(model, emb[:1], coords, labels),
                       iters=5, warmup=1)
    log(f"main path once: embed {t_embed * 1e3:.1f} ms for {B} images, decode + "
        f"postprocess {t_decode * 1e3:.1f} ms for {B} x {N_CLASSES} masks")
    log(f"embed: {B / (t_enc_ms / 1e3):.3f} images/s ({t_enc_ms:.2f} ms per batch of {B}, bf16)")
    log(f"decode: {N_CLASSES / (t_dec_ms / 1e3):.1f} masks/s ({t_dec_ms:.2f} ms per "
        f"{N_CLASSES}-class two-round decode, fp32)")

    phase_profile(torch, lambda: encode(packed, imgs, sizes), "encoder")

    # 4. kernel path vs plain path, whole encoder ----------------------------
    emb_plain = make_encode_batch(model, torch.bfloat16, ops=PLAIN_OPS)(packed, imgs, sizes)
    diff = (emb - emb_plain).abs()
    enc_max, enc_mean = diff.max().item(), diff.mean().item()
    log(f"encoder kernel path vs plain path (bf16): max abs err {enc_max:.4g} (tol "
        f"{ENCODER_TOL_MAX}), mean {enc_mean:.4g} (tol {ENCODER_TOL_MEAN}); "
        f"max |plain| {emb_plain.abs().max().item():.4g}")
    check(enc_max <= ENCODER_TOL_MAX and enc_mean <= ENCODER_TOL_MEAN,
          "encoder kernel path disagrees with the plain path")
    del emb_plain

    # the same with the rel tables scaled up, and the rel bias dropped as the fault
    def with_tables(scale):
        return [dict(pk, tables=(pk["tables"].float() * scale).to(pk["tables"].dtype))
                for pk in packed]

    hot = with_tables(REL_STRESS)
    plain_hot = make_encode_batch(model, torch.bfloat16, ops=PLAIN_OPS)(hot, imgs, sizes)
    diff = (encode(hot, imgs, sizes) - plain_hot).abs()
    hot_max, hot_mean = diff.max().item(), diff.mean().item()
    fault = (make_encode_batch(model, torch.bfloat16, ops=PLAIN_OPS)(
        with_tables(0.0), imgs, sizes) - plain_hot).abs()
    log(f"encoder, rel tables x{REL_STRESS}: kernel path vs plain path max abs err "
        f"{hot_max:.4g}, mean {hot_mean:.4g}; rel bias dropped misses by max "
        f"{fault.max().item():.4g}, mean {fault.mean().item():.4g} (must be >= "
        f"{FAULT_MARGIN} x tol)")
    check(hot_max <= ENCODER_TOL_MAX and hot_mean <= ENCODER_TOL_MEAN,
          "encoder kernel path disagrees with the plain path at scaled rel tables")
    check(fault.max().item() >= FAULT_MARGIN * ENCODER_TOL_MAX
          and fault.mean().item() >= FAULT_MARGIN * ENCODER_TOL_MEAN,
          "the encoder check cannot see a dropped rel bias")
    del hot, plain_hot, diff, fault

    # decode on the card vs on the CPU, fp32
    cpu_model = build_sam(cfg, device="cpu", state_dict={
        k: v.cpu() for k, v in model.state_dict().items()})
    low_c, iou_c = two_round_decode(cpu_model, emb[:1].cpu(), coords.cpu(), labels.cpu())
    low_g, iou_g = results[0][0].cpu(), results[0][1].cpu()
    scale = max(1.0, low_c.abs().max().item())
    dec_err = max((low_g - low_c).abs().max().item(), (iou_g - iou_c).abs().max().item())
    log(f"decode card vs CPU (fp32): max abs err {dec_err:.4g} (tol {DECODE_RTOL} x {scale:.4g})")
    check(dec_err <= DECODE_RTOL * scale, "decode on the card disagrees with the CPU")
    del cpu_model

    # 5. the enhance path, counted, and its checks ----------------------------
    launches_enh, k8_input = phase_enhance(torch, np, port, model, emb,
                                           B / (t_enc_ms / 1e3))

    # 6. every kernel vs its plain version at its path's shapes --------------
    recorded = {}

    def recorder(name, fn):
        def call(*args, **kw):
            recorded.setdefault(name, (args, kw))
            return fn(*args, **kw)
        return call

    rec_ops = EncoderOps(*(recorder(n, f) for n, f in zip(("K1", "K3", "K5", "K7"), KERNEL_OPS)))
    make_encode_batch(model, torch.bfloat16, ops=rec_ops)(packed, imgs, sizes)
    pairs = {"K1": (mlp_k.ln_masked_linear, mlp_k.ln_masked_linear_plain),
             "K3": (mlp_k.ln_mlp_residual, mlp_k.ln_mlp_residual_plain),
             "K5": (attn_k.rel_attention_window, attn_k.rel_attention_window_plain),
             "K7": (attn_k.rel_attention_global, attn_k.rel_attention_global_plain)}
    rows = []
    stress_gen = torch.Generator(device=dev).manual_seed(2)
    for name, (kern, plain) in pairs.items():
        args, kw = recorded[name]
        out_k = kern(*args, **kw)
        out_p = plain(*args, **kw)
        torch.cuda.synchronize()
        err = (out_k.float() - out_p.float()).abs().max().item()
        ref = out_p.float().abs().max().item()
        ms = card_ms(torch, lambda: kern(*args, **kw))
        plain_ms = card_ms(torch, lambda: plain(*args, **kw), iters=3, warmup=1)
        library_ms = None
        if name in ("K5", "K7"):
            kh, kwid = (kw["ws"], kw["ws"]) if name == "K5" else (kw["kh"], kw["kw"])
            q, k, v, bias = sdpa_inputs(torch, args[0], args[1], kw["heads"], kw["hd"],
                                        kh, kwid)
            sdpa = torch.nn.functional.scaled_dot_product_attention
            library_ms = card_ms(torch, lambda: sdpa(q, k, v, attn_mask=bias))
            del q, k, v, bias
        flops, nbytes = kernel_work(name, args, kw)
        bound_ms, bound_by = bound(flops, nbytes)
        shape = tuple(args[0].shape)
        log(f"{name} on {shape}: max abs err {err:.4g} vs max |plain| {ref:.4g} "
            f"(tol {KERNEL_TOL[name]} x max |plain|), {ms:.4f} ms (plain {plain_ms:.4f}, library "
            f"{library_ms}, bound {bound_ms:.4f} by {bound_by}); "
            f"{flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s")
        check(err <= KERNEL_TOL[name] * max(ref, 1e-6), f"{name} disagrees with its plain version")
        phase_stress(torch, name, kern, plain, args, kw, stress_gen)
        rows.append({"name": name, "route": "cuda", "source": KERNELS[name][1],
                     "replaces": KERNELS[name][2], "launches": launches[name],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms})
    del recorded
    k8 = phase_k8(torch, np, port.kccl, k8_input, np.random.default_rng(5))
    rows.append({"name": "K8", "route": "cuda", "source": KERNELS["K8"][1],
                 "replaces": KERNELS["K8"][2], "launches": launches_enh["K8"], **k8})

    # 7. the tiny config through the kernels vs the reference golden --------
    phase_golden(torch, np, sam_vit_t_config(), ImageEncoderViT, KERNEL_OPS)

    log(json.dumps({"kernels": rows}))
    log(identity)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
