"""Benchmark of the port: per-image SAM embed + 17-class refine throughput on
one card (the JAX package's ``bench.py``, through the port's entry points).

    python -m samcarriestheburden_torch.bench [--model vit_h] [--batch 32]
        [--quantize int8|none] [--enhance_batch 16] [--iters 3]
        [--attention auto|pallas|xla] [--unroll_blocks] [--smoke] [--device cuda]

Prints ONE JSON line with ``bench.py``'s keys: the metric
``sam_<model>_embed_refine_images_per_sec_per_chip`` (``..._cpu_smoke`` with
``--device cpu``), its value 1 / (1 / embed images/s + enhance seconds per
image), and per-leg figures, flop counts and MFU under ``detail``.

The legs and shapes are ``bench.py``'s, with zero weights by shape:

* embed: ``make_serving_encoder(model, dtype, quantize=...)`` on (batch, 3,
  1024, 1024) uint8 images of input size 1024 x 716 (bf16; int8 weights and
  activations by default; the compact layout);
* refine decode: one 17-class two-round decode of one embedding, round 1 with
  the image side shared, in the bench's dtype;
* enhance: per batch of ``--enhance_batch`` images (distinct blobs and
  embeddings per slot) the CCL selection over the whole stack (K8), the
  square-8 dilation, and one batched two-round refinement with the decoder
  head in the bench's dtype, landed on the 384 x 224 U-Net grid;
* train step: one ``UNetTrainer.train_step`` of the full-width U-Net
  (``UNetConfig()``, 17 classes) on a batch of 16 grayscale 384 x 224 images
  gathered on the device, normalised, warped (``data_aug`` 0.03), bf16
  forward, fp32 loss and AdamW (``bench.py:416-438``);
* AMG: one batch of 64 grid points (8 with ``--smoke``) on the refine leg's
  shared features: prompt encoding, the three-mask decode with the image
  side shared, ``postprocess_masks`` to the encoder's square, the stability
  score and the mask areas, in fp32 (``bench.py:440-461``): the points/s the
  card can score, without the host's filtering and RLE.

The embed and decode legs are timed with CUDA events over ``iters x 8``
calls after 2 warm-ups, the train step over ``iters x 4``, the AMG batch
over ``iters x 2``; the enhance leg,
which the host bounds, with the host clock around calls that end in
``synchronize()``.  MFU uses the analytic encoder count
(:func:`analytic_encoder_flops`), ``FlopCounterMode``'s count of the decode
and of the AMG batch, and the analytic U-Net count (:func:`analytic_unet_flops`), over the H100's
dense peaks; on another card the peaks are null.  ``--smoke`` runs the tiny
vit_t config in fp32 at batch 1 on a 48 x 32 grid, and the train step in
fp32 at batch 2 on that grid.  ``--attention pallas`` runs the unfused formulation through K9,
``xla`` the same with the plain attention; neither has an int8 mode.  No TPU
figure is reported: ``vs_baseline`` and the CPU anchor are null.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from samcarriestheburden_torch import config
from samcarriestheburden_torch.data.h5io import MemoryEmbeddings
from samcarriestheburden_torch.device import resolve_device
from samcarriestheburden_torch.engine.decoder_head import CONFIGS, SamMaskDecoderHead
from samcarriestheburden_torch.engine.embeddings import make_serving_encoder
from samcarriestheburden_torch.engine.refinement import SamSegRefiner, SegEnhance
from samcarriestheburden_torch.kernels.cost_probe import cost_probe
from samcarriestheburden_torch.models.image_encoder import (attention_apply,
                                                            attention_apply_kernel,
                                                            compact_window_groups)
from samcarriestheburden_torch.models.sam import SamModel, build_sam
from samcarriestheburden_torch.ops.ccl import remove_all_but_one_connected_component
from samcarriestheburden_torch.ops.mask_ops import calculate_stability_score
from samcarriestheburden_torch.train.augment import random_theta
from samcarriestheburden_torch.train.loop import UNetTrainer

#: dense peaks (TFLOP/s bf16, TOP/s int8) by card name: NVIDIA's H100 SXM data sheet
PEAKS = {"H100": (989, 1979)}
A100_BF16_TFLOPS = 312      # the hardware of the reference's cost estimate (SAM paper)
DECLARED_FLOPS = 1234567    # the cost K13 declares (bench.py:104)
INNER = 8
TRAIN_INNER = 4             # bench.py's train-step timing (bench.py:437)
AMG_INNER = 2               # the AMG leg's (bench.py:459-460)
TWO_ROUNDS = [["box"], ["pos_points", "neg_points"]]


def analytic_encoder_flops(cfg, compact: bool) -> float:
    """Analytic 2*m*n*k FLOPs of ONE image through the ViT encoder (JAX
    ``bench.analytic_encoder_flops``): matmul and conv terms only; the
    windowed layers on the padded 70 x 70 grid (flat layout) or on the
    compact layout's carried rows (``compact``)."""
    ie = cfg.image_encoder
    d, depth, ws = ie.embed_dim, ie.depth, ie.window_size
    g = ie.img_size // 16               # token grid side
    t = g * g                           # real tokens
    n_glob = len(ie.global_attn_indexes)
    n_win = depth - n_glob
    if compact:
        rows = sum(gr["nh"] * gr["nw"] * gr["np"] for gr in compact_window_groups(g, g, ws))
    else:
        rows = (g + (-g % ws)) ** 2     # zero-padded window grid
    proj_mlp = (6 + 2 + 16) * d * d     # qkv, projection, MLP per token row
    att_win = (4 * (ws * ws) + 4 * ws) * d
    att_glob = (4 * t + 4 * g) * d
    flops = n_win * (proj_mlp + att_win) * rows + n_glob * (proj_mlp + att_glob) * t
    flops += 2 * t * (3 * 16 * 16) * d                                    # patch embed
    flops += 2 * t * d * ie.out_chans + 2 * t * 9 * ie.out_chans * ie.out_chans  # neck
    return float(flops)


def analytic_unet_flops(cfg: config.UNetConfig, hw) -> Tuple[float, float]:
    """(forward, forward + backward) FLOPs of ONE image of ``hw`` through the
    U-Net: 2 per multiply-add of every convolution and transposed
    convolution (instance norms, activations, pooling and the loss not
    counted); the backward twice the forward (the input's and the weights'
    gradients), except the first convolution's input gradient, which
    nothing needs.  ``FlopCounterMode`` counts the same."""
    bc, factor = cfg.base_channels, 2 if cfg.bilinear else 1
    h, w = hw
    sizes = [(h, w)]
    for _ in range(4):
        sizes.append((sizes[-1][0] // 2, sizes[-1][1] // 2))

    def conv(hw_out, cin, cout, k):
        return 2.0 * hw_out[0] * hw_out[1] * cin * cout * k * k

    def double(hw_out, cin, cout, mid=None):
        mid = mid or cout
        return conv(hw_out, cin, mid, 3) + conv(hw_out, mid, cout, 3)

    first = conv(sizes[0], cfg.n_channels, bc, 3)
    fwd = double(sizes[0], cfg.n_channels, bc)
    chans = [bc, bc * 2, bc * 4, bc * 8, bc * 16 // factor]
    for i in range(1, 5):
        fwd += double(sizes[i], chans[i - 1], chans[i])
    ups = [(bc * 16, bc * 8 // factor), (bc * 8, bc * 4 // factor),
           (bc * 4, bc * 2 // factor), (bc * 2, cfg.n_last_channel)]
    for i, (cin, cout) in enumerate(ups):
        skip = sizes[3 - i]
        if cfg.bilinear:
            fwd += double(skip, cin, cout, cin // 2)
        else:
            below = sizes[4 - i]
            fwd += conv((2 * below[0], 2 * below[1]), cin, cin // 2, 1)   # k=2, stride 2
            fwd += double(skip, cin, cout)
    fwd += conv(sizes[0], cfg.n_last_channel, cfg.n_classes, 1)
    return fwd, 3 * fwd - first


def flops_convention_check(device: torch.device) -> Dict[str, Optional[object]]:
    """What ``FlopCounterMode`` counts on this side: a known bf16 matmul must
    count 2*m*n*k, and K13's declared cost must surface for its launch (JAX
    ``flops_convention_check``; eager PyTorch has no scan to count once)."""
    m, k, n = 128, 256, 512
    a = torch.zeros((m, k), dtype=torch.bfloat16, device=device)
    b = torch.zeros((k, n), dtype=torch.bfloat16, device=device)
    with FlopCounterMode(display=False) as fc:
        a @ b
    ratio = fc.get_total_flops() / (2 * m * n * k)
    x = torch.zeros((128, 128), dtype=torch.bfloat16, device=device)
    with FlopCounterMode(display=False) as fc:
        out = cost_probe(x, DECLARED_FLOPS)
    counted = fc.get_total_flops() == DECLARED_FLOPS and torch.equal(out, x * 2.0)
    return {"matmul_2mnk_ratio": ratio, "custom_kernel_cost_counted": bool(counted),
            "scan_body_counted_once": None, "ok": ratio == 1.0 and bool(counted)}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_device(fn, device: torch.device, iters: int, warmup: int = 2,
                inner: int = INNER) -> float:
    """Seconds per call of ``fn``: CUDA events around ``iters * inner`` calls
    after ``warmup``, on the card; the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    _sync(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters * inner):
            fn()
        return (time.perf_counter() - t0) / (iters * inner)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters * inner):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / 1e3 / (iters * inner)


def time_host(fn, device: torch.device, iters: int, warmup: int = 2,
              inner: int = INNER) -> float:
    """Seconds per call of ``fn`` on the host clock, each timed run ending in
    ``synchronize()``."""
    for _ in range(warmup):
        fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        for _ in range(inner):
            fn()
        _sync(device)
    return (time.perf_counter() - t0) / (iters * inner)


def zero_sam(cfg, device: torch.device) -> SamModel:
    """A SamModel with every weight zero (``bench.py``'s shape-only init),
    for inference only."""
    with torch.device("meta"):
        shapes = SamModel(cfg).state_dict()
    return build_sam(cfg, device=device, state_dict={
        k: torch.zeros(v.shape, dtype=v.dtype, device=device)
        for k, v in shapes.items()}).requires_grad_(False)


def enhance_probs(rng, n: int, hw) -> np.ndarray:
    """(n, 17, H, W) U-Net-like probabilities: one elongated soft blob per
    class and slot, distinct per slot (``bench.py:393-400``)."""
    yy, xx = np.mgrid[: hw[0], : hw[1]]
    prob = np.zeros((n, config.N_CLASSES) + tuple(hw), np.float32)
    for i in range(n):
        for c in range(config.N_CLASSES):
            cy, cx = rng.uniform(0.2, 0.8) * hw[0], rng.uniform(0.2, 0.8) * hw[1]
            ry, rx = rng.uniform(0.1, 0.3) * hw[0], rng.uniform(0.05, 0.2) * hw[1]
            d2 = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2
            prob[i, c] = np.clip(1.2 - d2, 0, 1)
    return prob


def nvidia_smi(query: str) -> Optional[str]:
    """One field of ``nvidia-smi --query-gpu`` for card 0, or None without it."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def parse_args(argv: Optional[List[str]]):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--smoke", action="store_true", help="tiny vit_t config, fp32, batch 1")
    p.add_argument("--model", default="vit_h", choices=["vit_b", "vit_l", "vit_h"])
    p.add_argument("--batch", type=int, default=32, help="encoder batch size")
    p.add_argument("--attention", choices=["xla", "pallas", "auto"], default="auto",
                   help="auto: the serving encoder; pallas: the unfused formulation "
                        "through K9; xla: the same with the plain attention")
    p.add_argument("--quantize", choices=["int8", "none"], default="int8",
                   help="int8 encoder weights and activations (the serving default) or bf16")
    p.add_argument("--enhance_batch", type=int, default=16,
                   help="images per refinement dispatch")
    p.add_argument("--unroll_blocks", action=argparse.BooleanOptionalAction, default=None,
                   help="accepted and recorded: eager PyTorch has no scan to unroll")
    p.add_argument("--iters", type=int, default=3, help="timing repeats")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    return p.parse_args(argv)


@torch.no_grad()
def main(argv: Optional[List[str]] = None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    model_name = "vit_t" if args.smoke else args.model
    batch = 1 if args.smoke else args.batch
    dtype = torch.float32 if args.smoke else torch.bfloat16
    quantize = None if args.smoke or args.quantize == "none" else args.quantize
    eb = 1 if args.smoke else args.enhance_batch
    seg_hw = (48, 32) if args.smoke else config.UNET_INPUT_HW
    if args.attention != "auto" and quantize:
        raise ValueError("--attention pallas|xla runs the unfused formulation, which has "
                         "no int8 mode: pass --quantize none")
    cfg = CONFIGS[model_name]()
    model = zero_sam(cfg, device)
    size = model.img_size
    grid = cfg.prompt_encoder.image_embedding_size[0]
    td = cfg.mask_decoder.transformer_dim
    rng = np.random.default_rng(0)

    # ---- encoder throughput ------------------------------------------------
    variant = {}
    if args.attention != "auto":
        variant = dict(attention_impl=attention_apply_kernel if args.attention == "pallas"
                       else attention_apply, fused_qkv=False)
    compact = args.attention == "auto"          # the fused path serves the compact layout
    encode, packed = make_serving_encoder(model, dtype, quantize=quantize,
                                          unroll_blocks=args.unroll_blocks, **variant)
    imgs = torch.from_numpy(rng.integers(0, 255, (batch, 3, size, size), dtype=np.uint8)).to(device)
    sizes = torch.tensor([[size, int(size * 0.7)]] * batch, dtype=torch.int32, device=device)
    t_encode = time_device(lambda: encode(packed, imgs, sizes), device, args.iters)
    embed_per_sec = batch / t_encode
    del encode, packed, imgs

    # ---- refinement decode: 17 classes x 2 rounds ----------------------------
    pe, md = model.prompt_encoder, model.mask_decoder
    n_points = 1 + (config.N_CLASSES - 1) + 1          # pos + negs + pad
    features = torch.from_numpy(rng.standard_normal((1, td, grid, grid), dtype=np.float32)
                                ).to(device)
    coords = torch.from_numpy(rng.uniform(0, size, (config.N_CLASSES, n_points, 2))
                              .astype(np.float32)).to(device)
    labels = torch.cat([torch.ones(config.N_CLASSES, 1), torch.zeros(config.N_CLASSES,
                                                                     config.N_CLASSES - 1),
                        -torch.ones(config.N_CLASSES, 1)], 1).to(device, torch.int32)

    def refine():
        sparse = pe.embed_unified_points(coords, labels)
        image_pe = pe.get_dense_pe()
        low1, _ = md(features, image_pe, sparse, pe.no_mask_dense(1), False,
                     image_shared=True, dtype=dtype)
        return md(features, image_pe, sparse, pe.embed_masks(low1), False, dtype=dtype)

    t_refine = time_device(refine, device, args.iters)
    masks_per_sec = config.N_CLASSES / t_refine
    with FlopCounterMode(display=False) as fc:
        refine()
    f_ref = float(fc.get_total_flops())

    # ---- the enhance leg: CCL + dilation + prompts + 2-round decode + grid ----
    original_size = np.asarray([seg_hw[0] * 6, seg_hw[1] * 6])
    input_size = np.asarray([size, int(size * seg_hw[1] / seg_hw[0])])
    prob = torch.from_numpy(enhance_probs(rng, eb, seg_hw)).to(device)
    feats = torch.from_numpy(rng.standard_normal((eb, td, grid, grid), dtype=np.float32)
                             ).to(device)
    store = MemoryEmbeddings(size, {"bench": feats[:1]}, {"bench": (original_size, input_size)},
                             checkpoint="bench.npz")
    head = SamMaskDecoderHead(None, model_name, store, device=device, params=model, cfg=cfg,
                              compute_dtype=dtype)
    refiner = SamSegRefiner(head, None, TWO_ROUNDS)
    enh = SegEnhance(refiner, "highest_probability", "dilation", "square", 8)
    inps = torch.as_tensor(np.tile(input_size, (eb, 1)), device=device)
    origs = torch.as_tensor(np.tile(original_size, (eb, 1)), device=device)
    num_iter = max(seg_hw)

    def enhance_full():
        segs = remove_all_but_one_connected_component(prob, "highest_probability", num_iter)
        morphed = enh._morph(segs)                      # the reference's side buffer
        refined, est = refiner._refine_batched(segs.bool(), feats, inps, origs, tuple(seg_hw))
        return refined, est, morphed

    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    t_enhance = time_host(enhance_full, device, args.iters) / eb
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9 if on_card else None

    per_image = 1.0 / embed_per_sec + t_enhance
    value = 1.0 / per_image

    # ---- the AMG leg (bench.py:440-461): one batch of grid points on shared
    # features, prompt encoding, decode, postprocess, stability and areas on
    # the card; the host's RLE and filtering are not in it ------------------------
    ppb = 8 if args.smoke else 64
    amg_pts = torch.from_numpy(rng.uniform(0, size, (ppb, 1, 2)).astype(np.float32)).to(device)
    amg_labels = torch.ones((ppb, 1), dtype=torch.int32, device=device)

    def amg_batch():
        sparse, dense = model.encode_prompts(points=(amg_pts, amg_labels))
        low_res, iou = model.decode_masks(features, model.get_dense_pe(), sparse, dense, True,
                                          image_shared=True)
        masks = model.postprocess_masks(low_res, (size, size), (size, size))
        stab = calculate_stability_score(masks, 0.0, 1.0)
        return iou, stab, (masks > 0).sum(dim=(-2, -1))

    t_amg = time_device(amg_batch, device, args.iters, inner=AMG_INNER)
    with FlopCounterMode(display=False) as fc:
        amg_batch()
    f_amg = float(fc.get_total_flops())

    # ---- the U-Net training step (bench.py:416-438): batch 16, 384 x 224,
    # 17 classes, data_aug 0.03, bf16 forward ----------------------------------
    tb = 2 if args.smoke else 16
    thw = (48, 32) if args.smoke else config.UNET_INPUT_HW
    tcfg = config.TrainConfig(batch_size=tb, data_aug=0.03,
                              compute_dtype="float32" if args.smoke else "bfloat16")
    ucfg = config.UNetConfig(n_last_channel=tcfg.n_last_channel)
    trainer = UNetTrainer(ucfg, tcfg, device=device)
    xd, yd = trainer.device_data(rng.standard_normal((tb, 1) + thw, dtype=np.float32),
                                 rng.integers(0, 2, (tb, config.N_CLASSES) + thw, dtype=np.uint8))
    t_idx = torch.arange(tb, device=device)
    theta = random_theta(torch.Generator().manual_seed(0), tb, tcfg.data_aug).to(device)
    t_train = time_device(lambda: trainer.train_step(xd, yd, t_idx, theta, tcfg.lr), device,
                          args.iters, inner=TRAIN_INNER)
    f_train = tb * analytic_unet_flops(ucfg, thw)[1]
    del trainer, xd, yd

    # ---- flops and MFU -----------------------------------------------------------
    kind = torch.cuda.get_device_name(device) if on_card else None
    peaks = next((v for k, v in PEAKS.items() if kind and k in kind), None)
    f_enc = batch * analytic_encoder_flops(cfg, compact)

    def mfu(flops, t, peak):
        return None if peak is None or t <= 0 else round(flops / t / (peak * 1e12), 4)

    pk = peaks[0] if peaks else None
    power = nvidia_smi("power.limit") if on_card else None
    result = {
        "metric": f"sam_{model_name}_embed_refine_images_per_sec_per_chip"
                  + ("" if on_card else "_cpu_smoke"),
        "value": round(value, 4),
        "unit": "images/sec",
        "vs_baseline": None,
        "detail": {
            "vs_baseline_est": None,
            "vs_baseline_measured_cpu": None,
            "cpu_anchor": None,
            "embed_images_per_sec": round(embed_per_sec, 4),
            "refined_masks_per_sec": round(masks_per_sec, 2),
            "full_enhance_images_per_sec": round(1.0 / t_enhance, 2),
            "train_ms_per_step": round(1e3 * t_train, 2),
            "train_batch_hw": [tb, list(thw)],
            "amg_device_points_per_sec": round(ppb / t_amg, 1),
            "amg_points_per_batch": ppb,
            "enhance_batch": eb,
            "seg_grid_hw": list(seg_hw),
            "encoder_batch": batch,
            "attention": args.attention,
            "encoder_dtype": str(dtype).replace("torch.", ""),
            "decoder_dtype": str(dtype).replace("torch.", ""),
            "quantize": quantize,
            "compact_windows": compact,
            "unroll_blocks": args.unroll_blocks,
            "platform": "gpu" if on_card else "cpu",
            "device_kind": nvidia_smi("name") if on_card else None,
            "power_limit_w": float(power) if power else None,
            "peak_tflops": {"bf16": peaks[0], "int8": peaks[1]} if peaks else None,
            "enhance_max_memory_allocated_gb": None if peak_gb is None else round(peak_gb, 3),
            "tflops_per_leg": {
                "encoder_per_img_analytic": round(f_enc / batch / 1e12, 3),
                "encoder_per_img_xla": None,
                "refine_17class_2round": round(f_ref / 1e12, 4),
                "train_step": round(f_train / 1e12, 4),
                "amg_points_batch": round(f_amg / 1e12, 4),
            },
            "mfu": {
                "encoder": mfu(f_enc, t_encode, pk),
                "encoder_vs_int8_peak": mfu(f_enc, t_encode, peaks[1] if peaks and quantize
                                            else None),
                "refine_decode": mfu(f_ref, t_refine, pk),
                "train_step": mfu(f_train, t_train, pk),
                "amg_batch": mfu(f_amg, t_amg, pk),
            },
            "flops_convention": flops_convention_check(device),
            "reference_implied_a100_mfu": round(
                analytic_encoder_flops(cfg, compact=False) / 0.30 / (A100_BF16_TFLOPS * 1e12), 4),
        },
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
