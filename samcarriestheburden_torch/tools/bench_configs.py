"""``BASELINE.json`` configs 3-5 through the port (JAX ``tools/bench_configs.py``).

    python -m samcarriestheburden_torch.tools.bench_configs [--smoke] [--cpu]
        [--model vit_h] [--n_imgs 32] [--only refine|train|amg] [--pps 32]

* config 3, the refinement sweep: ``SegEnhance.enhance`` (CCL, dilation,
  prompts, the two-round decode in fp32, postprocess) image by image as
  ``cli.save_refined_segmentations`` drives it, each image's features read
  from the store (held on the host in a ``MemoryEmbeddings``; from an h5
  file as well where ``h5py`` imports: ``images_per_sec_h5``) and its masks
  fetched and written to a ``MemoryMasks``; then ``enhance_batch`` over
  chunks of 8 images, the bit-packed masks fetched one chunk late.
* config 4, U-Net training on pseudo labels (batch 16, 384 x 224, 17
  classes, 43 samples, 48 a epoch): ms a step with and without
  augmentation (``UNetTrainer.train_epoch``, host clock; the first epoch
  warms up).
* config 5, ``SamAutomaticMaskGenerator`` on one 1024 x 716 image at 32 x 32
  points in batches of 64, ``uncompressed_rle`` output: s an image after a
  first image.

Prints one JSON object with the JAX tool's keys.  Weights are zeros by
shape, as the JAX tool's (``bench.py:zero_sam``).  ``--smoke`` shrinks
everything (vit_t with SAM's decoder widths, 4 images of 48 x 32, batch 4, 8
points a side);
``--cpu`` runs on the CPU, else the card (raises without one).
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from samcarriestheburden_torch.config import N_CLASSES, UNET_INPUT_HW
from samcarriestheburden_torch.device import resolve_device

CONFIGS = ("vit_t", "vit_b", "vit_l", "vit_h")


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _zero_sam(model_name: str, dev, smoke: bool = False):
    from samcarriestheburden_torch import config
    from samcarriestheburden_torch.bench import zero_sam

    if smoke:    # vit_t with SAM's decoder widths
        return zero_sam(config.sam_vit_t_config(sam_decoder=True), dev)
    return zero_sam(getattr(config, f"sam_{model_name}_config")(), dev)


def _enhancer(model, store, dev):
    from samcarriestheburden_torch.engine.decoder_head import SamMaskDecoderHead
    from samcarriestheburden_torch.engine.refinement import SamSegRefiner, SegEnhance

    head = SamMaskDecoderHead(None, "bench", store, device=dev, params=model, cfg=model.cfg)
    return SegEnhance(SamSegRefiner(head, prompts2use=[["box"], ["pos_points", "neg_points"]]),
                      "highest_probability", "dilation", "square", 8)


def _sweep(enh, segs, stems, writer) -> float:
    """Seconds for the per-image sweep (after one warm-up image)."""
    enh.enhance(segs[0], stems[0])
    t0 = time.perf_counter()
    for stem, prob in zip(stems, segs):
        refined, est = enh.enhance(prob, stem)
        writer.write(stem, refined.cpu().numpy().astype(np.uint8), est.cpu().numpy())
    return time.perf_counter() - t0


def bench_refine_sweep(model, n_imgs: int, seg_hw, dev) -> dict:
    from samcarriestheburden_torch.data.h5io import MemoryEmbeddings, MemoryMasks
    from samcarriestheburden_torch.ops.mask_ops import packbits_device
    from samcarriestheburden_torch.bench import enhance_probs

    cfg = model.cfg
    size = model.img_size
    grid = cfg.prompt_encoder.image_embedding_size
    rng = np.random.default_rng(0)
    stems = [f"img{i:04d}" for i in range(n_imgs)]
    feats = {s: rng.standard_normal((1, cfg.image_encoder.out_chans, *grid)).astype(np.float32)
             for s in stems}
    sizes = (np.asarray([seg_hw[0] * 6, seg_hw[1] * 6]),
             np.asarray([size, int(size * seg_hw[1] / seg_hw[0])]))
    segs = torch.from_numpy(enhance_probs(np.random.default_rng(0), n_imgs, seg_hw)).to(dev)

    enh = _enhancer(model, MemoryEmbeddings(size, feats, dict.fromkeys(stems, sizes)), dev)
    out = {"images_per_sec": n_imgs / _sweep(enh, segs, stems, MemoryMasks())}

    bs = min(8, n_imgs)
    packbits_device(enh.enhance_batch(segs[:bs], stems[:bs])[0]).cpu()
    t0 = time.perf_counter()
    pending = None
    for i in range(0, n_imgs, bs):
        refined, _ = enh.enhance_batch(segs[i:i + bs], stems[i:i + bs])
        if pending is not None:
            pending.cpu()
        pending = packbits_device(refined)
    pending.cpu()
    out["images_per_sec_batched"] = n_imgs / (time.perf_counter() - t0)
    out.update(img_batch=bs, n_images=n_imgs, seg_hw=list(seg_hw))

    try:
        import h5py  # noqa: F401  (the h5 leg needs it; the card's machine has none)
    except ImportError:
        return out
    from samcarriestheburden_torch.data.h5io import EmbeddingWriter

    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "emb.h5")
        with EmbeddingWriter(path, "bench", size) as wr:
            for s in stems:
                wr.write(s, feats[s], *sizes, compression=None)
        enh = _enhancer(model, path, dev)
        out["images_per_sec_h5"] = n_imgs / _sweep(enh, segs, stems, MemoryMasks())
    return out


def bench_training(smoke: bool, dev) -> dict:
    from samcarriestheburden_torch.config import TrainConfig, UNetConfig
    from samcarriestheburden_torch.train.loop import UNetTrainer

    hw = (48, 32) if smoke else UNET_INPUT_HW
    batch = 4 if smoke else 16
    n = 43                                    # reference num_train_samples for f_phi
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, 1, *hw)).astype(np.float32)
    y = (rng.random((n, N_CLASSES, *hw)) > 0.9).astype(np.uint8)
    out = {}
    for aug in (0.0, 0.5):
        trainer = UNetTrainer(UNetConfig(n_channels=1, n_classes=N_CLASSES),
                              TrainConfig(batch_size=batch, data_aug=aug,
                                          data_sample_per_epoch=48, epochs=1), device=dev)
        trainer.train_epoch(x, y, 0)          # warm-up
        _sync(dev)
        iters = 2 if smoke else 3
        t0 = time.perf_counter()
        for e in range(1, 1 + iters):
            trainer.train_epoch(x, y, e)
        _sync(dev)
        steps = iters * (48 // batch)
        out[f"ms_per_step_aug{aug:g}"] = 1e3 * (time.perf_counter() - t0) / steps
    return out


def bench_amg(model, smoke: bool, dev, pps: int = 32) -> dict:
    from samcarriestheburden_torch.engine.amg import SamAutomaticMaskGenerator

    pps = 8 if smoke else pps
    amg = SamAutomaticMaskGenerator(model, points_per_side=pps, pred_iou_thresh=-1e9,
                                    stability_score_thresh=0.0, output_mode="uncompressed_rle")
    side = 512 if smoke else 1024
    img = np.random.default_rng(0).integers(0, 255, (side, int(side * 0.7), 3), dtype=np.uint8)
    amg.generate(img)                         # warm-up
    iters = 1 if smoke else 3
    t0 = time.perf_counter()
    for _ in range(iters):
        amg.generate(img)
    _sync(dev)
    return {"sec_per_image": (time.perf_counter() - t0) / iters, "points_per_side": pps}


@torch.no_grad()
def bench_configs(device=None, *, smoke: bool = False, model_name: str = "vit_h",
                  n_imgs: int = 32, only: Optional[str] = None, pps: int = 32) -> dict:
    """The JSON object of the module docstring."""
    dev = resolve_device(device)
    model_name = "vit_t" if smoke else model_name
    seg_hw = (48, 32) if smoke else UNET_INPUT_HW
    n_imgs = 4 if smoke else n_imgs
    out = {"platform": "gpu" if dev.type == "cuda" else dev.type,
           "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "model": model_name}
    model = _zero_sam(model_name, dev, smoke) if only in (None, "refine", "amg") else None
    if only in (None, "refine"):
        out["config3_refinement_sweep"] = bench_refine_sweep(model, n_imgs, seg_hw, dev)
    if only in (None, "train"):
        with torch.enable_grad():
            out["config4_unet_training"] = bench_training(smoke, dev)
    if only in (None, "amg"):
        out["config5_amg"] = bench_amg(model, smoke, dev, pps)
    return out


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--cpu", action="store_true", help="run on the CPU; default: the card")
    p.add_argument("--model", default="vit_h", choices=CONFIGS)
    p.add_argument("--n_imgs", type=int, default=32, help="refinement sweep size")
    p.add_argument("--only", choices=["refine", "train", "amg"], default=None)
    p.add_argument("--pps", type=int, default=32, help="AMG points per side (reference default 32)")
    args = p.parse_args(argv)
    out = bench_configs("cpu" if args.cpu else None, smoke=args.smoke, model_name=args.model,
                        n_imgs=args.n_imgs, only=args.only, pps=args.pps)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
