"""SAM-refined pseudo-label export (JAX ``cli/save_refined_segmentations.py``,
reference scripts/save_refined_segmentations.py).

python -m samcarriestheburden_torch.cli.save_refined_segmentations --model_id <id>

The sweep's loop is :func:`refine_images`: U-Net probabilities, then
``SegEnhance.enhance_batch`` per batch of images, the refined masks
bit-packed on the device and fetched one batch late.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from samcarriestheburden_torch.models.unet import unet_probabilities
from samcarriestheburden_torch.ops.mask_ops import packbits_device, unpackbits_host
from samcarriestheburden_torch.profiling import span


def refine_images(unet, seg_processor, stems: Sequence[str], read: Callable[[str], np.ndarray],
                  writer, *, img_batch: int = 8, progress: bool = False) -> None:
    """Refine the U-Net's segmentation of each image ``read(stem)`` ((H, W)
    uint8 on the U-Net grid) with ``seg_processor`` (a ``SegEnhance``) and
    hand it to ``writer.write(stem, masks (C, H, W) uint8,
    estimated_dice=(C,))``.

    ``img_batch`` images per ``enhance_batch`` call (1: the reference's
    per-image ``enhance``; a refiner without an estimate, the random walk,
    writes a NaN row).  Batch i's masks are bit-packed on the device
    (``ops/mask_ops.py:packbits_device``, where W is a multiple of 8), their
    copy to pinned host memory is enqueued at once with an event behind it,
    and they are written after batch i+1 is dispatched, as the JAX sweep
    fetches one batch late; a copy enqueued at write time would wait for
    batch i+1 on the same stream.  Spans (``profiling.span``, each with
    ``batch``): ``refine_images.unet`` (the images read and the U-Net's
    probabilities), ``refine_images.flush`` (the wait for batch i-1's event,
    the unpacking and the writes); ``enhance_batch`` records its own."""
    bs = max(1, img_batch)
    pending = None

    def fetch(t: torch.Tensor) -> torch.Tensor:
        if t.device.type != "cuda":
            return t
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)

    def flush(p, batch):
        chunk_, refined_, est_, width, done = p
        with span("refine_images.flush", batch=batch):
            if done is not None:
                done.synchronize()
            refined_ = refined_.numpy()
            if width is not None:
                refined_ = unpackbits_host(refined_, width)
            refined_ = refined_.astype(np.uint8)
            est_ = est_.numpy()
            for j, name in enumerate(chunk_):
                writer.write(name, refined_[j], estimated_dice=est_[j])

    starts = range(0, len(stems), bs)
    if progress:
        from tqdm import tqdm

        starts = tqdm(starts, unit="batch", desc="Refine segmentation")
    for b, i in enumerate(starts):
        chunk = list(stems[i:i + bs])
        with span("refine_images.unet", batch=b):
            imgs = torch.from_numpy(np.stack([read(s) for s in chunk]))
            y_hat = unet_probabilities(unet, imgs)
        if bs == 1:
            refined, est_dice = seg_processor.enhance(y_hat[0], chunk[0])
            if est_dice is None:        # the random walk has no IoU-head signal
                est_dice = torch.full((refined.shape[0],), float("nan"),
                                      device=refined.device)
            refined, est_dice = refined[None], est_dice[None]
        else:
            refined, est_dice = seg_processor.enhance_batch(y_hat, chunk)
        width = None
        if refined.shape[-1] % 8 == 0:     # device-side bit-pack: 8x smaller fetch
            width, refined = refined.shape[-1], packbits_device(refined)
        refined, est_dice, done = fetch(refined), fetch(est_dice), None
        if refined.is_pinned():
            done = torch.cuda.Event()
            done.record()
        if pending is not None:
            flush(pending, b - 1)
        pending = (chunk, refined, est_dice, width, done)
    if pending is not None:
        flush(pending, b)


def main(argv=None):
    p = argparse.ArgumentParser(description="Save SAM-refined segmentations")
    p.add_argument("--model_id", type=str, required=True)
    p.add_argument("--n_files", type=str, default="all", help="'500' or 'all'")
    p.add_argument("--data_root", type=str, default="data")
    p.add_argument("--refiner", choices=["sam", "rndwalk"], default="sam",
                   help="refinement engine: the reference's SAM protocol, or the random-walk "
                        "baseline (reference seg_refinement.py:119) writing rndwalk_<count>.h5 "
                        "for train_on_pseudo_labels --pseudo_label rndwalk")
    p.add_argument("--bg_erosion_radius", type=int, default=8,
                   help="rndwalk: background seed erosion radius")
    p.add_argument("--laplace_sigma", type=float, default=5.0,
                   help="rndwalk: edge-weight sigma")
    p.add_argument("--sam_type", choices=["SAM", "MedSAM"], default="SAM")
    p.add_argument("--sam_checkpoint", type=str, default=None,
                   help="override the sam_type checkpoint convention")
    p.add_argument("--sam_model_type", type=str, default=None,
                   help="override: vit_h|vit_l|vit_b|vit_t")
    p.add_argument("--embeddings", type=str, default=None,
                   help="override the embeddings h5 path")
    # authors' HPO-selected refinement config (reference :25-31)
    p.add_argument("--prompt1st", nargs="*", default=["box"])
    p.add_argument("--prompt2nd", nargs="*", default=["pos_points", "neg_points"])
    p.add_argument("--ccl_selection", default="highest_probability")
    p.add_argument("--morph_op", default="dilation")
    p.add_argument("--struct_elem", default="square")
    p.add_argument("--radius", type=int, default=8)
    p.add_argument("--decoder_dtype", choices=["float32", "bfloat16"], default="float32",
                   help="decoder compute precision; float32 is the torch-parity default, "
                        "bfloat16 the serving opt-in")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions); default: the card")
    p.add_argument("--img_batch", type=int, default=8,
                   help="images per enhance_batch call (1 = reference-style per-image loop)")
    from samcarriestheburden_torch.cli.common import (add_multihost_flags, add_profile_flag,
                                                      profiled, setup_backend)
    add_profile_flag(p)
    add_multihost_flags(p)
    args = p.parse_args(argv)
    device = setup_backend(args)

    from samcarriestheburden_torch.cli.save_segmentations import (read_unet_image,
                                                                  select_unlabeled_files)
    from samcarriestheburden_torch.data.h5io import MaskWriter
    from samcarriestheburden_torch.engine.refinement import (RndWalkSegRefiner, SamSegRefiner,
                                                             SegEnhance)
    from samcarriestheburden_torch.models.modelio import ModelRegistry
    from samcarriestheburden_torch.parallel import distributed as pdist

    _, unet = ModelRegistry(f"{args.data_root}/model_registry").load(args.model_id, device)
    refine_params = {
        "ccl_selection": args.ccl_selection,
        "morph_op": args.morph_op,
        "struct_elem": args.struct_elem,
        "radius": args.radius,
    }
    img_dir = Path(args.data_root) / "img_only_front_all_left"
    if args.refiner == "rndwalk":
        refine_params.update({"bg_erosion_radius": args.bg_erosion_radius,
                              "laplace_sigma": args.laplace_sigma})
        refiner = RndWalkSegRefiner(args.bg_erosion_radius, args.laplace_sigma,
                                    img_path=img_dir, device=device)
        args.img_batch = 1  # a per-image solver: no batched path
    else:
        refine_params["prompts2use"] = [list(args.prompt1st), list(args.prompt2nd)]
        if args.sam_checkpoint is not None:
            from samcarriestheburden_torch.engine.decoder_head import SamMaskDecoderHead

            head = SamMaskDecoderHead(
                args.sam_checkpoint, args.sam_model_type, args.embeddings, device,
                compute_dtype={"float32": torch.float32,
                               "bfloat16": torch.bfloat16}[args.decoder_dtype])
            refiner = SamSegRefiner(head, prompts2use=refine_params["prompts2use"])
        else:
            refiner = SamSegRefiner(args.sam_type, device, refine_params["prompts2use"],
                                    data_root=args.data_root)
    seg_processor = SegEnhance(refiner, refine_params["ccl_selection"],
                               refine_params["morph_op"], refine_params["struct_elem"],
                               refine_params["radius"])
    print(f"Refine model {args.model_id} segmentation with {refine_params}")

    files = select_unlabeled_files(args.data_root, args.n_files)
    count = len(files) if args.n_files != "500" else 500
    if args.refiner == "rndwalk":
        name = f"rndwalk_{count}.h5"
    else:
        id_str = "_".join(args.prompt1st) + "_refine_" + "_".join(args.prompt2nd)
        name = f"sam_{id_str}_{count}.h5"
    out = Path(args.data_root) / "seg_masks" / args.model_id / name
    attrs = {"refine_params": json.dumps(refine_params), "model_id": args.model_id}
    if pdist.is_multiprocess():
        # each process refines its strided slice of the files on its own card
        # (per-image work, no collective) into <out>.part<rank>, with the
        # shard_count provenance that data/h5io.py:merge_mask_shards checks
        files = pdist.process_shard(files)
        out = Path(f"{out}.part{pdist.process_index()}")
        attrs["shard_count"] = pdist.process_count()
    with profiled(args.profile), MaskWriter(out, attrs=attrs) as writer:
        refine_images(unet, seg_processor, files, lambda s: read_unet_image(img_dir, s),
                      writer, img_batch=args.img_batch, progress=True)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
