"""Whole-image automatic mask generation CLI (JAX ``cli/amg.py``, reference
scripts/amg.py).

python -m samcarriestheburden_torch.cli.amg --checkpoint <ckpt> \\
    --model-type vit_h --input <img-or-dir> --output <dir> [--cpu]

Runs on ``--device`` (default: the card; raises without one); ``--cpu``
means the CPU.  Under ``--multihost`` each process takes a strided slice of
the images (per-image outputs: no merge step) on its own card.
Images are read and masks written with cv2, imported inside :func:`main`
and :func:`write_masks_to_folder`.
"""

from __future__ import annotations

import argparse
import json
import os

from samcarriestheburden_torch.cli.common import add_multihost_flags

parser = argparse.ArgumentParser(
    description="Runs automatic mask generation on an input image or directory "
                "of images, and outputs masks as either PNGs or COCO-style RLEs.")
parser.add_argument("--input", type=str, required=True,
                    help="Path to either a single input image or folder of images.")
parser.add_argument("--output", type=str, required=True,
                    help="Path to the directory where masks will be output.")
parser.add_argument("--model-type", type=str, required=True,
                    help="The type of model to load, in ['default', 'vit_h', 'vit_l', 'vit_b', "
                         "'vit_t']")
parser.add_argument("--checkpoint", type=str, required=True,
                    help="The path to the SAM checkpoint to use for mask generation.")
parser.add_argument("--device", type=str, default=None,
                    help="The device to run generation on (default: the card).")
parser.add_argument("--cpu", action="store_true", help="run on the CPU")
parser.add_argument("--convert-to-rle", action="store_true",
                    help="Save masks as COCO RLEs in a single json instead of as PNGs.")
add_multihost_flags(parser)

amg_settings = parser.add_argument_group("AMG Settings")
for flag, typ in [("--points-per-side", int), ("--points-per-batch", int),
                  ("--pred-iou-thresh", float), ("--stability-score-thresh", float),
                  ("--stability-score-offset", float), ("--box-nms-thresh", float),
                  ("--crop-n-layers", int), ("--crop-nms-thresh", float),
                  ("--crop-overlap-ratio", float),
                  ("--crop-n-points-downscale-factor", int),
                  ("--min-mask-region-area", int)]:
    amg_settings.add_argument(flag, type=typ, default=None)


def get_amg_kwargs(args) -> dict:
    kwargs = {
        "points_per_side": args.points_per_side,
        "points_per_batch": args.points_per_batch,
        "pred_iou_thresh": args.pred_iou_thresh,
        "stability_score_thresh": args.stability_score_thresh,
        "stability_score_offset": args.stability_score_offset,
        "box_nms_thresh": args.box_nms_thresh,
        "crop_n_layers": args.crop_n_layers,
        "crop_nms_thresh": args.crop_nms_thresh,
        "crop_overlap_ratio": args.crop_overlap_ratio,
        "crop_n_points_downscale_factor": args.crop_n_points_downscale_factor,
        "min_mask_region_area": args.min_mask_region_area,
    }
    return {k: v for k, v in kwargs.items() if v is not None}


def write_masks_to_folder(masks, path: str) -> None:
    """One PNG per mask and metadata.csv (reference scripts/amg.py:152-174)."""
    import cv2
    import numpy as np

    header = ("id,area,bbox_x0,bbox_y0,bbox_w,bbox_h,point_input_x,point_input_y,"
              "predicted_iou,stability_score,crop_box_x0,crop_box_y0,crop_box_w,crop_box_h")
    metadata = [header]
    for i, mask_data in enumerate(masks):
        mask = mask_data["segmentation"]
        cv2.imwrite(os.path.join(path, f"{i}.png"), mask.astype(np.uint8) * 255)
        md = [str(i), str(mask_data["area"]),
              *[str(x) for x in mask_data["bbox"]],
              *[str(x) for x in mask_data["point_coords"][0]],
              str(mask_data["predicted_iou"]), str(mask_data["stability_score"]),
              *[str(x) for x in mask_data["crop_box"]]]
        metadata.append(",".join(md))
    with open(os.path.join(path, "metadata.csv"), "w") as f:
        f.write("\n".join(metadata))


def main(argv=None) -> None:
    args = parser.parse_args(argv)
    from samcarriestheburden_torch.cli.common import setup_backend
    from samcarriestheburden_torch.device import resolve_device

    # --multihost joins the group (the rank's card, or the CPU under --cpu);
    # --cpu is the CPU; else --device, None being the card
    device = setup_backend(args) if args.cpu or args.multihost else resolve_device(args.device)
    import cv2

    from samcarriestheburden_torch.engine.amg import SamAutomaticMaskGenerator
    from samcarriestheburden_torch.models.build import sam_model_registry

    print("Loading model...")
    sam = sam_model_registry[args.model_type](checkpoint=args.checkpoint, device=device)
    output_mode = "coco_rle" if args.convert_to_rle else "binary_mask"
    generator = SamAutomaticMaskGenerator(sam, output_mode=output_mode, **get_amg_kwargs(args))

    if not os.path.isdir(args.input):
        targets = [args.input]
    else:
        targets = [os.path.join(args.input, f) for f in sorted(os.listdir(args.input))
                   if not os.path.isdir(os.path.join(args.input, f))]
    from samcarriestheburden_torch.parallel import distributed as pdist

    if pdist.is_multiprocess():
        # per-image work and per-image outputs: each process takes a strided slice
        targets = pdist.process_shard(targets)

    os.makedirs(args.output, exist_ok=True)
    for t in targets:
        print(f"Processing '{t}'...")
        image = cv2.imread(t)
        if image is None:
            print(f"Could not load '{t}' as an image, skipping...")
            continue
        image = cv2.cvtColor(image, cv2.COLOR_BGR2RGB)
        masks = generator.generate(image)
        base = os.path.splitext(os.path.basename(t))[0]
        save_base = os.path.join(args.output, base)
        if output_mode == "binary_mask":
            os.makedirs(save_base, exist_ok=True)
            write_masks_to_folder(masks, save_base)
        else:
            with open(save_base + ".json", "w") as f:
                json.dump(masks, f)
    print("Done!")


if __name__ == "__main__":
    main()
