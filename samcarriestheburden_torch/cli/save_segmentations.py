"""Raw U-Net segmentation export (JAX ``cli/save_segmentations.py``,
reference scripts/save_segmentations.py).

python -m samcarriestheburden_torch.cli.save_segmentations --model_id <id>
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def select_unlabeled_files(data_root: str, n_files) -> list:
    """500-split CSV or all unannotated PNGs (reference :25-33)."""
    import pandas as pd

    from samcarriestheburden_torch.data.cvat import CVATParser

    root = Path(data_root)
    if n_files == 500 or n_files == "500":
        return pd.read_csv(root / "500unlabeled_sample.csv",
                           index_col="filestem").index.tolist()
    stems = {f.stem for f in (root / "img_only_front_all_left").glob("*.png")}
    parser = CVATParser(sorted((root / "cvat_annotation_xml").glob("annotations_*.xml")),
                        True, False, True)
    return sorted(stems - set(parser.available_file_names))


def read_unet_image(img_dir: Path, stem: str) -> np.ndarray:
    """A grayscale PNG resized (bilinear) to the U-Net grid: (H, W) uint8."""
    import cv2

    from samcarriestheburden_torch.config import UNET_INPUT_HW

    img = cv2.imread(str(img_dir / f"{stem}.png"), cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise FileNotFoundError(img_dir / f"{stem}.png")
    h, w = UNET_INPUT_HW
    return cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)


def main(argv=None):
    p = argparse.ArgumentParser(description="Save raw U-Net segmentations")
    p.add_argument("--model_id", type=str, required=True)
    p.add_argument("--n_files", type=str, default="500", help="'500' or 'all'")
    p.add_argument("--data_root", type=str, default="data")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU; default: the card")
    args = p.parse_args(argv)

    from samcarriestheburden_torch.cli.common import setup_backend

    device = setup_backend(args)
    import torch
    from tqdm import tqdm

    from samcarriestheburden_torch.data.h5io import MaskWriter
    from samcarriestheburden_torch.models.modelio import ModelRegistry
    from samcarriestheburden_torch.models.unet import unet_probabilities

    print(f"Using model: {args.model_id}")
    _, unet = ModelRegistry(f"{args.data_root}/model_registry").load(args.model_id, device)
    files = select_unlabeled_files(args.data_root, args.n_files)
    img_dir = Path(args.data_root) / "img_only_front_all_left"
    out = (Path(args.data_root) / "seg_masks" / args.model_id /
           f"raw_segmentations_{len(files) if args.n_files != '500' else 500}.h5")

    with MaskWriter(out, attrs={"model_id": args.model_id}) as writer:
        for i in tqdm(range(0, len(files), args.batch_size), unit="batch",
                      desc="Predict segmentation"):
            chunk = files[i:i + args.batch_size]
            imgs = torch.from_numpy(np.stack([read_unet_image(img_dir, s) for s in chunk]))
            masks = (unet_probabilities(unet, imgs) > 0.5).cpu().numpy()
            for name, m in zip(chunk, masks):
                writer.write(name, m.astype(np.uint8))
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
