"""Visual QA of a saved segmentation h5 (JAX
``cli/sanity_check_saved_segmentation.py``, reference
scripts/sanity_check_saved_segmentaion.py).

python -m samcarriestheburden_torch.cli.sanity_check_saved_segmentation --h5 <file>
"""

from __future__ import annotations

import argparse
import random
from pathlib import Path


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--h5", type=str, required=True)
    p.add_argument("--data_root", type=str, default="data")
    p.add_argument("--stem", type=str, default=None, help="default: random sample")
    p.add_argument("--save_dir", type=str, default=None,
                   help="write PNGs instead of showing windows")
    args = p.parse_args(argv)

    import cv2
    from matplotlib import pyplot as plt

    from samcarriestheburden_torch.data.h5io import MaskReader

    reader = MaskReader(args.h5, check_labels=False)
    stems = reader.stems()
    stem = args.stem or random.sample(stems, 1)[0]
    img_path = Path(args.data_root) / "img_only_front_all_left" / f"{stem}.png"
    img = cv2.imread(str(img_path), cv2.IMREAD_GRAYSCALE)
    img = cv2.resize(img, (224, 384), interpolation=cv2.INTER_NEAREST)
    seg = reader.masks(stem)
    est_dice = reader.estimated_dice(stem)

    for lbl, lbl_idx in reader.labels.items():
        if not seg[lbl_idx].any():
            continue
        plt.figure(lbl)
        plt.imshow(img, cmap="gray")
        plt.imshow(seg[lbl_idx], alpha=seg[lbl_idx].astype(float))
        title = lbl
        if est_dice is not None and est_dice.ndim:
            title += f" (est. dice: {est_dice[lbl_idx]:.4f})"
        plt.title(title)
        if args.save_dir:
            Path(args.save_dir).mkdir(parents=True, exist_ok=True)
            plt.savefig(Path(args.save_dir) / f"{stem}_{lbl.replace(' ', '_')}.png")
            plt.close()
        else:
            plt.show()


if __name__ == "__main__":
    main()
