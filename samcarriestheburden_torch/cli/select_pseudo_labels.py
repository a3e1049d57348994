"""Select reliable pseudo labels by estimated-Dice agreement
(JAX ``cli/select_pseudo_labels.py``).

Produces the ``selected_pseudo_labels_500_dsc_<thr>.h5`` artifact the
mean-teacher dataset consumes (reference seg_grazpedwri_dataset.py:266-273).
An image is kept when the NaN-mean of its per-class estimated Dice (the SAM
IoU head's 2J/(1+J) signal that save_refined_segmentations stores) reaches
the threshold.  Host only.

python -m samcarriestheburden_torch.cli.select_pseudo_labels \\
    --model_id <id> --input sam_box_refine_pos_points_neg_points_500.h5 --threshold 0.8
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description="Filter pseudo labels by estimated Dice")
    p.add_argument("--model_id", type=str, required=True)
    p.add_argument("--input", type=str, required=True,
                   help="refined-mask h5 (relative to data/seg_masks/<model_id>/ or absolute)")
    p.add_argument("--threshold", type=float, default=0.8, help="dsc agreement threshold")
    p.add_argument("--data_root", type=str, default="data")
    args = p.parse_args(argv)

    from samcarriestheburden_torch.data.h5io import MaskReader, MaskWriter

    mdir = Path(args.data_root) / "seg_masks" / args.model_id
    in_path = Path(args.input)
    if not in_path.is_absolute() and not in_path.exists():
        in_path = mdir / args.input
    thr_str = str(args.threshold).replace(".", "")
    out = mdir / f"selected_pseudo_labels_500_dsc_{thr_str}.h5"
    kept, total = 0, 0
    with MaskReader(in_path, check_labels=False) as reader, \
            MaskWriter(out, labels=reader.labels,
                       attrs={"source": str(in_path),
                              "dsc_agreement_threshold": args.threshold}) as writer:
        for stem in reader.stems():
            total += 1
            est = reader.estimated_dice(stem)
            if est is None or est.ndim == 0:
                continue
            score = np.nanmean(est)
            if np.isfinite(score) and score >= args.threshold:
                writer.write(stem, reader.masks(stem), estimated_dice=est)
                kept += 1
    print(f"kept {kept}/{total} images at threshold {args.threshold}")
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()
