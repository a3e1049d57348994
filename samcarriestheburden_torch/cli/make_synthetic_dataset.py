"""Synthetic GrazPedWri-style dataset generator (JAX
``cli/make_synthetic_dataset.py``: the same files from the same seed).

The reference pipeline needs the (non-redistributable) GrazPedWri-DX images
plus the authors' CVAT annotations (reference data/cvat_annotation_xml/*.xml,
data/500unlabeled_sample.csv, data/successively_training_files_order.csv).
This CLI fabricates a drop-in data root with the same file conventions —
synthetic "wrist X-rays" with 17 bright bone-shaped regions whose polygon
outlines are written as CVAT "Image 1.1" XML — so the full 6-stage pipeline
(train → embeddings → save_segmentations → refine → select → retrain) runs
end-to-end on a fresh checkout.

python -m samcarriestheburden_torch.cli.make_synthetic_dataset --data_root data
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from samcarriestheburden_torch.config import BONE_LABEL

# Rough frontal left-wrist layout on a unit (h, w) frame: two forearm shafts
# at the bottom, their epiphyses above, two carpal rows, five metacarpals
# fanning out at the top.  (cy, cx, ry, rx) fractions of the image size.
_LAYOUT = {
    "Radius":                (0.86, 0.38, 0.13, 0.07),
    "Ulna":                  (0.86, 0.62, 0.13, 0.06),
    "Epiphyse Radius":       (0.68, 0.38, 0.045, 0.075),
    "Epiphyse Ulna":         (0.68, 0.62, 0.04, 0.055),
    "Os lunatum":            (0.585, 0.47, 0.035, 0.05),
    "Os scaphoideum":        (0.575, 0.30, 0.04, 0.055),
    "Os triquetrum":         (0.585, 0.64, 0.035, 0.045),
    "Os pisiforme":          (0.60, 0.76, 0.025, 0.03),
    "Os trapezium":          (0.50, 0.22, 0.035, 0.045),
    "Os trapezoideum":       (0.495, 0.35, 0.03, 0.04),
    "Os capitatum":          (0.49, 0.49, 0.045, 0.05),
    "Os hamatum":            (0.495, 0.65, 0.04, 0.05),
    "Ossa metacarpalia I":   (0.38, 0.14, 0.075, 0.04),
    "Ossa metacarpalia II":  (0.33, 0.32, 0.10, 0.04),
    "Ossa metacarpalia III": (0.31, 0.48, 0.105, 0.04),
    "Ossa metacarpalia IV":  (0.325, 0.63, 0.10, 0.038),
    "Ossa metacarpalia V":   (0.36, 0.78, 0.085, 0.035),
}
assert set(_LAYOUT) == set(BONE_LABEL)


def _bone_polygon(rng, bone, h, w, n_pts=10):
    """Jittered ellipse outline for one bone, clipped to the frame."""
    cy, cx, ry, rx = _LAYOUT[bone]
    cy, cx = cy * h + rng.normal(0, 0.01) * h, cx * w + rng.normal(0, 0.01) * w
    ry, rx = ry * h * rng.uniform(0.85, 1.15), rx * w * rng.uniform(0.85, 1.15)
    rot = rng.normal(0, 0.12)
    th = np.linspace(0, 2 * np.pi, n_pts, endpoint=False)
    r_jit = rng.uniform(0.9, 1.1, n_pts)
    y = ry * np.sin(th) * r_jit
    x = rx * np.cos(th) * r_jit
    xs = cx + x * np.cos(rot) - y * np.sin(rot)
    ys = cy + x * np.sin(rot) + y * np.cos(rot)
    xs = np.clip(xs, 0, w - 1.001)
    ys = np.clip(ys, 0, h - 1.001)
    return np.stack([xs, ys], axis=1)


def _render_image(rng, polys, h, w):
    """Noisy radiograph-ish background + soft-tissue blob + bright bones."""
    import cv2

    img = rng.normal(35, 8, (h, w)).astype(np.float32)
    tissue = np.zeros((h, w), np.uint8)
    cv2.ellipse(tissue, (w // 2, int(0.55 * h)), (int(0.42 * w), int(0.5 * h)),
                0, 0, 360, 1, -1)
    img += 45.0 * cv2.GaussianBlur(tissue.astype(np.float32), (0, 0), 9)
    for pts in polys.values():
        m = np.zeros((h, w), np.uint8)
        cv2.fillPoly(m, [np.round(pts).astype(np.int32)], 1)
        img += rng.uniform(55, 90) * cv2.GaussianBlur(m.astype(np.float32), (0, 0), 1.5)
    img += rng.normal(0, 4, (h, w)).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def _xml_image_element(idx, stem, polys, h, w):
    parts = [f'  <image id="{idx}" name="{stem}.png" width="{w}" height="{h}">']
    for bone, pts in polys.items():
        pstr = ";".join(f"{x:.2f},{y:.2f}" for x, y in pts)
        parts.append(
            f'    <polygon label="Knochen" points="{pstr}" z_order="0">\n'
            f'      <attribute name="Anatomie">{bone}</attribute>\n'
            f"    </polygon>")
    parts.append("  </image>")
    return "\n".join(parts)


def _write_xml(path, elements):
    path.write_text('<?xml version="1.0" encoding="utf-8"?>\n<annotations>\n'
                    + "\n".join(elements) + "\n</annotations>\n")


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Generate a synthetic GrazPedWri-style data root")
    p.add_argument("--data_root", type=str, default="data")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--n_train1", type=int, default=8)
    p.add_argument("--n_train2", type=int, default=4)
    p.add_argument("--n_val", type=int, default=3)
    p.add_argument("--n_test", type=int, default=3)
    p.add_argument("--n_unlabeled", type=int, default=12,
                   help="unannotated images listed in 500unlabeled_sample.csv")
    p.add_argument("--unlabeled_gt_xml", action="store_true",
                   help="also write annotations_unlabeled.xml with the "
                        "unlabeled images' true outlines — a HELD-OUT "
                        "evaluation file no dataset class ever reads (the "
                        "train glob is annotations_train[1-9].xml); lets "
                        "tests measure pseudo-label quality against truth")
    p.add_argument("--height", type=int, default=640)
    p.add_argument("--width", type=int, default=400)
    args = p.parse_args(argv)

    import cv2
    import pandas as pd

    rng = np.random.default_rng(args.seed)
    root = Path(args.data_root)
    img_dir = root / "img_only_front_all_left"
    xml_dir = root / "cvat_annotation_xml"
    img_dir.mkdir(parents=True, exist_ok=True)
    xml_dir.mkdir(parents=True, exist_ok=True)

    splits = [("train1", args.n_train1), ("train2", args.n_train2),
              ("val", args.n_val), ("test", args.n_test)]
    n_total = sum(n for _, n in splits) + args.n_unlabeled
    stems = [f"synth{i:04d}" for i in range(n_total)]

    rows, k = [], 0
    for split, n in splits:
        elements = []
        for j in range(n):
            stem = stems[k]
            h = args.height + int(rng.integers(-40, 40))
            w = args.width + int(rng.integers(-25, 25))
            polys = {b: _bone_polygon(rng, b, h, w) for b in BONE_LABEL}
            cv2.imwrite(str(img_dir / f"{stem}.png"),
                        _render_image(rng, polys, h, w))
            elements.append(_xml_image_element(j, stem, polys, h, w))
            rows.append((stem, 1, 0, "L"))
            k += 1
        _write_xml(xml_dir / f"annotations_{split}.xml", elements)

    unlabeled, unlabeled_elements = [], []
    for j in range(args.n_unlabeled):
        stem = stems[k]
        h = args.height + int(rng.integers(-40, 40))
        w = args.width + int(rng.integers(-25, 25))
        polys = {b: _bone_polygon(rng, b, h, w) for b in BONE_LABEL}
        cv2.imwrite(str(img_dir / f"{stem}.png"), _render_image(rng, polys, h, w))
        rows.append((stem, 1, 0, "L"))
        unlabeled.append(stem)
        unlabeled_elements.append(_xml_image_element(j, stem, polys, h, w))
        k += 1
    if args.unlabeled_gt_xml and unlabeled_elements:
        _write_xml(xml_dir / "annotations_unlabeled.xml", unlabeled_elements)

    pd.DataFrame(rows, columns=["filestem", "projection", "lateralproj",
                                "laterality"]).set_index("filestem").to_csv(
        root / "dataset.csv")
    pd.DataFrame({"filestem": unlabeled}).to_csv(root / "500unlabeled_sample.csv")
    # every annotated image covers all 17 classes, so any order is valid;
    # keep the reference CSV convention (define_successively_data_subsets)
    train_stems = stems[: args.n_train1 + args.n_train2]
    pd.DataFrame({"file_stem": train_stems}).to_csv(
        root / "successively_training_files_order.csv")

    print(f"wrote {n_total} images ({n_total - args.n_unlabeled} annotated over "
          f"{len(splits)} CVAT splits, {args.n_unlabeled} unlabeled) to {root}")
    return root


if __name__ == "__main__":
    main()
