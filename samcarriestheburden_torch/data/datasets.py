"""GrazPedWri-DX datasets (JAX ``data/datasets.py``, reference
scripts/seg_grazpedwri_dataset.py).

Numpy-backed: the same arrays from the same tree as the JAX package's (cv2
decode and resize, pandas CSVs, each imported inside the function that
uses it).  File conventions are identical to the reference
(``data/dataset.csv`` metadata, ``data/img_only_front_all_left/`` pre-flipped
PNGs, CVAT XML splits, the 500-unlabelled CSV and the successive-training-
order CSV), so a reference data directory drops in unchanged.

Each dataset keeps ``__len__``/``__getitem__`` API parity and adds
``as_arrays()`` returning stacked (images, masks, stems) ready for
``train/loop.py``.
"""

from __future__ import annotations

import logging
from pathlib import Path
from random import randint
from typing import List, Optional, Tuple

import numpy as np

from samcarriestheburden_torch.config import (
    BONE_LABEL, BONE_LABEL_MAPPING, GRAZ_IMG_MEAN, GRAZ_IMG_STD, N_CLASSES,
    POS_CLASS_WEIGHT, UNET_INPUT_HW)
from samcarriestheburden_torch.data.cvat import CVATParser
from samcarriestheburden_torch.data.h5io import MaskReader


def _imread_gray(path) -> np.ndarray:
    import cv2

    img = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise FileNotFoundError(path)
    return img


def _resize(img: np.ndarray, hw: Tuple[int, int], nearest: bool = False) -> np.ndarray:
    import cv2

    interp = cv2.INTER_NEAREST if nearest else cv2.INTER_LINEAR
    return cv2.resize(img, (hw[1], hw[0]), interpolation=interp)


class _GrazBase:
    IMG_MEAN = GRAZ_IMG_MEAN
    IMG_STD = GRAZ_IMG_STD
    BONE_LABEL = list(BONE_LABEL)
    BONE_LABEL_MAPPING = dict(BONE_LABEL_MAPPING)
    N_CLASSES = N_CLASSES
    POS_CLASS_WEIGHT = np.asarray(POS_CLASS_WEIGHT, np.float32)

    def as_arrays(self):
        """Stack the whole dataset: (images (N,1,H,W) f32, masks (N,C,H,W) f32,
        stems)."""
        xs, ys, names = [], [], []
        for i in range(len(self)):
            x, y, name = self[i]
            xs.append(x)
            ys.append(y)
            names.append(name)
        return np.stack(xs), np.stack(ys), names


class LightSegGrazPedWriDataset(_GrazBase):
    """64 radiologist-annotated frontal wrist X-rays, eagerly loaded
    (reference :20-139)."""

    def __init__(self, mode: str, number_training_samples="all",
                 rescale_HW: Tuple[int, int] = UNET_INPUT_HW,
                 data_root: str = "data"):
        import pandas as pd

        root = Path(data_root)
        self.df_meta = pd.read_csv(root / "dataset.csv", index_col="filestem")
        if mode == "train":
            xml_files = sorted((root / "cvat_annotation_xml").glob(
                "annotations_train[1-9].xml"))
        elif mode in ("val", "test"):
            xml_files = [root / "cvat_annotation_xml" / f"annotations_{mode}.xml"]
        else:
            raise ValueError(f"Unknown mode {mode}")
        self.gt_parser = CVATParser(xml_files, True, False, True)

        projection_mask = self.df_meta["projection"] == 1
        annotated = self.df_meta.index.isin(self.gt_parser.available_file_names)
        self.available_file_names: List[str] = \
            self.df_meta[projection_mask & annotated].index.tolist()

        if mode == "train" and number_training_samples != "all":
            training_files = pd.read_csv(
                root / "successively_training_files_order.csv")["file_stem"]
            assert len(training_files) == len(self.available_file_names), \
                "files are missing or duplicated"
            assert number_training_samples <= len(training_files), \
                "number_training_samples is larger than available files"
            self.available_file_names = training_files[:number_training_samples].tolist()
        elif mode != "train" and number_training_samples != "all":
            logging.warning(f"number_training_samples is not used for mode {mode}")

        img_path = root / "img_only_front_all_left"
        self.data = {}
        for name in self.available_file_names:
            img = _imread_gray(img_path / f"{name}.png")
            seg = CVATParser.cvt_mask_list_2_dict(self.gt_parser.extract_masks(name))
            need2flip = self.df_meta.loc[name, "laterality"] == "R"

            img_r = _resize(img, rescale_HW)
            stack = []
            for lbl in self.BONE_LABEL:
                m = seg.get(lbl)
                # albumentations resizes mask targets with nearest interpolation
                stack.append(_resize(m, rescale_HW, nearest=True)
                             if m is not None else np.zeros(rescale_HW, np.uint8))
            y = np.stack(stack).astype(np.float32)
            if need2flip:  # the stored image is already flipped; flip GT to match
                y = y[..., ::-1].copy()
            x = (img_r[None].astype(np.float32)) / 255.0
            self.data[name] = {"image": x, "mask": y}

    def __len__(self):
        return len(self.available_file_names)

    def __getitem__(self, index):
        name = self.available_file_names[index]
        d = self.data[name]
        return d["image"], d["mask"], name


class SavedSegGrazPedWriDataset(_GrazBase):
    """Images + stored (pseudo-label) segmentations from an h5
    (reference :142-199)."""

    def __init__(self, saved_seg_path, use_500_split: bool,
                 rescale_HW: Tuple[int, int] = UNET_INPUT_HW,
                 data_root: str = "data"):
        import pandas as pd

        root = Path(data_root)
        self.reader = MaskReader(saved_seg_path)
        self.img_path = root / "img_only_front_all_left"
        self.rescale_HW = rescale_HW

        if use_500_split:
            self.available_file_names = pd.read_csv(
                root / "500unlabeled_sample.csv")["filestem"].tolist()
        else:
            logging.warning("Using all available files in saved segmentations!")
            self.available_file_names = self.reader.stems()

    def __len__(self):
        return len(self.available_file_names)

    def __getitem__(self, index):
        name = self.available_file_names[index]
        seg = self.reader.masks(name).astype(np.float32)
        # reference resizes labels with legacy nearest (:176)
        y = np.stack([_resize(c, self.rescale_HW, nearest=True) for c in seg])
        img = _imread_gray(self.img_path / f"{name}.png")
        x = _resize(img, self.rescale_HW)[None].astype(np.float32) / 255.0
        return x, y, name


class CombinedSegGrazPedWriDataset(_GrazBase):
    """Pairs each GT sample with a random pseudo-label sample (reference :202-229)."""

    def __init__(self, ds_with_gt: LightSegGrazPedWriDataset,
                 ds_with_pseudo_lbl: SavedSegGrazPedWriDataset):
        self.ds_with_gt = ds_with_gt
        self.ds_with_pseudo_lbl = ds_with_pseudo_lbl

    def __len__(self):
        return len(self.ds_with_gt)

    def __getitem__(self, index):
        gt = self.ds_with_gt[index]
        rnd = randint(0, len(self.ds_with_pseudo_lbl) - 1)
        return {"gt": gt, "pseudo_lbl": self.ds_with_pseudo_lbl[rnd]}


class MeanTeacherSegGrazPedWriDataset(_GrazBase):
    """Labelled ∪ unlabelled, optionally with Dice-threshold-selected pseudo
    labels (reference :232-292)."""

    def __init__(self, use_500_split: bool, number_training_samples="all",
                 rescale_HW: Tuple[int, int] = UNET_INPUT_HW,
                 model_id_pseudo_label: Optional[str] = None,
                 dsc_agreement_threshold: Optional[float] = None,
                 data_root: str = "data"):
        import pandas as pd

        root = Path(data_root)
        self.rescale_HW = rescale_HW
        self.img_path = root / "img_only_front_all_left"
        self.ds_with_gt = LightSegGrazPedWriDataset(
            "train", number_training_samples, rescale_HW, data_root)

        if use_500_split:
            self.unlabeled_files_names = pd.read_csv(
                root / "500unlabeled_sample.csv")["filestem"].tolist()
        else:
            stems = [f.stem for f in self.img_path.rglob("*.png")]
            self.unlabeled_files_names = list(
                set(stems) - set(self.ds_with_gt.available_file_names))
        assert not (set(self.unlabeled_files_names)
                    & set(self.ds_with_gt.available_file_names)), "Files are duplicated"
        self.available_file_names = (self.ds_with_gt.available_file_names
                                     + self.unlabeled_files_names)

        self.use_pseudo_label = False
        if model_id_pseudo_label is not None and dsc_agreement_threshold is not None:
            self.use_pseudo_label = True
            thr = str(dsc_agreement_threshold).replace(".", "")
            path = (root / "seg_masks" / model_id_pseudo_label /
                    f"selected_pseudo_labels_500_dsc_{thr}.h5")
            assert path.exists(), \
                f"Pseudo label file does not exist. Please check the path: {path}"
            self.ds_with_pseudo_lbl = SavedSegGrazPedWriDataset(
                path, False, rescale_HW, data_root)
            assert all(f in self.available_file_names
                       for f in self.ds_with_pseudo_lbl.available_file_names), \
                "Pseudo label files are not in available files"

    def __len__(self):
        return len(self.available_file_names)

    def __getitem__(self, index):
        name = self.available_file_names[index]
        if name in self.ds_with_gt.available_file_names:
            return self.ds_with_gt[self.ds_with_gt.available_file_names.index(name)]
        if self.use_pseudo_label and name in self.ds_with_pseudo_lbl.available_file_names:
            return self.ds_with_pseudo_lbl[
                self.ds_with_pseudo_lbl.available_file_names.index(name)]
        img = _imread_gray(self.img_path / f"{name}.png")
        x = _resize(img, self.rescale_HW)[None].astype(np.float32) / 255.0
        return x, None, name
