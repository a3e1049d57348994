"""CVAT "Image 1.1" annotation parser (reference utils/cvat_parser.py).

A copy of the JAX package's ``data/cvat.py``, which imports no JAX: this
package imports nothing of the JAX package.  Stdlib ``xml.etree`` + numpy
only (the reference needs xmltodict and skimage.draw; neither is assumed
here).  The polygon rasteriser reproduces skimage's even-odd crossing test
so masks match the reference pixelwise.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List
from xml.etree import ElementTree

import numpy as np


@dataclass
class Mask:
    """Mask for a single anatomy (reference cvat_parser.py:9-13)."""

    mask: np.ndarray
    anatomy: str


def rle2mask(rle: List[int], width: int, height: int, dtype=np.uint8) -> np.ndarray:
    """Decode CVAT's alternating-run RLE, runs starting with background
    (reference :117-131)."""
    counts = np.asarray(rle, dtype=np.int64)
    values = np.arange(len(counts)) % 2 == 1
    decoded = np.repeat(values, counts)
    pad = width * height - decoded.size
    if pad > 0:
        decoded = np.concatenate([decoded, np.zeros(pad, bool)])
    return decoded[: width * height].reshape(height, width).astype(dtype)


def polygon2mask(shape, polygon_yx: np.ndarray, dtype=np.uint8) -> np.ndarray:
    """Rasterise a polygon given (N, 2) float (row, col) vertices — skimage
    ``draw.polygon2mask`` semantics (even-odd rule, vectorised)."""
    h, w = shape
    ys = np.asarray(polygon_yx, np.float64)[:, 0]
    xs = np.asarray(polygon_yx, np.float64)[:, 1]
    rr, cc = np.mgrid[0:h, 0:w]
    rr = rr.astype(np.float64)
    cc = cc.astype(np.float64)
    inside = np.zeros(shape, bool)
    n = len(ys)
    j = n - 1
    for i in range(n):
        y_i, x_i, y_j, x_j = ys[i], xs[i], ys[j], xs[j]
        cond = (y_i > rr) != (y_j > rr)
        with np.errstate(divide="ignore", invalid="ignore"):
            x_cross = (x_j - x_i) * (rr - y_i) / (y_j - y_i) + x_i
        inside ^= cond & (cc < x_cross)
        j = i
    return inside.astype(dtype)


class CVATParser:
    """Parse CVAT Image-1.1 XML (multi-file) into per-anatomy masks
    (reference cvat_parser.py:16-167).  Supports 'mask' (RLE) and 'polygon'
    elements; anatomy comes from the ``<attribute name="Anatomie">`` child."""

    def __init__(self, path2xml, merge_same_anatomy: bool, create_bone_mask: bool,
                 drop_sonstiges: bool, mask_dtype=np.uint8):
        self.merge_same_anatomy = merge_same_anatomy
        self.create_bone_mask = create_bone_mask
        self.drop_sonstiges = drop_sonstiges
        self.mask_dtype = mask_dtype
        self.images: List[ElementTree.Element] = []

        if not isinstance(path2xml, (list, tuple)):
            path2xml = [path2xml]
        for xml in path2xml:
            root = ElementTree.parse(Path(xml)).getroot()
            self.images.extend(root.findall("image"))
        self.name2id_map: Dict[str, int] = {
            img.get("name").split(".")[0]: i for i, img in enumerate(self.images)}

    @classmethod
    def cvt_mask_list_2_dict(cls, mask_list: List[Mask]) -> Dict[str, np.ndarray]:
        return {m.anatomy: m.mask for m in mask_list}

    @staticmethod
    def _anatomy(el: ElementTree.Element) -> str:
        attr = el.find("attribute")
        return attr.text.strip() if attr is not None and attr.text else ""

    def _mask_from_mask_el(self, el, img_h, img_w) -> Mask:
        top = int(el.get("top"))
        left = int(el.get("left"))
        m_w = int(el.get("width"))
        m_h = int(el.get("height"))
        rle = list(map(int, el.get("rle").split(",")))
        sub = rle2mask(rle, m_w, m_h, self.mask_dtype)
        full = np.zeros((img_h, img_w), self.mask_dtype)
        full[top:top + m_h, left:left + m_w] = sub
        return Mask(full, self._anatomy(el))

    def _mask_from_polygon_el(self, el, img_h, img_w) -> Mask:
        pts = [list(map(float, p.split(","))) for p in el.get("points").split(";")]
        pts_yx = np.asarray(pts)[:, ::-1]  # (x, y) -> (y, x), reference :156-157
        mask = polygon2mask((img_h, img_w), pts_yx, self.mask_dtype)
        return Mask(mask, self._anatomy(el))

    def extract_masks(self, img_name: str) -> List[Mask]:
        try:
            img = self.images[self.name2id_map[img_name]]
        except KeyError:
            raise KeyError(f"Image {img_name} not found in annotations")

        img_h = int(img.get("height"))
        img_w = int(img.get("width"))
        masks = [self._mask_from_mask_el(el, img_h, img_w)
                 for el in img.findall("mask")]
        masks += [self._mask_from_polygon_el(el, img_h, img_w)
                  for el in img.findall("polygon")]

        assert len(masks) > 0, f"No masks found for image {img_name}"
        assert all(m.mask.shape == (img_h, img_w) for m in masks), \
            "Mask and image shape do not match"

        if self.merge_same_anatomy:
            merged: Dict[str, np.ndarray] = {}
            for m in masks:
                if m.anatomy in merged:
                    merged[m.anatomy] |= m.mask
                else:
                    merged[m.anatomy] = m.mask
            masks = [Mask(v, k) for k, v in merged.items()]

        if self.create_bone_mask:
            bone = np.zeros((img_h, img_w), self.mask_dtype)
            d = {"Ossis": bone}
            for m in masks:
                d[m.anatomy] = m.mask
                d["Ossis"] |= m.mask
            masks = [Mask(v, k) for k, v in d.items()]

        if self.drop_sonstiges:
            if any(m.anatomy == "Sonstiges" for m in masks):
                print(f'{img_name} contains mask with anatomy "Sonstiges"')
            masks = [m for m in masks if m.anatomy != "Sonstiges"]

        return masks

    @property
    def available_file_names(self) -> List[str]:
        return list(self.name2id_map.keys())
