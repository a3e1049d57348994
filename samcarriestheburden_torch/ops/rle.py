"""Run-length encoding in the pycocotools uncompressed format (JAX
``ops/rle.py``, reference segment_anything/utils/amg.py:107-153).

RLE output is variable-length, so encode and decode run on the host.
:func:`mask_to_rle` runs the C++ codec (``native.py``) or, asked for with
``use_native=False``, the vectorised numpy version (``np.flatnonzero`` over
the XOR-diff), the plain one; a codec that fails to build raises.  A
compressed COCO-RLE encoder (pycocotools' LEB128 scheme) is included, so no
pycocotools is needed."""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np


def mask_to_rle(masks: np.ndarray, use_native: bool = True) -> List[Dict[str, Any]]:
    """Encode (B, H, W) boolean masks to uncompressed RLE dicts, in
    column-major (Fortran) order like pycocotools (reference amg.py:107-135).
    ``use_native``: the C++ codec (raises if it cannot be built), else numpy."""
    masks = np.asarray(masks, dtype=bool)
    if masks.ndim == 2:
        masks = masks[None]
    b, h, w = masks.shape
    if use_native:
        from samcarriestheburden_torch import native

        return [{"size": [h, w], "counts": native.rle_encode(m)} for m in masks]

    flat = masks.transpose(0, 2, 1).reshape(b, h * w)
    out = []
    for row in flat:
        change = np.flatnonzero(row[1:] ^ row[:-1]) + 1
        idxs = np.concatenate([[0], change, [h * w]])
        counts = np.diff(idxs).tolist()
        if row[0]:
            counts = [0] + counts
        out.append({"size": [h, w], "counts": counts})
    return out


def rle_to_mask(rle: Dict[str, Any]) -> np.ndarray:
    """Decode an uncompressed RLE dict to an (H, W) boolean mask
    (reference amg.py:138-149)."""
    h, w = rle["size"]
    counts = np.asarray(rle["counts"], dtype=np.int64)
    total = int(counts.sum())
    if total != h * w:
        raise ValueError("RLE does not cover the mask")
    parity = np.arange(len(counts)) % 2 == 1  # runs alternate 0,1,0,1,...
    mask = np.repeat(parity, counts)
    return mask.reshape(w, h).transpose()


def area_from_rle(rle: Dict[str, Any]) -> int:
    """Foreground area (reference amg.py:152-153)."""
    return int(sum(rle["counts"][1::2]))


def coco_encode_rle(uncompressed_rle: Dict[str, Any]) -> Dict[str, Any]:
    """Compress an uncompressed RLE into the COCO string format.

    Re-implements pycocotools' LEB128-with-delta scheme (the reference calls
    ``mask_utils.frPyObjects``, amg.py:294-300) so exports stay compatible
    without the native dependency.
    """
    counts = uncompressed_rle["counts"]
    out = []
    for i, cnt in enumerate(counts):
        x = int(cnt)
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = not ((x == 0 and not (c & 0x10)) or (x == -1 and (c & 0x10)))
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return {"size": uncompressed_rle["size"], "counts": "".join(out)}


def coco_decode_rle(coco_rle: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of :func:`coco_encode_rle` (pycocotools-compatible)."""
    s = coco_rle["counts"]
    counts: List[int] = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return {"size": coco_rle["size"], "counts": counts}
