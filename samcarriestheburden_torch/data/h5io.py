"""HDF5 artifact stores, the same schemas as the JAX package's
``data/h5io.py``, so files written by either package read in the other:

* embeddings (reference scripts/generate_img_embeddings.py:31-70):
  ``img_embedding/<stem>/features`` float32 (1, 256, 64, 64) with per-image
  attrs ``original_size`` (2,) and ``input_size`` (2,); file attrs
  ``checkpoint`` (the weights' file name) and ``img_encoder_img_size``;
* masks (reference scripts/save_segmentations.py:36-56,
  save_refined_segmentations.py:49-81): ``segmentation_mask/<stem>`` (C, H,
  W) with file attr ``labels`` (JSON label -> index) and an optional
  per-image attr ``estimated_dice`` (C,).

``h5py`` is imported when a file is opened, not with this module: the port
runs without it wherever no h5 file is read or written, and
:class:`MemoryEmbeddings` and :class:`MemoryMasks` hold the same records in
memory.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from samcarriestheburden_torch.config import BONE_LABEL_MAPPING


class EmbeddingWriter:
    def __init__(self, path, checkpoint_name: str, img_encoder_img_size: int = 1024,
                 append: bool = False):
        """``append=True`` reopens an interrupted run: its stems are kept and
        listed by :meth:`existing_stems`."""
        import h5py

        Path(path).parent.mkdir(parents=True, exist_ok=True)
        mode = "a" if (append and Path(path).exists()) else "w"
        self.f = h5py.File(path, mode)
        if mode == "a" and self.f.attrs["checkpoint"] != checkpoint_name:
            self.f.close()
            raise ValueError("resume with a different checkpoint")
        self.f.attrs["checkpoint"] = checkpoint_name
        self.f.attrs["img_encoder_img_size"] = img_encoder_img_size

    def existing_stems(self) -> Set[str]:
        if "img_embedding" not in self.f:
            return set()
        return set(self.f["img_embedding"].keys())

    def write(self, stem: str, features, original_size: Tuple[int, int],
              input_size: Tuple[int, int], compression: Optional[str] = "gzip",
              compression_opts=9) -> None:
        grp = self.f.create_group(f"img_embedding/{stem}")
        grp.create_dataset("features", data=np.asarray(features, np.float32),
                           compression=compression,
                           compression_opts=compression_opts if compression is not None else None)
        grp.attrs["original_size"] = np.asarray(original_size)
        grp.attrs["input_size"] = np.asarray(input_size)

    def close(self) -> None:
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class EmbeddingReader:
    """Reads an embeddings h5.  The decoder head needs only ``features``,
    ``sizes``, ``checkpoint`` and ``img_encoder_img_size``: any object with
    those reads the same way (e.g. embeddings held in memory)."""

    def __init__(self, path):
        import h5py

        self.f = h5py.File(path, "r")
        self.group = self.f["img_embedding"]
        self.checkpoint = self.f.attrs["checkpoint"]
        self.img_encoder_img_size = int(self.f.attrs["img_encoder_img_size"])

    def stems(self) -> List[str]:
        return list(self.group.keys())

    def features(self, stem: str) -> np.ndarray:
        return self.group[stem]["features"][:]

    def sizes(self, stem: str) -> Tuple[np.ndarray, np.ndarray]:
        """(original_size, input_size), each (2,) as (H, W)."""
        g = self.group[stem]
        return np.asarray(g.attrs["original_size"]), np.asarray(g.attrs["input_size"])

    def close(self) -> None:
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class MemoryEmbeddings:
    """Embeddings held in memory (on any device), read as
    :class:`EmbeddingReader` reads an h5 file: ``features(stem)`` (1, C, G, G)
    and ``sizes(stem)`` (original, input); written as
    :class:`EmbeddingWriter` writes one, ``write`` keeping a copy.  For runs
    that make their embeddings themselves (the bench, ``chip_smoke.py``) and
    machines without ``h5py``."""

    def __init__(self, img_encoder_img_size: int, features: Optional[dict] = None,
                 sizes: Optional[dict] = None, checkpoint: str = "random-weights"):
        self.img_encoder_img_size = img_encoder_img_size
        self.checkpoint = checkpoint
        self._features = {} if features is None else features
        self._sizes = {} if sizes is None else sizes

    def write(self, stem: str, features, original_size: Tuple[int, int],
              input_size: Tuple[int, int]) -> None:
        self._features[stem] = np.array(features, np.float32)
        self._sizes[stem] = (np.asarray(original_size), np.asarray(input_size))

    def existing_stems(self) -> Set[str]:
        return set(self._features)

    def stems(self) -> List[str]:
        return list(self._features)

    def features(self, stem: str):
        return self._features[stem]

    def sizes(self, stem: str):
        return self._sizes[stem]


class MaskWriter:
    def __init__(self, path, labels: Dict[str, int] = None, attrs: dict = None):
        import h5py

        Path(path).parent.mkdir(parents=True, exist_ok=True)
        self.f = h5py.File(path, "w")
        self.f.attrs["labels"] = json.dumps(labels or BONE_LABEL_MAPPING)
        for k, v in (attrs or {}).items():
            self.f.attrs[k] = v

    def write(self, stem: str, masks, estimated_dice=None, compression="gzip",
              compression_opts=9) -> None:
        ds = self.f.create_dataset(f"segmentation_mask/{stem}", data=np.asarray(masks),
                                   compression=compression, compression_opts=compression_opts)
        if estimated_dice is not None:
            ds.attrs["estimated_dice"] = np.asarray(estimated_dice)

    def close(self) -> None:
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class MaskReader:
    def __init__(self, path, check_labels: bool = True):
        import h5py

        self.f = h5py.File(path, "r")
        self.labels = json.loads(self.f.attrs["labels"])
        if check_labels and self.labels != BONE_LABEL_MAPPING:
            self.f.close()
            raise ValueError("Loaded labels do not match")
        self.group = self.f["segmentation_mask"]

    def stems(self) -> List[str]:
        return list(self.group.keys())

    def masks(self, stem: str) -> np.ndarray:
        return self.group[stem][:]

    def estimated_dice(self, stem: str) -> np.ndarray:
        return np.asarray(self.group[stem].attrs.get("estimated_dice"))

    def close(self) -> None:
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class MemoryMasks:
    """Masks held in memory, written as :class:`MaskWriter` writes a file
    (``write`` keeping a copy) and read as :class:`MaskReader` reads one.
    For machines without ``h5py`` (``chip_smoke.py``)."""

    def __init__(self, labels: Dict[str, int] = None):
        self.labels = dict(labels or BONE_LABEL_MAPPING)
        self._masks: Dict[str, np.ndarray] = {}
        self._dice: Dict[str, np.ndarray] = {}

    def write(self, stem: str, masks, estimated_dice=None) -> None:
        self._masks[stem] = np.array(masks)
        if estimated_dice is not None:
            self._dice[stem] = np.array(estimated_dice)

    def stems(self) -> List[str]:
        return list(self._masks)

    def masks(self, stem: str) -> np.ndarray:
        return self._masks[stem]

    def estimated_dice(self, stem: str) -> np.ndarray:
        return np.asarray(self._dice.get(stem))


def _check_shard_counts(parts) -> None:
    """Cross-check each part's write-time ``shard_count`` attr against the
    merge set: a leftover part from an earlier run with a DIFFERENT process
    count can be contiguous (part0..partN all overwritten except the tail),
    so index contiguity alone cannot catch it; provenance can.  Parts
    without the attr (written before it existed) are accepted."""
    import h5py

    counts = {}
    for p in parts:
        with h5py.File(p, "r") as f:
            c = f.attrs.get("shard_count")
        if c is not None:
            counts[p] = int(c)
    for p, c in counts.items():
        if c != len(parts):
            raise ValueError(
                f"{p} was written by a {c}-process run but {len(parts)} "
                f"shards are being merged: stale .part files from an "
                f"earlier run?")


def merge_h5_shards(out_h5, group: str, check_attr: str, n_processes: int = None,
                    delete_parts: bool = False) -> Path:
    """Merge per-process ``<out>.part<p>`` h5 files written by a multi-process
    sweep into one file (JAX ``merge_h5_shards``): every member of ``group``
    is copied (per-item attrs preserved), file attrs come from part 0, and
    ``check_attr`` must agree across parts.  Three stale-shard guards:
    auto-globbed part indices must be contiguous 0..N-1, each part's
    write-time ``shard_count`` provenance must equal the merge-set size, and
    the merged file drops ``shard_count`` (it is no longer one shard of an
    N-way run)."""
    import glob

    import h5py

    out_h5 = Path(out_h5)
    if n_processes is None:
        parts = sorted(glob.glob(str(out_h5) + ".part*"))
        if not parts:
            raise FileNotFoundError(f"no shard files matching {out_h5}.part*")
        idx = sorted(int(Path(p).suffix[len(".part"):]) for p in parts)
        if idx != list(range(len(idx))):
            raise ValueError(
                f"shard indices {idx} are not contiguous 0..{len(idx) - 1}: "
                f"stale .part files from an earlier run? Pass n_processes "
                f"or delete the extras")
    else:
        parts = [f"{out_h5}.part{p}" for p in range(n_processes)]
    _check_shard_counts(parts)
    with h5py.File(out_h5, "w") as dst:
        for i, part in enumerate(parts):
            with h5py.File(part, "r") as src:
                if i == 0:
                    for k, v in src.attrs.items():
                        if k != "shard_count":
                            dst.attrs[k] = v
                elif src.attrs[check_attr] != dst.attrs[check_attr]:
                    raise ValueError(f"shard {part} with different {check_attr}")
                for stem in src.get(group, {}):
                    src.copy(f"{group}/{stem}", dst, f"{group}/{stem}")
    if delete_parts:
        for part in parts:
            Path(part).unlink()
    return out_h5


def merge_mask_shards(out_h5, n_processes: int = None, delete_parts: bool = False) -> Path:
    """Merge per-process ``<out>.part<p>`` mask files written by a
    multi-process ``save_refined_segmentations`` sweep into one mask h5
    (same schema, file attrs copied from part 0; per-image
    ``estimated_dice`` attrs preserved).  Run in one process after every
    process has finished: the mask counterpart of
    ``engine/embeddings.py:merge_embedding_shards``."""
    return merge_h5_shards(out_h5, "segmentation_mask", "labels",
                           n_processes=n_processes, delete_parts=delete_parts)
