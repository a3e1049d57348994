"""HDF5 embedding store, the same schema as the JAX package's ``data/h5io.py``
(reference scripts/generate_img_embeddings.py:31-70), so files written by
either package read in the other:

``img_embedding/<stem>/features`` float32 (1, 256, 64, 64) with per-image
attrs ``original_size`` (2,) and ``input_size`` (2,); file attrs
``checkpoint`` (the weights' file name) and ``img_encoder_img_size``.

``h5py`` is imported when a file is opened, not with this module: the port
runs without it wherever no h5 file is read or written.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Set, Tuple

import numpy as np


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
    and ``sizes(stem)`` (original, input).  For runs that make their
    embeddings themselves (the bench, ``chip_smoke.py``) and machines without
    ``h5py``."""

    def __init__(self, img_encoder_img_size: int, features: dict, sizes: dict,
                 checkpoint: str = "random-weights"):
        self.img_encoder_img_size = img_encoder_img_size
        self.checkpoint = checkpoint
        self._features, self._sizes = features, sizes

    def stems(self) -> List[str]:
        return list(self._features)

    def features(self, stem: str):
        return self._features[stem]

    def sizes(self, stem: str):
        return self._sizes[stem]
