"""ctypes loader for the host kernels of ``native/sctb_native.cpp`` (JAX
``native.py``).

The port reads the source from the repository's ``native/`` and compiles it
with ``g++`` at first use into ``samcarriestheburden_torch/_build/`` (listed
in ``.gitignore``), as ``libsctb_native-<digest>.so``, keyed by the source and
the flags, as ``kernels/build.py`` keys the CUDA libraries: an edited source
is rebuilt, a stale library never loaded.  It exposes:

* :func:`rle_encode` / :func:`rle_decode`: pycocotools-format RLE, the AMG
  finalisation's hot path (thousands of masks per image);
* :func:`connected_components_with_areas`: 8-connectivity union-find CCL for
  the small-region postprocess.

A failed build raises (``RuntimeError``): nothing here falls back.  The
callers choose their numpy paths explicitly (``ops/rle.py``'s
``use_native=False``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "native" / "sctb_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
FLAGS = ("-O3", "-shared", "-fPIC")

_LIB: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libsctb_native-{digest[:16]}.so"


def build() -> Path:
    """Compile the source unless its current library exists; the library's path."""
    if not SOURCE.exists():
        raise RuntimeError(f"the native source {SOURCE} is missing")
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as exc:
        raise RuntimeError(f"g++ could not build {SOURCE.name}: {exc}") from exc
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCE.name} (exit {proc.returncode}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises if it cannot be."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        lib.rle_encode_fortran.restype = ctypes.c_int
        lib.rle_encode_fortran.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
        lib.rle_decode_fortran.restype = None
        lib.rle_decode_fortran.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8)]
        lib.connected_components_8.restype = ctypes.c_int
        lib.connected_components_8.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
        _LIB = lib
    return _LIB


def _u8(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i32(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def rle_encode(mask: np.ndarray) -> list:
    """(H, W) bool -> run lengths in column-major order, background first."""
    lib = load()
    mask = np.ascontiguousarray(mask, np.uint8)
    h, w = mask.shape
    cap = h * w + 2
    out = np.empty(cap, np.int32)
    n = lib.rle_encode_fortran(_u8(mask), h, w, _i32(out), cap)
    if n < 0:
        raise RuntimeError("rle_encode_fortran overflowed its h * w + 2 runs")
    return out[:n].tolist()


def rle_decode(counts, h: int, w: int) -> np.ndarray:
    """Run lengths -> (H, W) bool (the inverse of :func:`rle_encode`)."""
    lib = load()
    counts_arr = np.ascontiguousarray(counts, np.int32)
    out = np.empty((h, w), np.uint8)
    lib.rle_decode_fortran(_i32(counts_arr), len(counts_arr), h, w, _u8(out))
    return out.astype(bool)


def connected_components_with_areas(mask: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(H, W) bool -> (int32 labels, 0 the background, 1..n the components in
    first-seen order; areas (n + 1,), the background's first)."""
    lib = load()
    mask = np.ascontiguousarray(mask, np.uint8)
    h, w = mask.shape
    labels = np.empty((h, w), np.int32)
    max_labels = h * w // 2 + 2
    areas = np.empty(max_labels, np.int32)
    n = lib.connected_components_8(_u8(mask), h, w, _i32(labels), _i32(areas), max_labels)
    if n < 0:
        raise RuntimeError("connected_components_8 ran out of its label table")
    return labels, areas[:n].copy()
