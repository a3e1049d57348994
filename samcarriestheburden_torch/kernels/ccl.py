"""K8: connected-component label propagation (JAX ``ops/ccl.py:connected_components_pallas``).

Per (H, W) map of a (M, H, W) float stack: 8-connected max-label propagation
from ``init = (row * W + col + 1) * (mask > 0.5)``, each step a 3x3 window
max gated to the foreground, run in chunks of ``min(check_every,
num_iterations - i)`` steps until the cap or a chunk that changed nothing.
Returns int32 labels (M, H, W), a per-map converged flag and the steps each
map ran.  The CUDA kernels (``csrc/ccl.cu``) give every map a thread-block
cluster that keeps the map on chip: ``ccl_reg_kernel`` holds it in registers
and meets its cluster once per group of up to ``REG_DEPTH`` steps (the main
path's maps), ``ccl_prop_kernel`` holds it in shared memory and meets once
per step (wider or taller maps); :func:`geometry` picks one from (H, W).  The
plain version runs the same steps and chunk bookkeeping on the whole stack,
each map stopping at its own fixpoint.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from samcarriestheburden_torch.kernels import LAUNCHES, build, ptr, raise_on_error, stream

_VP, _I = ctypes.c_void_p, ctypes.c_int

#: shared memory one block of the kernel may use (the H100's 227 KB opt-in
#: limit, less a margin for the kernel's static flags)
SMEM_BYTES = 232448 - 1024
MAX_CLUSTER = 8
#: ``ccl_reg_kernel``'s fixed geometry (``csrc/ccl.cu``: kRegWarps,
#: kRowsPerWarp, kHalo, kDepth, kMaxCols): 16 warps of 8 rows hold a band and
#: its two halos of 16 rows, so a band has at most 96 rows; a lane holds up to
#: 8 columns, so a map at most 256
REG_WARPS, REG_ROWS_PER_WARP, REG_HALO, REG_DEPTH, REG_MAX_COLS = 16, 8, 16, 16, 8
REG_MAX_BAND = REG_WARPS * REG_ROWS_PER_WARP - 2 * REG_HALO


class Geometry(NamedTuple):
    """How K8 lays out one (H, W) map: which kernel, blocks per map, columns
    per lane (0: the shared-memory kernel), halo rows and steps per cluster
    barrier."""
    kernel: str          # "registers" or "shared"
    cluster: int
    cols_per_lane: int
    halo: int
    depth: int


def geometry(h: int, w: int) -> Geometry:
    """K8's layout of an (h, w) map, from the shape alone: the register
    kernel with ``ceil(w / 32)`` columns per lane and the smallest cluster
    whose bands have at most ``REG_MAX_BAND`` rows, where both fit; else the
    shared-memory kernel (:func:`cluster_size`), which raises for a map no
    cluster holds."""
    cols = -(-w // 32)
    if cols <= REG_MAX_COLS:
        size = 1
        while size <= MAX_CLUSTER:
            if -(-h // size) <= REG_MAX_BAND:
                return Geometry("registers", size, cols, REG_HALO, REG_DEPTH)
            size *= 2
    return Geometry("shared", cluster_size(h, w), 0, 1, 1)


def barrier_groups(num_iterations: int, check_every: int, depth: int = REG_DEPTH
                   ) -> List[List[int]]:
    """The steps the register kernel runs between cluster barriers, chunk by
    chunk, if no chunk ends the run early: each chunk of ``min(check_every,
    num_iterations - i)`` steps splits into groups of ``depth`` and the rest,
    so no group crosses a chunk's end (``csrc/ccl.cu:ccl_reg_kernel``)."""
    chunks, i = [], 0
    while i < num_iterations:
        n = min(check_every, num_iterations - i)
        chunks.append([min(depth, n - s) for s in range(0, n, depth)])
        i += n
    return chunks


def _lib():
    lib = build.load("ccl")
    if not getattr(lib, "_typed", False):
        lib.k8_ccl_propagate.argtypes = [_VP] * 4 + [_I] * 7 + [_VP]
        lib.k8_ccl_propagate.restype = _I
        lib._typed = True
    return lib


def cluster_size(h: int, w: int) -> int:
    """Blocks per map of the shared-memory kernel: the smallest power of two
    whose bands of ``ceil(h / size)`` rows fit two int32 label buffers in one
    block's shared memory.  Raises for a map no cluster of up to 8 blocks can
    hold."""
    size = 1
    while size <= MAX_CLUSTER:
        if 2 * -(-h // size) * w * 4 <= SMEM_BYTES:
            return size
        size *= 2
    raise ValueError(f"K8 takes maps of at most {MAX_CLUSTER} x {SMEM_BYTES // 8} "
                     f"pixels per band; got ({h}, {w})")


def _check_args(mask: torch.Tensor, check_every: int) -> None:
    if mask.ndim != 3:
        raise ValueError(f"K8: expected a (maps, H, W) stack, got shape {tuple(mask.shape)}")
    if check_every < 1:
        raise ValueError(f"K8: check_every must be >= 1, got {check_every}")


def propagate_plain(mask: torch.Tensor, num_iterations: int, check_every: int = 16
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K8: (labels int32, converged bool (M,), steps int32 (M,)).

    The 3x3 max is ``max_pool2d`` on float32 labels (exact: labels are below
    2**24); only the maps still running are stepped."""
    _check_args(mask, check_every)
    m, h, w = mask.shape
    dev = mask.device
    fg = mask > 0.5
    labels = torch.arange(1, h * w + 1, dtype=torch.int32, device=dev).view(h, w) * fg
    done = torch.zeros(m, dtype=torch.bool, device=dev)
    steps = torch.zeros(m, dtype=torch.int32, device=dev)
    i = 0
    while i < num_iterations and not bool(done.all()):
        n = min(check_every, num_iterations - i)
        act = (~done).nonzero().squeeze(1)
        start = labels[act]
        gate = fg[act, None].float()
        cur = start[:, None].float()
        for _ in range(n):
            cur = F.max_pool2d(cur, 3, stride=1, padding=1) * gate
        new = cur[:, 0].int()
        labels[act] = new
        steps[act] += n
        done[act] = (new == start).flatten(1).all(1)
        i += n
    return labels, done, steps


def propagate(mask: torch.Tensor, num_iterations: int, check_every: int = 16
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K8: the plain version for a CPU tensor, the CUDA kernel for a CUDA
    tensor.  ``mask``: (M, H, W) float32, contiguous."""
    if mask.device.type == "cpu":
        return propagate_plain(mask, num_iterations, check_every)
    _check_args(mask, check_every)
    if mask.device.type != "cuda" or mask.dtype != torch.float32 or not mask.is_contiguous():
        raise ValueError(f"K8: expected a contiguous float32 CUDA tensor, got "
                         f"{mask.dtype} on {mask.device}")
    m, h, w = mask.shape
    geo = geometry(h, w)
    labels = torch.empty((m, h, w), dtype=torch.int32, device=mask.device)
    converged = torch.empty((m,), dtype=torch.int32, device=mask.device)
    steps = torch.empty((m,), dtype=torch.int32, device=mask.device)
    if m == 0:
        return labels, converged.bool(), steps
    cap = min(max(0, num_iterations), 2**31 - 1)
    code = _lib().k8_ccl_propagate(ptr(mask), ptr(labels), ptr(converged), ptr(steps),
                                   m, h, w, cap, check_every, geo.cluster, geo.cols_per_lane,
                                   stream())
    raise_on_error("K8 ccl_propagate", code)
    LAUNCHES["K8"] += 1
    return labels, converged.bool(), steps
