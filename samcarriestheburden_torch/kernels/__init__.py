"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

Every wrapper here runs its plain version for a tensor on the CPU and
launches its CUDA kernel for a tensor on the card; there is no fallback
between the two.  Each wrapper counts its launches in :data:`LAUNCHES`, so a
run can show that its path went through the kernels.  The helpers below are
what every wrapper does around a ``ctypes`` launch.
"""

from __future__ import annotations

from typing import Optional

import torch

#: launches of each kernel since the last :func:`reset_launches`, by name
LAUNCHES = {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0, "K6": 0, "K7": 0, "K7-int8": 0,
            "K7-pv": 0, "K7-int8pv": 0, "K8": 0, "K9": 0, "K10": 0, "K11": 0, "K12": 0,
            "K13": 0, "K14": 0, "K15": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def check_cuda(name: str, t: torch.Tensor, shape, dtype) -> None:
    """Raise unless ``t`` is a contiguous, 16-byte aligned CUDA tensor of
    ``shape`` and ``dtype``: what the kernels' cp.async loads require."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: must be contiguous and 16-byte aligned")


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """A tensor's device address for ``ctypes`` (None for an absent operand)."""
    return None if t is None else t.data_ptr()


def stream() -> int:
    """PyTorch's current CUDA stream, where every kernel launches."""
    return torch.cuda.current_stream().cuda_stream


def raise_on_error(kernel: str, code: int) -> None:
    """Raise on the ``cudaError_t`` a launch function returned."""
    if code != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError {code}")
