"""K14: the bare matrix product ``a @ w.T`` (JAX ``tools/exp_int8.py:pallas_dot``
and ``tools/exp_3d.py:dot3d``, ``dotreshape``, ``dot2d``).

``dot(a, w, out_dtype)`` takes ``a`` (M, K) and ``w`` (N, K), the port's
``(out, in)`` weight layout, and computes one of three functions:

* bf16 x bf16 -> fp32 (``out_dtype=torch.float32``);
* bf16 x bf16 -> bf16, accumulated in fp32 and rounded once;
* int8 x int8 -> int32, exact.

The CUDA kernel (``csrc/gemm.cu``) is the TMA + wgmma mainloop of K2, K4 and
K15 (``csrc/gemm_sm90.cuh``) with an epilogue that only stores, so its time is
what those kernels' products reach alone.
The plain version multiplies in float64 and converts the product to the
output type: exact for int8 (the accumulants stay far below 2^53), one
rounding for fp32, and for bf16 PyTorch's conversion from float64 (through
fp32).
"""

from __future__ import annotations

import ctypes

import torch

from samcarriestheburden_torch.kernels import (LAUNCHES, build, check_cuda, ptr,
                                               raise_on_error, stream)

#: output type -> (input type, the kernel's mode)
MODES = {torch.float32: (torch.bfloat16, 0), torch.bfloat16: (torch.bfloat16, 1),
         torch.int32: (torch.int8, 2)}


def _lib():
    lib = build.load("gemm")
    if not getattr(lib, "_typed", False):
        lib.k14_dot.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.k14_dot.restype = ctypes.c_int
        lib._typed = True
    return lib


def _input_type(a, w, out_dtype):
    if out_dtype not in MODES:
        raise ValueError(f"out_dtype must be one of {list(MODES)}, got {out_dtype}")
    in_dtype = MODES[out_dtype][0]
    if a.dtype != in_dtype or w.dtype != in_dtype:
        raise ValueError(f"a {out_dtype} product takes {in_dtype} operands, got {a.dtype} "
                         f"and {w.dtype}")
    return in_dtype


def dot_plain(a: torch.Tensor, w: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
    """Plain version of K14: ``a @ w.T`` in float64, converted to ``out_dtype``."""
    _input_type(a, w, out_dtype)
    return (a.double() @ w.double().T).to(out_dtype)


def dot(a: torch.Tensor, w: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
    """K14: plain version for a CPU tensor, the CUDA kernel for a CUDA tensor."""
    in_dtype = _input_type(a, w, out_dtype)
    if a.device.type == "cpu":
        return dot_plain(a, w, out_dtype)
    m, k = a.shape
    n = w.shape[0]
    check_cuda("a", a, (m, k), in_dtype)
    check_cuda("w", w, (n, k), in_dtype)
    if k * a.element_size() % 16 or n % 8:
        raise ValueError(f"K14 needs K a multiple of 16 bytes and N of 8, got {k}, {n}")
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    code = _lib().k14_dot(ptr(a), ptr(w), ptr(out), m, n, k, MODES[out_dtype][1], stream())
    raise_on_error("K14 dot", code)
    LAUNCHES["K14"] += 1
    return out
