"""K13: the bench's cost probe, ``o = x * 2.0`` over a bf16 tensor (JAX
``bench.py:104``, the ``pallas_call`` of ``flops_convention_check``).

The JAX bench launches it with a declared ``CostEstimate(flops=1234567)`` to
check that a custom kernel's declared cost reaches XLA's counted total.  Here
the kernel is the custom op ``samcarriestheburden::cost_probe(x, declared)``,
defined once when this module is imported: its CPU implementation is the
plain version, its CUDA implementation launches K13 on the current stream,
and its flop formula (``torch.utils.flop_counter``) returns ``declared``, so
``FlopCounterMode`` counts exactly the declared cost for a call.
"""

from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from samcarriestheburden_torch.kernels import (LAUNCHES, build, check_cuda, ptr, raise_on_error,
                                               stream)


def _lib():
    lib = build.load("cost_probe")
    if not getattr(lib, "_typed", False):
        lib.k13_cost_probe.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                                       ctypes.c_void_p]
        lib.k13_cost_probe.restype = ctypes.c_int
        lib._typed = True
    return lib


def cost_probe_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of K13."""
    return x * 2.0


@torch.library.custom_op("samcarriestheburden::cost_probe", mutates_args=(),
                         device_types="cpu")
def cost_probe(x: torch.Tensor, declared: int) -> torch.Tensor:
    """``x * 2.0``, counted by ``FlopCounterMode`` as ``declared`` operations.
    A CPU tensor takes the plain version, a CUDA one K13."""
    return cost_probe_plain(x)


@cost_probe.register_kernel("cuda")
def _cost_probe_cuda(x: torch.Tensor, declared: int) -> torch.Tensor:
    check_cuda("x", x, x.shape, torch.bfloat16)
    out = torch.empty_like(x)
    raise_on_error("K13 cost_probe", _lib().k13_cost_probe(ptr(x), ptr(out), x.numel(), stream()))
    LAUNCHES["K13"] += 1
    return out


@cost_probe.register_fake
def _cost_probe_fake(x: torch.Tensor, declared: int) -> torch.Tensor:
    return torch.empty_like(x)


@register_flop_formula(torch.ops.samcarriestheburden.cost_probe)
def _cost_probe_flops(x_shape, declared: int, *args, **kwargs) -> int:
    return declared
