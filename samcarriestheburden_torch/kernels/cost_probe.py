"""K13: the bench's cost probe, ``o = x * 2.0`` over a bf16 tensor (JAX
``bench.py:104``, the ``pallas_call`` of ``flops_convention_check``).

The JAX bench launches it with a declared ``CostEstimate(flops=1234567)`` to
check that a custom kernel's declared cost reaches XLA's counted total.  Here
the kernel is the operator ``samcarriestheburden::cost_probe(x, declared)``,
defined once when this module is imported: its CPU implementation is the
plain version, its CUDA implementation launches K13 on the current stream,
and its flop formula (``torch.utils.flop_counter``) returns ``declared``, so
``FlopCounterMode`` counts exactly the declared cost for a call.

The probe's tensor is small (128 x 128 in the bench), so its time is the
host's: the operator is defined with ``torch.library.Library`` and its
kernels registered for the CPU and CUDA dispatch keys directly, so that a
call runs no Python autograd layer (``torch.library.custom_op`` adds one),
and the CUDA kernel looks its C function up once and checks its input in
one pass.  :data:`cost_probe` is the operator itself: a CPU tensor takes the
plain version, a CUDA one K13.
"""

from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from samcarriestheburden_torch.kernels import LAUNCHES, build, raise_on_error, stream

_LIB = torch.library.Library("samcarriestheburden", "DEF")
_LIB.define("cost_probe(Tensor x, int declared) -> Tensor")

#: the C launch function, typed, once the first CUDA call has loaded it
_launch = None
_BF16 = torch.bfloat16


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


def _cost_probe_cpu(x: torch.Tensor, declared: int) -> torch.Tensor:
    return cost_probe_plain(x)


def _cost_probe_cuda(x: torch.Tensor, declared: int) -> torch.Tensor:
    global _launch
    xp = x.data_ptr()
    if x.dtype != _BF16 or xp % 16 or not x.is_contiguous():
        raise ValueError(f"K13 cost_probe: x must be a contiguous, 16-byte aligned bf16 tensor, "
                         f"got {x.dtype}, contiguous {x.is_contiguous()}")
    out = torch.empty_like(x)
    if _launch is None:
        _launch = _lib().k13_cost_probe
    code = _launch(xp, out.data_ptr(), x.numel(), stream())
    if code != 0:
        raise_on_error("K13 cost_probe", code)
    LAUNCHES["K13"] += 1
    return out


def _cost_probe_fake(x: torch.Tensor, declared: int) -> torch.Tensor:
    return torch.empty_like(x)


_LIB.impl("cost_probe", _cost_probe_cpu, "CPU")
_LIB.impl("cost_probe", _cost_probe_cuda, "CUDA")
torch.library.register_fake("samcarriestheburden::cost_probe", _cost_probe_fake, lib=_LIB)

#: ``cost_probe(x, declared)``: ``x * 2.0``, counted by ``FlopCounterMode`` as
#: ``declared`` operations
cost_probe = torch.ops.samcarriestheburden.cost_probe.default


@register_flop_formula(torch.ops.samcarriestheburden.cost_probe)
def _cost_probe_flops(x_shape, declared: int, *args, **kwargs) -> int:
    return declared
