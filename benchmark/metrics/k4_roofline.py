"""K4's share of its roofline, in %: the least time of the traced window's
K4 launches (``kernels/quant.py:fused_ln_mlp_residual_int8``: LN and row
quantization, lin1 with GELU, the hidden's chunked quantization, lin2 with
the residual; ``harness/flops.py:mlp_kernel_bound`` at each launch's call
shape) over their summed device time in the trace.

The launches are found in the trace by their CUDA kernels' names, as K4
builds them today, and counted against the program's own count of K4
launches.  Where K4 ran but the trace's groups do not match that count (a
later K4 made of other kernels), the reader says so on standard error and
reports nothing: a roofline of part of the launches would read too high.
"""

import sys

from harness import flops
from harness.tracing import launch_groups

KERNELS = ("quant_chunks_kernel", ["ln_quant_rows_kernel", "gemm_s8_kernel<1"],
           ["gemm_s8_kernel<3"])


def read(run):
    c, traffic = run["config"], run["traffic"]
    launched = run["launches"].get("K4", 0)
    if traffic.get("quantize") != "int8" or not launched:
        return None
    calls = run["window"].counts["encode_calls"]
    found = launch_groups(run["trace"], *KERNELS)
    if not found or found[0] != launched or launched != calls * c["encoder_depth"]:
        print(f"k4_roofline: not reported: K4 launched {launched} times in the window "
              f"({calls} encoder calls), the trace holds "
              f"{found[0] if found else 'no whole'} groups of {KERNELS}", file=sys.stderr)
        return None
    least = calls * flops.encoder_mlp_bounds(c, traffic["batch_size"], True)
    return 100.0 * least / found[1]
