"""K4's share of its roofline, in %, keyed on the program's own span: the
least time of the traced window's K4 launches (``harness/flops.py:
encoder_mlp_bounds`` at each encoder call's shape) over the device time
charged to the window's ``kernels.K4`` spans (``kernels/quant.py:
ln_mlp_residual_int8``; ``harness/program_trace.py``), whatever kernels K4
is made of.  There must be one span a launch, ``encode_calls`` ×
``encoder_depth`` of them, each charged some device time; otherwise the
reader says so on standard error and reports nothing."""

import sys

from harness import flops
from harness.program_trace import program_of


def read(run):
    c, traffic, prog = run["config"], run["traffic"], program_of(run)
    if prog is None or traffic.get("quantize") != "int8":
        return None
    spans = [i for i, s in enumerate(prog.spans) if s.name == "kernels.K4"]
    calls = run["window"].counts["encode_calls"]
    secs = [prog.device_by_index.get(i, 0.0) for i in spans]
    if not spans or len(spans) != calls * c["encoder_depth"] or min(secs) <= 0.0:
        print(f"k4_roofline.program: not reported: {len(spans)} kernels.K4 spans for "
              f"{calls} encoder calls of {c['encoder_depth']} blocks, "
              f"{sum(s <= 0.0 for s in secs)} of them charged no device time", file=sys.stderr)
        return None
    least = calls * flops.encoder_mlp_bounds(c, traffic["batch_size"], True)
    return 100.0 * least / sum(secs)
