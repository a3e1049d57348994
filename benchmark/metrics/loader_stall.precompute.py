"""The share of the traced window, in %, that the device sat idle while the
precompute's loop waited for its loaders: idle gaps charged to the
program's ``encode_images.load_wait`` spans (``harness/program_trace.py``)
over the window."""

from harness.program_trace import program_of


def read(run):
    t, prog = run["trace"], program_of(run)
    if prog is None or not prog.count("encode_images.load_wait"):
        return None
    return 100.0 * t.idle_by_span.get("encode_images.load_wait", 0.0) / t.window_s
