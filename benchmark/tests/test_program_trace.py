"""The program's spans on the device trace (``harness/program_trace.py``) and
the five readers of ``metrics/`` that read them, on hand-made traces; and,
on the card (``-m chip``), a traced run of each cell that reports every
per-layer metric of its cell and the program's counters."""

import json
import subprocess
import sys
from types import SimpleNamespace

import pytest

from harness import core, flops
from harness import program_trace as pt
from harness.tracing import Trace

MAN = core.manifest()


def ev(cat, name, ts, dur, corr, stream=7):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": stream,
            "args": {"stream": stream, "correlation": corr}}


def call(ts, corr, tid=11, dur=1.0):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": {"correlation": corr}}


def rec(*spans, counters=None):
    """A recording as the program's ``profiling.recording`` leaves it:
    spans of (start ns, end ns, name, parent) on the thread 1."""
    return SimpleNamespace(spans=[SimpleNamespace(start_ns=a, end_ns=b, name=n, thread=1,
                                                  parent=p, batch=None, round=None)
                                  for a, b, n, p in spans], counters=counters or {})


def test_reduce_joins_the_clocks_on_the_markers_launch_and_names_the_gaps():
    # host µs = trace µs - 1000; the marker's launch at host 5..7 (trace 1005)
    events = [ev("kernel", "at::cuda::spin_kernel(long)", 1020, 5, 1), call(1005, 1, dur=2),
              ev("kernel", "gemm", 1110, 20, 2), call(1105, 2),      # in K4
              ev("kernel", "add", 1150, 30, 3), call(1135, 3),       # dispatch
              ev("kernel", "copy", 1200, 10, 4), call(1150, 4)]      # no program span
    r = rec((100e3, 145e3, "encode_images.dispatch", -1), (102e3, 130e3, "kernels.K4", 0),
            (160e3, 195e3, "encode_images.load_wait", -1),
            counters={"encode_images.batches_waited": 1})
    harness = [(90e3, 220e3, "loops.encode_images")]
    t = pt.reduce(events, (4.0, 8.0), (90.0, 220.0), harness, r, ident=1)
    assert t.window_s == pytest.approx(130e-6) and t.busy_s == pytest.approx(60e-6)
    p = t.program
    assert [s.start for s in p.spans] == pytest.approx([1100, 1102, 1160])
    assert p.counters == {"encode_images.batches_waited": 1}
    assert p.device_by_span == pytest.approx({"kernels.K4": 20e-6,
                                              "encode_images.dispatch": 30e-6,
                                              pt.OUTSIDE: 10e-6})
    assert p.device_by_index == pytest.approx({1: 20e-6, 0: 30e-6})
    # idle: 1090..1110 (middle 1100, before K4's start) and 1130..1150 to
    # dispatch, 1180..1200 to load_wait, 1210..1220 to the benchmark's span
    assert t.idle_by_span == pytest.approx({"encode_images.dispatch": 40e-6,
                                            "encode_images.load_wait": 20e-6,
                                            "loops.encode_images": 10e-6})
    # a program without a recording: the trace as before, no program part
    t0 = pt.reduce(events, (4.0, 8.0), (90.0, 220.0), harness, None, ident=1)
    assert t0.program is None and t0.idle_by_span == {"loops.encode_images": 70e-6}


def traced(program, busy_s=1.0, window_s=2.0, idle=None):
    trace = Trace(window_s=window_s, busy_s=busy_s, idle_by_span=idle or {},
                  device_by_name={})
    return pt.Traced(**vars(trace), program=program)


def span(name):
    return pt.Span(0, 1, name, 1, -1, None, None)


def run_of(workload, trace, **counts):
    _, _, config, traffic = core.cell(MAN, workload)
    return {"trace": trace, "config": config, "traffic": traffic, "launches": {},
            "window": SimpleNamespace(counts=counts), "workload": workload}


def read(metric, run):
    return core.load_module(core.BENCH_DIR / "metrics" / f"{metric}.py").read(run)


def test_k4_roofline_program_keys_on_the_spans(capsys):
    name = "sam_vit_h.precompute_int8"
    c = core.cell(MAN, name)[2]
    calls, depth = 2, c["encoder_depth"]
    least = calls * flops.encoder_mlp_bounds(c, 32, True)
    spans = [span("models.encode")] + [span("kernels.K4")] * (calls * depth)
    per = least / 0.28 / (calls * depth)
    prog = pt.Program(spans, {}, {i: per for i in range(1, len(spans))}, {})
    assert read("k4_roofline.program", run_of(name, traced(prog), encode_calls=calls)) == \
        pytest.approx(28.0)
    # a launch with no device time charged, or a span too few: nothing reported
    prog.device_by_index[5] = 0.0
    assert read("k4_roofline.program", run_of(name, traced(prog), encode_calls=calls)) is None
    assert "1 of them charged no device time" in capsys.readouterr().err
    prog = pt.Program(spans[:-1], {}, {i: per for i in range(1, len(spans) - 1)}, {})
    assert read("k4_roofline.program", run_of(name, traced(prog), encode_calls=calls)) is None


@pytest.mark.parametrize("metric, workload, span_name", [
    ("decode_share.refine", "sam_vit_h.refine", "enhance.decode"),
    ("select_share.refine", "sam_vit_h.refine", "enhance.select"),
    ("augment_share.train", "unet_grazpedwri.train", "trainer.augment")])
def test_device_shares_read_their_spans(metric, workload, span_name):
    prog = pt.Program([span(span_name), span("other")], {}, {0: 0.25, 1: 0.5},
                      {span_name: 0.25, "other": 0.5})
    assert read(metric, run_of(workload, traced(prog, busy_s=1.25))) == pytest.approx(20.0)
    # no such span recorded, or no program part (a parent without spans)
    assert read(metric, run_of(workload, traced(pt.Program([span("other")], {})))) is None
    assert read(metric, run_of(workload, traced(None))) is None


def test_decode_share_counts_the_kernel_spans_nested_in_the_decode():
    """D1's launches are charged to its own ``kernels.D1`` span, the
    innermost open at their launch; the decode's share takes them in, and
    takes in nothing outside ``enhance.decode``."""
    # host µs = trace µs - 1000; the marker's launch at host 5..7 (trace 1005)
    events = [ev("kernel", "at::cuda::spin_kernel(long)", 1020, 5, 1), call(1005, 1, dur=2),
              ev("kernel", "gemm", 1110, 20, 2), call(1102, 2),       # decode, round 1
              ev("kernel", "d1_kernel", 1130, 30, 3), call(1106, 3),  # its D1
              ev("kernel", "add", 1160, 10, 4), call(1111, 4),        # decode again
              ev("kernel", "d1_kernel", 1180, 40, 5), call(1175, 5),  # D1 in no decode
              ev("kernel", "hist", 1220, 20, 6), call(1190, 6)]       # enhance.select
    r = rec((100e3, 115e3, "enhance.decode", -1), (105e3, 108e3, "kernels.D1", 0),
            (170e3, 180e3, "kernels.D1", -1), (185e3, 195e3, "enhance.select", -1))
    t = pt.reduce(events, (4.0, 8.0), (90.0, 250.0), [], r, ident=1)
    p = t.program
    assert p.device_by_span == pytest.approx({"enhance.decode": 30e-6, "kernels.D1": 70e-6,
                                              "enhance.select": 20e-6})
    assert t.busy_s == pytest.approx(120e-6)
    run = run_of("sam_vit_h.refine", t)
    assert read("decode_share.refine", run) == pytest.approx(100 * 60 / 120)
    assert read("select_share.refine", run) == pytest.approx(100 * 20 / 120)
    assert pt.within(p, "enhance.decode") == [0, 1]


def test_loader_stall_reads_the_idle_under_load_wait():
    name = "sam_vit_h.precompute_int8"
    prog = pt.Program([span("encode_images.load_wait")], {})
    idle = {"encode_images.load_wait": 0.01, "encode_images.drain": 0.05}
    assert read("loader_stall.precompute", run_of(name, traced(prog, window_s=4.0, idle=idle),
                                                  encode_calls=1)) == pytest.approx(0.25)
    assert read("loader_stall.precompute", run_of(name, traced(None), encode_calls=1)) is None


#: the metrics that read the program's spans and counters
PROGRAM_METRICS = ("k4_roofline.program", "loader_stall.precompute", "decode_share.refine",
                   "select_share.refine", "augment_share.train")


def test_the_metrics_entries_fit_the_manifest():
    entries = {m["name"]: m for m in MAN["per_layer"]}
    cells = {w["name"] for w in MAN["workloads"]}
    assert "k4_roofline" not in entries
    for name in PROGRAM_METRICS:
        m = entries[name]
        assert m["source"] == "device_trace" and set(m["workloads"]) <= cells
        assert callable(core.load_module(core.BENCH_DIR / "metrics" / f"{name}.py").read)
        assert m["layer"] in {"kernels", "loops", "enhance engine", "trainer"}


@pytest.mark.chip
@pytest.mark.parametrize("name", [w["name"] for w in MAN["workloads"]])
def test_a_traced_run_reports_its_cells_layer_metrics(name, card):
    """A traced run by the manifest's command, one process as the benchmark
    makes it (one profiler capture a process): correct, every per-layer
    metric of the cell reported, the program's counters in the result."""
    proc = subprocess.run([sys.executable, str(core.BENCH_DIR / "run.py"), "--workload", name,
                           "--seed", str(2 ** 31 + 91), "--seconds", "3", "--trace", "1"],
                          capture_output=True, text=True, timeout=1200, cwd=core.ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    w = {x["name"]: x for x in MAN["workloads"]}[name]
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {m["name"] for m in core.layer_metrics(MAN, w)}, res["metrics"]
    assert "program_counters" in res["diagnostics"]
