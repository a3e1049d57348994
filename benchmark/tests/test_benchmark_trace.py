"""The reduction of a device trace, on hand-made Chrome trace events."""

import pytest

from harness import flops
from harness.tracing import summarize


def ev(cat, name, ts, dur, tid=1, stream=7):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if cat == "kernel":
        e["args"] = {"stream": stream}
    return e


def test_busy_is_a_union_and_gaps_go_to_the_innermost_span():
    events = [ev("kernel", "a", 10, 30),
              ev("gpu_memcpy", "copy", 20, 30, stream=8),      # overlaps a: counted once
              ev("kernel", "b", 90, 20),                      # runs past the window
              ev("kernel", "before", -20, 10)]                 # ends before it
    spans = [(0, 100, "loops.x"), (60, 80, "store.write")]
    t = summarize(events, (0, 100), spans)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx((50 - 10 + 10) * 1e-6)
    assert t.idle_by_span == pytest.approx({"loops.x": 10e-6, "store.write": 40e-6})
    assert t.device_by_name["b"] == pytest.approx(10e-6)
    bd = t.breakdown()
    assert bd["device_ops"][0][0] == "a" and bd["idle_gaps"][0][0] == "store.write"


def test_least_times_stay_under_the_work_done():
    c = {"encoder_embed_dim": 1280, "image_size": 1024, "vit_patch_size": 16, "mlp_ratio": 4.0,
         "encoder_global_attn_indexes": [7, 15, 23, 31], "encoder_depth": 32, "window_size": 14,
         "prompt_embed_dim": 256}
    int8, bf16 = flops.encoder_work(c, True), flops.encoder_work(c, False)
    assert int8["int8"] + int8["float"] == bf16["float"]
    assert flops.least_seconds(int8) < flops.least_seconds(bf16)
    assert flops.compact_rows(64, 14) == 4208
    # the windows cover every token once
    assert sum(rh * rw * k for rh, rw, k in flops.window_shapes(64, 14)) == 64 * 64
