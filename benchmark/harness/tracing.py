"""Host spans and the device trace of the traced window.

The benchmark names its own spans around each call into a layer of the
program (``Spans``), recorded on the host's clock in a traced run.  The
device's activity comes from one ``torch.profiler`` capture of the window
with device activity only: recording every host operation as well slowed
the precompute's host-bound dispatch by half, and the idle share with it.
:func:`summarize` reduces the capture
to what the metric readers need: the device's busy time as the union of
its kernel, copy and set intervals (overlapping streams counted once), the
idle gaps charged to the innermost span the main thread was in, the device
time by kernel name, and each stream's kernels in launch order.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: the kernel of ``torch.cuda._sleep``, launched once to align the clocks
MARKER = "spin_kernel"


class Spans:
    """``with spans("layer"): ...`` around a call into the program.  While
    a window is traced it records (start, end, name) in
    ``time.perf_counter_ns`` on the thread that opened the capture;
    otherwise it costs a context manager and nothing else."""

    def __init__(self):
        self.enabled = False
        self.main = None
        self.records: List[Tuple[int, int, str]] = []

    def __call__(self, name: str):
        if not self.enabled or threading.get_ident() != self.main:
            return contextlib.nullcontext()
        return self._span(name)

    @contextlib.contextmanager
    def _span(self, name: str):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.records.append((t0, time.perf_counter_ns(), name))


@dataclass
class Trace:
    window_s: float
    busy_s: float
    idle_by_span: Dict[str, float]
    device_by_name: Dict[str, float]
    kernels: Dict[int, List[Tuple[str, float, float]]] = field(default_factory=dict)

    def breakdown(self, n: int = 10) -> dict:
        top = sorted(self.device_by_name.items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[short(k), v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in gaps]}


def short(name: str, n: int = 64) -> str:
    """A kernel name cut to ``n`` characters of letters, digits and ``_``."""
    return "".join(ch if ch.isalnum() or ch == "_" else "_" for ch in name)[:n]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def summarize(events: List[dict], window: Tuple[float, float],
              spans: List[Tuple[float, float, str]]) -> Trace:
    """Reduce a Chrome trace's device events to a :class:`Trace` over
    ``window``, with the host's ``spans``; all times in the trace's µs."""
    t0, t1 = window
    dev, by_name, kernels = [], {}, {}
    for e in events:
        if e.get("cat") not in DEVICE_CATS or e.get("ph") != "X":
            continue
        a, b = max(e["ts"], t0), min(e["ts"] + e["dur"], t1)
        if b <= a:
            continue
        dev.append((a, b))
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + (b - a) * 1e-6
        if e["cat"] == "kernel":
            stream = e.get("args", {}).get("stream", e.get("tid"))
            kernels.setdefault(stream, []).append((e["name"], e["ts"], e["dur"]))
    if not dev:
        raise RuntimeError("the trace holds no device activity in the window")
    busy = _union(dev)
    starts = [s[0] for s in spans]
    idle: Dict[str, float] = {}
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        inner = [s for s in spans[:bisect.bisect_right(starts, mid)] if mid < s[1]]
        name = min(inner, key=lambda s: s[1] - s[0])[2] if inner else "outside_spans"
        idle[name] = idle.get(name, 0.0) + (b - a) * 1e-6
    for ks in kernels.values():
        ks.sort(key=lambda k: k[1])
    return Trace(window_s=(t1 - t0) * 1e-6, busy_s=sum(b - a for a, b in busy) * 1e-6,
                 idle_by_span=idle, device_by_name=by_name, kernels=kernels)


def capture(fn, spans: Spans):
    """Run ``fn()`` inside one device-only profiler capture; returns (fn's
    result, :class:`Trace`).  The host's spans are put on the trace's clock
    by a marker kernel launched at a known host time on an idle card (the
    launch's latency, microseconds, is the error).  The Chrome trace goes to
    a temporary file, which is read and removed."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    spans.main, spans.records, spans.enabled = threading.get_ident(), [], True
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        mark = time.perf_counter_ns()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        start = time.perf_counter_ns()
        result = fn()
        torch.cuda.synchronize()
        end = time.perf_counter_ns()
    spans.enabled = False
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    marks = sorted(e["ts"] for e in events
                   if e.get("cat") == "kernel" and MARKER in e.get("name", ""))
    if not marks:
        raise RuntimeError("the trace holds no marker kernel")
    offset = marks[0] - mark / 1e3
    spans_us = sorted((a / 1e3 + offset, b / 1e3 + offset, n) for a, b, n in spans.records)
    return result, summarize(events, (start / 1e3 + offset, end / 1e3 + offset), spans_us)


def launch_groups(trace: Trace, anchor: str, before: List[str], after: List[str]):
    """Device seconds of every launch of a port kernel made of several CUDA
    kernels in a row on one stream: each kernel whose name holds
    ``anchor``, with the kernels right before and after it, whose names
    must hold ``before`` and ``after`` in order.  Returns (groups found,
    their summed seconds), or None where a group's neighbours do not
    match."""
    count, total = 0, 0.0
    for ks in trace.kernels.values():
        for i, (name, _, dur) in enumerate(ks):
            if anchor not in name:
                continue
            lo, hi = i - len(before), i + len(after)
            if lo < 0 or hi >= len(ks):
                return None
            group = ks[lo:hi + 1]
            if not all(p in g[0] for p, g in zip(before + [anchor] + after, group)):
                return None
            count += 1
            total += sum(g[2] for g in group) * 1e-6
    return count, total
