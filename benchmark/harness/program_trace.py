"""The program's own spans and counters on the device trace's clock.

The port records spans and counters where its loops, its enhance engine, its
trainer and K4's wrapper do their work (``samcarriestheburden_torch/
profiling.py``), but only inside its ``recording()``.  :func:`capture` runs
the traced window inside one device-only profiler capture (recording every
host operation as well slowed the precompute's host-bound dispatch by half,
and the idle share with it) with that recording open, and joins the host's
clock to the trace's on the marker kernel's launch event (``cuda_runtime``,
matched by ``args.correlation``) rather than on the kernel's start, which
comes later by the launch's queue latency.  It returns a :class:`Traced`:
the ``tracing.Trace`` of the window, whose idle gaps are charged to the
innermost of the benchmark's and the program's spans taken together, and
``program``, a :class:`Program`: the program's spans on the trace's clock,
its counters, and the device time of each kernel, copy and set charged to
the innermost program span that was open on the launching thread when its
launch event fired.

A checkout whose program has no ``recording()`` traces as before, with
``program`` None; the readers of ``metrics/`` that read it then report
nothing.  ``harness/core.py`` captures every traced run with :func:`capture`.
"""

from __future__ import annotations

import bisect
import contextlib
import ctypes
import json
import os
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Tuple

from harness.tracing import DEVICE_CATS, MARKER, Trace, summarize

#: where a device operation's launch fell in no program span
OUTSIDE = "outside_program_spans"


class Span(NamedTuple):
    """A program span on the trace's clock (µs); ``parent`` indexes
    :attr:`Program.spans`, -1 for none."""
    start: float
    end: float
    name: str
    thread: int
    parent: int
    batch: Optional[int]
    round: Optional[int]


@dataclass
class Program:
    """What the program recorded in the window: ``spans`` in the order they
    opened, ``counters``, and the device seconds charged to each span
    (``device_by_index``, by index into ``spans``) and to each span name
    (``device_by_span``, with :data:`OUTSIDE` for launches in no span and
    ``unlaunched`` for operations whose launch the trace does not hold)."""
    spans: List[Span]
    counters: Dict[str, int]
    device_by_index: Dict[int, float] = field(default_factory=dict)
    device_by_span: Dict[str, float] = field(default_factory=dict)

    def count(self, name: str) -> int:
        return sum(s.name == name for s in self.spans)


@dataclass
class Traced(Trace):
    program: Optional[Program] = None


def trace_tid(ident: int) -> int:
    """The thread id a Chrome trace gives the launches of the Python thread
    ``ident`` (``threading.get_ident``): its low 32 bits as a signed
    integer, without the sign."""
    return abs(ctypes.c_int32(ident).value)


def launches(events: List[dict]) -> Dict[int, dict]:
    """The host's CUDA runtime and driver calls (cuDNN and cuBLAS launch
    through the driver) by correlation id."""
    return {e["args"]["correlation"]: e for e in events
            if e.get("cat") in ("cuda_runtime", "cuda_driver") and e.get("ph") == "X"
            and "correlation" in e.get("args", {})}


def clock_offset(events: List[dict], mark: Tuple[float, float]) -> Tuple[float, Optional[dict]]:
    """(trace µs − host µs, the marker's launch event or None).  ``mark``:
    the host's µs just before and just after the marker's launch; its
    launch event lies inside them, so the offset is taken in the middle of
    the range that allows.  Without a launch event, the marker kernel's
    start (later by the queue latency)."""
    marks = sorted((e for e in events if e.get("cat") == "kernel"
                    and MARKER in e.get("name", "")), key=lambda e: e["ts"])
    if not marks:
        raise RuntimeError("the trace holds no marker kernel")
    launch = launches(events).get(marks[0].get("args", {}).get("correlation"))
    if launch is None:
        return marks[0]["ts"] - mark[0], None
    return ((launch["ts"] - mark[0]) + (launch["ts"] + launch["dur"] - mark[1])) / 2, launch


class _Pos(NamedTuple):
    """A span in its thread's list sorted by start: its end, its parent's
    position in that list (-1 for none), its index in :attr:`Program.spans`."""
    end: float
    parent_pos: int
    index: int


def innermost(rows: List[_Pos], starts: List[float], ts: float) -> int:
    """The position in ``rows`` (one thread's spans sorted by start,
    ``starts`` their starts) of the innermost span open at ``ts``, -1 for
    none.  Spans on one thread nest, so the innermost is the latest started
    that is still open: the latest started at or before ``ts``, or the
    nearest of its ancestors that is still open."""
    i = bisect.bisect_right(starts, ts) - 1
    while i >= 0 and rows[i].end <= ts:
        i = rows[i].parent_pos
    return i


#: :func:`charges`' span index for an operation whose launch the trace lacks
UNLAUNCHED = -2


def charges(events: List[dict], window: Tuple[float, float], spans: List[Span],
            main: Optional[Tuple[int, int]] = None):
    """Yield (event, its seconds inside ``window``, the index in ``spans``
    of the innermost span open on its launch's thread at its launch's start;
    -1 for none, :data:`UNLAUNCHED` where the trace holds no launch) for each
    kernel, copy and set that overlaps ``window``.  ``main``: (the Python
    ident, the trace's tid) of the thread that drives the program; other
    threads' tids are :func:`trace_tid` of their ident.  A launch from a
    thread with no span open there (autograd's backward thread, a library's
    worker) goes to the innermost span open on ``main``'s thread then, which
    waits for it."""
    t0, t1 = window
    by_thread: Dict[int, list] = {}
    for i, s in enumerate(spans):
        tid = main[1] if main and s.thread == main[0] else trace_tid(s.thread)
        by_thread.setdefault(tid, []).append((s.start, i))
    lookup = {}
    for tid, items in by_thread.items():
        items.sort()
        pos = {i: k for k, (_, i) in enumerate(items)}
        rows = [_Pos(spans[i].end, pos.get(spans[i].parent, -1), i) for _, i in items]
        lookup[tid] = ([a for a, _ in items], rows)

    def find(tid, ts):
        starts, rows = lookup.get(tid, ([], []))
        k = innermost(rows, starts, ts)
        return rows[k].index if k >= 0 else -1

    calls = launches(events)
    for e in events:
        if e.get("cat") not in DEVICE_CATS or e.get("ph") != "X":
            continue
        a, b = max(e["ts"], t0), min(e["ts"] + e["dur"], t1)
        if b <= a:
            continue
        call = calls.get(e.get("args", {}).get("correlation"))
        if call is None:
            yield e, (b - a) * 1e-6, UNLAUNCHED
            continue
        i = find(call["tid"], call["ts"])
        if i < 0 and main and call["tid"] != main[1]:
            i = find(main[1], call["ts"])
        yield e, (b - a) * 1e-6, i


def attribute(events: List[dict], window: Tuple[float, float], spans: List[Span],
              main: Optional[Tuple[int, int]] = None):
    """(device seconds by span index, by span name, with :data:`OUTSIDE`
    and ``unlaunched``) of :func:`charges`."""
    by_index: Dict[int, float] = {}
    by_name: Dict[str, float] = {}
    for _, secs, i in charges(events, window, spans, main):
        name = spans[i].name if i >= 0 else OUTSIDE if i == -1 else "unlaunched"
        by_name[name] = by_name.get(name, 0.0) + secs
        if i >= 0:
            by_index[i] = by_index.get(i, 0.0) + secs
    return by_index, by_name


def _recording():
    """The program's recording, or a context yielding None where the
    program has none."""
    try:
        from samcarriestheburden_torch import profiling
    except ImportError:
        return contextlib.nullcontext()
    rec = getattr(profiling, "recording", None)
    return rec() if rec is not None else contextlib.nullcontext()


def capture(fn, spans):
    """Run ``fn()`` inside one device-only profiler capture with the
    program's recording open, the benchmark's ``spans``
    (``tracing.Spans``) recording on this thread: returns (fn's result,
    :class:`Traced`).  The Chrome trace goes to a temporary file, which is
    read and removed."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda._sleep(1)            # the marker's module loaded before its timed launch
    torch.cuda.synchronize()
    ident = threading.get_ident()
    spans.main, spans.records, spans.enabled = ident, [], True
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        mark0 = time.perf_counter_ns()
        torch.cuda._sleep(1000)
        mark1 = time.perf_counter_ns()
        torch.cuda.synchronize()
        start = time.perf_counter_ns()
        with _recording() as rec:
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
    return result, reduce(events, (mark0 / 1e3, mark1 / 1e3), (start / 1e3, end / 1e3),
                          spans.records, rec, ident)


def reduce(events: List[dict], mark: Tuple[float, float], window: Tuple[float, float],
           harness: List[Tuple[int, int, str]], rec, ident: int) -> Traced:
    """The :class:`Traced` of a capture: ``mark`` and ``window`` in the
    host's µs, the benchmark's spans in its ns, the program's ``rec`` (None:
    no program spans) recorded with the capturing thread ``ident``."""
    offset, launch = clock_offset(events, mark)
    window = (window[0] + offset, window[1] + offset)
    on_trace = [(a / 1e3 + offset, b / 1e3 + offset, n) for a, b, n in harness]
    program = None
    if rec is not None:
        # a span still open (none is, once fn has returned) ends with the window
        prog = [Span(s.start_ns / 1e3 + offset,
                     s.end_ns / 1e3 + offset if s.end_ns else window[1], s.name, s.thread,
                     s.parent, s.batch, s.round) for s in rec.spans]
        main = (ident, launch["tid"] if launch is not None else trace_tid(ident))
        by_index, by_name = attribute(events, window, prog, main)
        program = Program(prog, dict(rec.counters), by_index, by_name)
        on_trace += [(s.start, s.end, s.name) for s in prog if s.thread == ident]
    trace = summarize(events, window, sorted(on_trace))
    return Traced(**vars(trace), program=program)


def program_of(run) -> Optional[Program]:
    """The program's part of a traced run, None where it recorded nothing."""
    return getattr(run["trace"], "program", None)


def within(prog: Program, name: str) -> List[int]:
    """The indices of the program's spans ``name`` and of every span nested
    inside one of them (a parent precedes its children in
    :attr:`Program.spans`)."""
    inside: List[bool] = []
    for s in prog.spans:
        inside.append(s.name == name or (s.parent >= 0 and inside[s.parent]))
    return [i for i, x in enumerate(inside) if x]


def device_share(run, name: str) -> Optional[float]:
    """The device time charged to the program's spans ``name`` and to the
    spans nested inside them (a kernel's own span, such as ``kernels.D1``
    inside ``enhance.decode``, takes its launches' time), over the traced
    window's busy time, in %; None where the program recorded no such
    span."""
    prog = program_of(run)
    if prog is None or not prog.count(name):
        return None
    secs = sum(prog.device_by_index.get(i, 0.0) for i in within(prog, name))
    return 100.0 * secs / run["trace"].busy_s
