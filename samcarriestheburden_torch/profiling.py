"""Tracing, and the program's spans and counters (JAX ``profiling.py``).

* :func:`trace` — context manager around ``torch.profiler`` writing a Chrome
  trace (``trace.json``, loadable in Perfetto or ``chrome://tracing``).
* :func:`span`, :func:`count`, :func:`recording` — named spans and counters
  where the loops, the enhance engine, the trainer and K4's wrapper do their
  work.  They record only inside ``with recording() as rec:``; outside it
  :func:`span` checks one module-level flag and returns one shared no-op
  context, and :func:`count` returns at once: no clock read, no allocation,
  no ``synchronize``, no CUDA event.  A span records
  ``time.perf_counter_ns()`` at its start and end, its name, its thread, the
  index of the span it opened inside (on the same thread) and its ``batch``
  and ``round`` attributes; nothing waits for the card, so a span measures
  the host's side of what the program overlaps, and a device trace (which
  shares the host's clock up to an offset) charges the card's time to it.
  The records stay in memory; :meth:`Recording.summary` totals them with
  each span's self time (its duration less its children's).
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch


@contextlib.contextmanager
def trace(log_dir="runs/profile"):
    """Capture a host and device trace of the block:
    ``with trace('dir'): ...`` writes ``dir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    Path(log_dir).mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


class SpanRecord:
    """One span: ``start_ns`` and ``end_ns`` (``time.perf_counter_ns``; 0
    while open), ``thread`` (``threading.get_ident``), ``parent`` (the index in
    :attr:`Recording.spans` of the span this one opened inside on the same
    thread, -1 for none), ``batch`` and ``round`` (None where not given)."""

    __slots__ = ("name", "start_ns", "end_ns", "thread", "parent", "batch", "round")

    def __init__(self, name, thread, batch, round_):
        self.name, self.start_ns, self.end_ns = name, 0, 0
        self.thread, self.parent, self.batch, self.round = thread, -1, batch, round_


class Recording:
    """What one :func:`recording` holds: ``spans`` in the order they opened
    (a parent before its children) and ``counters`` by name."""

    def __init__(self):
        self.spans: List[SpanRecord] = []
        self.counters: Dict[str, int] = {}
        self._open = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._open, "stack", None)
        if stack is None:
            stack = self._open.stack = []
        return stack

    def self_ns(self) -> List[int]:
        """Each closed span's self time in ns: its duration less the part
        its closed child spans cover (children nest inside their parent, on
        one thread, so their durations add)."""
        own = [s.end_ns - s.start_ns for s in self.spans]
        for s in self.spans:
            if s.parent >= 0 and s.end_ns:
                own[s.parent] -= s.end_ns - s.start_ns
        return own

    def summary(self) -> Dict[str, dict]:
        """``{name: {total_s, self_s, count, mean_ms}}`` over the closed
        spans, and ``{name: {count}}`` for each counter."""
        out: Dict[str, dict] = {}
        for s, own in zip(self.spans, self.self_ns()):
            if not s.end_ns:
                continue
            row = out.setdefault(s.name, {"total_s": 0.0, "self_s": 0.0, "count": 0})
            row["total_s"] += (s.end_ns - s.start_ns) * 1e-9
            row["self_s"] += own * 1e-9
            row["count"] += 1
        for row in out.values():
            row["mean_ms"] = 1e3 * row["total_s"] / row["count"]
        for name, n in self.counters.items():
            out[name] = {"count": n}
        return dict(sorted(out.items()))

    def dump(self, path) -> None:
        """:meth:`summary` as JSON at ``path``."""
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text(json.dumps(self.summary(), indent=2))


class _Span:
    __slots__ = ("rec", "record")

    def __init__(self, rec: Recording, name: str, batch, round_):
        self.rec = rec
        self.record = SpanRecord(name, threading.get_ident(), batch, round_)

    def __enter__(self):
        spans, stack, record = self.rec.spans, self.rec._stack(), self.record
        record.parent = stack[-1] if stack else -1
        stack.append(len(spans))
        spans.append(record)
        record.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.record.end_ns = time.perf_counter_ns()
        self.rec._stack().pop()
        return False


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NO_SPAN = _NoSpan()
#: the recording in progress, None when off (the flag every span checks)
_RECORDING: Optional[Recording] = None


def span(name: str, batch: Optional[int] = None, round: Optional[int] = None):
    """``with span("enhance.decode", batch=i, round=1): ...``: one span of
    the recording in progress, or the shared no-op context when none is."""
    rec = _RECORDING
    if rec is None:
        return _NO_SPAN
    return _Span(rec, name, batch, round)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the recording in progress."""
    rec = _RECORDING
    if rec is not None:
        rec.counters[name] = rec.counters.get(name, 0) + n


def active() -> bool:
    """Whether a recording is in progress (for a counter whose count costs
    work to find)."""
    return _RECORDING is not None


@contextlib.contextmanager
def recording():
    """Turn recording on for the block and yield its :class:`Recording`;
    a recording opened inside another one takes the spans until it closes."""
    global _RECORDING
    outer, rec = _RECORDING, Recording()
    _RECORDING = rec
    try:
        yield rec
    finally:
        _RECORDING = outer
