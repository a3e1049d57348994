"""Tracing and phase timing (JAX ``profiling.py``).

* :func:`trace` — context manager around ``torch.profiler`` writing a Chrome
  trace (``trace.json``, loadable in Perfetto or ``chrome://tracing``).
* :class:`PhaseTimer` — wall-clock accounting per pipeline phase (load,
  encode, write, enhance, ...), used by the CLIs under ``--profile``.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict

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


class PhaseTimer:
    """Per-phase wall-clock totals.  ``sync=True`` waits for the card at the
    end of each phase (``torch.cuda.synchronize``, where CUDA is in use), so
    a phase is charged the device work it enqueued; ``sync=False`` only
    accounts host time, and leaves a pipeline's overlap as it is."""

    def __init__(self, sync: bool = True):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.sync = sync

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> Dict[str, dict]:
        return {name: {"total_s": round(self.totals[name], 4),
                       "count": self.counts[name],
                       "mean_ms": round(1e3 * self.totals[name] / max(self.counts[name], 1), 3)}
                for name in sorted(self.totals)}

    def dump(self, path) -> None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text(json.dumps(self.report(), indent=2))
