"""Device timing shared by the port's experiment tools (``exp_int8``,
``exp_mlp2``, ``exp_3d``): the counterpart of the JAX scripts' ``_trace_run``
and ``timeit``, with CUDA events in place of a profiler trace.

Each experiment is ``(fn, args)``.  It is called once (host clock, the
kernels' build included) and ``WARMUP`` times, then timed over ``ITERS``
back-to-back calls between two CUDA events: device time per iteration.  The
launches of each counted kernel (``kernels.LAUNCHES``) over all those calls
are kept beside the time.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, List

import torch

from samcarriestheburden_torch.kernels import LAUNCHES

ITERS = 10
WARMUP = 2


def device_us(fn, args, iters: int = ITERS, warmup: int = WARMUP) -> float:
    """Mean device time of ``fn(*args)`` in microseconds (CUDA events)."""
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / iters


def run_experiments(exps: Dict, names: Iterable[str],
                    lines: Callable[[str, Dict], List[str]],
                    notes: Dict[str, str] = None) -> Dict[str, Dict]:
    """Each named experiment on the card, in order, printing ``lines(name,
    result)`` and its note.  Returns ``{name: {"us", "first_s", "sum",
    "launches"}}``: device microseconds per call, the first call's host
    seconds, the sum of its output, and the launches of each kernel over every
    call of the experiment."""
    results = {}
    for name in names:
        fn, args = exps[name]
        before = dict(LAUNCHES)
        t0 = time.perf_counter()
        total = float(fn(*args).double().sum())
        first_s = time.perf_counter() - t0
        us = device_us(fn, args)
        res = {"us": us, "first_s": first_s, "sum": total,
               "launches": {k: v - before[k] for k, v in LAUNCHES.items() if v != before[k]}}
        for line in lines(name, res):
            print(line, flush=True)
        print(f"  launches {res['launches']}" + (f"; {notes[name]}" if notes and name in notes
                                                  else ""), flush=True)
        results[name] = res
    return results


def print_summary(header: str, results: Dict[str, Dict], width: int = 20) -> None:
    print(f"\n{header}")
    for name, res in results.items():
        print(f"  {name:{width}s} {res['us']:9.1f}")
