"""The harness: one run of one cell.

Everything that belongs to a configuration, a traffic mix or a per-layer
metric is a file of its own, found by the names in ``BENCHMARK.json``:

* ``configs/<config>.json`` (the ``file`` the manifest names): the sizes;
* ``workloads/<traffic>.json``: the mix's parameters, and the driver that
  runs it (``drivers/<driver>.py``);
* ``metrics/<metric>.py``: a reader ``read(run) -> float | None``.

A driver has ``setup(ctx)``, which builds the program's objects and warms
every shape the mix uses, ``window(state, ctx, seconds)``, which runs the
timed work and returns a :class:`Window`, ``release(state)``, which frees
the program's state, and ``check(state, ctx)``, which compares what the
window produced with the plain reference and returns the numbers compared
with their limits.  For the tests and ``calibrate.py`` it also brings
``CONTROL``, its lower-precision control (:func:`control`), with
``control(state, ctx)`` where that runs in the program's place, ``FAULTS``,
the faults its cell can have (``harness/faults.py``), and ``tiny(config,
traffic)``, which shrinks its cell in place to a CPU test's size.

A traced run captures the device trace with the program's own spans and
counters (``harness/program_trace.py``).
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
import zlib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from harness.program_trace import capture
from harness.tracing import Spans

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
#: top-level modules that no run may load: JAX, its libraries, the JAX
#: package the program was ported from, and the JAX package's own bench
FORBIDDEN = ("jax", "jaxlib", "flax", "samcarriestheburden_tpu", "bench")


class BenchError(RuntimeError):
    """A run that cannot give a result."""


@dataclass
class Window:
    """What a timed window did: ``work`` units completed in ``seconds``,
    from ``t_start`` (``time.perf_counter``) on, and the counts a metric
    reader may use."""
    work: float
    seconds: float
    t_start: float
    attempted: int
    failed: int = 0
    counts: Dict[str, float] = field(default_factory=dict)


class StopWindow(Exception):
    """Raised by a :class:`BatchStore` once the window has closed."""


class BatchStore:
    """The store a loop writes its answers to, which brackets the window on
    whole batches.  Every answer is counted and handed to ``take(n,
    *answer)``, which returns (key, what to keep) for an answer the check
    samples and None for the rest.  After every whole batch it reads the
    clock: the window opens at the first batch's end and closes, raising
    :class:`StopWindow` into the loop, at the first batch to end once
    ``seconds`` have passed and answer ``last`` has been written."""

    def __init__(self, batch: int, seconds: float, last: int, spans,
                 take: Optional[Callable] = None):
        self.batch, self.seconds, self.last, self.spans, self.take = (batch, seconds, last,
                                                                      spans, take)
        self.kept: Dict[object, object] = {}
        self.n = self.n_start = 0
        self.t_start = self.t_end = None
        self.ends: List[float] = []

    def write(self, *answer, **kw):
        with self.spans("store.write"):
            got = None if self.take is None else self.take(self.n, *answer, **kw)
            if got is not None:
                self.kept[got[0]] = got[1]
            self.n += 1
            if self.n % self.batch:
                return
            now = time.perf_counter()
            self.ends.append(now)
            if self.t_start is None:
                self.t_start, self.n_start = now, self.n
            elif now - self.t_start >= self.seconds and self.n > self.last:
                self.t_end = now
                raise StopWindow

    def window(self, **counts) -> "Window":
        """The window's work: the answers of the batches written in it."""
        done = self.n - self.n_start
        return Window(work=done, seconds=self.t_end - self.t_start, t_start=self.t_start,
                      attempted=done, counts={"batches": done // self.batch, **counts,
                                              "batch_s": np.diff(self.ends).tolist()})


class Names(Sequence):
    """A long sequence of work item names, made as they are read:
    ``name(k)`` for item k.  A window ends at a time, not at a count, so the
    loop is handed more items than any window reaches."""

    def __init__(self, name: Callable[[int], str], length: int = 10 ** 7):
        self.name, self.length = name, length

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, k):
        if isinstance(k, slice):
            return [self.name(i) for i in range(*k.indices(self.length))]
        if not -self.length <= k < self.length:
            raise IndexError(k)
        return self.name(k % self.length)


@dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Context:
    seed: int
    device: object
    config: dict
    traffic: dict
    spans: Spans
    workload: str = ""

    def subseed(self, name: str) -> int:
        """A 32-bit seed for one use, drawn from the run's seed and a name."""
        seq = np.random.SeedSequence([self.seed % 2 ** 63, zlib.crc32(name.encode())])
        return int(seq.generate_state(1)[0])


def judge(readings: Dict[str, float], limits: Dict[str, float]) -> List[Check]:
    """The numbers a mix compares, each against its limit; a number with no
    reading (nothing was produced to compare) is infinitely far."""
    return [Check(k, float(readings.get(k, float("inf"))), v) for k, v in limits.items()]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A driver or metric module by its file path (its name may hold dots)."""
    if not path.is_file():
        raise BenchError(f"{path} is missing")
    name = f"bench_{path.parent.name}_{path.stem}".replace(".", "_")
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(man: dict, name: str, root: Path = ROOT):
    """(workload entry, configuration entry, config dict, traffic dict),
    the files read under the checkout ``root``."""
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise BenchError(f"no workload {name!r}; one of {sorted(cells)}")
    w = cells[name]
    cfg = {c["name"]: c for c in man["configs"]}[w["config"]]
    mix = root / BENCH_DIR.name / "workloads" / f"{w['traffic']}.json"
    return w, cfg, load_json(root / cfg["file"]), load_json(mix)


def driver_path(traffic: dict, root: Path = ROOT) -> Path:
    return root / BENCH_DIR.name / "drivers" / f"{traffic['driver']}.py"


def driver_for(traffic: dict, root: Path = ROOT):
    return load_module(driver_path(traffic, root))


def layer_metrics(man: dict, w: dict) -> List[dict]:
    """The per-layer metrics a traced run of cell ``w`` reports: those that
    list it, and those without a list that move a metric it reports."""
    reported = {m["name"] for m in man["end_to_end"]
                if "workloads" not in m or w["name"] in m["workloads"]}
    return [m for m in man["per_layer"]
            if (w["name"] in m["workloads"] if "workloads" in m else m["moves"] in reported)]


def loaded_forbidden() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def execute(workload: str, seed: int, seconds: float, trace: bool, device,
            t_process: float, man: Optional[dict] = None,
            override: Optional[Callable[[dict, dict], None]] = None) -> dict:
    """One run: set-up, the window (traced or not), the comparison with the
    reference.  Returns the result object the last line prints.
    ``override(config, traffic)`` may change the loaded files in place (the
    CPU tests shrink a cell with it)."""
    import torch

    man = man or manifest()
    w, _, config, traffic = cell(man, workload)
    if override is not None:
        override(config, traffic)
    drv = driver_for(traffic)
    spans = Spans()
    ctx = Context(seed=seed, device=torch.device(device), config=config, traffic=traffic,
                  spans=spans, workload=workload)
    cuda = ctx.device.type == "cuda"
    state = drv.setup(ctx)
    if cuda:
        torch.cuda.synchronize()
    trace_info = None
    if trace:
        win, trace_info = capture(lambda: drv.window(state, ctx, traffic["trace_seconds"]), spans)
    else:
        win = drv.window(state, ctx, seconds)
    peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0
    drv.release(state)
    checks: List[Check] = drv.check(state, ctx)
    bad = loaded_forbidden()
    if bad:
        raise BenchError(f"modules loaded that the run may not load: {bad}")

    metrics = {}
    if trace:
        run = {"trace": trace_info, "window": win, "config": config, "traffic": traffic,
               "workload": workload}
        for m in layer_metrics(man, w):
            value = load_module(BENCH_DIR / "metrics" / f"{m['name']}.py").read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics[traffic["rate_metric"]] = {"value": win.work / win.seconds,
                                           "unit": traffic["rate_unit"]}
        metrics["setup_s"] = {"value": win.t_start - t_process, "unit": "s"}
    result = {
        "correct": bool(checks) and all(c.ok for c in checks) and win.failed == 0,
        "attempted": win.attempted,
        "failed": win.failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(ctx.device) if cuda else "cpu",
                   "count": int(w["chips"]),
                   "memory_peak_bytes": int(peak)},
    }
    result["diagnostics"] = {"window_s": win.seconds, "work": win.work, **win.counts,
                             "launches": dict(getattr(state, "launches", {}) or {}),
                             "readings": getattr(state, "readings", {})}
    if trace_info is not None:
        result["device"]["busy_s"] = trace_info.busy_s
        result["device"]["window_s"] = trace_info.window_s
        result["breakdown"] = trace_info.breakdown()
        if trace_info.program is not None:
            result["diagnostics"]["program_counters"] = trace_info.program.counters
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return result


def control(workload: str, seed: int, device, man: Optional[dict] = None,
            override: Optional[Callable[[dict, dict], None]] = None,
            seconds: float = 3.0) -> Dict[str, float]:
    """The readings of a cell's lower-precision control, to be judged by
    the mix's limits.  The driver's ``CONTROL`` is (mode, changes):
    ``changes`` are made to the loaded configuration or mix (after
    ``override``, as in :func:`execute`); mode ``control`` runs the
    driver's ``control`` in the program's place, mode ``program`` runs the
    program itself, as changed, for ``seconds``."""
    import torch

    man = man or manifest()
    config, traffic = cell(man, workload)[2:]
    drv = driver_for(traffic)
    mode, changes = drv.CONTROL

    def changed(config, traffic):
        if override is not None:
            override(config, traffic)
        for k, v in changes.items():
            (config if k in config else traffic)[k] = v

    if mode == "program":
        res = execute(workload, seed, seconds, False, device, time.perf_counter(), man, changed)
        return res["diagnostics"]["readings"]
    changed(config, traffic)
    ctx = Context(seed=seed, device=torch.device(device), config=config, traffic=traffic,
                  spans=Spans(), workload=workload)
    return drv.control(drv.setup(ctx), ctx)


def main(argv=None, t_process: Optional[float] = None) -> int:
    import argparse

    t_process = time.perf_counter() if t_process is None else t_process
    p = argparse.ArgumentParser(description="Run one cell of the benchmark")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    man = manifest()
    w = cell(man, args.workload)[0]
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(w["chips"]):
        print(f"this cell needs {w['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    emit(execute(args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0",
                 t_process, man))
    return 0


def emit(result: dict) -> None:
    """The numbers compared, each beside its limit, as the last lines of
    standard error; the result as the last line of standard output."""
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})"
              f"{'' if c['value'] <= c['limit'] else '  FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
