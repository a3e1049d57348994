"""Readings for the limits of ``correct``: the numbers a cell compares, on
many seeds in one process, for the program, for the lower-precision
control, or for the program with a fault planted.

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3
        [--mode program|control] [--fault <name>] [--set c.key=value]
        [--set t.key=value] [--seconds 3] [--smi]

Prints one JSON line a seed: {"seed", "checks": {name: value}, ...}.  The
limits in ``workloads/<mix>.json`` are set from these readings (the lower
from the program, the upper from the control and the faults), never from
the benchmark's own runs, which do not run the control.  ``--mode control``
runs the cell's driver's ``CONTROL`` (``harness/core.py:control``): its own
control in the program's place, or the program with the control's changes
made; ``--set`` changes come before those.  ``--smi`` reads
the card's SM clock, power draw and temperature with ``nvidia-smi`` at
1 Hz beside each seed's run and prints their least, median and largest
value in its line (the diagnosis of a cell's spread).
"""

import contextlib
import json
import os
import subprocess
import sys
import threading
import time
from typing import List, Optional, Tuple

sys.path[:0] = [os.path.dirname(os.path.abspath(__file__)),
                os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]

from harness import core  # noqa: E402
from harness.faults import planted  # noqa: E402


class SmiSampler:
    """``nvidia-smi`` read at 1 Hz beside a run: the card's SM clock,
    power draw and temperature.  Silent where the tool is missing."""

    QUERY = "clocks.sm,power.draw,temperature.gpu"

    def __init__(self):
        self.rows: List[Tuple[float, ...]] = []
        self.proc = None
        self.thread: Optional[threading.Thread] = None

    def __enter__(self):
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", f"--query-gpu={self.QUERY}", "--format=csv,noheader,nounits",
                 "-i", "0", "-lms", "1000"], stdout=subprocess.PIPE,
                stderr=subprocess.DEVNULL, text=True)
        except OSError:
            return self
        self.thread = threading.Thread(target=self._read, daemon=True)
        self.thread.start()
        return self

    def _read(self):
        for line in self.proc.stdout:
            try:
                self.rows.append(tuple(float(v) for v in line.split(",")))
            except ValueError:
                continue

    def __exit__(self, *exc):
        if self.proc is not None:
            self.proc.terminate()
            self.proc.wait()
            self.thread.join(timeout=5)
        return False

    def summary(self) -> Optional[dict]:
        if not self.rows:
            return None
        cols = list(zip(*self.rows))
        out = {"samples": len(self.rows)}
        for name, vals in zip(("sm_clock_mhz", "power_w", "temp_c"), cols):
            s = sorted(vals)
            out[name] = [s[0], s[len(s) // 2], s[-1]]
        return out


def _value(v: str):
    return json.loads(v) if v[:1] in "-0123456789[{tfn\"" else v


def main(argv=None) -> int:
    import argparse

    import torch

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--mode", choices=("program", "control"), default="program")
    p.add_argument("--fault", default=None)
    p.add_argument("--set", action="append", default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--smi", action="store_true")
    args = p.parse_args(argv)

    def override(config, traffic):
        for item in args.set:
            key, value = item.split("=", 1)
            where, key = key.split(".", 1)
            (config if where == "c" else traffic)[key] = _value(value)

    man = core.manifest()
    drv = core.driver_for(core.cell(man, args.workload)[3])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        smi = SmiSampler() if args.smi else contextlib.nullcontext()
        with planted(drv, args.fault), smi:
            if args.mode == "program":
                res = core.execute(args.workload, seed, args.seconds, False, args.device, t0,
                                   man, override)
                checks = res["diagnostics"]["readings"]
                extra = {"metrics": {k: v["value"] for k, v in res["metrics"].items()},
                         "correct": res["correct"]}
            else:
                checks = core.control(args.workload, seed, args.device, man, override,
                                      args.seconds)
                extra = {}
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        if args.smi:
            extra["smi"] = smi.summary()
        print(json.dumps({"seed": seed, "mode": args.mode, "fault": args.fault, "set": args.set,
                          "checks": checks, "seconds": time.perf_counter() - t0, **extra}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
