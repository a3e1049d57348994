"""What the port's CLIs share (JAX ``cli/common.py``): the device choice,
``--profile`` and the multi-host flags."""

from __future__ import annotations

import argparse
import contextlib

import torch

from samcarriestheburden_torch.device import resolve_device


def add_multihost_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--multihost", action="store_true",
                   help="multi-process run (not ported: raises; ROADMAP queue A item 5)")
    p.add_argument("--coordinator", type=str, default=None,
                   help="coordinator address host:port (multi-host)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)


def add_profile_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--profile", nargs="?", const="runs/profile", default=None,
                   metavar="DIR",
                   help="capture a torch.profiler trace plus per-phase wall-clock "
                        "JSON into DIR (default runs/profile)")


@contextlib.contextmanager
def profiled(profile_dir):
    """A CLI's profiling scope: yields a PhaseTimer (or None when profiling is
    off); on exit writes ``<dir>/phases.json`` and ``<dir>/trace.json``."""
    if not profile_dir:
        yield None
        return
    from pathlib import Path

    from samcarriestheburden_torch.profiling import PhaseTimer, trace

    timer = PhaseTimer()
    try:
        with trace(profile_dir):
            yield timer
    finally:
        timer.dump(Path(profile_dir) / "phases.json")
        print(f"profile: phase timings -> {profile_dir}/phases.json; "
              f"trace -> {profile_dir}/trace.json")


def setup_backend(args) -> torch.device:
    """The device of a CLI run: the CPU under ``--cpu``, else the card (raises
    without one: nothing falls back to the CPU).  ``--multihost`` raises
    ``NotImplementedError``."""
    if getattr(args, "multihost", False):
        raise NotImplementedError("multi-process runs are not ported (ROADMAP queue A item 5)")
    return resolve_device("cpu" if getattr(args, "cpu", False) else None)
