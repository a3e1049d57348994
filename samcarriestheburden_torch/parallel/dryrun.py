"""Spawn the ranks of a multi-process run (``parallel/worker.py``) and read
their results; :func:`dryrun_multiprocess` is the counterpart of the JAX
package's ``__graft_entry__.dryrun_multichip``.

    python -m samcarriestheburden_torch.parallel.dryrun [N] [--device cpu|cuda]
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence

ROOT = Path(__file__).resolve().parents[2]


def free_port() -> str:
    """An ephemeral port on localhost for the group's store."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return str(s.getsockname()[1])


def run_workers(job, world: int, *, backend: str = "gloo", device: str = "cpu",
                spec: Optional[dict] = None, out: str = ".", timeout: float = 300,
                cards: Optional[Sequence[int]] = None) -> List[List[dict]]:
    """Start the ``world`` ranks of ``python -m
    samcarriestheburden_torch.parallel.worker job`` (``job``: a name, or a
    list of names run in turn in one group) at once on a fresh localhost
    port, wait for them within ``timeout`` seconds in all, and return each
    rank's ``RESULT`` records.  Each rank writes to files of its own, so no
    pipe fills while another rank is waited for.  A rank that fails or
    outlasts the timeout kills every rank and raises ``RuntimeError`` with
    its errors: nothing is skipped."""
    import tempfile
    import time

    port = free_port()
    env = {**os.environ,
           "PYTHONPATH": str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = []
    try:
        for r in range(world):
            cmd = [sys.executable, "-m", "samcarriestheburden_torch.parallel.worker",
                   *([job] if isinstance(job, str) else job),
                   "--rank", str(r), "--world", str(world),
                   "--coordinator", f"localhost:{port}", "--backend", backend,
                   "--device", device, "--spec", json.dumps(spec or {}), "--out", str(out)]
            if cards is not None:
                cmd += ["--card", str(cards[r])]
            logs = (tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+"))
            procs.append((r, subprocess.Popen(cmd, stdout=logs[0], stderr=logs[1], text=True,
                                              env=env, cwd=str(ROOT)), logs))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for _, p, _ in procs):
            if any(p.poll() not in (None, 0) for _, p, _ in procs):
                break
            if time.monotonic() > deadline:
                raise RuntimeError(f"{job}: the ranks outlasted {timeout} s; every rank killed")
            time.sleep(0.2)
        for r, p, (_, err_f) in sorted(procs, key=lambda t: t[1].poll() in (None, 0)):
            if p.poll() != 0:
                err_f.seek(0)
                raise RuntimeError(f"{job}: rank {r} of {world} exited {p.returncode} (every "
                                   f"rank killed):\n{err_f.read()[-4000:]}")
        outs = []
        for _, _, (out_f, _) in procs:
            out_f.seek(0)
            outs.append(out_f.read())
    finally:
        for _, p, logs in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            for f in logs:
                f.close()
    return [[json.loads(line[len("RESULT "):]) for line in o.splitlines()
             if line.startswith("RESULT ")] for o in outs]


def dryrun_multiprocess(n: int = 2, device: str = "cpu", timeout: float = 300) -> Dict:
    """Spawn ``n`` processes (gloo) that run one data-parallel U-Net training
    step and one strided encoder batch at ``vit_t``; raise if any process
    fails, if the ranks' losses or parameters differ, or if the encoded
    shards do not cover the batch.  Returns rank 0's record."""
    recs = [r[0] for r in run_workers("dryrun", n, backend="gloo", device=device,
                                      timeout=timeout,
                                      cards=[0] * n if device == "cuda" else None)]
    if len({(r["loss"], r["digest"]) for r in recs}) != 1:
        raise RuntimeError(f"dryrun_multiprocess({n}): the ranks disagree: {recs}")
    if sorted(i for r in recs for i in r["encoded"]) != list(range(2 * n)):
        raise RuntimeError(f"dryrun_multiprocess({n}): the encoder shards miss images")
    if not all(r["finite"] for r in recs):
        raise RuntimeError(f"dryrun_multiprocess({n}): non-finite output")
    print(f"dryrun_multiprocess({n}, {device!r}): train step loss={recs[0]['loss']:.4f} on "
          f"every rank, encode shards {[r['encoded'] for r in recs]} "
          f"{recs[0]['feats_shape']} OK")
    return recs[0]


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=2)
    ap.add_argument("--device", choices=["cpu", "cuda"], default="cpu")
    a = ap.parse_args()
    dryrun_multiprocess(a.n, a.device)
