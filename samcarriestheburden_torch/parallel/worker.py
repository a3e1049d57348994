"""One rank of a multi-process run: the module that ``parallel/dryrun.py``,
the two-process tests and ``chip_smoke.py`` spawn, once per rank.

    python -m samcarriestheburden_torch.parallel.worker JOB [JOB ...] --rank R --world N \\
        --coordinator localhost:PORT --backend gloo|nccl --device cpu|cuda \\
        [--card I] [--spec JSON] [--out DIR]

Jobs:

* ``dryrun``: one data-parallel U-Net training step and one strided encoder
  batch at ``vit_t`` (random weights, seed 0);
* ``train``: ``UNetTrainer`` epochs on a mesh of the group, as ``--spec``
  says (:data:`_harness.TRAIN_SPEC`), each placement, then each planted fault
  (replicated placement, not evaluated), in turn;
  per-step losses and a digest of the parameters, and where asked, each
  step held on rank 0 against a single-process trainer from the same state,
  or each step's state written to ``--out`` for a reference elsewhere;
  ``float64`` runs the model, the data and AdamW in double (a harness
  setting: rounding then cannot hide a difference between the data-parallel
  step and one process's, as fp32's cuDNN algorithm choices can), and
  ``probe`` reports how far fp32 rounding alone moves one process's
  gradient (``_harness.py:precision_probe``);
* ``precompute``: ``engine/embeddings.py:encode_images`` over this rank's
  strided shard of seeded X-rays (``--spec``: :data:`_harness.PRECOMPUTE_SPEC`),
  counted, written to ``--out``; then the seeded sweep
  (``cli/save_refined_segmentations.py:refine_images``) over the rank's
  shard of the sweep's stems on those embeddings, counted, written;
* ``nccl``: an all-reduce, a broadcast and a gather of rows on the card,
  then (``--spec``: a ``train`` spec) the ``train`` job;
* ``cli``: the port's CLIs in order, the first through its own
  ``--multihost`` flags (``--spec``: the working directory, the model id,
  the output tag).

Several jobs (not ``cli``) run in turn in one group; ``--spec`` then maps
each job to its settings.

Each job prints ``RESULT <json>`` lines; a failure exits non-zero.  The
jobs live in ``parallel/_harness.py``; this module joins the group and
dispatches them.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from samcarriestheburden_torch.parallel import _harness as harness
from samcarriestheburden_torch.parallel import distributed as pdist
from samcarriestheburden_torch.parallel import mesh as pmesh

JOBS = {"dryrun": harness.run_dryrun, "train": harness.run_train,
        "precompute": harness.run_precompute, "nccl": harness.run_nccl}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="one rank of a multi-process run")
    p.add_argument("jobs", nargs="+", choices=[*JOBS, "cli"],
                   help="the jobs, run in turn in one group")
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--coordinator", default=None, help="host:port of the group")
    p.add_argument("--backend", choices=pdist.BACKENDS, default="gloo")
    p.add_argument("--device", choices=["cpu", "cuda"], default="cpu")
    p.add_argument("--card", type=int, default=None,
                   help="the card of this rank (default: its local rank)")
    p.add_argument("--spec", default="{}",
                   help="the job's settings, JSON (several jobs: {job: settings})")
    p.add_argument("--out", default=".", help="where the jobs write their arrays")
    args = p.parse_args(argv)
    if args.device == "cpu":    # ranks share the host's cores: one intra-op thread each
        torch.set_num_threads(1)
    spec = json.loads(args.spec)
    specs = spec if len(args.jobs) > 1 else {args.jobs[0]: spec}
    if args.jobs == ["cli"]:
        try:
            harness.run_cli(spec, args, args.out)
        finally:
            pdist.shutdown()
        return 0
    pdist.initialize(args.coordinator, args.world, args.rank,
                     None if args.card is None else [args.card], backend=args.backend,
                     device=args.device)
    try:
        mesh = pmesh.make_mesh()
        for job in args.jobs:
            JOBS[job](specs.get(job, {}), mesh, args.out)
            pdist.barrier()
    finally:
        pdist.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
