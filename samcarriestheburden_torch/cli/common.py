"""What the port's CLIs share (JAX ``cli/common.py``): the training flags
(reference unet_training/hyper_params.py:3-19), the device choice,
``--profile``, the multi-process flags and the data mesh."""

from __future__ import annotations

import argparse
import contextlib

import torch

from samcarriestheburden_torch.config import TrainConfig
from samcarriestheburden_torch.device import resolve_device


def hp_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="training")
    # settings
    p.add_argument("--gpu_id", type=int, default=None,
                   help="accepted for reference-CLI parity; the port trains on the first card")
    p.add_argument("--seed", type=int, default=42, help="seed for reproducibility")
    # hyperparameters
    p.add_argument("--lr", type=float, default=0.001, help="initial learning rate")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--infer_batch_size", type=int, default=16,
                   help="batch size during validation and testing")
    p.add_argument("--weight_decay", type=float, default=0,
                   help="weight decay used by optimizer")
    p.add_argument("--epochs", type=int, default=350,
                   help="number of epochs for training")
    p.add_argument("--data_aug", type=float, default=0.03,
                   help="strength of affine data augmentation.")
    p.add_argument("--lr_scheduler", default=True,
                   action=argparse.BooleanOptionalAction,
                   help="whether to use learning rate scheduler")
    # architecture
    p.add_argument("--n_last_channel", type=int, default=64,
                   help="number of channels before the last convolution")
    # the JAX package's additions
    p.add_argument("--data_root", type=str, default="data")
    p.add_argument("--num_devices", type=int, default=None,
                   help="data-parallel device count (default: every process of the group, "
                        "one card each; more than the group raises: start one process per "
                        "card, torchrun --nproc-per-node N)")
    p.add_argument("--cpu", action="store_true", help="run on the CPU; default: the card")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 forward pass (fp32 master params)")
    p.add_argument("--data_placement", choices=["replicated", "sharded"],
                   default="replicated",
                   help="dataset residency on the ranks: the whole split on every card "
                        "(replicated, small splits) or each rank's block of it (sharded, "
                        "large datasets)")
    add_multihost_flags(p)
    return p


def train_config_from_args(args, **overrides) -> TrainConfig:
    kw = dict(seed=args.seed, lr=args.lr, batch_size=args.batch_size,
              infer_batch_size=args.infer_batch_size,
              weight_decay=args.weight_decay, epochs=args.epochs,
              data_aug=args.data_aug, lr_scheduler=args.lr_scheduler,
              n_last_channel=args.n_last_channel,
              compute_dtype="bfloat16" if getattr(args, "bf16", False) else "float32",
              data_placement=getattr(args, "data_placement", "replicated"))
    kw.update(overrides)
    return TrainConfig(**kw)


def maybe_mesh(args):
    """The data mesh over the process group, None for one process (JAX
    ``maybe_mesh``: the device count reduced by ``gcd`` with the batch size,
    so that a batch splits without padding).  The port runs one card per
    process, so the mesh is the group: ``--num_devices`` above the group's
    size raises ``ValueError`` (start one process per card: ``torchrun
    --nproc-per-node N``), and so does a count, or a ``gcd``, below it,
    which would leave ranks idle.  Nothing runs silently on fewer cards."""
    import math

    from samcarriestheburden_torch.parallel.distributed import process_count

    world = process_count()
    n = getattr(args, "num_devices", None) or world
    if n > world:
        raise ValueError(f"--num_devices {n} with {world} process(es): the port runs one "
                         f"card per process; start {n} (torchrun --nproc-per-node {n} -m "
                         "samcarriestheburden_torch.cli.<cli>, or --multihost on each)")
    batch = getattr(args, "batch_size", None)
    if batch is not None:
        n = math.gcd(n, batch)
    if world == 1:
        return None
    if n != world:
        raise ValueError(f"a mesh of {n} device(s) (--num_devices and the batch size "
                         f"{batch}) in a group of {world} processes would leave ranks idle: "
                         f"use a batch size that {world} divides")
    from samcarriestheburden_torch.parallel.mesh import make_mesh

    return make_mesh(n)


def add_multihost_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--multihost", action="store_true",
                   help="join a process group first (torchrun's environment, or "
                        "--coordinator/--num_processes/--process_id); each process runs on "
                        "its own card (cuda:<local rank>) unless --cpu")
    p.add_argument("--coordinator", type=str, default=None,
                   help="coordinator address host:port (multi-host)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)


def add_profile_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--profile", nargs="?", const="runs/profile", default=None,
                   metavar="DIR",
                   help="capture a torch.profiler trace plus the program's span totals "
                        "(phases.json) into DIR (default runs/profile)")


@contextlib.contextmanager
def profiled(profile_dir):
    """A CLI's profiling scope (nothing when ``profile_dir`` is empty): the
    program's spans recorded (``profiling.recording``) inside a
    ``torch.profiler`` capture, with no synchronisation added; on exit
    writes ``<dir>/phases.json`` (``{span: {total_s, self_s, count,
    mean_ms}}``, host time) and ``<dir>/trace.json``."""
    if not profile_dir:
        yield
        return
    from pathlib import Path

    from samcarriestheburden_torch.profiling import recording, trace

    with recording() as rec:
        try:
            with trace(profile_dir):
                yield
        finally:
            rec.dump(Path(profile_dir) / "phases.json")
            print(f"profile: span totals -> {profile_dir}/phases.json; "
                  f"trace -> {profile_dir}/trace.json")


def setup_backend(args) -> torch.device:
    """The device of a CLI run: the CPU under ``--cpu``, else the card (raises
    without one: nothing falls back to the CPU).  ``--multihost`` first
    joins the process group (``parallel/distributed.py:initialize``, JAX
    ``setup_backend``) and returns this rank's device: ``cuda:<local rank>``
    over NCCL, or the CPU over gloo under ``--cpu``."""
    cpu = getattr(args, "cpu", False)
    if getattr(args, "multihost", False):
        from samcarriestheburden_torch.parallel.distributed import initialize

        return initialize(getattr(args, "coordinator", None),
                          getattr(args, "num_processes", None),
                          getattr(args, "process_id", None),
                          backend="gloo" if cpu else "nccl",
                          device="cpu" if cpu else "cuda")
    if cpu:
        return resolve_device("cpu")
    from samcarriestheburden_torch.parallel.distributed import is_multiprocess, local_device

    # a later CLI call in a process that joined a group runs on the rank's card
    return resolve_device(local_device() if is_multiprocess() else None)


def on_rank0(fn):
    """``fn()`` on rank 0 only (the registry's and the logger's writes), its
    value broadcast to every rank, the others waiting for it; ``fn()`` where
    there is one process."""
    from samcarriestheburden_torch.parallel import distributed as pdist

    if not pdist.is_multiprocess():
        return fn()
    box = [fn() if pdist.process_index() == 0 else None]
    torch.distributed.broadcast_object_list(box, src=0)
    return box[0]
