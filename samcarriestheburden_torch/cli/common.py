"""What the port's CLIs share (JAX ``cli/common.py``): the training flags
(reference unet_training/hyper_params.py:3-19), the device choice,
``--profile`` and the multi-host flags."""

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
                   help="data-parallel device count (default 1: the port trains on one "
                        "card; more raise, ROADMAP queue A item 5)")
    p.add_argument("--cpu", action="store_true", help="run on the CPU; default: the card")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 forward pass (fp32 master params)")
    p.add_argument("--data_placement", choices=["replicated", "sharded"],
                   default="replicated",
                   help="dataset residency: the whole split on the card (replicated); "
                        "sharded is not ported and raises")
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
    """None: the port trains on one device.  More than one raises
    ``NotImplementedError`` (ROADMAP queue A item 5), as ``--multihost`` does."""
    n = getattr(args, "num_devices", None) or 1
    if n > 1:
        raise NotImplementedError(f"--num_devices {n}: data-parallel training is not "
                                  "ported (ROADMAP queue A item 5)")
    return None


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
