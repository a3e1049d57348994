"""Mid-training checkpoint and resume (JAX ``train/checkpoint.py``, there
through Orbax; here ``torch.save``).

The reference never saves optimiser state, so a crashed 350-epoch run
restarts from zero (SURVEY §5).  Here the whole training state (the U-Net's
weights, AdamW's moments and step, the epoch) goes into ``epoch_{:05d}/``
every N epochs, written whole or not at all, and training resumes exactly.
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path
from typing import Optional

import torch

STATE_FILE = "train_state.pt"


def save_train_state(directory, epoch: int, model: torch.nn.Module,
                     optimizer: torch.optim.Optimizer) -> Path:
    directory = Path(directory).resolve()
    directory.mkdir(parents=True, exist_ok=True)
    path = directory / f"epoch_{epoch:05d}"
    tmp = directory / f".epoch_{epoch:05d}.tmp"     # outside latest_checkpoint's glob
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir()
    torch.save({"model": model.state_dict(), "optimizer": optimizer.state_dict(),
                "epoch": epoch}, tmp / STATE_FILE)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    return path


def latest_checkpoint(directory) -> Optional[Path]:
    directory = Path(directory)
    if not directory.exists():
        return None
    ckpts = sorted(directory.glob("epoch_*"))
    return ckpts[-1] if ckpts else None


def restore_train_state(path, model: torch.nn.Module,
                        optimizer: torch.optim.Optimizer) -> int:
    """Load a saved state into ``model`` and ``optimizer`` in place (the
    tensors go to their parameters' device; AdamW's step counts stay on the
    host, where it keeps them); returns the epoch it was saved after."""
    state = torch.load(Path(path) / STATE_FILE, map_location="cpu", weights_only=True)
    model.load_state_dict(state["model"])
    optimizer.load_state_dict(state["optimizer"])
    return int(state["epoch"])
