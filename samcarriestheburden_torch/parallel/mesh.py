"""The data axis and its placements (JAX ``parallel/mesh.py``).

JAX builds a ``Mesh`` over the chips of one program, annotates batch axes
with ``P('data')`` and lets XLA insert the collectives.  The port runs one
card per process, so its mesh is the process group: each rank is one
position of the data axis, holds its own rows of a batch, and the
collectives are explicit (``train/loop.py``).  The names are JAX's, so a
reader finds the counterpart; nothing here needs DTensor.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from samcarriestheburden_torch.parallel import distributed as pdist


def tree_map(fn, tree):
    """``fn`` over the leaves of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


@dataclass(frozen=True)
class Mesh:
    """A 1-D data axis over processes: ``devices`` in data-axis order (one
    per rank), ``index`` this rank's position on it (None where the devices
    are not the group's own, as in a test of the ordering), ``device`` this
    rank's device and ``group`` the process group of its collectives (None:
    the default group)."""

    devices: np.ndarray
    axis_names: tuple
    index: Optional[int]
    device: torch.device
    group: Any = None

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @classmethod
    def over(cls, devices: np.ndarray, axis_names=("data",)) -> "Mesh":
        rank = pdist.process_index()
        index = next((i for i, d in enumerate(devices.reshape(-1))
                      if getattr(d, "id", None) == rank), None)
        return cls(devices.reshape(-1), tuple(axis_names), index, pdist.local_device())


def make_mesh(num_devices: Optional[int] = None) -> Mesh:
    """The data axis over every rank of the group, in rank order (one
    process: a mesh of one).  ``num_devices`` other than the group's size
    raises ``ValueError``: the port runs one card per process, so a mesh of N
    needs N processes (``torchrun --nproc-per-node N``), and none runs
    silently on fewer cards than asked for."""
    world = pdist.process_count()
    n = world if num_devices is None else int(num_devices)
    if n != world:
        raise ValueError(f"a mesh of {n} devices needs {n} processes, one per card "
                         f"(torchrun --nproc-per-node {n}); this group has {world}")
    return Mesh.over(np.asarray(pdist.rank_devices(), dtype=object))


class Sharding(NamedTuple):
    """A placement on the mesh: ``spec`` ("data",) splits the leading axis
    over the ranks (each holds its contiguous block), () replicates."""

    mesh: Mesh
    spec: tuple


def batch_sharding(mesh: Mesh, axis: str = "data") -> Sharding:
    """The leading (batch) axis split over the ranks: rank i holds rows
    [i * B / n, (i + 1) * B / n) on its device (JAX ``P('data')``)."""
    return Sharding(mesh, (axis,))


def replicated(mesh: Mesh) -> Sharding:
    """The whole value on every rank's device, rank 0's copy (JAX ``P()``)."""
    return Sharding(mesh, ())


def shard_batch(mesh: Mesh, tree, axis: str = "data"):
    """This rank's contiguous rows of each batched array of ``tree``, on its
    device.  The leading axis must divide by the mesh's size."""
    def rows(x):
        x = torch.as_tensor(x)
        if x.shape[0] % mesh.size:
            raise ValueError(f"leading axis {x.shape[0]} does not divide over "
                             f"{mesh.size} ranks (pad_to_multiple first)")
        b = x.shape[0] // mesh.size
        return x[mesh.index * b:(mesh.index + 1) * b].to(mesh.device)
    return tree_map(rows, tree)


def replicate(mesh: Mesh, tree):
    """Every tensor of ``tree`` as the mesh's first rank holds it, broadcast
    to each rank's device (new tensors; ``tree`` is not changed)."""
    src = int(getattr(mesh.devices[0], "id", 0))

    def bcast(x):
        x = torch.as_tensor(x).to(mesh.device)
        if mesh.size > 1:
            buf = x.to(pdist.comm_device()).contiguous()
            dist.broadcast(buf, src, group=mesh.group)
            x = buf.to(mesh.device)
        return x
    return tree_map(bcast, tree)


def pad_to_multiple(batch: np.ndarray, multiple: int):
    """Pad the leading axis to a multiple (device count divisibility);
    returns (padded, valid_count)."""
    n = batch.shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return batch, n
    padding = np.zeros((pad,) + batch.shape[1:], batch.dtype)
    return np.concatenate([batch, padding]), n
