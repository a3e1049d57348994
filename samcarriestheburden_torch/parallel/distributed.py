"""Multi-process initialization and work sharding on ``torch.distributed``
(JAX ``parallel/distributed.py``).

The recipe:

* every process calls :func:`initialize` first, with an explicit backend:
  NCCL for CUDA with one card per rank, gloo for the CPU and for ranks that
  share one card.  Nothing switches backend or device by itself;
* the data axis is the group's ranks (``parallel/mesh.py:make_mesh``, or
  :func:`make_hybrid_mesh` to order them host-major);
* host-side work lists shard per process (:func:`process_shard`), and each
  rank's batch rows are its own (:func:`global_batch`).

The port runs one card per process, so where the JAX package shards a batch
over the devices of one process, the port shards it over processes, and the
collectives are explicit (``train/loop.py``).
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass
from datetime import timedelta
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
#: how long a rank waits for the others to join (and for any collective)
TIMEOUT_S = 600
_TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


@dataclass
class _State:
    backend: str
    device: torch.device


_STATE: Optional[_State] = None


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None, *,
               backend: str, device: str = "cuda") -> torch.device:
    """Join the process group and return this rank's device.

    ``coordinator_address`` ("host:port"), ``num_processes`` and
    ``process_id`` name the group (``tcp://host:port``); all None reads
    ``torchrun``'s environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``), as JAX auto-detects on a pod.

    ``device`` "cuda": the rank runs on card ``local_device_ids[0]``, else on
    card ``LOCAL_RANK`` (else ``process_id``); "cpu": on the CPU.
    ``backend`` "nccl" needs one card per rank and raises for a CPU rank, a
    card index the machine lacks, or two ranks of one host on one card;
    "gloo" takes either device, several ranks sharing one card included.
    Raises if the group does not form within TIMEOUT_S seconds."""
    global _STATE
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if backend == "nccl" and device != "cuda":
        raise ValueError("NCCL runs on CUDA devices only: use backend='gloo' on the CPU")
    if dist.is_initialized():
        raise RuntimeError("the process group is already initialized")
    given = (coordinator_address, num_processes, process_id)
    if all(v is None for v in given):
        missing = [k for k in _TORCHRUN_ENV if k not in os.environ]
        if missing:
            raise ValueError("no coordinator given and no torchrun environment: "
                             f"{', '.join(missing)} unset (start with torchrun, or pass "
                             "--coordinator host:port --num_processes N --process_id p)")
        init_method, rank, world = "env://", int(os.environ["RANK"]), \
            int(os.environ["WORLD_SIZE"])
    elif any(v is None for v in given):
        raise ValueError("coordinator_address, num_processes and process_id go together")
    else:
        init_method, rank, world = f"tcp://{coordinator_address}", int(process_id), \
            int(num_processes)
    if not 0 <= rank < world:
        raise ValueError(f"process id {rank} outside a group of {world}")

    if device == "cpu":
        dev = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' asked for and no CUDA device is available")
        if local_device_ids:
            index = int(local_device_ids[0])
        else:
            index = int(os.environ.get("LOCAL_RANK", rank))
        if index >= torch.cuda.device_count():
            raise ValueError(f"rank {rank} asks for card {index}; this host has "
                             f"{torch.cuda.device_count()}. NCCL runs one card per rank: "
                             "start one process per card, or share a card over gloo")
        dev = torch.device("cuda", index)
        torch.cuda.set_device(dev)
    try:
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world, timeout=timedelta(seconds=TIMEOUT_S))
    except Exception as exc:
        raise RuntimeError(f"rank {rank} of {world}: the {backend} group did not form "
                           f"at {init_method}: {exc}") from exc
    _STATE = _State(backend, dev)
    if backend == "nccl":
        _check_one_card_per_rank(dev)
    return dev


def _check_one_card_per_rank(dev: torch.device) -> None:
    """NCCL refuses two ranks on one card; say so before its first collective
    hangs or fails inside the library.  Reads every rank's (host, card)
    through the group's store."""
    store = dist.distributed_c10d._get_default_store()
    rank, world = dist.get_rank(), dist.get_world_size()
    store.set(f"samcarriestheburden/card/{rank}", f"{socket.gethostname()}:{dev.index}")
    seen = {}
    for r in range(world):
        where = store.get(f"samcarriestheburden/card/{r}").decode()
        if where in seen:
            dist.destroy_process_group()
            raise ValueError(f"ranks {seen[where]} and {r} share card {where}: NCCL runs "
                             "one card per rank (use gloo to share a card)")
        seen[where] = r


def shutdown() -> None:
    """Leave the process group (every rank calls it at its end)."""
    global _STATE
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _STATE = None


def is_multiprocess() -> bool:
    return process_count() > 1


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def backend() -> Optional[str]:
    """The group's backend, None outside a group."""
    return dist.get_backend() if dist.is_available() and dist.is_initialized() else None


def local_device() -> torch.device:
    """The device :func:`initialize` gave this rank (the CPU outside a group)."""
    return _STATE.device if _STATE is not None else torch.device("cpu")


def comm_device() -> torch.device:
    """Where a collective's tensors go: the rank's card under NCCL, the CPU
    under gloo (whose CUDA support stops at all-reduce and broadcast)."""
    return local_device() if backend() == "nccl" else torch.device("cpu")


def barrier() -> None:
    if is_multiprocess():
        dist.barrier()


def process_shard(items: Sequence, process_id: Optional[int] = None,
                  num_processes: Optional[int] = None) -> list:
    """Strided per-process slice of a host-side work list (files, stems):
    process p of N handles items[p::N]."""
    p = process_index() if process_id is None else process_id
    n = process_count() if num_processes is None else num_processes
    return list(items)[p::n]


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0 in rank order, on every rank
    (ranks may hold different row counts), on ``x``'s device."""
    if not is_multiprocess():
        return x
    cdev = comm_device()
    world = dist.get_world_size(group)
    n = torch.tensor([x.shape[0]], dtype=torch.int64, device=cdev)
    counts = [torch.zeros_like(n) for _ in range(world)]
    dist.all_gather(counts, n, group=group)
    counts = [int(c) for c in counts]
    top = max(counts)
    pad = torch.zeros((top - x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
    mine = torch.cat([x, pad]).to(cdev).contiguous()
    parts = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(parts, mine, group=group)
    return torch.cat([p[:c] for p, c in zip(parts, counts)]).to(x.device)


def host_value(x, split: bool = False) -> np.ndarray:
    """``x`` as a numpy array on the host.  ``split``: ``x`` is this rank's
    rows of a value split over the ranks; every rank gets the whole value
    (an all-gather in rank order), as JAX's ``process_allgather`` does."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    if split:
        x = all_gather_rows(x)
    return x.detach().cpu().numpy()


def global_batch(mesh, local_tree):
    """This rank's rows of a global batch, in their global order, on the
    rank's device: the global batch is the ranks' local batches concatenated
    in data-axis order (JAX: ``make_array_from_process_local_data``)."""
    from samcarriestheburden_torch.parallel.mesh import tree_map

    return tree_map(lambda x: torch.as_tensor(x).to(mesh.device), local_tree)


@dataclass(frozen=True)
class RankDevice:
    """One rank as a device of the data axis.  ``slice_index`` is its host's
    index (the attribute JAX reads off a multi-slice TPU device)."""

    id: int
    slice_index: int
    host: str = ""


def rank_devices() -> list:
    """Every rank of the group as a :class:`RankDevice`, hosts numbered in
    order of their first rank."""
    world = process_count()
    hosts = [socket.gethostname()] * world
    if world > 1:
        dist.all_gather_object(hosts, socket.gethostname())
    index = {h: i for i, h in enumerate(dict.fromkeys(hosts))}
    return [RankDevice(r, index[h], h) for r, h in enumerate(hosts)]


def make_hybrid_mesh(ici_axis_size: Optional[int] = None,
                     axis_names: Sequence[str] = ("data",),
                     devices: Optional[Sequence] = None):
    """Data mesh with the ranks ordered host-major: the host is the
    slow-varying factor of the data axis, so the ranks of one host
    (NVLink) are neighbours and only large contiguous groups talk across
    the network (ICI and DCN on the TPU).  One host gives the flat order.

    ``devices``: anything with ``slice_index`` (default: the group's ranks,
    :func:`rank_devices`); devices without it count as one host.  A device
    count that ``ici_axis_size`` (default: devices per host) does not divide
    raises ``ValueError``."""
    from samcarriestheburden_torch.parallel.mesh import Mesh

    devices = list(rank_devices() if devices is None else devices)
    n = len(devices)
    n_slices = len({getattr(d, "slice_index", 0) for d in devices})
    ici = ici_axis_size or n // n_slices
    if n % ici:
        raise ValueError(f"{n} devices not divisible by ici size {ici}")
    if n // ici > 1:
        devices = sorted(devices, key=lambda d: getattr(d, "slice_index", 0))
    return Mesh.over(np.asarray(devices, dtype=object), tuple(axis_names))
