"""Bring up ``torch.distributed`` and feed each process its own rows (port of
:mod:`dquartic_tpu.parallel.distributed`).

A process learns of its peers from its caller (the rank, the number of
processes and where they meet: ``tcp://host:port`` or ``file://path``) or
from the standard launcher's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``, set by ``python -m
torch.distributed.run``, which ships with torch). Launched so, each rank
takes the card ``cuda:LOCAL_RANK``.

The backend is ``nccl`` where each rank has a card of its own, and
``gloo`` where ranks share a card or run on the CPU. The port's collectives
are ``all_reduce``, ``all_gather`` and ``broadcast``, which both backends
implement on CUDA tensors (gloo has no CUDA ``reduce_scatter``), so ranks
may share one card.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Optional

import torch
import torch.distributed as dist


def launched_world_size() -> int:
    """The number of processes the launcher started (1 without one)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def local_device(device=None) -> torch.device:
    """``device`` as given, or this launched rank's card: ``cuda:LOCAL_RANK``
    (modulo the cards there are, so that ranks may share one)."""
    if device is not None:
        return torch.device(device)
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % max(1, torch.cuda.device_count()))


def pick_backend(device) -> str:
    """``nccl`` for CUDA ranks that each have a card of their own, else
    ``gloo``."""
    device = torch.device(device)
    local_ranks = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1")))
    if device.type == "cuda" and dist.is_nccl_available() and \
            torch.cuda.device_count() >= local_ranks:
        return "nccl"
    return "gloo"


def initialize_runtime(
    backend: Optional[str] = None,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    init_method: Optional[str] = None,
    timeout_s: Optional[float] = None,
    device=None,
) -> int:
    """Initialise the default process group once and return the number of
    processes. Idempotent: a second call returns the running group's size
    (and raises if it names another). Without ``rank``, ``world_size`` and
    ``init_method`` it reads the launcher's environment (``env://``). One
    process (``world_size`` 1 and no launcher) needs no group: a no-op that
    returns 1. ``backend`` None picks it for ``device`` (None: this launched
    rank's card) by :func:`pick_backend`. ``timeout_s`` bounds each
    collective's wait for the other ranks (the backend's default when
    None)."""
    if dist.is_initialized():
        size = dist.get_world_size()
        if world_size is not None and world_size != size:
            raise ValueError(f"a process group of {size} ranks is already running, not {world_size}")
        return size
    if rank is None and world_size is None and init_method is None and launched_world_size() > 1:
        rank, world_size, init_method = (int(os.environ["RANK"]), launched_world_size(),
                                         "env://")
    if (world_size or 1) == 1 and init_method is None:
        return 1
    if rank is None or world_size is None or init_method is None:
        raise ValueError("initialize_runtime: name the rank, the world_size and the init_method")
    if backend is None:
        backend = pick_backend(local_device(device))
    kw = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size,
                            **kw)
    return world_size


def row_range(rows: int, mesh) -> range:
    """The contiguous rows of a global batch of ``rows`` that this
    process's dp replica takes; every sp and tp rank of the replica takes
    the same. Raises when dp does not divide the rows."""
    dp = 1 if mesh is None else mesh.dp
    if rows % dp:
        raise ValueError(f"global batch rows {rows} not divisible by process count {dp} "
                         "(the mesh's dp)")
    n = rows // dp
    start = 0 if mesh is None else mesh.dp_rank * n
    return range(start, start + n)


def local_rows(batch: Any, mesh) -> Any:
    """This process's rows of a global batch (a tensor or array, or a dict,
    tuple or list of them), the counterpart of the JAX
    ``global_batch_from_local``'s input: rows ``[d·n, (d+1)·n)`` for dp
    rank d. A mesh without dp returns the batch unchanged."""
    if mesh is None or mesh.dp == 1:
        return batch
    if isinstance(batch, dict):
        return {k: local_rows(v, mesh) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(local_rows(v, mesh) for v in batch)
    r = row_range(batch.shape[0], mesh)
    return batch[r.start:r.stop]
