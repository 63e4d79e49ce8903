"""Bring up ``torch.distributed`` (port of
:func:`dquartic_tpu.parallel.distributed.initialize_runtime`).

Nothing tells a process of its peers: the caller names the rank, the
number of processes and where they meet (``tcp://host:port`` or
``file://path``). The collectives of the port are all ``all_reduce``, which
the ``gloo`` backend implements for CPU and CUDA tensors alike, so two
ranks may share one card.
"""

from __future__ import annotations

import datetime
from typing import Optional

import torch.distributed as dist


def initialize_runtime(
    backend: str = "gloo",
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    init_method: Optional[str] = None,
    timeout_s: Optional[float] = None,
) -> int:
    """Initialise the default process group once and return the number of
    processes. Idempotent: a second call returns the running group's size
    (and raises if it names another). One process (``world_size`` None or
    1, no ``init_method``) needs no group: a no-op that returns 1.
    ``timeout_s`` bounds each collective's wait for the other ranks (the
    backend's default when None)."""
    if dist.is_initialized():
        size = dist.get_world_size()
        if world_size is not None and world_size != size:
            raise ValueError(f"a process group of {size} ranks is already running, not {world_size}")
        return size
    if (world_size or 1) == 1 and init_method is None:
        return 1
    if rank is None or world_size is None or init_method is None:
        raise ValueError("initialize_runtime: name the rank, the world_size and the init_method")
    kw = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size,
                            **kw)
    return world_size
