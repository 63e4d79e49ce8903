"""Placing a batch on the mesh (port of
:func:`dquartic_tpu.parallel.sharding.shard_batch` for the ``sp`` axis)."""

from __future__ import annotations

from typing import Any, Optional

import torch

from .mesh import Mesh
from .sequence import sp_slice


def shard_batch(batch: Any, mesh: Optional[Mesh]) -> Any:
    """This rank's slice of the m/z axis (the last) of every window, a
    tensor of 3 or more dimensions such as (b, rt, mz), in a tensor, tuple,
    list or dict; other values (the (b, rt) MS1 traces, the timesteps) are
    replicated and pass through. The slice is :func:`sp_slice`, so autograd
    sees it. A mesh without ``sp`` returns the batch unchanged."""
    if mesh is None or mesh.sp == 1:
        return batch

    def put(x):
        if isinstance(x, torch.Tensor) and x.dim() >= 3:
            return sp_slice(x, mesh.sp_group, dim=-1)
        return x

    if isinstance(batch, dict):
        return {k: put(v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(put(v) for v in batch)
    return put(batch)
