"""The device mesh (port of :mod:`dquartic_tpu.parallel.mesh`).

The JAX mesh names three axes: ``dp`` (rows of the batch), ``sp`` (the m/z
axis of the U-Net activations) and ``tp`` (the feature axes of the wide
leaves). Here a mesh is one process per rank, and each axis is a
``torch.distributed`` process group: the ranks that differ only in their
coordinate on that axis. Ranks follow JAX's device order,
``reshape(dp, sp, tp)``, so mesh rank ``(d·sp + s)·tp + t`` sits at
``(d, s, t)``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis sizes, this process's mesh rank and the process group of each
    axis it lies on (None for an axis of size 1)."""

    dp: int = 1
    sp: int = 1
    tp: int = 1
    sp_group: Any = None
    dp_group: Any = None
    tp_group: Any = None
    rank: int = 0

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp, "sp": self.sp, "tp": self.tp}

    @property
    def dp_rank(self) -> int:
        """This process's replica: the rows of the batch it takes."""
        return self.rank // (self.sp * self.tp)

    @property
    def sp_rank(self) -> int:
        """This process's slice of m/z."""
        return (self.rank // self.tp) % self.sp

    @property
    def tp_rank(self) -> int:
        """This process's shard of the wide leaves."""
        return self.rank % self.tp


def _launcher_hint(n: int) -> str:
    return (f"launch {n} processes with `python -m torch.distributed.run --nproc-per-node {n} "
            "-m dquartic_tpu_torch.cli ...`, or call initialize_runtime in each")


def make_mesh(dp: int = 1, sp: int = 1, tp: int = 1,
              ranks: Optional[Sequence[int]] = None) -> Optional[Mesh]:
    """A (dp, sp, tp) mesh over the global ``ranks`` (default: every process
    of the running group), whose number is ``dp·sp·tp``. Every process of
    the running group must call it alike, members or not, since each axis
    group is made with ``torch.distributed.new_group``; a process outside
    ``ranks`` gets None."""
    if min(dp, sp, tp) < 1:
        raise ValueError(f"mesh axes must be >= 1 (got dp={dp}, sp={sp}, tp={tp})")
    n = dp * sp * tp
    if n == 1:
        return Mesh()
    if not dist.is_available() or not dist.is_initialized():
        raise ValueError(
            f"a mesh of dp={dp}, sp={sp}, tp={tp} needs a running torch.distributed process "
            f"group of {n} ranks in every process: {_launcher_hint(n)}")
    ranks = list(range(dist.get_world_size())) if ranks is None else list(ranks)
    if len(ranks) != n:
        raise ValueError(f"dp*sp*tp = {dp}*{sp}*{tp} = {n} does not match the {len(ranks)} "
                         f"ranks of the mesh ({_launcher_hint(n)})")
    me = dist.get_rank()

    def coords(i):
        return i // (sp * tp), (i // tp) % sp, i % tp

    groups = {}
    for axis, size in (("dp", dp), ("sp", sp), ("tp", tp)):
        if size == 1:
            continue
        # one group per line along the axis, made by every process in one order
        lines: Dict[tuple, list] = {}
        for i in range(n):
            d, s, t = coords(i)
            key = {"dp": (s, t), "sp": (d, t), "tp": (d, s)}[axis]
            lines.setdefault(key, []).append(ranks[i])
        for members in lines.values():
            g = dist.new_group(members)
            if me in members:
                groups[axis] = g
    if me not in ranks:
        return None
    return Mesh(dp=dp, sp=sp, tp=tp, sp_group=groups.get("sp"), dp_group=groups.get("dp"),
                tp_group=groups.get("tp"), rank=ranks.index(me))


def mesh_axis_sizes(mesh: Optional[Mesh]) -> Dict[str, int]:
    return dict(mesh.shape) if mesh is not None else {"dp": 1, "sp": 1, "tp": 1}
