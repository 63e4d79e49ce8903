"""The device mesh (port of :mod:`dquartic_tpu.parallel.mesh`).

The JAX mesh names three axes: ``dp`` (rows), ``sp`` (the m/z axis of the
U-Net activations) and ``tp`` (the wide mid convs). Here a mesh is one
process per device, and the ``sp`` axis is a ``torch.distributed`` process
group whose ranks each hold a slice of m/z. ``dp > 1`` (data parallelism,
to come as DDP) and ``tp > 1`` (tensor-parallel mid convs) are not ported
yet and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis sizes and the ``sp`` process group (None when ``sp == 1``)."""

    dp: int = 1
    sp: int = 1
    tp: int = 1
    sp_group: Any = None

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp, "sp": self.sp, "tp": self.tp}

    @property
    def sp_rank(self) -> int:
        """This process's rank on the ``sp`` axis: its slice of m/z."""
        return dist.get_rank(self.sp_group) if self.sp > 1 else 0


def make_mesh(dp: int = 1, sp: int = 1, tp: int = 1, group: Optional[Any] = None) -> Mesh:
    """A (dp, sp, tp) mesh whose ``sp`` axis is ``group`` (default: the
    whole running process group), which must hold exactly ``sp`` ranks."""
    if dp != 1:
        raise ValueError(
            f"dp={dp}: data parallelism (DDP over the rows) is not ported yet; "
            "the port's mesh takes dp=1")
    if tp != 1:
        raise ValueError(
            f"tp={tp}: tensor-parallel mid convs are not ported yet; the port's mesh takes tp=1")
    if sp < 1:
        raise ValueError(f"sp must be >= 1 (got {sp})")
    if sp == 1:
        return Mesh()
    if not dist.is_available() or not dist.is_initialized():
        raise ValueError(
            f"a mesh with sp={sp} needs a running torch.distributed process group of {sp} "
            "ranks (initialize_runtime) in every process")
    group = dist.group.WORLD if group is None else group
    size = dist.get_world_size(group)
    if size != sp:
        raise ValueError(f"the sp axis needs a group of {sp} ranks; this one holds {size}")
    return Mesh(sp=sp, sp_group=group)


def mesh_axis_sizes(mesh: Optional[Mesh]) -> Dict[str, int]:
    return dict(mesh.shape) if mesh is not None else {"dp": 1, "sp": 1, "tp": 1}
