"""The multi-device layer: ``torch.distributed`` runtime, the mesh, and the
sequence-parallel split of the m/z axis (port of :mod:`dquartic_tpu.parallel`
for ``sp``; ``dp`` and ``tp`` raise until they are ported)."""

from .distributed import initialize_runtime
from .mesh import Mesh, make_mesh, mesh_axis_sizes
from .sequence import halo_exchange, sharded_levels, sp_all_reduce, sp_gather, sp_slice
from .sharding import shard_batch

__all__ = [
    "Mesh", "halo_exchange", "initialize_runtime", "make_mesh", "mesh_axis_sizes",
    "shard_batch", "sharded_levels", "sp_all_reduce", "sp_gather", "sp_slice",
]
