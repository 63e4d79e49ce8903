"""The multi-device layer (port of :mod:`dquartic_tpu.parallel`): the
``torch.distributed`` runtime, the (dp, sp, tp) mesh of process groups,
per-process rows (dp), the sequence-parallel split of the m/z axis (sp) and
the tensor-parallel split of the wide leaves (tp)."""

from .distributed import initialize_runtime, local_rows, pick_backend, row_range
from .mesh import Mesh, make_mesh, mesh_axis_sizes
from .sequence import halo_exchange, sharded_levels, sp_all_reduce, sp_gather, sp_slice
from .sharding import shard_batch
from .tensor import full_state_dict, shard_model, shard_state_dict, spec_for_shape, tp_plan

__all__ = [
    "Mesh", "full_state_dict", "halo_exchange", "initialize_runtime", "local_rows",
    "make_mesh", "mesh_axis_sizes", "pick_backend", "row_range", "shard_batch",
    "shard_model", "shard_state_dict", "sharded_levels", "sp_all_reduce", "sp_gather",
    "sp_slice", "spec_for_shape", "tp_plan",
]
