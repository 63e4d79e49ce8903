"""Tensor parallelism: the wide leaves split over the ``tp`` process group
(port of :mod:`dquartic_tpu.parallel.sharding`'s parameter rule).

Which leaves: JAX's rule (:func:`spec_for_shape`) applied to each
parameter's JAX shape, through the name and layout map of
:func:`~dquartic_tpu_torch.compat.jax_params.torch_layouts`: the last
(output) axis when it is at least ``min_tp_features`` long and ``tp``
divides it, else the second to last (input) axis on the same terms, else
none. So the port shards exactly the leaves JAX shards, on the same axis;
flax's last axis of a conv or dense kernel is torch ``weight`` axis 0.
Each rank keeps the contiguous shard ``[r·n, (r+1)·n)`` of its rank r.

How a sharded leaf is used:

* a product whose weight is split on its output axis (conv, 1x1 conv,
  linear, int8 conv) computes its column shard, its bias shard added, and
  gathers the activation over the group (:func:`product`);
* a product split on its input axis takes its slice of the input, forms
  the partial product and sums it over the group, then adds the bias;
* any other sharded leaf (a norm's gains, the weights a kernel op takes
  whole) is gathered where it is used (:func:`full`).

Everything downstream of a gather or a sum is computed alike on every tp
rank, so every cotangent that reaches a collective is whole and alike on
every rank: the backward of a gather keeps the rank's slice, of a sum is
the identity, and of a slice gathers. One sum remains in the backward: the
input of an output-axis product gets from each rank the part of its
cotangent that the rank's columns carry (``dy_r · W_r``), so it enters the
product through :func:`tp_copy`, the identity whose backward sums over the
group (Megatron's column-parallel input). Replicated parameters then get
identical gradients with no reduction over tp, and a sharded one its
shard's.

A gather moves bf16 tensors as they are, except over gloo, whose CUDA
collectives lack bf16: there they travel as float32 (exact). A sum of bf16
partials is taken in float32 on every backend, so it is rounded once.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn


# the smallest axis the rule splits: the JAX Trainer's default
MIN_TP_FEATURES = 2048


def spec_for_shape(shape, tp: int, min_tp_features: int) -> Optional[int]:
    """The axis of a (flax) ``shape`` that the JAX rule splits over ``tp``
    (:func:`dquartic_tpu.parallel.sharding._spec_for_shape`), or None."""
    if tp <= 1 or len(shape) == 0:
        return None
    nd = len(shape)
    if shape[-1] >= min_tp_features and shape[-1] % tp == 0:
        return nd - 1
    if nd >= 2 and shape[-2] >= min_tp_features and shape[-2] % tp == 0:
        return nd - 2
    return None


@dataclasses.dataclass(frozen=True)
class TPSpec:
    """How a module's leaves lie on the tp group: ``dims`` maps each sharded
    parameter or buffer name to the torch axis it is split on."""

    group: Any
    rank: int
    size: int
    dims: Dict[str, int]

    def full_shape(self, name: str, shape) -> Tuple[int, ...]:
        shape = list(shape)
        shape[self.dims[name]] *= self.size
        return tuple(shape)


# --------------------------------------------------------------------- #
# collectives with their adjoints                                       #
# --------------------------------------------------------------------- #


def _wire(x: torch.Tensor, group) -> torch.Tensor:
    # gloo's CUDA collectives lack bf16; widening to float32 is exact
    if x.dtype == torch.bfloat16 and dist.get_backend(group) == "gloo":
        return x.float()
    return x.contiguous()


def gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' tensors concatenated along ``dim`` in rank order (no
    autograd)."""
    size = dist.get_world_size(group)
    w = _wire(x, group)
    parts = [torch.empty_like(w) for _ in range(size)]
    dist.all_gather(parts, w, group=group)
    return torch.cat(parts, dim=dim).to(x.dtype)


def rank_slice(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's contiguous slice of ``x`` along ``dim`` (a view)."""
    size, r = dist.get_world_size(group), dist.get_rank(group)
    if x.shape[dim] % size:
        raise ValueError(f"length {x.shape[dim]} does not split over {size} tp ranks")
    n = x.shape[dim] // size
    return x.narrow(dim, r * n, n)


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    w = x.float() if x.dtype == torch.bfloat16 else x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(w, group=group)
    return w.to(x.dtype)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return rank_slice(g, ctx.group, ctx.dim).contiguous(), None, None


class _Slice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return rank_slice(x, group, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return gather(g, ctx.group, ctx.dim), None, None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


def tp_copy(x: torch.Tensor, group) -> torch.Tensor:
    """The identity; backward: the sum of the cotangent over the group."""
    return _Copy.apply(x, group)


def tp_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Gather along ``dim``; backward: the rank's slice of the cotangent."""
    return _Gather.apply(x, group, dim % x.dim())


def tp_slice(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The rank's slice along ``dim``; backward: the gathered cotangent."""
    return _Slice.apply(x, group, dim % x.dim())


def tp_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group; backward: the identity."""
    return _Sum.apply(x, group)


# --------------------------------------------------------------------- #
# use of the leaves in the layers                                       #
# --------------------------------------------------------------------- #


def full(module: nn.Module, name: str) -> torch.Tensor:
    """The module's parameter ``name`` whole: itself when it is not
    sharded, else gathered over the tp group (backward: its shard of the
    gradient)."""
    p = getattr(module, name)
    spec = getattr(module, "tp", None)
    if spec is None or name not in spec.dims:
        return p
    return tp_gather(p, spec.group, spec.dims[name])


def product(spec: TPSpec, out_axis: bool, x: torch.Tensor,
            fn: Callable[[torch.Tensor, Optional[torch.Tensor]], torch.Tensor],
            bias: Optional[torch.Tensor], dim: int) -> torch.Tensor:
    """A layer's product under tp: ``fn(x, bias)`` runs the product of x
    with the rank's shard of the weight (and adds ``bias`` when given);
    ``dim`` is the channel axis of x and of the result. ``out_axis``: the
    weight is split on its output axis (column shard, bias shard, gather);
    else on its input axis (the slice of x, the partial product summed over
    the group, then the whole bias)."""
    if out_axis:
        return tp_gather(fn(tp_copy(x, spec.group), bias), spec.group, dim)
    y = tp_sum(fn(tp_slice(x, spec.group, dim), None), spec.group)
    if bias is None:
        return y
    shape = [1] * y.dim()
    shape[dim] = -1
    return y + bias.to(y.dtype).reshape(shape)


# --------------------------------------------------------------------- #
# the plan, the shards and the whole state                              #
# --------------------------------------------------------------------- #


def tp_plan(names_and_shapes: Dict[str, Tuple[int, ...]], tp: int,
            min_tp_features: int = MIN_TP_FEATURES) -> Dict[str, int]:
    """``{torch name: torch axis}`` of the parameters the JAX rule splits
    over ``tp``, from the model's names and (whole) torch shapes."""
    from ..compat.jax_params import torch_layouts

    plan = {}
    for name, (_, perm) in torch_layouts(names_and_shapes).items():
        tshape = tuple(names_and_shapes[name])
        if perm is None:  # a norm: (C,) in flax, (1, C, 1) here
            fshape, to_torch = (tshape[1],), (1,)
        else:
            fshape = [0] * len(perm)
            for i, a in enumerate(perm):
                fshape[a] = tshape[i]
            to_torch = tuple(perm.index(a) for a in range(len(perm)))
        axis = spec_for_shape(tuple(fshape), tp, min_tp_features)
        if axis is not None:
            plan[name] = to_torch[axis]
    return plan


def _split(name: str):
    mod, _, leaf = name.rpartition(".")
    return mod, leaf


def shard_model(model: nn.Module, mesh, min_tp_features: int = MIN_TP_FEATURES) -> nn.Module:
    """Split the JAX rule's leaves of ``model`` over ``mesh``'s tp group in
    place: each keeps its rank's shard (on the meta device too, before the
    model is materialized), and each module that holds one gets a
    :class:`TPSpec` as ``module.tp``, and the model its
    ``tp_min_features``. A model split already raises."""
    if mesh is None or mesh.tp == 1:
        return model
    if getattr(model, "tp_min_features", None) is not None:
        raise ValueError("the model's wide leaves are split over tp already")
    shapes = {n: tuple(t.shape) for n, t in model.state_dict().items()}
    plan = tp_plan(shapes, mesh.tp, min_tp_features)
    by_module: Dict[str, Dict[str, int]] = {}
    for name, dim in plan.items():
        mod, leaf = _split(name)
        by_module.setdefault(mod, {})[leaf] = dim
    for mod_name, dims in by_module.items():
        module = model.get_submodule(mod_name)
        spec = TPSpec(mesh.tp_group, mesh.tp_rank, mesh.tp, dims)
        for leaf, dim in dims.items():
            t = getattr(module, leaf)
            n = t.shape[dim] // mesh.tp
            t.data = t.data.narrow(dim, mesh.tp_rank * n, n).clone()
        module.tp = spec
    model.tp_min_features = min_tp_features
    return model


def leaf_specs(model: nn.Module) -> Dict[str, Tuple[TPSpec, int]]:
    """``{name: (spec, axis)}`` of the model's sharded parameters and
    buffers."""
    out = {}
    for mod_name, module in model.named_modules():
        spec = getattr(module, "tp", None)
        if spec is not None:
            for leaf, dim in spec.dims.items():
                out[f"{mod_name}.{leaf}" if mod_name else leaf] = (spec, dim)
    return out


def full_state_dict(model: nn.Module, device="cpu") -> Dict[str, torch.Tensor]:
    """The model's state_dict with every sharded leaf gathered whole, one
    leaf at a time, onto ``device`` (every rank of the tp group calls it);
    the state_dict itself for an unsplit model."""
    specs = leaf_specs(model)
    out = {}
    for name, t in model.state_dict().items():
        if name in specs:
            spec, dim = specs[name]
            t = gather(t, spec.group, dim)
        out[name] = t.to(device)
    return out


def shard_state_dict(model: nn.Module, sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A whole state_dict cut to this rank's shards of the model's sharded
    leaves (views; ``load_state_dict`` copies them)."""
    specs = leaf_specs(model)
    out = dict(sd)
    for name, (spec, dim) in specs.items():
        if name in out:
            out[name] = own(out[name], spec, dim)
    return out


def own(t: torch.Tensor, spec: TPSpec, dim: int) -> torch.Tensor:
    """This rank's shard of a whole tensor along ``dim`` (a view)."""
    n = t.shape[dim] // spec.size
    return t.narrow(dim, spec.rank * n, n)
