"""Optimizer and learning-rate schedule (port of
:mod:`dquartic_tpu.train.optim`).

The JAX optimizer is the optax chain clip_by_global_norm(10) ->
scale_by_adam(0.9, 0.999, 1e-8) -> add_decayed_weights(0.01), scaled by
-lr: decoupled weight decay, which is what ``torch.optim.AdamW`` computes
(p <- p - lr·(m̂/(√v̂ + eps) + wd·p)). The clipping is written out as optax
writes it: ``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm.

``kind="factored"`` is the chain clip_by_global_norm(10) ->
scale_by_factored_rms() (Adafactor's factored second moment, optax's
defaults), scaled by -lr: :class:`ClippedFactoredRMS`.

Under tensor parallelism (:meth:`shard`) a parameter may be a rank's
shard of a leaf split over the ``tp`` group. The clipping norm is then the
global one, optax's over the whole tree: the replicated leaves counted
once, plus the sum over the group of the sharded leaves' squares. AdamW
is elementwise on the shards. The factored statistics that average over
the split axis are summed over the group and divided (their mean); the
axes factored are those of the whole leaf. ``state_dict(whole=...)``
gathers each state tensor of a sharded leaf whole, and ``load_state_dict``
takes a whole state and keeps the rank's shards, so a checkpoint is the
one a single process writes.

Each optimizer saves its state in its own ``state_dict`` form, indexed by
the position of the parameter, and also loads the form
:func:`~dquartic_tpu_torch.compat.jax_params.jax_checkpoint_to_port`
makes of a JAX optimizer state: ``{"kind", "count", <moment>: {name:
tensor}}``, keyed by parameter name.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.tensor import gather, rank_slice


@dataclasses.dataclass(frozen=True)
class WarmupCosineSchedule:
    """Linear warmup then cosine decay, evaluated per epoch: epochs <
    warmup give ``(epoch+1)/warmup``, afterwards
    ``max(1e-10, 0.5*(1+cos(pi*2*cycles*progress)))``. :meth:`clamped`
    applies the reference's clamp ``warmup = epochs // 2`` when warmup >
    epochs."""

    base_lr: float
    num_warmup_steps: int
    num_training_steps: int
    num_cycles: float = 0.5

    def scale(self, epoch: int) -> float:
        if epoch < self.num_warmup_steps:
            return float(epoch + 1) / float(max(1, self.num_warmup_steps))
        progress = float(epoch - self.num_warmup_steps) / float(
            max(1, self.num_training_steps - self.num_warmup_steps)
        )
        return max(1e-10, 0.5 * (1.0 + math.cos(math.pi * self.num_cycles * 2.0 * progress)))

    def __call__(self, epoch: int) -> float:
        return self.base_lr * self.scale(epoch)

    @classmethod
    def clamped(
        cls, base_lr: float, warmup_epochs: int, num_epochs: int, num_cycles: float = 0.5
    ) -> "WarmupCosineSchedule":
        if warmup_epochs > num_epochs:
            warmup_epochs = num_epochs // 2
        return cls(base_lr, warmup_epochs, num_epochs, num_cycles)


def global_norm(tensors: List[torch.Tensor], split: Optional[Sequence[bool]] = None,
                group=None) -> torch.Tensor:
    """float32 L2 norm over all the tensors (optax ``global_norm``). With
    ``group``, the tensors marked in ``split`` are each a rank's shard of a
    tensor split over the group: their squares are summed over the group,
    the others' counted once."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    if group is None or not any(split):
        return torch.linalg.vector_norm(torch.stack(norms))
    sq = torch.stack(norms).square()
    mask = torch.tensor(list(split), device=sq.device)
    sharded = torch.where(mask, sq, torch.zeros_like(sq)).sum()
    dist.all_reduce(sharded, group=group)
    return torch.sqrt(torch.where(mask, torch.zeros_like(sq), sq).sum() + sharded)


def clip_by_global_norm_(grads: List[torch.Tensor], clip_norm: float,
                         split: Optional[Sequence[bool]] = None, group=None) -> torch.Tensor:
    """Clip the gradients in place (``g / norm * max`` when norm > max) and
    return the norm before clipping, on the device (no host sync);
    ``split`` and ``group`` as :func:`global_norm`."""
    norm = global_norm(grads, split, group)
    # optax: select(norm < max, g, g / norm * max), without a host sync
    denom = torch.where(norm < clip_norm, torch.ones_like(norm), norm / clip_norm)
    torch._foreach_div_(grads, denom)
    return norm


def _check_named(named: dict, kind: str) -> None:
    if named.get("kind") != kind:
        raise ValueError(f"optimizer state of kind {named.get('kind')!r} cannot load into "
                         f"the {kind!r} optimizer (tpu.optimizer)")


class _Sharded:
    """The tensor-parallel state an optimizer shares: for each parameter,
    the axis its leaf is split on over ``tp_group`` (None: replicated)."""

    tp_group = None
    tp_dims: Optional[List[Optional[int]]] = None

    def shard(self, group, dims: Sequence[Optional[int]]) -> None:
        """Mark each parameter (in the order of ``self.params``) as a shard
        split on axis ``dims[i]`` over ``group``, or replicated (None), and
        start from a fresh state."""
        if len(dims) != len(self.params):
            raise ValueError(f"{len(dims)} axes for {len(self.params)} parameters")
        self.tp_group = group if any(d is not None for d in dims) else None
        self.tp_dims = list(dims)
        self.reset()

    def _dims(self) -> List[Optional[int]]:
        return self.tp_dims if self.tp_group is not None else [None] * len(self.params)

    def _clip(self) -> torch.Tensor:
        return clip_by_global_norm_([p.grad for p in self.params], self.clip_norm,
                                    [d is not None for d in self._dims()], self.tp_group)

    def _whole(self, t: Optional[torch.Tensor], dim: Optional[int], device):
        """A state tensor of a shard, gathered whole along ``dim`` onto
        ``device``."""
        if t is None:
            return None
        if dim is not None and self.tp_group is not None:
            t = gather(t, self.tp_group, dim)
        return t.to(device)

    def _own(self, t: Optional[torch.Tensor], dim: Optional[int]):
        """This rank's shard of a whole state tensor."""
        if t is None or dim is None or self.tp_group is None:
            return t
        return rank_slice(t, self.tp_group, dim)


class ClippedAdamW(_Sharded):
    """Global-norm clipping, then ``torch.optim.AdamW``, with the learning
    rate given at each step (the per-epoch schedule sets it)."""

    kind = "adamw"

    def __init__(
        self,
        params: Iterable[torch.nn.Parameter],
        clip_norm: float = 10.0,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        weight_decay: float = 0.01,
    ):
        self.params = [p for p in params if p.requires_grad]
        self.clip_norm = clip_norm
        self.adamw = torch.optim.AdamW(
            self.params, lr=0.0, betas=(b1, b2), eps=eps, weight_decay=weight_decay
        )

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def step(self, lr: float) -> torch.Tensor:
        """Clip the gradients in place (``g / norm * max`` when norm >
        max), take one AdamW step at ``lr``, and return the gradient norm
        before clipping, on the device (no host sync)."""
        norm = self._clip()
        for group in self.adamw.param_groups:
            group["lr"] = lr
        self.adamw.step()
        return norm

    def reset(self) -> None:
        """Fresh moments and step count."""
        self.adamw.state.clear()

    def state_dict(self, whole: Optional[str] = None) -> dict:
        """The AdamW ``state_dict``; with ``whole`` (a device) every moment
        of a sharded parameter gathered whole onto it, one at a time."""
        sd = self.adamw.state_dict()
        if whole is None:
            return sd
        dims = self._dims()
        sd["state"] = {i: {k: self._whole(v, dims[i], whole) if k != "step" else v
                           for k, v in st.items()} for i, st in sd["state"].items()}
        return sd

    def state_layout(self, names: Sequence[str]) -> Dict[str, tuple]:
        """``{"<moment>/<name>": (this rank's shape, split axis or None)}``
        of the moments :meth:`named_state` gives once a step was taken."""
        return {f"{k}/{n}": (tuple(p.shape), d) for p, n, d in zip(self.params, names, self._dims())
                for k in ("exp_avg", "exp_avg_sq")}

    def named_state(self, names: Sequence[str]):
        """This rank's state as it is (its shards under tp), in the
        name-keyed form: ``({"kind", "count"}, {"<moment>/<name>": (tensor,
        split axis or None)})``."""
        st = self.adamw.state
        steps = {float(st[p]["step"]) for p in self.params if p in st}
        if len(steps) > 1:
            raise ValueError(f"the AdamW step counts differ between parameters: {sorted(steps)}")
        moments = {f"{k}/{n}": (st[p][k], d)
                   for p, n, d in zip(self.params, names, self._dims()) if p in st
                   for k in ("exp_avg", "exp_avg_sq")}
        return {"kind": self.kind, "count": int(steps.pop()) if steps else 0}, moments

    def load_state_dict(self, state: dict, names: Optional[Sequence[str]] = None,
                        sharded: bool = False) -> None:
        """Load this optimizer's ``state_dict``, or a name-keyed state
        (optax's ``mu``, ``nu`` and ``count`` as ``exp_avg``,
        ``exp_avg_sq`` and ``step``) for the parameters ``names``, in the
        order of ``self.params`` (a parameter without moments has no
        state). Under tp the moments are whole and each rank keeps its
        shard, or with ``sharded`` they are the rank's shards already."""
        if "kind" in state:
            _check_named(state, self.kind)
            sd = self.adamw.state_dict()
            sd["state"] = {
                i: {"step": torch.tensor(float(state["count"])),
                    "exp_avg": state["exp_avg"][n], "exp_avg_sq": state["exp_avg_sq"][n]}
                for i, n in enumerate(names) if n in state.get("exp_avg", {})
            }
            state = sd
        if self.tp_group is not None and not sharded:
            dims = self._dims()
            state = dict(state, state={
                i: {k: self._own(v, dims[i]) if k != "step" else v for k, v in st.items()}
                for i, st in state["state"].items()})
        self.adamw.load_state_dict(state)


def factored_dims(shape: Sequence[int], min_dim_size_to_factor: int = 128):
    """optax ``_factored_dims``: the (second largest, largest) axes of a
    parameter of at least two axes whose second largest is at least
    ``min_dim_size_to_factor``, else None."""
    if len(shape) < 2:
        return None
    sorted_dims = np.argsort(shape)
    if shape[sorted_dims[-2]] < min_dim_size_to_factor:
        return None
    return int(sorted_dims[-2]), int(sorted_dims[-1])


class ClippedFactoredRMS(_Sharded):
    """Global-norm clipping, then optax ``scale_by_factored_rms()`` with its
    defaults: a second moment kept as row and column means for parameters
    whose two largest axes are both at least 128 long (:func:`factored_dims`),
    a full one for the others, decaying at ``1 - (count + 1)^-0.8``; no first
    moment and no weight decay. Plain torch ops on the float32 parameters.
    The row and column statistics are those of the parameter's own (torch)
    layout; the update does not depend on which of the two is which."""

    kind = "factored"

    def __init__(
        self,
        params: Iterable[torch.nn.Parameter],
        clip_norm: float = 10.0,
        decay_rate: float = 0.8,
        min_dim_size_to_factor: int = 128,
        epsilon: float = 1e-30,
    ):
        self.params = [p for p in params if p.requires_grad]
        self.clip_norm = clip_norm
        self.decay_rate = decay_rate
        self.min_dim_size_to_factor = min_dim_size_to_factor
        self.epsilon = epsilon
        self.reset()

    def _whole_shape(self, p, dim) -> List[int]:
        shape = list(p.shape)
        if dim is not None and self.tp_group is not None:
            shape[dim] *= dist.get_world_size(self.tp_group)
        return shape

    def _stat_dims(self):
        """For each parameter, the split axis of its (v_row, v_col, v)
        (None where the statistic is whole on every rank)."""
        out = []
        for dims, d in zip(self.dims, self._dims()):
            if dims is None or d is None:
                out.append((None, None, d))
                continue
            d1, d0 = dims
            out.append((None if d == d0 else d - (d > d0), None if d == d1 else d - (d > d1), None))
        return out

    def reset(self) -> None:
        """optax's init: zero statistics, count 0; the axes factored are the
        whole leaf's."""
        self.dims = [factored_dims(self._whole_shape(p, d), self.min_dim_size_to_factor)
                     for p, d in zip(self.params, self._dims())]
        self.count = 0
        self.state: List[Dict[str, Optional[torch.Tensor]]] = []
        for p, dims in zip(self.params, self.dims):
            if dims is None:
                self.state.append({"v_row": None, "v_col": None,
                                   "v": torch.zeros_like(p, memory_format=torch.contiguous_format)})
            else:
                d1, d0 = dims
                shape = list(p.shape)
                self.state.append({
                    "v_row": p.new_zeros(shape[:d0] + shape[d0 + 1:]),
                    "v_col": p.new_zeros(shape[:d1] + shape[d1 + 1:]),
                    "v": None,
                })

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self, lr: float) -> torch.Tensor:
        """Clip, take one factored-RMS step at ``lr`` and return the
        gradient norm before clipping, on the device."""
        norm = self._clip()
        # float32 as optax forms it: t = count + 1, rate = 1 - t^-decay
        rate = np.float32(1.0) - np.float32(self.count + 1) ** np.float32(-self.decay_rate)
        keep, new = float(rate), float(np.float32(1.0) - rate)
        for p, dims, st, split in zip(self.params, self.dims, self.state, self._dims()):
            g = p.grad
            grad_sqr = g * g + self.epsilon
            if dims is None:
                v = st["v"].mul_(keep).add_(grad_sqr * new)
                update = g * v.pow(-0.5)
            else:
                d1, d0 = dims
                v_row = st["v_row"].mul_(keep).add_(
                    self._mean(grad_sqr.mean(dim=d0), split == d0) * new)
                v_col = st["v_col"].mul_(keep).add_(
                    self._mean(grad_sqr.mean(dim=d1), split == d1) * new)
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_mean = self._mean(v_row.mean(dim=reduced_d1, keepdim=True), split == d1)
                row_factor = (v_row / row_mean).pow(-0.5)
                update = g * row_factor.unsqueeze(d0) * v_col.pow(-0.5).unsqueeze(d1)
            p.add_(update, alpha=-lr)
        self.count += 1
        return norm

    def _mean(self, t: torch.Tensor, over_split: bool) -> torch.Tensor:
        """A mean taken over a shard's axis, made the whole axis's: summed
        over the tp group and divided by its size."""
        if not over_split:
            return t
        dist.all_reduce(t, group=self.tp_group)
        return t.div_(dist.get_world_size(self.tp_group))

    def state_dict(self, whole: Optional[str] = None) -> dict:
        """The statistics by position; with ``whole`` (a device) those of a
        sharded parameter gathered whole onto it, one at a time."""
        keys = ("v_row", "v_col", "v")
        if whole is None:
            return {"count": self.count, **{k: [st[k] for st in self.state] for k in keys}}
        sdims = self._stat_dims()
        return {"count": self.count,
                **{k: [self._whole(st[k], sd[j], whole) for st, sd in zip(self.state, sdims)]
                   for j, k in enumerate(keys)}}

    def _named(self, names: Sequence[str]):
        for n, st, sd in zip(names, self.state, self._stat_dims()):
            for j, k in enumerate(("v_row", "v_col", "v")):
                if st[k] is not None:
                    yield f"{k}/{n}", st[k], sd[j]

    def state_layout(self, names: Sequence[str]) -> Dict[str, tuple]:
        """``{"<statistic>/<name>": (this rank's shape, split axis or
        None)}`` of :meth:`named_state`."""
        return {key: (tuple(t.shape), d) for key, t, d in self._named(names)}

    def named_state(self, names: Sequence[str]):
        """This rank's statistics as they are (its shards under tp), in the
        name-keyed form: ``({"kind", "count"}, {"<statistic>/<name>":
        (tensor, split axis or None)})``."""
        return ({"kind": self.kind, "count": self.count},
                {key: (t, d) for key, t, d in self._named(names)})

    def load_state_dict(self, state: dict, names: Optional[Sequence[str]] = None,
                        sharded: bool = False) -> None:
        """Load this optimizer's ``state_dict``, or a name-keyed state for
        the parameters ``names`` in the order of ``self.params`` (a
        statistic the parameter does not keep may be absent). Under tp the
        statistics are whole and each rank keeps its shards, or with
        ``sharded`` they are the rank's shards already."""
        keys = ("v_row", "v_col", "v")
        if "kind" in state:
            _check_named(state, self.kind)
            state = {"count": state["count"],
                     **{k: [state[k].get(n) for n in names] for k in keys}}
        self.count = int(state["count"])
        sdims = self._stat_dims()
        for i, (p, st) in enumerate(zip(self.params, self.state)):
            for j, k in enumerate(keys):
                src = state[k][i] if sharded else self._own(state[k][i], sdims[i][j])
                if (st[k] is None) != (src is None):
                    raise ValueError(f"factored optimizer state {k} of parameter {i} "
                                     f"{tuple(p.shape)} does not match")
                if src is not None:
                    st[k].copy_(src)


def make_optimizer(
    params: Iterable[torch.nn.Parameter],
    clip_norm: float = 10.0,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.01,
    kind: str = "adamw",
):
    """clip -> AdamW over ``params``, or with ``kind="factored"`` clip ->
    factored RMS (the JAX ``make_optimizer``)."""
    if kind == "factored":
        return ClippedFactoredRMS(params, clip_norm)
    if kind != "adamw":
        raise ValueError(f"Unknown optimizer kind: {kind!r} (adamw|factored)")
    return ClippedAdamW(params, clip_norm, b1, b2, eps, weight_decay)
