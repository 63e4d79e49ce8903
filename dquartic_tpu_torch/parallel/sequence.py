"""Sequence parallelism: the m/z axis of the U-Net's activations split over
the ranks of an ``sp`` process group.

In JAX one sharding constraint per level shards ``(b·rt, mz', C)`` over
the ``sp`` mesh axis, and XLA's SPMD partitioner inserts every halo
exchange and gather. Here those steps are written out, each a function of
the global tensor, so that the same inputs give the same numbers at every
``sp``:

* :func:`sharded_levels` — the level plan: rank r owns columns
  ``[r·N/S, (r+1)·N/S)`` of the leading levels whose width N is a
  multiple of S; from the first level where it is not, the model runs
  replicated on every rank;
* :func:`sp_slice`, :func:`sp_gather` — enter and leave a slice, as
  autograd functions;
* :func:`halo_exchange` — the neighbours' edge columns a conv reaches
  across a slice's edge, zeros at the global ends (what padding does);
* :func:`sp_all_reduce` — a sum over the ranks.

Every collective is one ``torch.distributed.all_reduce`` (a gather is the
all-reduce of a zero buffer that holds the rank's own slice), which gloo
and NCCL implement for CPU and CUDA tensors alike; bf16 tensors travel as
float32, which the zeros of a gather leave exact.

Gradients: a tensor that every rank holds alike (a replicated level, a
parameter) carries on each rank a partial cotangent, and the sum over the
ranks is its gradient; a sliced tensor carries its own slice's cotangent.
So the backward of a slice pads with zeros, and the backward of a gather
sums over the ranks and keeps the rank's slice. ``sp_gather(grad="slice")``
is the exception for a result that every rank then uses alike, such as a
model output under a loss that every rank computes in full: its cotangent
is already whole on every rank, and the rank keeps its slice without a sum.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _rank_size(group):
    return dist.get_rank(group), dist.get_world_size(group)


def sp_all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` in place over the ranks of ``group`` (float32 on the wire
    for bf16) and return it."""
    if t.dtype == torch.bfloat16:
        wire = t.float()
        dist.all_reduce(wire, group=group)
        return t.copy_(wire)
    dist.all_reduce(t, group=group)
    return t


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    r, size = _rank_size(group)
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * size
    buf = x.new_zeros(shape, dtype=torch.float32)
    buf.narrow(dim, r * n, n).copy_(x)
    dist.all_reduce(buf, group=group)
    return buf.to(x.dtype)


def _own(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    r, size = _rank_size(group)
    if x.shape[dim] % size:
        raise ValueError(f"length {x.shape[dim]} does not split over {size} ranks")
    n = x.shape[dim] // size
    return x.narrow(dim, r * n, n).contiguous()


class _Slice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.full = group, dim, x.shape
        return _own(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        r, _ = _rank_size(ctx.group)
        n = g.shape[ctx.dim]
        out = g.new_zeros(ctx.full)
        out.narrow(ctx.dim, r * n, n).copy_(g)
        return out, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, grad):
        ctx.group, ctx.dim, ctx.grad = group, dim, grad
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad == "sum":
            g = sp_all_reduce(g.contiguous().clone(), ctx.group)
        return _own(g, ctx.group, ctx.dim), None, None, None


def sp_slice(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """This rank's slice of ``x`` along ``dim`` (whose length the group
    size divides). Backward: the cotangent padded with zeros."""
    return _Slice.apply(x, group, dim % x.dim())


def sp_gather(x: torch.Tensor, group, dim: int = -1, grad: str = "sum") -> torch.Tensor:
    """The slices of every rank concatenated along ``dim``, rank order.
    Backward (``grad``): ``"sum"`` sums the cotangent over the ranks and
    keeps this rank's slice; ``"slice"`` keeps the slice of a cotangent
    every rank already holds in full (see the module docstring)."""
    if grad not in ("sum", "slice"):
        raise ValueError(f"grad must be 'sum' or 'slice' (got {grad!r})")
    return _Gather.apply(x, group, dim % x.dim(), grad)


def _edges(x, left, right, group):
    """Forward of the halo: (left halo, right halo) of this rank's slice."""
    r, size = _rank_size(group)
    n = x.shape[-1]
    if n < max(left, right):
        raise ValueError(f"a slice of {n} columns is narrower than the halo ({left}, {right})")
    lead = x.shape[:-1]
    firsts = x.new_zeros((size, *lead, right), dtype=torch.float32)
    lasts = x.new_zeros((size, *lead, left), dtype=torch.float32)
    firsts[r] = x[..., :right]
    lasts[r] = x.narrow(-1, n - left, left)
    buf = torch.cat([firsts.reshape(-1), lasts.reshape(-1)])
    dist.all_reduce(buf, group=group)
    firsts, lasts = buf.split([firsts.numel(), lasts.numel()])
    firsts, lasts = firsts.reshape(size, *lead, right), lasts.reshape(size, *lead, left)
    lh = lasts[r - 1] if r > 0 else torch.zeros_like(lasts[0])
    rh = firsts[r + 1] if r < size - 1 else torch.zeros_like(firsts[0])
    return lh.to(x.dtype), rh.to(x.dtype)


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, left, right, group):
        ctx.left, ctx.right, ctx.group = left, right, group
        lh, rh = _edges(x, left, right, group)
        return torch.cat([lh, x, rh], dim=-1)

    @staticmethod
    def backward(ctx, g):
        left, right, group = ctx.left, ctx.right, ctx.group
        r, size = _rank_size(group)
        n = g.shape[-1] - left - right
        lead = g.shape[:-1]
        # the halos' cotangents go back to the neighbours' edge columns
        to_last = g.new_zeros((size, *lead, left), dtype=torch.float32)
        to_first = g.new_zeros((size, *lead, right), dtype=torch.float32)
        if r > 0:
            to_last[r - 1] = g[..., :left]
        if r < size - 1:
            to_first[r + 1] = g[..., left + n:]
        buf = torch.cat([to_last.reshape(-1), to_first.reshape(-1)])
        dist.all_reduce(buf, group=group)
        to_last, to_first = buf.split([to_last.numel(), to_first.numel()])
        dx = g[..., left:left + n].float()  # a copy
        dx.narrow(-1, n - left, left).add_(to_last.reshape(size, *lead, left)[r])
        dx[..., :right] += to_first.reshape(size, *lead, right)[r]
        return dx.to(g.dtype), None, None, None


def halo_exchange(x: torch.Tensor, left: int, right: int, group) -> torch.Tensor:
    """This rank's slice of the last axis with ``left`` columns of the
    previous rank's slice before it and ``right`` of the next rank's after
    it; zeros beyond the global ends, as a conv's zero padding."""
    return _Halo.apply(x, left, right, group)


def sharded_levels(mz: int, n_levels: int, sp: int) -> int:
    """The level plan of a U-Net whose level i is ``mz / 2**i`` wide: the
    number of leading levels whose width ``sp`` divides, which run sharded
    (``n_levels`` when all do). From the first level it does not divide,
    the levels, the bottleneck and the way back up to that level run
    replicated. Raises when ``sp`` does not divide m/z itself."""
    if mz % sp:
        raise ValueError(f"the m/z length {mz} does not split over sp={sp} ranks")
    for i in range(n_levels):
        if (mz >> i) % sp:
            return i
    return n_levels
