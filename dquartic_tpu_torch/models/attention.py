"""Attention modules of the UNet1d: RoPE, the linear-attention mixer (K1,
K6 under sequence parallelism, K8 or plain torch, by ``impl``), softmax attention over the RT axis (self
and cross), the hybrid self-then-cross attention and the 1-D transformer
stack.

Ports of :mod:`dquartic_tpu.models.attention`, channel-first ``(b, C, n)``.
Heads are channel-major ``(h c)``, as in the reference checkpoints. Every
1x1 conv of the softmax attention and the transformer runs as a matrix
product (:class:`~dquartic_tpu_torch.models.layers.Conv1x1`).

Module names follow the reference layout: a :class:`Transformer1d` holds
``layers.{i}.0`` (the attention) and ``layers.{i}.1`` (the
:class:`~dquartic_tpu_torch.models.layers.FeedForward1d`), two-element
layer lists, as the reference builds them (SURVEY.md M11).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from ..ops.attention_dispatch import dot_product_attention
from ..ops.linear_attention import (
    fused_linear_attention, linear_attention, linear_attention_nr_reference,
    linear_attention_rows_reference, linear_attention_sp, rmsnorm_reference,
)
from ..parallel.sequence import sp_gather, sp_slice
from ..parallel.tensor import full
from .layers import Conv1d, Conv1x1, FeedForward1d, RMSNorm


def rope_rotate(x: torch.Tensor, rot_dim: int, theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding of the first ``rot_dim`` features of each head,
    adjacent pairs interleaved (``rotary_embedding_torch`` convention);
    the rest pass through. ``x`` is (..., seq, dim_head)."""
    seq = x.shape[-2]
    inv_freq = 1.0 / (
        theta ** (torch.arange(0, rot_dim, 2, dtype=torch.float32, device=x.device) / rot_dim)
    )
    pos = torch.arange(seq, dtype=torch.float32, device=x.device)
    freqs = torch.repeat_interleave(pos[:, None] * inv_freq[None, :], 2, dim=-1)
    cos, sin = torch.cos(freqs).to(x.dtype), torch.sin(freqs).to(x.dtype)
    x_rot, x_pass = x[..., :rot_dim], x[..., rot_dim:]
    rotated = torch.stack([-x_rot[..., 1::2], x_rot[..., 0::2]], dim=-1).reshape(x_rot.shape)
    return torch.cat([x_rot * cos + rotated * sin, x_pass], dim=-1)


# Smallest sequence length N from which "auto" runs K1 rather than the
# "xla" path, set from the sweep of chip_smoke.py phase 9 (B = 34, C = 4
# and 16, bf16, the mixer's whole forward under each impl), whose times
# PERF.md section 6 lists with the card they were taken on: K1 was the
# faster at every swept N from 1 to 40000, so "auto" never picks "xla". The
# DQUARTIC_LINATTN_MIN_SEQ environment variable overrides it, as in JAX;
# the JAX package's 2048 is a TPU v5e's crossover and does not carry over.
LINATTN_MIN_SEQ = 1


def _min_seq() -> int:
    return int(os.environ.get("DQUARTIC_LINATTN_MIN_SEQ", LINATTN_MIN_SEQ))


def resolve_linear_attn_impl(impl: str, n: int, sp: int = 1) -> str:
    """The implementation a mixer over ``n`` positions runs, by the rule of
    :class:`dquartic_tpu.models.attention.LinearAttention`: an explicit
    ``impl`` wins ("pallas" and "pallas_t" as named, any other string the
    "xla" path, as there); ``"auto"`` takes ``DQUARTIC_LINATTN_IMPL`` when
    it names an impl, else ``"pallas_t"`` (K1, what JAX picks on its
    accelerator), and the "xla" path where ``n`` is below
    ``DQUARTIC_LINATTN_MIN_SEQ`` (default :data:`LINATTN_MIN_SEQ`).

    With the sequence split over ``sp > 1`` ranks, ``"pallas_t"`` means the
    sequence-parallel kernels (K6) and holds only where ``sp`` divides
    ``n`` and, under ``"auto"``, each rank's ``n // sp`` clears the same
    floor; otherwise the mixer takes the "xla" path, as in JAX."""
    auto = impl == "auto"
    if not auto:
        impl = impl if impl in ("pallas", "pallas_t") else "xla"
    else:
        env = os.environ.get("DQUARTIC_LINATTN_IMPL")
        impl = env if env in ("pallas", "pallas_t", "xla") else "pallas_t"
        if impl != "xla" and n < _min_seq():
            impl = "xla"
    if impl == "pallas_t" and sp > 1 and (n % sp or (auto and n // sp < _min_seq())):
        impl = "xla"
    return impl


class LinearAttention(nn.Module):
    """Linear attention mixer; ``forward(x, g_pre)`` returns
    ``x + RMSNorm(to_out(attn(RMSNorm_{g_pre}(x))))`` on (B, C, N), by
    ``impl`` (see :func:`resolve_linear_attn_impl`):

      * ``"pallas_t"`` — the K1 op: pre-norm, attention and residual in one;
      * ``"pallas"``   — the pre-norm in plain torch, the K8 op on the
        transposed activations (a view, no copy), the residual add in the
        compute dtype; the weights reach K8 as stored, as the JAX module
        hands its float32 parameters to the kernel;
      * ``"xla"``      — the JAX XLA path with its roundings: pre-norm in
        float32 cast to the compute dtype, projections in the compute
        dtype, q and k softmaxed in float32 and cast, both contractions
        summed in float32 and cast, RMSNorm in float32, residual add.

    With ``kernels`` off (a model's ``use_kernels(False)``) the two kernel
    impls run their ops' plain versions.

    Under sequence parallelism ``group`` is the ``sp`` process group and
    ``sharded`` says whether x is this rank's slice of N (else every rank
    holds the whole x): ``"pallas_t"`` then runs the K6 op on the slice
    (slicing a whole x first and gathering the result), and the other
    impls run on the sequence gathered over the group and keep their
    slice, as XLA's partitioner does around them in JAX."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32, impl: str = "auto"):
        super().__init__()
        self.heads, self.dim_head, self.impl = heads, dim_head, impl
        self.kernels = True
        hidden = heads * dim_head
        self.to_qkv = Conv1d(dim, hidden * 3, 1, bias=False)
        self.to_out = nn.Sequential(Conv1d(hidden, dim, 1), RMSNorm(dim))

    def forward(self, x: torch.Tensor, g_pre: torch.Tensor, group=None,
                sharded: bool = False) -> torch.Tensor:
        size = dist.get_world_size(group) if group is not None else 1
        n = x.shape[2] * (size if sharded else 1)
        impl = resolve_linear_attn_impl(self.impl, n, sp=size)
        if size == 1:
            return self._mix(x, g_pre, impl)
        if impl == "pallas_t" and self.kernels:
            xs = x if sharded else sp_slice(x, group)
            cd = x.dtype
            w_qkv, w_out, b_out, g = self._leaves()
            y = linear_attention_sp(xs, w_qkv.t().to(cd), w_out.t().to(cd),
                                    b_out.to(cd), g,
                                    g_pre.reshape(-1), self.heads, self.dim_head, group)
            return y if sharded else sp_gather(y, group)
        if sharded:
            return sp_slice(self._mix(sp_gather(x, group), g_pre, impl), group)
        return self._mix(x, g_pre, impl)

    def _leaves(self):
        """(w_qkv, w_out, b_out, g) as the ops take them: the 1x1 conv
        weights squeezed, whole (gathered where tp splits them)."""
        return (full(self.to_qkv, "weight")[:, :, 0], full(self.to_out[0], "weight")[:, :, 0],
                full(self.to_out[0], "bias"), full(self.to_out[1], "g").reshape(-1))

    def _mix(self, x: torch.Tensor, g_pre: torch.Tensor, impl: str) -> torch.Tensor:
        """The mixer over the whole sequence by ``impl``."""
        cd = x.dtype  # conv parameters at the compute dtype; norm gains float32
        g_pre = g_pre.reshape(-1)
        w_qkv, w_out, b_out, g = self._leaves()
        if impl == "pallas_t":
            op = linear_attention if self.kernels else linear_attention_nr_reference
            return op(x, w_qkv.t().to(cd), w_out.t().to(cd), b_out.to(cd), g, g_pre,
                      self.heads, self.dim_head)
        xin = rmsnorm_reference(x, g_pre).to(cd)
        if impl == "pallas":
            op = fused_linear_attention if self.kernels else linear_attention_rows_reference
            out = op(xin.transpose(1, 2), w_qkv.t(), w_out.t(), b_out, g, self.heads,
                     self.dim_head).transpose(1, 2)
            return (x + out).to(cd)
        B, _, N = x.shape
        heads, dh = self.heads, self.dim_head
        qkv = torch.matmul(w_qkv.to(cd), xin)  # (B, 3H, N)
        q, k, v = (t.reshape(B, heads, dh, N) for t in qkv.chunk(3, dim=1))
        q = (torch.softmax(q.float(), dim=2) * dh**-0.5).to(cd)  # over each head's features
        k = torch.softmax(k.float(), dim=3).to(cd)  # over the sequence
        ctx = torch.einsum("bhdn,bhen->bhde", k.float(), v.float()).to(cd)
        out = torch.einsum("bhde,bhdn->bhen", ctx.float(), q.float()).to(cd)
        out = torch.matmul(w_out.to(cd), out.reshape(B, heads * dh, N)) + b_out.to(cd)[:, None]
        return (x + rmsnorm_reference(out, g).to(cd)).to(cd)


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = RMSNorm(dim)
        self.fn = fn

    def forward(self, x: torch.Tensor, *args) -> torch.Tensor:
        return self.fn(self.norm(x), *args)


class Residual(nn.Module):
    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x: torch.Tensor, *args) -> torch.Tensor:
        return self.fn(x, *args) + x


class LinearAttentionBlock(nn.Module):
    """The reference's ``Residual(PreNorm(dim, LinearAttention(dim)))``
    parameter tree (``fn.norm.g``, ``fn.fn.*``), run as one mixer call:
    the norm's gain is the mixer's ``g_pre`` (inside K1 under
    ``"pallas_t"``)."""

    def __init__(self, dim: int, impl: str = "auto"):
        super().__init__()
        self.fn = PreNorm(dim, LinearAttention(dim, impl=impl))

    def forward(self, x: torch.Tensor, group=None, sharded: bool = False) -> torch.Tensor:
        return self.fn.fn(x, full(self.fn.norm, "g"), group, sharded)


class _SoftmaxAttention(nn.Module):
    """Heads, RoPE and the attention op shared by the attention modules;
    ``attn_impl`` is ``dot_product_attention``'s ``impl``."""

    def __init__(self, heads: int, dim_head: int, attn_impl: str):
        super().__init__()
        self.heads, self.dim_head, self.attn_impl = heads, dim_head, attn_impl
        self.kernels = True

    def _attend(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """(b, h·c, n) q and (b, h·c, m) k, v -> (b, h·c, n), RoPE on q, k."""

        def heads(t):  # (b, h*c, n) -> (b, h, n, c)
            b, hc, n = t.shape
            return t.reshape(b, self.heads, hc // self.heads, n).transpose(2, 3)

        q, k, v = heads(q), heads(k), heads(v)
        q = rope_rotate(q, self.dim_head // 2)
        k = rope_rotate(k, self.dim_head // 2)
        out = dot_product_attention(q, k, v, impl=self.attn_impl, kernels=self.kernels)
        b, h, n, c = out.shape
        return out.transpose(2, 3).reshape(b, h * c, n)


class Attention(_SoftmaxAttention):
    """Softmax attention with RoPE over the length axis. Self mode
    (``to_qkv``) without ``cond_dim``; cross mode with it: queries and
    values from x, keys from the condition (the reference's q/v-from-x
    convention). x (b, dim, n), cond (b, cond_dim, n)."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32,
                 cond_dim: Optional[int] = None, attn_impl: str = "auto"):
        super().__init__(heads, dim_head, attn_impl)
        hidden = heads * dim_head
        if cond_dim is None:
            self.to_qkv = Conv1x1(dim, hidden * 3, bias=False)
        else:
            self.to_qv = Conv1x1(dim, hidden * 2, bias=False)
            self.to_k = Conv1x1(cond_dim, hidden, bias=False)
        self.to_out = Conv1x1(hidden, dim)

    def forward(self, x: torch.Tensor, cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        if hasattr(self, "to_qkv"):
            q, k, v = self.to_qkv(x).chunk(3, dim=1)
        else:
            q, v = self.to_qv(x).chunk(2, dim=1)
            k = self.to_k(cond)
        return self.to_out(self._attend(q, k, v))


class HybridSelfAndCrossAttention(_SoftmaxAttention):
    """Self attention, a 1x1 ``to_mid`` projection, then cross attention
    with queries and values from the mid and keys from ``cond``."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32, cond_dim: int = 1,
                 attn_impl: str = "auto"):
        super().__init__(heads, dim_head, attn_impl)
        hidden = heads * dim_head
        self.to_qkv = Conv1x1(dim, hidden * 3, bias=False)
        self.to_mid = Conv1x1(hidden, dim)
        self.to_qv = Conv1x1(dim, hidden * 2, bias=False)
        self.to_k = Conv1x1(cond_dim, hidden, bias=False)
        self.to_out = Conv1x1(hidden, dim)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        mid = self.to_mid(self._attend(*self.to_qkv(x).chunk(3, dim=1)))
        q, v = self.to_qv(mid).chunk(2, dim=1)
        return self.to_out(self._attend(q, self.to_k(cond), v))


class Transformer1d(nn.Module):
    """Depth-``depth`` stack over (b, dim, n): the first half of the layers
    self attention, the second half hybrid self + cross attention when
    ``use_xattn`` (else all self attention); each layer
    ``x = attn(x[, cond]) + x; x = ff(x) + x``."""

    def __init__(self, dim: int, depth: int = 4, heads: int = 4, dim_head: int = 32,
                 mlp_mult: int = 2, use_xattn: bool = False, cond_dim: int = 1,
                 attn_impl: str = "auto"):
        super().__init__()
        self.layers = nn.ModuleList()
        for i in range(depth):
            if i < depth // 2 or not use_xattn:
                attn = Attention(dim, heads, dim_head, attn_impl=attn_impl)
            else:
                attn = HybridSelfAndCrossAttention(dim, heads, dim_head, cond_dim, attn_impl)
            self.layers.append(nn.ModuleList([attn, FeedForward1d(dim, mlp_mult)]))

    def forward(self, x: torch.Tensor, cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        for attn, ff in self.layers:
            hybrid = isinstance(attn, HybridSelfAndCrossAttention)
            x = (attn(x, cond) if hybrid else attn(x)) + x
            x = ff(x) + x
        return x
