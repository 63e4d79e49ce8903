"""Attention modules of the UNet1d: RoPE, the fused linear-attention mixer
and cross attention over the RT axis.

Ports of :mod:`dquartic_tpu.models.attention` (the forms UNet1d with
``simple=True`` uses). Heads are channel-major ``(h c)``, as in the
reference checkpoints.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.attention_dispatch import dot_product_attention
from ..ops.linear_attention import linear_attention, linear_attention_nr_reference
from .layers import Conv1d, RMSNorm


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


class LinearAttention(nn.Module):
    """Linear attention mixer around the K1 op; ``forward(x, g_pre)``
    returns ``x + RMSNorm(to_out(attn(RMSNorm_{g_pre}(x))))`` on (B, C, N)."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.kernels = True
        hidden = heads * dim_head
        self.to_qkv = Conv1d(dim, hidden * 3, 1, bias=False)
        self.to_out = nn.Sequential(Conv1d(hidden, dim, 1), RMSNorm(dim))

    def forward(self, x: torch.Tensor, g_pre: torch.Tensor) -> torch.Tensor:
        op = linear_attention if self.kernels else linear_attention_nr_reference
        cd = x.dtype  # conv parameters at the compute dtype; norm gains float32
        return op(
            x,
            self.to_qkv.weight[:, :, 0].t().to(cd),  # flax layout (C, 3H)
            self.to_out[0].weight[:, :, 0].t().to(cd),  # (H, C)
            self.to_out[0].bias.to(cd),
            self.to_out[1].g.reshape(-1),
            g_pre.reshape(-1),
            self.heads,
            self.dim_head,
        )


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
    parameter tree (``fn.norm.g``, ``fn.fn.*``), run as one fused op: the
    pre-norm and the residual add happen inside K1."""

    def __init__(self, dim: int):
        super().__init__()
        self.fn = PreNorm(dim, LinearAttention(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn.fn(x, self.fn.norm.g)


class Attention(nn.Module):
    """Cross attention with RoPE: queries and values from x, keys from the
    condition (the reference's q/v-from-x convention). x (b, dim, n),
    cond (b, cond_dim, n)."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32, cond_dim: int = 1):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.to_qv = Conv1d(dim, hidden * 2, 1, bias=False)
        self.to_k = Conv1d(cond_dim, hidden, 1, bias=False)
        self.to_out = Conv1d(hidden, dim, 1)

    def _heads(self, t: torch.Tensor) -> torch.Tensor:
        b, hc, n = t.shape  # (b, h*c, n) -> (b, h, n, c)
        return t.reshape(b, self.heads, hc // self.heads, n).transpose(2, 3)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        q, v = self.to_qv(x).chunk(2, dim=1)
        k = self.to_k(cond)
        q, k, v = self._heads(q), self._heads(k), self._heads(v)
        q = rope_rotate(q, self.dim_head // 2)
        k = rope_rotate(k, self.dim_head // 2)
        out = dot_product_attention(q, k, v)  # (b, h, n, c)
        b, h, n, c = out.shape
        return self.to_out(out.transpose(2, 3).reshape(b, h * c, n))
