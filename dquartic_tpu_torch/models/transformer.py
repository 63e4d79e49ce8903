"""The legacy cross-attention transformer denoiser.

Port of :mod:`dquartic_tpu.models.transformer` (``apply_rope_pairwise``,
``TimeEmbedding``, ``TransformerLayer``, ``CustomTransformer``), feature-last
``(b, seq, hidden)`` as there, with the 4-argument denoiser signature
``(x_t, t, init_cond, attn_cond)``: ``init_cond`` is ignored and
``attn_cond`` is the MS1 chromatogram ``(b, rt)``.

Module and parameter names are the JAX tree's (``input_projection``,
``conditional_projection``, ``time_embedding.linear{1,2}``,
``layers.{i}.{q,k,v,out}_proj``, ``norm1``, ``norm2``, ``ff1``, ``ff2``,
``output_projection``), torch ``(out, in)`` Linear weights and LayerNorm
``weight``/``bias`` for flax's ``scale``/``bias``, so
:mod:`dquartic_tpu_torch.compat.jax_params` maps the two trees by
transposes.

Mixed precision follows flax's ``dtype``/``param_dtype=float32``: the
parameters are float32 masters cast to the compute dtype at use; the
attention logits and softmax, and the LayerNorm statistics, are float32.
The attention and the projections are torch ops, as their JAX
counterparts are einsums and XLA dots (no Pallas kernel).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.tensor import full
from .layers import Linear, lecun_normal_, sinusoidal_pos_emb


def apply_rope_pairwise(x: torch.Tensor) -> torch.Tensor:
    """Rotary embedding of the whole hidden width over adjacent (even, odd)
    pairs with ``hidden/2`` frequencies ``10000**(-i/(hidden/2))``; sin and
    cos are cast to x's dtype before the products. ``x``: (b, seq, hidden).
    A 3-D MS1 condition reaches here as 4-D and raises, as in JAX."""
    if x.dim() != 3:
        raise ValueError(
            f"apply_rope_pairwise takes (b, seq, hidden), got {tuple(x.shape)}: the "
            "CustomTransformer's condition is the 2-D MS1 chromatogram (b, rt), not a "
            "(b, rt, mz) MS1 map")
    b, seq, hidden = x.shape
    half = hidden // 2
    inv_freq = 10000.0 ** -(torch.arange(half, dtype=torch.float32, device=x.device) / half)
    angles = torch.arange(seq, dtype=torch.float32, device=x.device)[:, None] * inv_freq[None]
    sin, cos = torch.sin(angles).to(x.dtype), torch.cos(angles).to(x.dtype)
    xr = x.reshape(b, seq, half, 2)
    x1, x2 = xr[..., 0], xr[..., 1]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).reshape(b, seq, hidden)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis: epsilon 1e-6, float32
    ``weight`` (flax ``scale``) and ``bias``, float32 statistics with
    flax's one-pass variance ``max(E[x²] - E[x]², 0)``, result in x's
    dtype."""

    tp = None

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = torch.clamp(x32.square().mean(-1, keepdim=True) - mean.square(), min=0.0)
        mul = torch.rsqrt(var + self.eps) * full(self, "weight").float()
        return ((x32 - mean) * mul + full(self, "bias").float()).to(x.dtype)


class TimeEmbedding(nn.Module):
    """Sinusoidal features ``[sin, cos]`` of t, Dense to ``4·hidden``,
    exact GELU, Dense to ``hidden``."""

    def __init__(self, hidden_dim: int):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.linear1 = Linear(hidden_dim, hidden_dim * 4)
        self.linear2 = Linear(hidden_dim * 4, hidden_dim)

    def forward(self, t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        h = sinusoidal_pos_emb(t, self.hidden_dim).to(dtype)
        return self.linear2(F.gelu(self.linear1(h)))


class TransformerLayer(nn.Module):
    """Post-norm cross-attention layer: queries from ``x_t``, keys and
    values from ``concat([cond, x_t])`` over the sequence, then
    ``norm1(x + attn)`` and ``norm2(x + ff)``."""

    def __init__(self, hidden_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (
            Linear(hidden_dim, hidden_dim) for _ in range(4))
        self.norm1 = LayerNorm(hidden_dim)
        self.ff1 = Linear(hidden_dim, 4 * hidden_dim)
        self.ff2 = Linear(4 * hidden_dim, hidden_dim)
        self.norm2 = LayerNorm(hidden_dim)

    def forward(self, x_t: torch.Tensor, x_cond: torch.Tensor) -> torch.Tensor:
        combined = torch.cat([x_cond, x_t], dim=1)
        b, n, d = x_t.shape
        hd = d // self.num_heads

        def split(t):  # (b, n, d) -> (b, h, n, hd)
            return t.reshape(t.shape[0], t.shape[1], self.num_heads, hd).transpose(1, 2)

        q, k, v = split(self.q_proj(x_t)), split(self.k_proj(combined)), split(self.v_proj(combined))
        sim = torch.matmul(q.float(), k.float().transpose(-1, -2))  # float32 logits
        attn = torch.softmax(sim * hd**-0.5, dim=-1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, n, d)
        x_t = self.norm1(x_t + self.out_proj(out))
        return self.norm2(x_t + self.ff2(F.gelu(self.ff1(x_t))))


class CustomTransformer(nn.Module):
    """The legacy denoiser (see the module docstring). ``dtype`` is the
    compute dtype: inputs and parameters are cast to it at use."""

    def __init__(self, input_dim: int = 40000, hidden_dim: int = 128, num_heads: int = 1,
                 num_layers: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.input_projection = Linear(input_dim, hidden_dim)
        self.conditional_projection = Linear(1, hidden_dim)
        self.time_embedding = TimeEmbedding(hidden_dim)
        self.layers = nn.ModuleList(TransformerLayer(hidden_dim, num_heads)
                                    for _ in range(num_layers))
        self.output_projection = Linear(hidden_dim, input_dim)

    @staticmethod
    @torch.no_grad()
    def init_leaf(name: str, t: torch.Tensor, generator: torch.Generator) -> None:
        """flax's initialization of the parameter ``name`` (its whole
        tensor ``t``): a Dense kernel ``lecun_normal`` (a normal truncated
        at two standard deviations, standard deviation sqrt(1 / fan_in))
        from ``generator``, a Dense bias 0, a LayerNorm scale 1 and bias 0."""
        if name.endswith("bias"):
            t.zero_()
        elif ".norm" in name:
            t.fill_(1.0)
        else:
            lecun_normal_(t, t.shape[1], generator)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """flax's initialization from ``generator`` (:meth:`init_leaf`),
        the parameters in their order."""
        for name, p in self.named_parameters():
            self.init_leaf(name, p, generator)

    def forward(self, x_t: torch.Tensor, t: torch.Tensor,
                init_cond: Optional[torch.Tensor] = None,
                attn_cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x_t (b, rt, input_dim), t (b,), attn_cond (b, rt) or None
        (zeros); ``init_cond`` is unused by this architecture. Returns
        (b, rt, input_dim) in the compute dtype."""
        del init_cond
        dtype = self.compute_dtype
        if attn_cond is None:
            attn_cond = torch.zeros(x_t.shape[:2], dtype=x_t.dtype, device=x_t.device)
        x = apply_rope_pairwise(self.input_projection(x_t.to(dtype)))
        cond = apply_rope_pairwise(self.conditional_projection(attn_cond.to(dtype)[..., None]))
        x = x + self.time_embedding(t, dtype)[:, None, :]
        for layer in self.layers:
            x = layer(x, cond)
        return self.output_projection(x)
