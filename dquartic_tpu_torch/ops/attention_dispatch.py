"""Softmax attention over (b, h, n, d) tensors.

Port of the plain path of :mod:`dquartic_tpu.ops.attention_dispatch`
(``_xla_attention``). UNet1d runs it over the RT axis (34 rows), where
the JAX package also runs plain XLA math. Scores are taken in float32
(bf16 products are exact in float32), the softmax runs in float32, and
the weights are cast back to v's dtype for the second product — the same
rounding points as the JAX einsums with ``preferred_element_type=f32``.
"""

from __future__ import annotations

from typing import Optional

import torch


def dot_product_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> torch.Tensor:
    if scale is None:
        scale = q.shape[-1] ** -0.5
    sim = torch.matmul(q.to(torch.float32), k.to(torch.float32).transpose(-1, -2)) * scale
    attn = torch.softmax(sim, dim=-1)
    return torch.matmul(attn.to(v.dtype), v)
