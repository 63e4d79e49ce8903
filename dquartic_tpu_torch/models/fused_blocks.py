"""ResnetBlock on (B, C, N) activations backed by the K2 op.

Port of :class:`dquartic_tpu.models.fused_blocks.ResnetBlockT`: the same
parameters as :class:`~dquartic_tpu_torch.models.layers.ResnetBlock`,
with a per-row FiLM from ``t_rows`` (one time-embedding row per row of
x), run as one fused launch.
"""

from __future__ import annotations

import torch

from ..ops.fused_resnet import fused_resnet_block_t, resnet_block_t_reference
from ..parallel.tensor import full
from .layers import ResnetBlock


class ResnetBlockT(ResnetBlock):
    def __init__(self, dim_in: int, dim_out: int, time_emb_dim: int):
        super().__init__(dim_in, dim_out, time_emb_dim)
        self.kernels = True

    def forward(self, x: torch.Tensor, t_rows: torch.Tensor) -> torch.Tensor:
        """The parameters go to the op as they are stored: the torch conv
        weights (out, in, k) seen as flax (k, in, out) by ``permute`` (a
        view), biases and gains in their own dtype. The op rounds the conv
        weights to x's dtype (flax's ``dtype=bf16, param_dtype=float32``).
        Leaves split over tp are gathered whole for the op."""
        scale, shift = self.film(t_rows)
        b1, b2, res = self.block1, self.block2, self.res_conv
        op = fused_resnet_block_t if self.kernels else resnet_block_t_reference
        return op(
            x,
            full(b1.proj, "weight").permute(2, 1, 0), full(b1.proj, "bias"),
            full(b1.norm, "g").reshape(-1),
            scale, shift,
            full(b2.proj, "weight").permute(2, 1, 0), full(b2.proj, "bias"),
            full(b2.norm, "g").reshape(-1),
            full(res, "weight").permute(2, 1, 0) if res is not None else None,
            full(res, "bias") if res is not None else None,
        )
