"""ResnetBlock on (B, C, N) activations backed by the K2 op.

Port of :class:`dquartic_tpu.models.fused_blocks.ResnetBlockT`: the same
parameters as :class:`~dquartic_tpu_torch.models.layers.ResnetBlock`,
with a per-row FiLM from ``t_rows`` (one time-embedding row per row of
x), run as one fused launch.
"""

from __future__ import annotations

import torch

from ..ops.fused_resnet import fused_resnet_block_t, resnet_block_t_reference
from .layers import ResnetBlock


class ResnetBlockT(ResnetBlock):
    def __init__(self, dim_in: int, dim_out: int, time_emb_dim: int):
        super().__init__(dim_in, dim_out, time_emb_dim)
        self.kernels = True

    def forward(self, x: torch.Tensor, t_rows: torch.Tensor) -> torch.Tensor:
        scale, shift = self.film(t_rows)
        cd = x.dtype  # conv parameters at the compute dtype; norm gains float32

        def flax(conv):  # torch (out, in, k) -> flax (k, in, out)
            return conv.weight.permute(2, 1, 0).to(cd)

        res = self.res_conv
        op = fused_resnet_block_t if self.kernels else resnet_block_t_reference
        return op(
            x,
            flax(self.block1.proj), self.block1.proj.bias.to(cd), self.block1.norm.g.reshape(-1),
            scale, shift,
            flax(self.block2.proj), self.block2.proj.bias.to(cd), self.block2.norm.g.reshape(-1),
            flax(res) if res is not None else None, res.bias.to(cd) if res is not None else None,
        )
