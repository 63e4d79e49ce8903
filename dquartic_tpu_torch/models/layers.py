"""Building-block layers of the UNet1d, channel-first ``(batch, C, length)``.

Ports of :mod:`dquartic_tpu.models.layers`. Module and parameter names
follow the reference PyTorch UNet1d, whose state_dict the JAX converter
(:func:`dquartic_tpu.compat.torch_ckpt.convert_unet1d_state_dict`) maps:
Conv1d weights (out, in, k), Linear weights (out, in), norm gains
(1, C, 1).

Mixed precision follows flax's ``dtype=bf16, param_dtype=float32``: the
convs and linears cast their parameters to the activation dtype at use, so
float32 master weights compute in bf16 and autograd returns float32
gradients; norm gains and RMSNorm math stay float32.

Under tensor parallelism (:mod:`dquartic_tpu_torch.parallel.tensor`) a
layer whose leaves the JAX rule splits holds its shards and a ``tp``
spec: the products (convs, linears, int8 convs) run on their shard and
gather or sum over the group, the norms gather their gains at use.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.int8_matmul import int8_conv1d, int8_matmul, int8_matmul_reference, quantize_conv_kernel
from ..ops.linear_attention import rmsnorm_reference
from ..parallel.sequence import halo_exchange
from ..parallel.tensor import full, product

# flax.linen.initializers.lecun_normal: a normal truncated at two standard
# deviations, scaled so that its standard deviation is sqrt(1 / fan_in);
# this is the standard deviation of the unit normal truncated to [-2, 2].
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """flax's ``lecun_normal`` (the default kernel initializer of its Dense
    and Conv) in place: a normal truncated at two standard deviations,
    its standard deviation sqrt(1 / fan_in), from ``generator``."""
    std = fan_in ** -0.5 / _TRUNC_STD
    return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)


class Conv1d(nn.Conv1d):
    """``nn.Conv1d`` with its parameters cast to the input's dtype at use.

    With ``group`` (the ``sp`` process group of a sequence-parallel model)
    x is this rank's slice of the length axis: the conv takes its padding's
    width of columns from each neighbour (zeros at the global ends) and
    returns its own slice of the output (a stride-2 conv on an even slice
    too). With a ``tp`` spec the weight is split on its output (axis 0) or
    input (axis 1) channels."""

    tp = None

    def forward(self, x: torch.Tensor, group=None) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        weight = self.weight.to(x.dtype)
        if group is None:
            conv = lambda h, b: self._conv_forward(h, weight, b)  # noqa: E731
        else:
            pad = self.padding[0]
            x = halo_exchange(x, pad, pad, group)
            conv = lambda h, b: F.conv1d(h, weight, b, self.stride, 0,  # noqa: E731
                                         self.dilation, self.groups)
        if self.tp is None:
            return conv(x, bias)
        return product(self.tp, self.tp.dims["weight"] == 0, x, conv, bias, 1)


class Conv1x1(Conv1d):
    """1x1 ``Conv1d`` (same parameters and names) run as a matrix product
    on the squeezed weight, ``W @ x`` over (b, C_in, n), not through cuDNN,
    which transposes large weights between layouts on every call."""

    def __init__(self, in_channels: int, out_channels: int, bias: bool = True):
        super().__init__(in_channels, out_channels, 1, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight[:, :, 0].to(x.dtype)

        def mm(h, b):
            y = torch.matmul(w, h)
            return y if b is None else y + b.to(h.dtype)[:, None]

        if self.tp is None:
            return mm(x, self.bias)
        return product(self.tp, self.tp.dims["weight"] == 0, x, mm, self.bias, 1)


class Linear(nn.Linear):
    """``nn.Linear`` with its parameters cast to the input's dtype at use;
    with a ``tp`` spec its weight is split on its output (axis 0) or input
    (axis 1) features."""

    tp = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        weight = self.weight.to(x.dtype)
        if self.tp is None:
            return F.linear(x, weight, bias)
        return product(self.tp, self.tp.dims["weight"] == 0, x,
                       lambda h, b: F.linear(h, weight, b), bias, -1)


def sinusoidal_pos_emb(t: torch.Tensor, dim: int, theta: float = 10000.0) -> torch.Tensor:
    """Timestep embedding (b,) -> (b, dim) float32: ``[sin, cos]`` of
    ``t · theta^(-i / (half_dim - 1))``."""
    half_dim = dim // 2
    emb = math.log(theta) / (half_dim - 1)
    freqs = torch.exp(
        torch.arange(half_dim, dtype=torch.float32, device=t.device) * -emb
    )
    args = t.to(torch.float32)[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class SinusoidalPosEmb(nn.Module):
    def __init__(self, dim: int, theta: float = 10000.0):
        super().__init__()
        self.dim, self.theta = dim, theta

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return sinusoidal_pos_emb(t, self.dim, self.theta)


class RMSNorm(nn.Module):
    """Channel RMSNorm ``x / max(||x||, 1e-12) · g · sqrt(C)`` over dim 1,
    float32 math, result in x's dtype."""

    tp = None

    def __init__(self, dim: int):
        super().__init__()
        self.g = nn.Parameter(torch.ones(1, dim, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm_reference(x, full(self, "g").reshape(-1)).to(x.dtype)


class LayerNorm1d(nn.Module):
    """Channel LayerNorm over dim 1 with biased variance, eps 1e-5, float32
    gain ``g`` and bias ``b`` (1, C, 1), float32 math, result in x's dtype."""

    tp = None

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.g = nn.Parameter(torch.ones(1, dim, 1))
        self.b = nn.Parameter(torch.zeros(1, dim, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.float32)
        mean = x32.mean(dim=1, keepdim=True)
        var = (x32 - mean).square().mean(dim=1, keepdim=True)
        g, b = full(self, "g").float(), full(self, "b").float()
        out = (x32 - mean) * torch.rsqrt(var + self.eps) * g + b
        return out.to(x.dtype)


class FeedForward1d(nn.Module):
    """LayerNorm1d -> 1x1 conv to ``ch_mult·C`` -> exact GELU -> 1x1 conv."""

    def __init__(self, dim: int, ch_mult: int = 2):
        super().__init__()
        self.norm = LayerNorm1d(dim)
        self.conv1 = Conv1x1(dim, dim * ch_mult)
        self.conv2 = Conv1x1(dim * ch_mult, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.gelu(self.conv1(self.norm(x))))


class Int8Conv1d(nn.Module):
    """Same-padding conv1d with int8 weights and per-output-channel scales
    (inference only). ``weight_q`` (k·C_in, C_out) int8 and ``scale``
    (C_out,) float32 are buffers in the layout of
    :func:`~dquartic_tpu_torch.ops.int8_matmul.quantize_conv_kernel`. Under
    tp a rank holds the columns of its output shard of ``weight_q``,
    ``scale`` and ``bias``: the scales are per output column, so quantizing
    the shard is slicing the whole quantization."""

    tp = None

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3):
        super().__init__()
        self.kernel = kernel
        self.kernels = True
        self.register_buffer(
            "weight_q", torch.zeros(kernel * in_channels, out_channels, dtype=torch.int8)
        )
        self.register_buffer("scale", torch.ones(out_channels, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    @classmethod
    def from_conv(cls, conv: nn.Conv1d) -> "Int8Conv1d":
        c_out, c_in, k = conv.weight.shape
        with torch.device("meta"):
            q = cls(c_in, c_out, k)
        q.weight_q, q.scale = quantize_conv_kernel(conv.weight.detach())
        q.bias = nn.Parameter(conv.bias.detach().clone(), requires_grad=False)
        if conv.tp is not None:
            if conv.tp.dims != {"weight": 0, "bias": 0}:
                raise ValueError(f"an int8 conv takes a conv split on its output channels, "
                                 f"not {conv.tp.dims}")
            q.tp = dataclasses.replace(conv.tp, dims={"weight_q": 1, "scale": 0, "bias": 0})
        return q

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        matmul = int8_matmul if self.kernels else int8_matmul_reference
        conv = lambda h, b: int8_conv1d(h, self.weight_q, self.scale, b,  # noqa: E731
                                        self.kernel, matmul)
        if self.tp is None:
            return conv(x, self.bias)
        return product(self.tp, True, x, conv, self.bias, 1)


class Block(nn.Module):
    """conv3 -> RMSNorm -> (FiLM) -> SiLU."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = Conv1d(dim_in, dim_out, 3, padding=1)
        self.norm = RMSNorm(dim_out)

    def forward(
        self, x: torch.Tensor, scale_shift: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        group=None,
    ) -> torch.Tensor:
        x = self.norm(self.proj(x) if group is None else self.proj(x, group))
        if scale_shift is not None:
            scale, shift = scale_shift
            x = x * (scale + 1.0) + shift
        return F.silu(x)


class ResnetBlock(nn.Module):
    """Two conv Blocks + residual, FiLM on block1 from ``time_emb``
    (one row of ``time_emb`` per batch row of x). With ``group`` x is a
    rank's slice of the length axis and both convs take halos (see
    :class:`Conv1d`); the norms, FiLM and the 1x1 residual are per column."""

    def __init__(self, dim_in: int, dim_out: int, time_emb_dim: Optional[int] = None):
        super().__init__()
        self.mlp = (
            nn.Sequential(nn.SiLU(), Linear(time_emb_dim, dim_out * 2))
            if time_emb_dim is not None
            else None
        )
        self.block1 = Block(dim_in, dim_out)
        self.block2 = Block(dim_out, dim_out)
        self.res_conv = Conv1d(dim_in, dim_out, 1) if dim_in != dim_out else None

    def film(self, time_emb: Optional[torch.Tensor]):
        """(scale, shift), each (b, C_out), or None."""
        if self.mlp is None or time_emb is None:
            return None
        return tuple(self.mlp(time_emb).chunk(2, dim=-1))

    def forward(self, x: torch.Tensor, time_emb: Optional[torch.Tensor] = None,
                group=None) -> torch.Tensor:
        ss = self.film(time_emb)
        if ss is not None:
            ss = (ss[0][:, :, None], ss[1][:, :, None])
        h = self.block2(self.block1(x, ss, group), group=group)
        return h + (self.res_conv(x) if self.res_conv is not None else x)


class ConditionalScaleShift(nn.Module):
    """FiLM of the init condition by the time embedding."""

    def __init__(self, dim: int, time_emb_dim: int):
        super().__init__()
        self.to_scale_shift = nn.Sequential(nn.SiLU(), Linear(time_emb_dim, dim * 2))

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        scale, shift = self.to_scale_shift(t).chunk(2, dim=-1)
        return x * (scale[:, :, None] + 1.0) + shift[:, :, None]


def Upsample(dim_in: int, dim_out: int) -> nn.Sequential:
    """Nearest x2 upsample, then conv3."""
    return nn.Sequential(
        nn.Upsample(scale_factor=2, mode="nearest"), Conv1d(dim_in, dim_out, 3, padding=1)
    )


def Downsample(dim_in: int, dim_out: int) -> Conv1d:
    """Stride-2 conv4 downsample."""
    return Conv1d(dim_in, dim_out, 4, stride=2, padding=1)
