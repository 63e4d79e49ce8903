"""The precision the reference's products run in.

``float32`` leaves every operand as it is: the reference. ``bf16`` rounds
each operand of every product to bfloat16 and back: the yardstick, how far
the program's own precision alone moves a seed's numbers. ``fp8`` rounds
each operand to float8 e4m3 with one scale per tensor (amax / 448, the
usual fp8 recipe) and back: the control, the next precision below the bf16
the program computes in. Products accumulate in float32. The rounding
passes gradients through unchanged, so a backward differentiates the
rounded forward.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


class _RoundFP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        amax = x.detach().abs().amax().float()
        s = torch.where(amax > 0, amax / E4M3_MAX, torch.ones_like(amax))
        return ((x.float() / s).to(torch.float8_e4m3fn).float() * s).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundBF16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


class Precision:
    NAMES = ("float32", "bf16", "fp8")

    def __init__(self, name: str = "float32"):
        if name not in self.NAMES:
            raise ValueError(f"unknown precision {name!r}: one of {self.NAMES}")
        self.name = name

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if self.name == "float32":
            return t
        return (_RoundBF16 if self.name == "bf16" else _RoundFP8).apply(t)
