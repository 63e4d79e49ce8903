"""Learned Fourier-space filter block.

Port of :class:`dquartic_tpu.models.fourier.FourierFeatures`: a float32
``rfft2`` over the (h, w) axes with ``norm="ortho"``, a product with the
learned complex weight sliced to the spectrum's ``[:h, :w//2 + 1]``, the
inverse ``irfft2(s=(h, w))``, and a cast to ``dtype``.

Layout: channel-first ``(batch, dim, h, w)``, as the reference PyTorch
module; the JAX module is feature-last ``(batch, h, w, dim)``. The weight
keeps the layout both share, ``complex_weight`` (dim, h, w, 2) (real and
imaginary parts), so it carries across 1:1. Nothing on the model paths
builds it, as in JAX; the FFTs are torch's (cuFFT on the card).
"""

from __future__ import annotations

import torch
from torch import nn


class FourierFeatures(nn.Module):
    def __init__(self, dim: int, h: int = 10000, w: int = 34,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        # flax's normal(0.02) initializer
        self.complex_weight = nn.Parameter(torch.randn(dim, h, w, 2) * 0.02)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (b, dim, h, w) -> (b, dim, h, w) in ``dtype``."""
        h, w = x.shape[-2:]
        xf = torch.fft.rfft2(x.float(), dim=(2, 3), norm="ortho")
        wf = torch.view_as_complex(self.complex_weight.float())  # (dim, h, w)
        xf = xf * wf[None, :, : xf.shape[2], : xf.shape[3]]
        return torch.fft.irfft2(xf, s=(h, w), dim=(2, 3), norm="ortho").to(self.dtype)
