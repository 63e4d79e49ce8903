"""Softmax attention over (b, h, n, d) tensors, and the choice of its
implementation.

Port of :mod:`dquartic_tpu.ops.attention_dispatch`, with the JAX names of
the implementations (what ``tpu.attn_impl`` in a config selects):

  * ``"xla"``    — the plain version: scores in float32 (bf16 products are
    exact in float32), softmax in float32, the weights cast back to v's
    dtype for the second product, the rounding points of the JAX einsums
    with ``preferred_element_type=f32``;
  * ``"pallas"`` — the flash op (:mod:`.flash_attention`): K7a/K7b on CUDA
    tensors, their plain versions on CPU tensors;
  * ``"auto"``   — the flash op where :func:`flash_suits` (CUDA tensors,
    bf16, head dimension 32, both sequences at least :data:`FLASH_MIN_SEQ`
    long), else the plain version; with ``FLASH_MIN_SEQ = None`` always
    the plain version.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import flash_attention as _fa

IMPLS = ("auto", "xla", "pallas")

# Smallest n = m from which K7a beats the plain version on the card (bf16,
# (1, 4, n, 32)) at every longer swept length; "auto" takes K7a only where
# that sweep measured it (see flash_suits), set from the sweep of
# chip_smoke.py phase 2, whose times PERF.md section 6 lists with the card
# they were taken on. On the H100 the tensor-core K7a wins at every swept
# length, 34 to 16384: below ~2048 the plain version's several launches
# cost more than its math, above it its (n, m) scores in device memory. So
# "auto" runs K7a from 34 rows up (the UNet's RT axis). The JAX package's
# 5120 is where XLA's attention spills on a TPU v5e and does not carry over.
FLASH_MIN_SEQ: Optional[int] = 34


def flash_suits(q: torch.Tensor, k: torch.Tensor) -> bool:
    """Whether ``"auto"`` runs the flash op on CUDA tensors ``q``, ``k``:
    where the sweep behind :data:`FLASH_MIN_SEQ` measured K7a winning,
    bf16 (its tensor-core body) at head dimension 32 with both sequences
    that long. float32 takes K7a's CUDA-core body, which loses to the
    plain version at long rows, and the kernels take no other head
    dimension."""
    n = min(q.shape[-2], k.shape[-2])
    return (FLASH_MIN_SEQ is not None and n >= FLASH_MIN_SEQ
            and q.dtype == torch.bfloat16 and q.shape[-1] == _fa.HEAD_DIM)


def xla_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> torch.Tensor:
    if scale is None:
        scale = q.shape[-1] ** -0.5
    sim = torch.matmul(q.to(torch.float32), k.to(torch.float32).transpose(-1, -2)) * scale
    attn = torch.softmax(sim, dim=-1)
    return torch.matmul(attn.to(v.dtype), v)


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    impl: str = "auto",
    kernels: bool = True,
) -> torch.Tensor:
    """Softmax attention over (b, h, n, d) by ``impl``; ``scale=None`` is
    1/sqrt(d). ``kernels=False`` runs the flash op's plain version where
    ``impl`` selects the flash op (a model's ``use_kernels(False)``)."""
    if impl not in IMPLS:
        raise ValueError(f"Unknown attention impl: {impl!r}")
    if impl == "auto":
        impl = "pallas" if (q.is_cuda and flash_suits(q, k)) else "xla"
    if impl == "pallas":
        flash = _fa.flash_attention if kernels else _fa.flash_attention_plain
        return flash(q, k, v, scale)
    return xla_attention(q, k, v, scale)
