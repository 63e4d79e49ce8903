"""Fused ResnetBlock on channel-first (B, C, N) activations (K2).

Port of :func:`dquartic_tpu.ops.fused_resnet.fused_resnet_block_t`
(forward only): conv3 -> RMSNorm -> FiLM -> SiLU -> conv3 -> RMSNorm ->
SiLU -> + (1x1 conv or identity) residual, as one CUDA launch
(``csrc/fused_resnet.cu``). The public function keeps the JAX op's
(B, C_in, N) layout and flax weight layouts, so tests hand both the same
arrays. There is no backward kernel yet: the op raises under autograd.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import _build
from .linear_attention import rmsnorm_reference

MAX_C_IN = 32
MAX_C_OUT = 16


def resnet_block_t_reference(x_t, w1, b1, g1, scale, shift, w2, b2, g2, w_res, b_res):
    """Plain version with the JAX oracle's math and rounding points
    (``resnet_block_t_reference``): every stage is rounded to x's dtype,
    norms run in float32."""
    dtype = x_t.dtype

    def conv3(x, w, b):  # w (3, C_in, C_out)
        return F.conv1d(x, w.permute(2, 1, 0).to(dtype), b.to(dtype), padding=1)

    h = rmsnorm_reference(conv3(x_t, w1, b1), g1).to(dtype)
    if scale is not None:
        h = h * (scale[:, :, None].to(dtype) + 1.0) + shift[:, :, None].to(dtype)
    h = h * torch.sigmoid(h)
    h2 = rmsnorm_reference(conv3(h, w2, b2), g2).to(dtype)
    h2 = h2 * torch.sigmoid(h2)
    if w_res is not None:
        res = torch.einsum("bcn,cd->bdn", x_t, w_res[0].to(dtype))
        if b_res is not None:
            res = res + b_res.to(dtype).reshape(1, -1, 1)
    else:
        res = x_t
    return (h2 + res.to(dtype)).to(dtype)


def fused_resnet_block_t(
    x_t: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    g1: torch.Tensor,
    scale: Optional[torch.Tensor],
    shift: Optional[torch.Tensor],
    w2: torch.Tensor,
    b2: torch.Tensor,
    g2: torch.Tensor,
    w_res: Optional[torch.Tensor],
    b_res: Optional[torch.Tensor],
) -> torch.Tensor:
    """Fused ResnetBlock forward.

    Args:
      x_t: (B, C_in, N) activations, float32 or bfloat16.
      w1/w2: flax conv3 kernels (3, C_in, C_out) / (3, C_out, C_out).
      b1/b2, g1/g2: (C_out,) biases and RMSNorm gains.
      scale/shift: (B, C_out) FiLM (the kernel applies h*(scale+1)+shift),
        or both None.
      w_res/b_res: (1, C_in, C_out) 1x1 residual conv and bias, or None
        for the identity residual (C_in == C_out).

    Returns (B, C_out, N) in x_t's dtype. CPU tensors run
    :func:`resnet_block_t_reference`; CUDA tensors launch the kernel."""
    if (scale is None) != (shift is None):
        raise ValueError("scale and shift must both be provided or both None")
    B, c_in, N = x_t.shape
    c_out = w1.shape[-1]
    if w_res is None and c_in != c_out:
        raise ValueError("identity residual requires C_in == C_out")
    _build.require_no_grad(
        "fused_resnet_block_t", x_t, w1, b1, g1, scale, shift, w2, b2, g2, w_res, b_res
    )
    if x_t.device.type == "cpu":
        return resnet_block_t_reference(x_t, w1, b1, g1, scale, shift, w2, b2, g2, w_res, b_res)
    if x_t.device.type != "cuda":
        raise RuntimeError(f"fused_resnet_block_t: unsupported device {x_t.device}")
    if x_t.dtype not in (torch.float32, torch.bfloat16) or not x_t.is_contiguous():
        raise ValueError("fused_resnet_block_t: x_t must be contiguous float32 or bfloat16")
    if c_in > MAX_C_IN or c_out > MAX_C_OUT:
        raise ValueError(
            f"fused_resnet_block_t: kernel takes C_in <= {MAX_C_IN}, C_out <= "
            f"{MAX_C_OUT} (got {c_in} -> {c_out})"
        )
    if w1.shape != (3, c_in, c_out) or w2.shape != (3, c_out, c_out):
        raise ValueError(f"conv kernels must be (3, {c_in}, {c_out}) and (3, {c_out}, {c_out})")

    dev = x_t.device

    def weight(w):  # rounded to the compute dtype like the TPU kernel's weights
        return w.to(device=dev, dtype=x_t.dtype).to(torch.float32).contiguous()

    def f32(v, shape):
        return v.to(device=dev, dtype=torch.float32).reshape(shape).contiguous()

    film = scale is not None
    has_res = w_res is not None
    args = [
        weight(w1), f32(b1, (c_out,)), f32(g1, (c_out,)),
        f32(scale, (B, c_out)) if film else None,
        f32(shift, (B, c_out)) if film else None,
        weight(w2), f32(b2, (c_out,)), f32(g2, (c_out,)),
        weight(w_res[0]) if has_res else None,
        (f32(b_res, (c_out,)) if b_res is not None else torch.zeros(c_out, device=dev))
        if has_res else None,
    ]
    out = torch.empty((B, c_out, N), dtype=x_t.dtype, device=dev)
    lib = _build.library()
    code = lib.dq_fused_resnet(
        x_t.data_ptr(), *[a.data_ptr() if a is not None else None for a in args],
        out.data_ptr(), B, c_in, c_out, N, int(film), int(has_res),
        int(x_t.dtype == torch.bfloat16), dev.index or 0, _build.stream_of(x_t),
    )
    _build.check(code, "dq_fused_resnet")
    fused_resnet_block_t.launches += 1
    return out


fused_resnet_block_t.launches = 0  # kernel launches; reset by the caller
