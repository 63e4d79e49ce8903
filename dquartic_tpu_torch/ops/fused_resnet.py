"""Fused ResnetBlock on channel-first (B, C, N) activations: forward (K2)
and backward (K5).

Port of :func:`dquartic_tpu.ops.fused_resnet.fused_resnet_block_t`:
conv3 -> RMSNorm -> FiLM -> SiLU -> conv3 -> RMSNorm -> SiLU -> + (1x1
conv or identity) residual, as one CUDA launch (``csrc/fused_resnet.cu``);
its gradient is the recompute-based ``csrc/fused_resnet_bwd.cu``. On CUDA
tensors the op is a ``torch.autograd.Function`` that saves only ``(x,
params)``, as the JAX ``custom_vjp`` does. The public functions keep the
JAX op's (B, C_in, N) layout and flax weight layouts, so tests hand both
the same arrays.
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


def resnet_block_t_backward_reference(dy, *args):
    """Plain backward: autograd of :func:`resnet_block_t_reference` at
    ``args`` (the op's eleven arguments). Returns one gradient per
    argument, None for an argument that is None."""
    with torch.enable_grad():
        leaves = [None if a is None else a.detach().requires_grad_(True) for a in args]
        out = resnet_block_t_reference(*leaves)
        live = [a for a in leaves if a is not None]
        grads = iter(torch.autograd.grad(out, live, dy))
        return tuple(None if a is None else next(grads) for a in leaves)


def _check_args(op, x_t, w1, scale, shift, w2, w_res) -> bool:
    """Checks the op's arguments; True for CUDA tensors (the kernel's
    checks too), False for CPU tensors (the plain version's)."""
    if (scale is None) != (shift is None):
        raise ValueError("scale and shift must both be provided or both None")
    B, c_in, N = x_t.shape
    c_out = w1.shape[-1]
    if w_res is None and c_in != c_out:
        raise ValueError("identity residual requires C_in == C_out")
    if not x_t.is_cuda:
        if x_t.device.type == "cpu":
            return False
        raise RuntimeError(f"{op}: unsupported device {x_t.device}")
    if x_t.dtype not in (torch.float32, torch.bfloat16) or not x_t.is_contiguous():
        raise ValueError(f"{op}: x_t must be contiguous float32 or bfloat16")
    if c_in > MAX_C_IN or c_out > MAX_C_OUT:
        raise ValueError(
            f"{op}: kernel takes C_in <= {MAX_C_IN}, C_out <= {MAX_C_OUT} (got {c_in} -> {c_out})"
        )
    if w1.shape != (3, c_in, c_out) or w2.shape != (3, c_out, c_out):
        raise ValueError(f"conv kernels must be (3, {c_in}, {c_out}) and (3, {c_out}, {c_out})")
    return True


_OPERANDS = ("w1", "b1", "g1", "scale", "shift", "w2", "b2", "g2", "w_res", "b_res")
_NDIM = (3, 1, 1, 2, 2, 3, 1, 1, 3, 1)
# the strides K2 reads of each operand (all but w_res's leading 1), and the
# arguments that stand for a missing one
_NSTRIDES = (3, 1, 1, 2, 2, 3, 1, 1, 2, 1)
_STRIDES = tuple(slice(-n, None) for n in _NSTRIDES)
_ABSENT = tuple((None,) + (0,) * n for n in _NSTRIDES)
_BF16_BIT = {torch.float32: 0, torch.bfloat16: 1}


def _operand_args(x_t, params, what="fused_resnet_block_t"):
    """The pointers and strides of the ten operands as K2 and K5 read them
    (each in its own dtype through its strides, no copy), their dtype bits
    and the flags (FiLM, residual conv, residual bias); checks their
    shapes."""
    B, c_in, N = x_t.shape
    c_out = params[0].shape[-1]
    dev = x_t.get_device()
    args, bits = [], 0
    for i, t in enumerate(params):
        if t is None:
            args += _ABSENT[i]
            continue
        st = t.stride()
        if len(st) != _NDIM[i] or t.get_device() != dev or t.dtype not in _BF16_BIT:
            raise ValueError(
                f"{what}: {_OPERANDS[i]} must be a {_NDIM[i]}-d float32 or "
                f"bfloat16 tensor on {x_t.device} (got {tuple(t.shape)} {t.dtype} on {t.device})")
        bits |= _BF16_BIT[t.dtype] << i
        args.append(t.data_ptr())
        args += st[_STRIDES[i]]
    w1, b1, g1, scale, shift, w2, b2, g2, w_res, b_res = params
    if not b1.shape[0] == g1.shape[0] == b2.shape[0] == g2.shape[0] == c_out or (
            b_res is not None and b_res.shape[0] != c_out):
        raise ValueError(f"{what}: biases and gains must hold {c_out} values")
    if scale is not None and not scale.shape == shift.shape == (B, c_out):
        raise ValueError(f"{what}: scale and shift must be ({B}, {c_out})")
    if w_res is not None and w_res.shape != (1, c_in, c_out):
        raise ValueError(f"{what}: w_res must be (1, {c_in}, {c_out})")
    flags = (scale is not None) | (w_res is not None) << 1 | (b_res is not None) << 2
    return args, bits, flags


def _forward_kernel(x_t, *params):
    """Launch K2 (``csrc/fused_resnet.cu``): checks, one allocation (out)
    and one launch. The kernel reads every parameter as it is, in its own
    dtype (float32 or bf16) through its strides, and rounds the conv
    weights to x's dtype itself, as K5 does."""
    B, c_in, N = x_t.shape
    c_out = params[0].shape[-1]
    args, bits, flags = _operand_args(x_t, params)
    out = torch.empty((B, c_out, N), dtype=x_t.dtype, device=x_t.device)
    code = _build.library().dq_fused_resnet(
        x_t.data_ptr(), out.data_ptr(), *args, B, c_in, c_out, N, flags, bits,
        _BF16_BIT[x_t.dtype], x_t.get_device(), _build.stream_of(x_t),
    )
    _build.check(code, "dq_fused_resnet")
    fused_resnet_block_t.launches += 1
    return out


def fused_resnet_backward(dy, x_t, w1, b1, g1, scale, shift, w2, b2, g2, w_res, b_res):
    """Gradients of :func:`fused_resnet_block_t` at its eleven arguments for
    the output cotangent ``dy`` (K5): dx in x_t's dtype, every other
    gradient in its argument's shape and dtype, None where the argument is
    None.

    CPU tensors run :func:`resnet_block_t_backward_reference`. CUDA tensors
    launch ``csrc/fused_resnet_bwd.cu``: one kernel that recomputes the
    block from x, reads the parameters as K2 does and sums each CTA's
    parameter gradients in registers, and one small launch that sums the
    CTAs' partials in a fixed order into tensors of the parameters' shapes,
    dtypes and strides. The wrapper allocates and launches; it runs no
    torch op on the parameters."""
    args = (x_t, w1, b1, g1, scale, shift, w2, b2, g2, w_res, b_res)
    if not _check_args("fused_resnet_backward", x_t, w1, scale, shift, w2, w_res):
        return resnet_block_t_backward_reference(dy, *args)
    return _backward_kernel(dy, *args)


def _backward_kernel(dy, x_t, *params):
    """Launch K5 on checked arguments: the gradients' allocations, one
    buffer of partial sums and the entry point's two launches."""
    B, c_in, N = x_t.shape
    c_out = params[0].shape[-1]
    pargs, bits, flags = _operand_args(x_t, params, "fused_resnet_backward")
    if dy.dtype != x_t.dtype or not dy.is_contiguous():
        dy = dy.to(x_t.dtype).contiguous()
    dx = torch.empty_like(x_t)
    grads = [None if t is None else torch.empty_like(t) for t in params]
    gargs, gbits, _ = _operand_args(x_t, grads, "fused_resnet_backward")
    # each CTA's partial sums: up to 64 CTAs a row, every weight, bias, gain
    # and FiLM gradient
    plen = 3 * c_in * c_out + 3 * c_out * c_out + c_in * c_out + 7 * c_out
    part = torch.empty(B * min(64, -(-N // 128)) * plen, dtype=torch.float32, device=x_t.device)
    code = _build.library().dq_fused_resnet_bwd(
        x_t.data_ptr(), dy.data_ptr(), dx.data_ptr(), *pargs, *gargs, part.data_ptr(), B, c_in,
        c_out, N, flags, bits, gbits, _BF16_BIT[x_t.dtype], x_t.get_device(),
        _build.stream_of(x_t),
    )
    _build.check(code, "dq_fused_resnet_bwd")
    fused_resnet_backward.launches += 1
    return (dx, *grads)


class _FusedResnetFn(torch.autograd.Function):
    """K2 forward, K5 backward; saves only ``(x, params)``."""

    @staticmethod
    def forward(ctx, *args):
        ctx.save_for_backward(*args)
        return _forward_kernel(*args)

    @staticmethod
    def backward(ctx, dy):
        return fused_resnet_backward(dy, *ctx.saved_tensors)


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
    """Fused ResnetBlock.

    Args:
      x_t: (B, C_in, N) activations, float32 or bfloat16.
      w1/w2: flax conv3 kernels (3, C_in, C_out) / (3, C_out, C_out).
      b1/b2, g1/g2: (C_out,) biases and RMSNorm gains.
      scale/shift: (B, C_out) FiLM (the kernel applies h*(scale+1)+shift),
        or both None.
      w_res/b_res: (1, C_in, C_out) 1x1 residual conv and bias, or None
        for the identity residual (C_in == C_out).

    Each parameter may be float32 or bfloat16 and any strided view (the
    module hands over its torch conv weights permuted, and its float32
    masters in training); the conv weights are used rounded to x's dtype.

    Returns (B, C_out, N) in x_t's dtype. CPU tensors run
    :func:`resnet_block_t_reference`, which autograd differentiates; CUDA
    tensors run the K2 kernel, and its gradient is the K5 kernel. An
    untracked call (no_grad, or nothing requiring grad) launches K2 without
    an autograd node."""
    args = (x_t, w1, b1, g1, scale, shift, w2, b2, g2, w_res, b_res)
    if not _check_args("fused_resnet_block_t", x_t, w1, scale, shift, w2, w_res):
        return resnet_block_t_reference(*args)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in args):
        return _FusedResnetFn.apply(*args)
    return _forward_kernel(*args)  # untracked: no autograd node


fused_resnet_block_t.launches = 0  # kernel launches; reset by the caller
fused_resnet_backward.launches = 0
