"""Flash attention over (b, h, n, d): forward (K7a) and backward (K7b).

Port of :mod:`dquartic_tpu.ops.flash_attention`. The forward writes the
output and, for the backward, each row's statistics; the backward rebuilds
P block by block from the saved ``(q, k, v, out, stats)``, so the (n, m)
score matrix never reaches device memory in either direction. Two
differences from the JAX kernel:

* the saved ``out`` is the float32 output, before its rounding to a bf16
  input's dtype, so that ``D = rowsum(dO ∘ O)`` carries no rounding that is
  shared by every key of a row (``csrc/flash_attention.cu`` says what such
  an error does to the gradients);
* P is rebuilt from the rows' statistics ``stats = (m, l)``, saved apart:
  ``P = exp2(s·scale·log2e − m) / l``, with ``m``
  the row's largest scaled score in log2 units and ``l`` the sum of
  ``exp2(s·scale·log2e − m)``, each score formed as the forward forms it.
  ``P = exp(s·scale − lse)``, from the JAX kernel's per-row logsumexp
  ``lse = m ln 2 + log l`` (:func:`lse_of`), is off by factors of ``2^k``
  where ``|lse|`` nears 1e8 (float32's spacing there is 8), which the full
  UNet1d's transformer reaches in training; from ``(m, l)`` P is the
  forward's softmax to float32's rounding at any size of the scores.

:func:`flash_attention` is a ``torch.autograd.Function`` on both devices.
On CUDA tensors its forward launches ``csrc/flash_attention.cu`` (bf16 on
tensor cores, float32 on CUDA cores) and its backward
``csrc/flash_attention_bwd.cu`` (one cluster launch at the model's lengths,
:func:`flash_backward_plan`); a call that autograd does not track
launches the forward alone, writing only the output. On CPU tensors they
run the plain versions :func:`flash_attention_reference` and
:func:`flash_attention_backward_reference`, which compute the same
formulas with float32 scores, softmax and products and round once to the
input dtype (the math of the JAX kernel, not of ``_xla_attention``, which
casts the weights to v's dtype before the second product).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import _build

HEAD_DIM = 32  # the kernels map one head row onto one warp's lanes
# scale · log2(e) as the kernels form it: both factors in float32, one rounding
_LOG2E = np.float32(1.4426950408889634)
_LN2 = float(np.float32(0.6931471805599453))
# n and m up to which K7b is one cluster launch (kOneLaunch in
# csrc/flash_attention_bwd.cu), and the kv rows of one of its CTAs
FLASH_BWD_ONE_LAUNCH = 512
_KV_BLOCK = 64


def _scaled_scores(q, k, scale: float) -> torch.Tensor:
    """``(q·kᵀ)·(scale·log2e)`` in float32: the scaled scores (log2 units)
    the softmax, its statistics and the rebuilt P are formed from."""
    s = torch.matmul(q.to(torch.float32), k.to(torch.float32).transpose(-1, -2))
    return s * float(np.float32(scale) * _LOG2E)


def _reference_f32(q, k, v, scale: float):
    """Plain forward with the output left in float32: ``(out32, stats)``,
    as K7a forms them: ``stats`` (b, h, n, 2) float32 holds each row's
    ``m``, its largest scaled score (log2 units), and ``l``, the sum of
    ``e = exp2(score − m)``; ``P = e / l``. ``m`` is a shift that P does
    not depend on: autograd does not differentiate it."""
    s2 = _scaled_scores(q, k, scale)
    m = s2.amax(dim=-1, keepdim=True).detach()
    e = torch.exp2(s2 - m)
    l = e.sum(dim=-1, keepdim=True)
    return torch.matmul(e / l, v.to(torch.float32)), torch.cat([m, l], dim=-1)


def lse_of(stats: torch.Tensor) -> torch.Tensor:
    """The per-row logsumexp ``m ln 2 + log l`` (b, h, n) float32 of the
    rows' statistics: the JAX kernel's second forward result."""
    return stats[..., 0] * _LN2 + torch.log(stats[..., 1])


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain forward: ``(out, lse)``; ``out`` in q's dtype, ``lse`` (b, h, n)
    float32."""
    out32, stats = _reference_f32(q, k, v, scale)
    return out32.to(q.dtype), lse_of(stats)


def flash_attention_plain(q, k, v, scale: Optional[float] = None) -> torch.Tensor:
    """The op's plain version as one differentiable function (autograd of
    torch ops), for the model's plain path (``use_kernels(False)``)."""
    return flash_attention_reference(q, k, v, _scale(q, scale))[0]


def flash_attention_backward_reference(q, k, v, o, stats, do, scale: float):
    """Plain backward: ``D = rowsum(dO ∘ O)``, ``dS = P ∘ (dO·vᵀ − D)``,
    ``dq = dS·k·scale``, ``dk = dSᵀ·q·scale``, ``dv = Pᵀ·dO``, in float32,
    each rounded once to its input's dtype. ``o`` is the forward's output,
    in float32 or in the input dtype. P is ``exp2(score − m) / l`` from the
    rows' ``stats`` (b, h, n, 2) = (m, l), as the forward saves them."""
    q32, k32, v32, do32 = (t.to(torch.float32) for t in (q, k, v, do))
    stats = stats.to(torch.float32)
    p = torch.exp2(_scaled_scores(q32, k32, scale) - stats[..., :1]) / stats[..., 1:]
    d = (do32 * o.to(torch.float32)).sum(-1, keepdim=True)
    ds = p * (torch.matmul(do32, v32.transpose(-1, -2)) - d)
    dq = torch.matmul(ds, k32) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q32) * scale
    dv = torch.matmul(p.transpose(-1, -2), do32)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return float(q.shape[-1] ** -0.5 if scale is None else scale)


def _check_kernel_args(op: str, q, k, v) -> None:
    if q.device.type != "cuda":
        raise RuntimeError(f"{op}: unsupported device {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"{op}: q, k, v must all be float32 or all bfloat16")
    if q.dim() != 4 or k.shape != v.shape or k.shape[:2] != q.shape[:2]:
        raise ValueError(f"{op}: q (b, h, n, d), k and v (b, h, m, d); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[-1] != HEAD_DIM or k.shape[-1] != HEAD_DIM:
        raise ValueError(f"{op}: the kernel takes dim_head {HEAD_DIM} (got {q.shape[-1]})")
    if q.shape[2] < 1 or k.shape[2] < 1 or q.shape[0] * q.shape[1] > 65535:
        raise ValueError(f"{op}: needs n, m >= 1 and b*h <= 65535")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous, at a 16-byte aligned address (a view with an odd
    offset is copied): the kernels read rows with 16-byte copies."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch_forward(q, k, v, scale, saved: bool = True):
    """K7a (``csrc/flash_attention.cu``): ``(out, out32, stats)``. With
    ``saved`` the kernel also writes what the backward takes: ``out32``,
    the float32 output (``out`` itself for float32 inputs), and the rows'
    ``stats`` (m, l); without it they are None, and the output is the only
    allocation."""
    _check_kernel_args("flash_attention", q, k, v)
    b, h, n, _ = q.shape
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    bf16 = q.dtype == torch.bfloat16
    out = torch.empty_like(q)
    out32 = stats = None
    if saved:
        out32 = torch.empty(q.shape, dtype=torch.float32, device=q.device) if bf16 else out
        stats = torch.empty((b, h, n, 2), dtype=torch.float32, device=q.device)
    code = _build.library().dq_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        out32.data_ptr() if saved and bf16 else None, stats.data_ptr() if saved else None,
        b * h, n, k.shape[2], scale, int(bf16), q.device.index or 0, _build.stream_of(q),
    )
    _build.check(code, "dq_flash_attention")
    flash_attention.launches += 1
    return out, out32, stats


def _plain(t: torch.Tensor) -> bool:
    """Whether the op runs its plain versions: on CPU tensors."""
    return t.device.type == "cpu"


def flash_backward_plan(b: int, h: int, n: int, m: int, bf16: bool = True) -> dict:
    """K7b's launches for q (b, h, n, 32) and k, v (b, h, m, 32): where n and
    m are at most FLASH_BWD_ONE_LAUNCH (the UNet's RT axis, 34 or 340), one
    cluster launch a call, ``cluster`` = ceil(m / 64) CTAs a head, each
    owning 64 kv rows and summing dq over the cluster in rank order; past
    it, two (dq over q blocks, then dk and dv over kv blocks), ``cluster``
    0. ``tensor_cores``: bf16 runs ``mma.sync``, float32 CUDA cores."""
    if min(b, h, n, m) < 1:
        raise ValueError(f"flash_backward_plan: needs b, h, n, m >= 1 (got {(b, h, n, m)})")
    one = n <= FLASH_BWD_ONE_LAUNCH and m <= FLASH_BWD_ONE_LAUNCH
    return dict(launches=1 if one else 2, cluster=-(-m // _KV_BLOCK) if one else 0,
                tensor_cores=bool(bf16))


def flash_attention_backward(q, k, v, o, stats, do, scale: float):
    """(dq, dk, dv) of :func:`flash_attention` for the output cotangent
    ``do``, each in its input's dtype; ``o`` is the forward's output, best
    the float32 one (``D`` is formed from it), and P is rebuilt from the
    rows' ``stats`` (b, h, n, 2) = (m, l), as the forward saves them. CPU
    tensors run :func:`flash_attention_backward_reference`; CUDA tensors
    launch K7b (``csrc/flash_attention_bwd.cu``) as
    :func:`flash_backward_plan` says: one cluster launch at the model's
    lengths, D formed inside, no atomics, so deterministic. The only
    allocations are dq, dk and dv (and copies of inputs that are not dense,
    aligned or of the kernel's dtype)."""
    if o.shape != q.shape or do.shape != q.shape or stats.shape != (*q.shape[:3], 2):
        raise ValueError("flash_attention_backward: o and do must have q's shape, stats "
                         f"(b, h, n, 2); got {tuple(o.shape)}, {tuple(do.shape)}, "
                         f"{tuple(stats.shape)}")
    if _plain(q):
        return flash_attention_backward_reference(q, k, v, o, stats, do, scale)
    _check_kernel_args("flash_attention_backward", q, k, v)
    b, h, n, _ = q.shape
    m = k.shape[2]
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    do = _aligned(do if do.dtype == q.dtype else do.to(q.dtype))
    o = _aligned(o if o.dtype == torch.float32 else o.to(torch.float32))
    stats = _aligned(stats if stats.dtype == torch.float32 else stats.to(torch.float32))
    bf16 = q.dtype == torch.bfloat16
    plan = flash_backward_plan(b, h, n, m, bf16)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    ptrs = (q, k, v, o, stats, do, dq, dk, dv)
    code = _build.library().dq_flash_attention_bwd(
        *[t.data_ptr() for t in ptrs], b * h, n, m, scale, int(bf16), plan["cluster"],
        q.device.index or 0, _build.stream_of(q),
    )
    _build.check(code, "dq_flash_attention_bwd")
    flash_attention_backward.launches += 1
    return dq, dk, dv


class _FlashFn(torch.autograd.Function):
    """K7a forward, K7b backward; saves ``(q, k, v, out32, stats)`` on both
    devices (on the CPU the plain forward's)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        if _plain(q):
            out32, stats = _reference_f32(q, k, v, scale)
            out = out32.to(q.dtype)
        else:
            out, out32, stats = _launch_forward(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out32, stats)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        return (*flash_attention_backward(*ctx.saved_tensors, do, ctx.scale), None)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> torch.Tensor:
    """Softmax attention over (b, h, n, d) with a blockwise backward;
    ``scale=None`` is ``d ** -0.5``. On CUDA tensors: float32 or bf16,
    d = 32, any n and m. A call that autograd does not track (grad mode
    off, or no input requiring grad) launches K7a alone, writing the
    output and neither the rows' statistics nor the float32 output."""
    scale = _scale(q, scale)
    if not _plain(q) and not (torch.is_grad_enabled()
                              and (q.requires_grad or k.requires_grad or v.requires_grad)):
        return _launch_forward(q, k, v, scale, saved=False)[0]
    return _FlashFn.apply(q, k, v, scale)


flash_attention.launches = 0  # kernel launches; reset by the caller
flash_attention_backward.launches = 0
