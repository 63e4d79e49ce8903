"""Fused pre-norm linear attention with residual (K1), forward only.

Port of the form of :func:`dquartic_tpu.ops.linear_attention.fused_linear_attention_t`
that UNet1d calls — pre-RMSNorm, residual and static softmax shift all on
(``_fused_forward_single_t`` / ``_kernel_ab_t``):

    y = x + RMSNorm_g(W_out · attn(RMSNorm_{g_pre}(x)) + b_out)

with q softmaxed over each head's features and k over the sequence. The
CUDA kernel is ``csrc/linear_attention.cu``. The op takes channel-first
(B, C, N) activations — the layout the TPU kernel itself runs on — and
the flax weight layouts: ``w_qkv`` (C, 3H) with q|k|v blocks and
channel-major heads, ``w_out`` (H, C).
"""

from __future__ import annotations

import math

import torch

from . import _build

_LOG2E = 1.4426950408889634
MAX_C = 16
DIM_HEAD = 32  # the kernel maps one head onto one warp
_CHUNK = 1024  # sequence columns per phase-0 CTA


def rmsnorm_reference(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """float32 RMSNorm over the channel axis (dim 1), 1e-12 norm clamp."""
    x32 = x.to(torch.float32)
    norm = torch.sqrt(torch.sum(x32 * x32, dim=1, keepdim=True))
    return x32 / torch.clamp(norm, min=1e-12) * g.to(torch.float32).reshape(1, -1, 1) * (
        x.shape[1] ** 0.5
    )


def linear_attention_reference(x, w_qkv, w_out, b_out, g, heads, dim_head):
    """Plain linear attention + out-projection + RMSNorm on (B, C, N), in
    float32 (``linear_attention_reference`` of the JAX package)."""
    B, C, N = x.shape
    H = heads * dim_head
    qkv = torch.einsum("bcn,ch->bhn", x.to(torch.float32), w_qkv.to(torch.float32))
    q, k, v = (t.reshape(B, heads, dim_head, N) for t in qkv.split(H, dim=1))
    q = torch.softmax(q, dim=2) * (dim_head**-0.5)  # over each head's features
    k = torch.softmax(k, dim=3)  # over the sequence
    context = torch.einsum("bhdn,bhen->bhde", k, v)
    out = torch.einsum("bhde,bhdn->bhen", context, q).reshape(B, H, N)
    y = torch.einsum("bhn,hc->bcn", out, w_out.to(torch.float32))
    y = y + b_out.to(torch.float32).reshape(1, -1, 1)
    return rmsnorm_reference(y, g).to(x.dtype)


def linear_attention_nr_reference(x, w_qkv, w_out, b_out, g, g_pre, heads, dim_head):
    """Plain version of the op: ``x + attn(RMSNorm_{g_pre}(x))``
    (``linear_attention_nr_reference`` of the JAX package, residual on)."""
    xn = rmsnorm_reference(x, g_pre).to(x.dtype)
    out = linear_attention_reference(xn, w_qkv, w_out, b_out, g, heads, dim_head)
    return (x + out).to(x.dtype)


def static_shifts(wq: torch.Tensor, wk: torch.Tensor, g_pre: torch.Tensor, heads: int):
    """Softmax shift bounds (H,) for the pre-normed input (``_static_shifts``).

    A pre-normed column has norm sqrt(C)·||u ∘ g_pre|| <= sqrt(C)·max|g_pre|,
    so kshift[d] = ||wk_d||·sqrt(C)·max|g_pre| bounds every k[d, n]; the q
    shift must be constant within a head, so it is the head's max bound."""
    C = wq.shape[1]
    cn = (C**0.5) * g_pre.abs().max()
    kshift = torch.linalg.vector_norm(wk, dim=1) * cn
    qrow = torch.linalg.vector_norm(wq, dim=1) * cn
    qshift = qrow.reshape(heads, -1).amax(dim=1).repeat_interleave(wq.shape[0] // heads)
    return kshift, qshift


def linear_attention(
    x: torch.Tensor,
    w_qkv: torch.Tensor,
    w_out: torch.Tensor,
    b_out: torch.Tensor,
    g: torch.Tensor,
    g_pre: torch.Tensor,
    heads: int = 4,
    dim_head: int = DIM_HEAD,
) -> torch.Tensor:
    """``x + RMSNorm_g(attn(RMSNorm_{g_pre}(x)))`` on (B, C, N).

    CPU tensors run :func:`linear_attention_nr_reference`; CUDA tensors
    launch the kernel (C <= 16, dim_head 32, heads·32 <= 256)."""
    _build.require_no_grad("linear_attention", x, w_qkv, w_out, b_out, g, g_pre)
    if x.device.type == "cpu":
        return linear_attention_nr_reference(x, w_qkv, w_out, b_out, g, g_pre, heads, dim_head)
    if x.device.type != "cuda":
        raise RuntimeError(f"linear_attention: unsupported device {x.device}")
    B, C, N = x.shape
    H = heads * dim_head
    if x.dtype not in (torch.float32, torch.bfloat16) or not x.is_contiguous():
        raise ValueError("linear_attention: x must be contiguous float32 or bfloat16")
    if C > MAX_C or dim_head != DIM_HEAD or H > 256:
        raise ValueError(
            f"linear_attention: kernel takes C <= {MAX_C}, dim_head {DIM_HEAD}, "
            f"heads*dim_head <= 256 (got C={C}, heads={heads}, dim_head={dim_head})"
        )
    if w_qkv.shape != (C, 3 * H) or w_out.shape != (H, C):
        raise ValueError(f"w_qkv must be ({C}, {3 * H}) and w_out ({H}, {C})")

    dev = x.device

    def f32(t):
        return t.to(device=dev, dtype=torch.float32).contiguous()

    wt = f32(w_qkv).t()
    wq, wk, wv = wt[:H], wt[H : 2 * H], wt[2 * H :]
    gp = f32(g_pre).reshape(C)
    kshift, qshift = static_shifts(wq, wk, gp, heads)
    # exp via exp2f: fold log2(e) into the q/k projections and their shifts
    wq, wk = f32(wq * _LOG2E), f32(wk * _LOG2E)
    kshift, qshift = f32(kshift * _LOG2E), f32(qshift * _LOG2E)

    nsplit = max(1, math.ceil(N / _CHUNK))
    chunk = math.ceil(N / nsplit)
    part = torch.empty((B, nsplit, H, C + 1), dtype=torch.float32, device=dev)
    m = torch.empty((B, C, H), dtype=torch.float32, device=dev)
    y = torch.empty_like(x)
    args = (wq, wk, f32(wv), f32(w_out), qshift, kshift, gp, f32(b_out).reshape(C),
            f32(g).reshape(C))
    lib = _build.library()
    code = lib.dq_linear_attention(
        x.data_ptr(), *[a.data_ptr() for a in args], part.data_ptr(), m.data_ptr(),
        y.data_ptr(), B, C, N, heads, nsplit, chunk, int(x.dtype == torch.bfloat16),
        dev.index or 0, _build.stream_of(x),
    )
    _build.check(code, "dq_linear_attention")
    linear_attention.launches += 1
    return y


linear_attention.launches = 0  # kernel launches; reset by the caller
