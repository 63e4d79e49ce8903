"""Fused pre-norm linear attention with residual: forward (K1) and
backward (K4).

Port of the form of :func:`dquartic_tpu.ops.linear_attention.fused_linear_attention_t`
that UNet1d calls — pre-RMSNorm, residual and static softmax shift all on
(``_fused_forward_single_t`` / ``_kernel_ab_t``, and its streamed
backward ``_fused_backward_t``):

    y = x + RMSNorm_g(W_out · attn(RMSNorm_{g_pre}(x)) + b_out)

with q softmaxed over each head's features and k over the sequence. The
CUDA kernels are ``csrc/linear_attention.cu`` (forward) and
``csrc/linear_attention_bwd.cu`` (backward); on CUDA tensors the op is a
``torch.autograd.Function`` that runs one forward and one backward kernel
and saves only ``(x, weights)``, as the JAX ``custom_vjp`` does. The op
takes channel-first (B, C, N) activations — the layout the TPU kernel
itself runs on — and the flax weight layouts: ``w_qkv`` (C, 3H) with
q|k|v blocks and channel-major heads, ``w_out`` (H, C).

The row-blocked ops of ``impl="pallas"`` (port of
:func:`dquartic_tpu.ops.linear_attention.fused_linear_attention`) compute
``RMSNorm_g(W_out · attn(x) + b_out)`` on (B, N, C), without pre-norm or
residual and with a running max for the k-softmax:
:func:`fused_linear_attention` (K8, one launch) and
:func:`fused_linear_attention_two_call` (K9, two launches), both in
``csrc/linear_attention_rows.cu``, with :func:`linear_attention_rows_reference`
as their plain version.
"""

from __future__ import annotations

import math

import torch

from . import _build

_LOG2E = 1.4426950408889634
MAX_C = 16
DIM_HEAD = 32  # the kernel maps one head onto one warp
_CHUNK = 1024  # sequence columns per CTA of the streaming passes


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


def linear_attention_backward_reference(dy, x, w_qkv, w_out, b_out, g, g_pre, heads, dim_head):
    """Plain backward: autograd of :func:`linear_attention_nr_reference`.
    Returns (dx, dw_qkv, dw_out, db_out, dg, dg_pre)."""
    with torch.enable_grad():
        args = [t.detach().requires_grad_(True) for t in (x, w_qkv, w_out, b_out, g, g_pre)]
        y = linear_attention_nr_reference(*args, heads, dim_head)
        return torch.autograd.grad(y, args, dy)


def _check_kernel_args(op, x, w_qkv, w_out, heads, dim_head):
    if x.device.type != "cuda":
        raise RuntimeError(f"{op}: unsupported device {x.device}")
    B, C, N = x.shape
    H = heads * dim_head
    if x.dtype not in (torch.float32, torch.bfloat16) or not x.is_contiguous():
        raise ValueError(f"{op}: x must be contiguous float32 or bfloat16")
    if C > MAX_C or dim_head != DIM_HEAD or H > 256:
        raise ValueError(
            f"{op}: kernel takes C <= {MAX_C}, dim_head {DIM_HEAD}, "
            f"heads*dim_head <= 256 (got C={C}, heads={heads}, dim_head={dim_head})"
        )
    if w_qkv.shape != (C, 3 * H) or w_out.shape != (H, C):
        raise ValueError(f"w_qkv must be ({C}, {3 * H}) and w_out ({H}, {C})")


def _kernel_weights(x, w_qkv, g_pre, heads):
    """float32 (wq, wk, wv) as (H, C) rows, g_pre, and the log2(e)-scaled
    wq/wk and shifts that the exp2 softmax of the partials takes."""
    dev = x.device
    H = w_qkv.shape[1] // 3
    wt = w_qkv.to(device=dev, dtype=torch.float32).t()
    wq, wk, wv = (wt[i * H : (i + 1) * H].contiguous() for i in range(3))
    gp = g_pre.to(device=dev, dtype=torch.float32).reshape(-1).contiguous()
    kshift, qshift = static_shifts(wq, wk, gp, heads)
    scaled = [(t * _LOG2E).contiguous() for t in (wq, wk, kshift, qshift)]
    return wq, wk, wv, gp, kshift.contiguous(), qshift.contiguous(), scaled


def _f32(t, dev):
    return t.to(device=dev, dtype=torch.float32).contiguous()


def _split(N):
    nsplit = max(1, math.ceil(N / _CHUNK))
    return nsplit, math.ceil(N / nsplit)


def _forward_kernel(x, w_qkv, w_out, b_out, g, g_pre, heads, dim_head):
    """Launch K1 (three kernels of ``csrc/linear_attention.cu``)."""
    _check_kernel_args("linear_attention", x, w_qkv, w_out, heads, dim_head)
    B, C, N = x.shape
    H = heads * dim_head
    dev = x.device
    _, _, wv, gp, _, _, (wq2, wk2, kshift2, qshift2) = _kernel_weights(x, w_qkv, g_pre, heads)
    nsplit, chunk = _split(N)
    part = torch.empty((B, nsplit, H, C + 1), dtype=torch.float32, device=dev)
    m = torch.empty((B, C, H), dtype=torch.float32, device=dev)
    y = torch.empty_like(x)
    args = (wq2, wk2, wv, _f32(w_out, dev), qshift2, kshift2, gp, _f32(b_out, dev).reshape(C),
            _f32(g, dev).reshape(C))
    code = _build.library().dq_linear_attention(
        x.data_ptr(), *[a.data_ptr() for a in args], part.data_ptr(), m.data_ptr(),
        y.data_ptr(), B, C, N, heads, nsplit, chunk, int(x.dtype == torch.bfloat16),
        dev.index or 0, _build.stream_of(x),
    )
    _build.check(code, "dq_linear_attention")
    linear_attention.launches += 1
    return y


def linear_attention_backward(dy, x, w_qkv, w_out, b_out, g, g_pre, heads=4, dim_head=DIM_HEAD):
    """Gradients (dx, dw_qkv, dw_out, db_out, dg, dg_pre) of
    :func:`linear_attention` at ``x`` for the output cotangent ``dy``, each
    in its input's dtype (K4).

    CPU tensors run :func:`linear_attention_backward_reference`; CUDA
    tensors launch the kernels of ``csrc/linear_attention_bwd.cu``, which
    recompute the forward from ``x`` and return per-row partials; the
    per-row weight gradients are finished here with torch ops (a few
    (H, C) tensors), as the JAX wrapper finishes them in XLA."""
    if x.device.type == "cpu":
        return linear_attention_backward_reference(
            dy, x, w_qkv, w_out, b_out, g, g_pre, heads, dim_head)
    _check_kernel_args("linear_attention_backward", x, w_qkv, w_out, heads, dim_head)
    B, C, N = x.shape
    H = heads * dim_head
    dev = x.device
    dy = dy.to(x.dtype).contiguous()
    wq, wk, wv, gp, kshift, qshift, (_, wk2, kshift2, _) = _kernel_weights(x, w_qkv, g_pre, heads)
    wout, bo, gg = _f32(w_out, dev), _f32(b_out, dev).reshape(C), _f32(g, dev).reshape(C)
    nsplit, chunk = _split(N)
    f32 = dict(dtype=torch.float32, device=dev)
    # scratch of the passes; see csrc/linear_attention_bwd.cu for each layout
    part = torch.empty((B, nsplit, H, C + 1), **f32)
    m = torch.empty((B, C, H), **f32)
    ctx = torch.empty((B, H, DIM_HEAD), **f32)
    inv_s = torch.empty((B, H), **f32)
    dxq = torch.empty((B, C, N), **f32)
    len_q, len_k = 2 * H * C + 2 * C, H + 2 * H * C
    part_q = torch.empty((B, nsplit, len_q), **f32)
    sum_q = torch.empty((B, len_q), **f32)
    dctx = torch.empty((B, H, DIM_HEAD), **f32)
    d2 = torch.empty((B, H, C), **f32)
    dwo = torch.empty((B, H, C), **f32)
    part_k = torch.empty((B, nsplit, len_k), **f32)
    sum_k = torch.empty((B, len_k), **f32)
    part_x = torch.empty((B, nsplit, C), **f32)
    dgpre = torch.empty((B, C), **f32)
    dx = torch.empty_like(x)
    ptrs = [x, dy, wq, wk, wv, wout, bo, gg, gp, qshift, kshift, wk2, kshift2, part, m, ctx,
            inv_s, dxq, part_q, sum_q, dctx, d2, dwo, part_k, sum_k, part_x, dgpre, dx]
    code = _build.library().dq_linear_attention_bwd(
        *[t.data_ptr() for t in ptrs], B, C, N, heads, nsplit, chunk,
        int(x.dtype == torch.bfloat16), dev.index or 0, _build.stream_of(x),
    )
    _build.check(code, "dq_linear_attention_bwd")
    linear_attention_backward.launches += 1

    # per-row partials -> weight gradients (tiny torch ops, fixed order)
    HC = H * C
    dwq = sum_q[:, HC : 2 * HC].sum(0).reshape(H, C)
    db, dg = sum_q[:, 2 * HC : 2 * HC + C].sum(0), sum_q[:, 2 * HC + C :].sum(0)
    t_sum = sum_k[:, :H]
    dwka, bmat = sum_k[:, H : H + HC].reshape(B, H, C), sum_k[:, H + HC :].reshape(B, H, C)
    dwk = (dwka - bmat * t_sum[:, :, None]).sum(0)
    # dWv[e, c] = sum_b sum_{d in head(e)} dctx_b[d, e] bmat_b[d, c]
    dwv = torch.einsum(
        "bhdi,bhdc->hic", dctx.reshape(B, heads, DIM_HEAD, DIM_HEAD),
        bmat.reshape(B, heads, DIM_HEAD, C),
    ).reshape(H, C)
    dw_qkv = torch.cat([dwq, dwk, dwv], dim=0).t()
    grads = (dw_qkv, dwo.sum(0), db, dg, dgpre.sum(0))
    params = (w_qkv, w_out, b_out, g, g_pre)
    return (dx, *(d.reshape(p.shape).to(p.dtype) for d, p in zip(grads, params)))


class _LinearAttentionFn(torch.autograd.Function):
    """K1 forward, K4 backward; saves only ``(x, weights)``."""

    @staticmethod
    def forward(ctx, x, w_qkv, w_out, b_out, g, g_pre, heads, dim_head):
        ctx.save_for_backward(x, w_qkv, w_out, b_out, g, g_pre)
        ctx.heads, ctx.dim_head = heads, dim_head
        return _forward_kernel(x, w_qkv, w_out, b_out, g, g_pre, heads, dim_head)

    @staticmethod
    def backward(ctx, dy):
        grads = linear_attention_backward(dy, *ctx.saved_tensors, ctx.heads, ctx.dim_head)
        return (*grads, None, None)


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

    CPU tensors run :func:`linear_attention_nr_reference`, which autograd
    differentiates; CUDA tensors run the K1 kernel, and its gradient is the
    K4 kernel (C <= 16, dim_head 32, heads·32 <= 256)."""
    if x.device.type == "cpu":
        return linear_attention_nr_reference(x, w_qkv, w_out, b_out, g, g_pre, heads, dim_head)
    return _LinearAttentionFn.apply(x, w_qkv, w_out, b_out, g, g_pre, heads, dim_head)


linear_attention.launches = 0  # kernel launches; reset by the caller
linear_attention_backward.launches = 0


# --------------------------------------------------------------------- #
# row-blocked ops (impl="pallas"): K8 single call, K9 two calls          #
# --------------------------------------------------------------------- #


def linear_attention_rows_reference(x, w_qkv, w_out, b_out, g, heads=4, dim_head=DIM_HEAD):
    """Plain version of K8/K9: ``linear_attention_reference`` of the JAX
    package on (B, N, C), float32 inside, the result in x's dtype."""
    return linear_attention_reference(
        x.transpose(1, 2), w_qkv, w_out, b_out, g, heads, dim_head).transpose(1, 2)


def rows_launcher(op, x, w_qkv, w_out, b_out, g, heads, dim_head, two_call):
    """Check the arguments of K8 (``two_call=False``) or K9 on a (B, N, C)
    CUDA tensor, prepare the kernel's weights and output, and return
    ``(launch, y)``: ``launch()`` runs the kernel into ``y`` and nothing
    else (no allocation, no count), so it can be timed alone. x's memory is
    either layout's: row-major, or the model's channel-first (B, C, N) seen
    through ``transpose(1, 2)``; y gets x's strides."""
    B, N, C = x.shape
    H = heads * dim_head
    if x.device.type != "cuda":
        raise RuntimeError(f"{op}: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{op}: x must be float32 or bfloat16")
    if not 1 <= C <= MAX_C or dim_head != DIM_HEAD or H > 256 or 256 % H or N < 1:
        raise ValueError(
            f"{op}: kernel takes 1 <= C <= {MAX_C}, N >= 1, dim_head {DIM_HEAD} and "
            f"heads*dim_head dividing 256 (got C={C}, N={N}, heads={heads}, dim_head={dim_head})"
        )
    if w_qkv.shape != (C, 3 * H) or w_out.shape != (H, C):
        raise ValueError(f"w_qkv must be ({C}, {3 * H}) and w_out ({H}, {C})")
    if not (x.is_contiguous() or x.transpose(1, 2).is_contiguous()):
        x = x.contiguous()
    dev = x.device
    y = torch.empty_like(x)  # dense input: the same strides
    wt = w_qkv.to(device=dev, dtype=torch.float32).t()
    wq, wk = ((wt[i * H : (i + 1) * H] * _LOG2E).contiguous() for i in range(2))
    wv = wt[2 * H :].contiguous()
    m = torch.empty((B, C, H) if two_call else (1,), dtype=torch.float32, device=dev)
    args = (wq, wk, wv, _f32(w_out, dev), _f32(b_out, dev).reshape(C), _f32(g, dev).reshape(C), m)
    ptrs = [a.data_ptr() for a in args]
    lib, stream = _build.library(), _build.stream_of(x)

    def launch():
        code = lib.dq_linear_attention_rows(
            x.data_ptr(), y.data_ptr(), *x.stride(), *ptrs, B, C, N, heads, int(two_call),
            int(x.dtype == torch.bfloat16), dev.index or 0, stream,
        )
        _build.check(code, "dq_linear_attention_rows")

    launch.args = args  # keeps the prepared weights alive with the closure
    return launch, y


class _RowsFn(torch.autograd.Function):
    """K8 forward; the gradient is the vjp of the recomputed reference, as
    the JAX ``_fused`` custom_vjp's backward is. Saves only ``(x, weights)``."""

    @staticmethod
    def forward(ctx, x, w_qkv, w_out, b_out, g, heads, dim_head):
        launch, y = rows_launcher("fused_linear_attention", x, w_qkv, w_out, b_out, g, heads,
                                  dim_head, two_call=False)
        launch()
        fused_linear_attention.launches += 1
        ctx.save_for_backward(x, w_qkv, w_out, b_out, g)
        ctx.heads, ctx.dim_head = heads, dim_head
        return y

    @staticmethod
    def backward(ctx, dy):
        args = [t.detach().requires_grad_(need)
                for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            y = linear_attention_rows_reference(*args, ctx.heads, ctx.dim_head)
        wanted = [t for t in args if t.requires_grad]
        grads = iter(torch.autograd.grad(y, wanted, dy) if wanted else ())
        return (*(next(grads) if t.requires_grad else None for t in args), None, None)


def fused_linear_attention(x, w_qkv, w_out, b_out, g, heads=4, dim_head=DIM_HEAD):
    """``RMSNorm_g(W_out · attn(x) + b_out)`` on (B, N, C), in x's dtype
    (K8; :func:`dquartic_tpu.ops.linear_attention.fused_linear_attention`).

    CPU tensors run :func:`linear_attention_rows_reference`, which autograd
    differentiates. CUDA tensors launch K8, one launch per call (C <= 16,
    dim_head 32, heads·32 dividing 256), with or without autograd. There
    is no K8 backward kernel, in JAX or here: the gradient recomputes the
    reference from the saved ``(x, weights)`` and takes its vjp, as the
    backward of JAX's ``_fused`` custom_vjp does. (JAX's ``_fused_fwd``
    also runs the reference as the primal under differentiation, a choice
    timed on a TPU; the port keeps the kernel, see PERF.md.)"""
    if x.device.type == "cpu":
        return linear_attention_rows_reference(x, w_qkv, w_out, b_out, g, heads, dim_head)
    return _RowsFn.apply(x, w_qkv, w_out, b_out, g, heads, dim_head)


def fused_linear_attention_two_call(x, w_qkv, w_out, b_out, g, heads=4, dim_head=DIM_HEAD):
    """The function of :func:`fused_linear_attention` in two launches (K9;
    ``_fused_forward`` of the JAX package): the context of each row to
    device memory, then the output pass. Forward only, as in JAX, where no
    model path reaches it. CPU tensors run the plain version."""
    if x.device.type == "cpu":
        return linear_attention_rows_reference(x, w_qkv, w_out, b_out, g, heads, dim_head)
    _build.require_no_grad("fused_linear_attention_two_call", x, w_qkv, w_out, b_out, g)
    launch, y = rows_launcher("fused_linear_attention_two_call", x, w_qkv, w_out, b_out, g,
                              heads, dim_head, two_call=True)
    launch()
    fused_linear_attention_two_call.launches += 1
    return y


fused_linear_attention.launches = 0
fused_linear_attention_two_call.launches = 0
