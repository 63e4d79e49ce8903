"""Fused pre-norm linear attention with residual: forward (K1) and
backward (K4).

Port of the form of :func:`dquartic_tpu.ops.linear_attention.fused_linear_attention_t`
that UNet1d calls — pre-RMSNorm, residual and static softmax shift all on
(``_fused_forward_single_t`` / ``_kernel_ab_t``, and its streamed
backward ``_fused_backward_t``):

    y = x + RMSNorm_g(W_out · attn(RMSNorm_{g_pre}(x)) + b_out)

with q softmaxed over each head's features and k over the sequence. The
CUDA kernels are ``csrc/linear_attention.cu`` (forward, one cluster
launch that reads the weights as they are) and
``csrc/linear_attention_bwd.cu`` (backward); on CUDA tensors the op is a
``torch.autograd.Function`` that runs one forward and one backward kernel
and saves only ``(x, weights)``, as the JAX ``custom_vjp`` does, and a call
autograd does not track launches the forward alone. The op
takes channel-first (B, C, N) activations — the layout the TPU kernel
itself runs on — and the flax weight layouts: ``w_qkv`` (C, 3H) with
q|k|v blocks and channel-major heads, ``w_out`` (H, C).

The row-blocked ops of ``impl="pallas"`` (port of
:func:`dquartic_tpu.ops.linear_attention.fused_linear_attention`) compute
``RMSNorm_g(W_out · attn(x) + b_out)`` on (B, N, C), without pre-norm or
residual and with a running max for the k-softmax:
:func:`fused_linear_attention` (K8, one cluster launch that reads the
weights as they are) and
:func:`fused_linear_attention_two_call` (K9, two launches of K8's kernel:
its context mode, then its apply mode), both in
``csrc/linear_attention_rows.cu``, with :func:`linear_attention_rows_reference`
as their plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..parallel.sequence import sp_all_reduce
from . import _build

MAX_C = 16
DIM_HEAD = 32  # the kernel maps one head onto one warp


def _inner(x: torch.Tensor) -> torch.dtype:
    """The dtype the plain versions compute in: float32, or float64 for
    float64 x (an oracle whose own rounding is out of the way)."""
    return torch.promote_types(x.dtype, torch.float32)


def rmsnorm_reference(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """float32 RMSNorm over the channel axis (dim 1), 1e-12 norm clamp
    (float64 for float64 x)."""
    ct = _inner(x)
    x32 = x.to(ct)
    norm = torch.sqrt(torch.sum(x32 * x32, dim=1, keepdim=True))
    return x32 / torch.clamp(norm, min=1e-12) * g.to(ct).reshape(1, -1, 1) * (x.shape[1] ** 0.5)


def linear_attention_reference(x, w_qkv, w_out, b_out, g, heads, dim_head):
    """Plain linear attention + out-projection + RMSNorm on (B, C, N), in
    float32 (``linear_attention_reference`` of the JAX package; float64 for
    float64 x)."""
    B, C, N = x.shape
    H = heads * dim_head
    ct = _inner(x)
    qkv = torch.einsum("bcn,ch->bhn", x.to(ct), w_qkv.to(ct))
    q, k, v = (t.reshape(B, heads, dim_head, N) for t in qkv.split(H, dim=1))
    q = torch.softmax(q, dim=2) * (dim_head**-0.5)  # over each head's features
    k = torch.softmax(k, dim=3)  # over the sequence
    context = torch.einsum("bhdn,bhen->bhde", k, v)
    out = torch.einsum("bhde,bhdn->bhen", context, q).reshape(B, H, N)
    y = torch.einsum("bhn,hc->bcn", out, w_out.to(ct))
    y = y + b_out.to(ct).reshape(1, -1, 1)
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
    if w_qkv.shape != (C, 3 * H) or (w_out is not None and w_out.shape != (H, C)):
        raise ValueError(f"w_qkv must be ({C}, {3 * H}) and w_out ({H}, {C})")


def _kernel_weights(x, w_qkv, g_pre, heads):
    """float32 (wq, wk, wv) as (H, C) rows, g_pre and the static shifts
    (kshift, qshift) of the plain sequence-parallel versions."""
    dev = x.device
    H = w_qkv.shape[1] // 3
    wt = w_qkv.to(device=dev, dtype=torch.float32).t()
    wq, wk, wv = (wt[i * H : (i + 1) * H] for i in range(3))
    gp = g_pre.to(device=dev, dtype=torch.float32).reshape(-1)
    kshift, qshift = static_shifts(wq, wk, gp, heads)
    return wq, wk, wv, gp, kshift, qshift


def _vec_stride(t, C):
    """The stride between the C values of a vector parameter of any shape
    holding C values ((C,), (1, C, 1), ...), without a view op."""
    if t.numel() != C:
        raise ValueError(f"b_out, g and g_pre must hold {C} values")
    strides = [st for n, st in zip(t.shape, t.stride()) if n > 1]
    return strides[0] if strides else 1


def _tensor_args(ts, C, dev, what, matrices=2):
    """Pointers and strides of the op's weights, or of their gradients, as
    the kernels take them: ``(args, dtype bits)``, bit i set where tensor i
    is bf16; the first ``matrices`` tensors give their two strides, the
    vectors after them the stride of their C values."""
    args, bits = [], 0
    for i, t in enumerate(ts):
        if t.device != dev or t.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"linear_attention: {what} must be float32 or bfloat16 on "
                             f"{dev} (got {t.dtype} on {t.device})")
        bits |= (t.dtype == torch.bfloat16) << i
        args += [t.data_ptr(), *(t.stride() if i < matrices else (_vec_stride(t, C),))]
    return args, bits


def _weight_args(x, w_qkv, w_out, b_out, g, g_pre):
    """The weights as K1 and K4 read them, each in its own dtype through
    its strides (no copy): ``(args, dtype bits)``, ``args`` the pointers
    and strides of ``dq_linear_attention``."""
    return _tensor_args((w_qkv, w_out, b_out, g, g_pre), x.shape[1], x.device, "weights")


def _forward_kernel(x, w_qkv, w_out, b_out, g, g_pre, heads, dim_head):
    """Launch K1: one cluster launch of ``csrc/linear_attention.cu``, which
    reads the weights as they are and prepares them itself."""
    _check_kernel_args("linear_attention", x, w_qkv, w_out, heads, dim_head)
    B, C, N = x.shape
    wargs, bits = _weight_args(x, w_qkv, w_out, b_out, g, g_pre)
    y = torch.empty_like(x)
    code = _build.library().dq_linear_attention(
        x.data_ptr(), y.data_ptr(), *wargs, B, C, N, heads, bits,
        int(x.dtype == torch.bfloat16), x.device.index or 0, _build.stream_of(x),
    )
    _build.check(code, "dq_linear_attention")
    linear_attention.launches += 1
    return y


def linear_attention_plan(C: int, N: int, heads: int = 4, bf16: bool = True) -> dict:
    """K1's launch shape for (C, N) (builds the kernels): CTAs per cluster
    (``cluster``), whether a CTA stages its slice of x in shared memory
    (``staged``) and its dynamic shared memory (``smem_bytes``)."""
    out = (ctypes.c_int * 3)()
    _build.check(_build.library().dq_linear_attention_plan(C, N, heads, int(bf16), out),
                 "dq_linear_attention_plan")
    return dict(cluster=out[0], staged=bool(out[1]), smem_bytes=out[2])


def linear_attention_backward_plan(B: int, C: int, N: int, heads: int = 4,
                                   bf16: bool = True, device: int = 0) -> dict:
    """K4's launch shape for (B, C, N) on ``device`` (builds the kernels):
    CTAs per cluster (``cluster``), whether a CTA stages its slices of x
    and dy in shared memory (``staged``) and its dynamic shared memory
    (``smem_bytes``)."""
    out = (ctypes.c_int * 3)()
    _build.check(_build.library().dq_linear_attention_bwd_plan(B, C, N, heads, int(bf16), device,
                                                               out),
                 "dq_linear_attention_bwd_plan")
    return dict(cluster=out[0], staged=bool(out[1]), smem_bytes=out[2])


def linear_attention_backward(dy, x, w_qkv, w_out, b_out, g, g_pre, heads=4, dim_head=DIM_HEAD):
    """Gradients (dx, dw_qkv, dw_out, db_out, dg, dg_pre) of
    :func:`linear_attention` at ``x`` for the output cotangent ``dy``, each
    in its input's shape and dtype (K4).

    CPU tensors run :func:`linear_attention_backward_reference`. CUDA
    tensors launch ``csrc/linear_attention_bwd.cu``: one cluster launch
    that recomputes the forward from ``x`` and reads the weights as they
    are, and one small launch that sums the rows' weight gradients in a
    fixed order into tensors of the parameters' shapes, dtypes and (for
    the two matrices) strides. The wrapper allocates and launches; it runs
    no torch op on the weights."""
    if x.device.type == "cpu":
        return linear_attention_backward_reference(
            dy, x, w_qkv, w_out, b_out, g, g_pre, heads, dim_head)
    _check_kernel_args("linear_attention_backward", x, w_qkv, w_out, heads, dim_head)
    return _backward_kernel(dy, x, w_qkv, w_out, b_out, g, g_pre, heads, dim_head)


def _backward_buffers(x, w_qkv, w_out, b_out, g, g_pre, heads, dim_head):
    """What K4's launches write, allocated: dx, the gradients in their
    parameters' shapes, dtypes and (for the two matrices) strides, with
    their kernel arguments, and float32 scratch for the per-row partials
    (dW_out, dW_v, db, dg) and the per-CTA partials (dW_q, dW_k, dg_pre) of
    up to 8 CTAs a row. Returns ``(dx, grads, (gargs, gbits), scratch,
    (rowpart, ctapart))``, the last two the scratch's pointers."""
    B, C, _ = x.shape
    HC = heads * dim_head * C
    dev = x.device
    grads = (torch.empty_like(w_qkv), torch.empty_like(w_out),
             *(torch.empty(t.shape, dtype=t.dtype, device=dev) for t in (b_out, g, g_pre)))
    rows = B * (2 * HC + 2 * C)
    scratch = torch.empty(rows + B * 8 * (2 * HC + C), dtype=torch.float32, device=dev)
    return (torch.empty_like(x), grads, _tensor_args(grads, C, dev, "gradients"), scratch,
            (scratch.data_ptr(), scratch.data_ptr() + 4 * rows))


def _backward_kernel(dy, x, w_qkv, w_out, b_out, g, g_pre, heads, dim_head):
    """Launch K4 on checked arguments: the gradients' allocations, one
    scratch buffer and the entry point's two launches."""
    B, C, N = x.shape
    dev = x.device
    if dy.dtype != x.dtype or not dy.is_contiguous():
        dy = dy.to(x.dtype).contiguous()
    wargs, wbits = _weight_args(x, w_qkv, w_out, b_out, g, g_pre)
    # scratch stays bound until the launches are queued: freed earlier, its
    # memory could go to another allocation first
    dx, grads, (gargs, gbits), scratch, parts = _backward_buffers(x, w_qkv, w_out, b_out, g,
                                                                  g_pre, heads, dim_head)
    code = _build.library().dq_linear_attention_bwd(
        x.data_ptr(), dy.data_ptr(), dx.data_ptr(), *wargs, *gargs, *parts, B, C, N, heads,
        wbits, gbits, int(x.dtype == torch.bfloat16), dev.index or 0, _build.stream_of(x),
    )
    _build.check(code, "dq_linear_attention_bwd")
    linear_attention_backward.launches += 1
    return (dx, *grads)


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
    args = (x, w_qkv, w_out, b_out, g, g_pre)
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in args)):
        return _forward_kernel(*args, heads, dim_head)  # untracked: no autograd node
    return _LinearAttentionFn.apply(*args, heads, dim_head)


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


def rows_context_reference(x, w_qkv, w_out, heads=4, dim_head=DIM_HEAD):
    """Plain version of K9's first launch (K8's kernel in its context mode):
    each row's folded context ``M = W_outᵀ ctxᵀ``, (B, C, H) float32 (float64
    for float64 x), ctx the per-head ``context`` of
    :func:`linear_attention_reference`, from x (B, N, C)."""
    B, N, C = x.shape
    H = heads * dim_head
    ct = _inner(x)
    w = w_qkv.to(ct)
    k, v = (torch.einsum("bnc,ch->bhn", x.to(ct), w[:, i * H:(i + 1) * H])
            .reshape(B, heads, dim_head, N) for i in (1, 2))
    context = torch.einsum("bhdn,bhen->bhde", torch.softmax(k, dim=3), v)
    wo = w_out.to(ct).reshape(heads, dim_head, C)
    return torch.einsum("hec,bhde->bchd", wo, context).reshape(B, C, H)


def rows_apply_reference(x, m, w_qkv, b_out, g, heads=4, dim_head=DIM_HEAD):
    """Plain version of K9's second launch (its apply mode): ``y =
    RMSNorm_g(M q^ + b_out)`` on (B, N, C) from each row's M (B, C, H), q^ the
    per-head softmax of ``W_q x`` times ``dim_head ** -0.5``; float32 inside,
    the result in x's dtype. Composed with :func:`rows_context_reference` it
    is :func:`linear_attention_rows_reference`."""
    B, N, C = x.shape
    H = heads * dim_head
    ct = _inner(x)
    q = torch.einsum("bnc,ch->bhn", x.to(ct), w_qkv.to(ct)[:, :H]).reshape(B, heads, dim_head, N)
    q = torch.softmax(q, dim=2) * (dim_head**-0.5)
    y = torch.einsum("bch,bhn->bcn", m.to(ct), q.reshape(B, H, N)) + b_out.to(ct).reshape(1, -1, 1)
    return rmsnorm_reference(y, g).to(x.dtype).transpose(1, 2)


def _check_rows_args(op, x, w_qkv, w_out, heads, dim_head):
    if x.device.type != "cuda":
        raise RuntimeError(f"{op}: unsupported device {x.device}")
    B, N, C = x.shape
    H = heads * dim_head
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{op}: x must be float32 or bfloat16")
    if not 1 <= C <= MAX_C or dim_head != DIM_HEAD or H > 256 or 256 % H or N < 1:
        raise ValueError(
            f"{op}: kernel takes 1 <= C <= {MAX_C}, N >= 1, dim_head {DIM_HEAD} and "
            f"heads*dim_head dividing 256 (got C={C}, N={N}, heads={heads}, dim_head={dim_head})"
        )
    if w_qkv.shape != (C, 3 * H) or w_out.shape != (H, C):
        raise ValueError(f"w_qkv must be ({C}, {3 * H}) and w_out ({H}, {C})")


def rows_launcher(op, x, w_qkv, w_out, b_out, g, heads, dim_head, two_call):
    """Check the arguments of K8 (``two_call=False``) or K9 on a (B, N, C)
    CUDA tensor, allocate the output and return ``(launch, y)``:
    ``launch()`` runs the kernel into ``y`` and nothing else (no allocation,
    no count), so it can be timed alone. x's memory is either layout's:
    row-major, or the model's channel-first (B, C, N) seen through
    ``transpose(1, 2)``. Both read x, y and the weights through their
    strides, in their own dtypes (``csrc/linear_attention_rows.cu``). K8 is
    one cluster launch; K9 is K8's kernel in its context mode (a cluster
    launch whose rank 0 writes each row's M, float32 (B, C, H), to device
    memory), then in its apply mode (a grid of independent CTAs that read
    M). The only torch ops are the allocations of y (``empty_like``: x's
    strides where x is dense) and, for K9, of M."""
    _check_rows_args(op, x, w_qkv, w_out, heads, dim_head)
    B, N, C = x.shape
    wargs, bits = _tensor_args((w_qkv, w_out, b_out, g), C, x.device, "weights")
    y = torch.empty_like(x)
    lib, stream, dev = _build.library(), _build.stream_of(x), x.device.index or 0
    tail = (B, C, N, heads, bits, int(x.dtype == torch.bfloat16), dev, stream)
    m = None
    if two_call:
        m = torch.empty((B, C, heads * dim_head), dtype=torch.float32, device=x.device)
        name, tail = "dq_linear_attention_rows", (m.data_ptr(), *tail)
    else:
        name = "dq_linear_attention_rows_fused"
    args = (x.data_ptr(), y.data_ptr(), *x.stride(), *y.stride(), *wargs, *tail)
    fn = getattr(lib, name)

    def launch():
        _build.check(fn(*args), name)

    launch.tensors = (x, y, m, w_qkv, w_out, b_out, g)  # alive while the closure may launch
    return launch, y


def _rows_kernel(x, w_qkv, w_out, b_out, g, heads, dim_head):
    """Launch K8 once and count it."""
    launch, y = rows_launcher("fused_linear_attention", x, w_qkv, w_out, b_out, g, heads,
                              dim_head, two_call=False)
    launch()
    fused_linear_attention.launches += 1
    return y


class _RowsFn(torch.autograd.Function):
    """K8 forward; the gradient is the vjp of the recomputed reference, as
    the JAX ``_fused`` custom_vjp's backward is. Saves only ``(x, weights)``."""

    @staticmethod
    def forward(ctx, x, w_qkv, w_out, b_out, g, heads, dim_head):
        ctx.save_for_backward(x, w_qkv, w_out, b_out, g)
        ctx.heads, ctx.dim_head = heads, dim_head
        return _rows_kernel(x, w_qkv, w_out, b_out, g, heads, dim_head)

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
    dim_head 32, heads·32 dividing 256), with or without autograd; the
    kernel reads the weights as they are. There is no K8 backward kernel,
    in JAX or here: the gradient recomputes the reference from the saved
    ``(x, weights)`` and takes its vjp, as the backward of JAX's ``_fused``
    custom_vjp does. (JAX's ``_fused_fwd`` also runs the reference as the
    primal under differentiation, a choice timed on a TPU; the port keeps
    the kernel, see PERF.md.)"""
    if x.device.type == "cpu":
        return linear_attention_rows_reference(x, w_qkv, w_out, b_out, g, heads, dim_head)
    args = (x, w_qkv, w_out, b_out, g)
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in args)):
        return _rows_kernel(*args, heads, dim_head)  # untracked: no autograd node
    return _RowsFn.apply(*args, heads, dim_head)


def fused_linear_attention_two_call(x, w_qkv, w_out, b_out, g, heads=4, dim_head=DIM_HEAD):
    """The function of :func:`fused_linear_attention` in two launches (K9;
    ``_fused_forward`` of the JAX package): each row's folded context M to
    device memory (K8's kernel in its context mode), then the output pass
    (its apply mode). Forward only, as in JAX, where no
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


# --------------------------------------------------------------------- #
# sequence parallel (K6a-c): N split over the ranks of a process group  #
# --------------------------------------------------------------------- #
#
# Each rank holds a slice of the columns of every row. The only couplings
# across columns are the k-softmax statistics (A, s) and Z, both plain
# sums thanks to the static shift, so each is a per-rank partial summed by
# ``reduce`` (an all_reduce over the group) between launches, where
# ``_fused_forward_sp_local`` / ``_fused_backward_sp_local`` of the JAX
# package psum (JAX also psums T, which here follows from Z and the summed
# (A, s): T = rows of D2 . bmat, bmat = A / s). ``reduce(t)`` sums ``t`` in
# place over the ranks.


def _round_cd(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to the matmul operand type of ``dtype`` (bf16 or float32)."""
    return t.to(torch.bfloat16).to(torch.float32) if dtype == torch.bfloat16 else t


def sp_stats_reference(x, w_qkv, g_pre, heads=4, dim_head=DIM_HEAD, round_operands=True):
    """Plain K6a: this rank's phase-0 partials ``[A | s]`` (B, H, C + 1),
    float32, over the columns of x (B, C, N_local): A = Σ_n p x̂ᵀ, s = Σ_n p,
    p = exp(W_k x̂ - kshift). ``round_operands`` rounds p and x̂ to x's dtype
    before the product, as the forward kernels do (K1, JAX ``_kernel_sp0_t``);
    the backward's recompute keeps them float32, as K4 does."""
    _, wk, _, gp, kshift, _ = _kernel_weights(x, w_qkv, g_pre, heads)
    xh = rmsnorm_reference(x, gp)
    p = torch.exp(torch.einsum("hc,bcn->bhn", wk, xh) - kshift[:, None])
    s = p.sum(2)
    if round_operands:
        p, xh = _round_cd(p, x.dtype), _round_cd(xh, x.dtype)
    return torch.cat([torch.einsum("bhn,bcn->bhc", p, xh), s[..., None]], dim=2)


def sp_context(stats, w_qkv, w_out, heads=4, round_m=False):
    """From the all-reduced stats (B, H, C + 1): ``(ctx, inv_s, M)`` with
    ctx (B, H, 32) = per head (A W_vᵀ) / s, inv_s (B, H) = 1 / s and the
    folded context M = W_outᵀ ctxᵀ (B, C, H), float32 (torch ops on a few
    (H, C) tensors, as the JAX package's XLA einsums; ``round_m`` rounds M
    to bf16, as K1 does for a bf16 forward)."""
    B, H, C = stats.shape[0], stats.shape[1], stats.shape[2] - 1
    dev = stats.device
    a, s = stats[..., :C], stats[..., C]
    inv_s = 1.0 / torch.clamp(s, min=1e-30)
    wv = w_qkv.to(device=dev, dtype=torch.float32).t()[2 * H :].reshape(heads, DIM_HEAD, C)
    wo = w_out.to(device=dev, dtype=torch.float32).reshape(heads, DIM_HEAD, C)
    ctx = torch.einsum("bhic,hjc->bhij", a.reshape(B, heads, DIM_HEAD, C), wv)
    ctx = ctx * inv_s.reshape(B, heads, DIM_HEAD, 1)
    m = torch.einsum("hjc,bhij->bchi", wo, ctx).reshape(B, C, H)
    if round_m:
        m = m.to(torch.bfloat16).to(torch.float32)
    return ctx.reshape(B, H, DIM_HEAD).contiguous(), inv_s.contiguous(), m.contiguous()


def sp_apply_reference(x, m, w_qkv, b_out, g, g_pre, heads=4, dim_head=DIM_HEAD):
    """Plain K6b: ``y = RMSNorm_g(M q̂ + b_out) + x`` per local column, q̂ the
    per-head softmax of W_q x̂ times dh^-½ (rounded to x's dtype, as K1 and
    JAX ``_kernel_sp1_t`` round the operand); y in x's dtype."""
    B, C, N = x.shape
    wq, _, _, gp, _, qshift = _kernel_weights(x, w_qkv, g_pre, heads)
    xh = rmsnorm_reference(x, gp)
    q = torch.einsum("hc,bcn->bhn", wq, xh) - qshift[:, None]
    qn = torch.softmax(q.reshape(B, heads, DIM_HEAD, N), dim=2).reshape(B, -1, N)
    qn = _round_cd(qn * DIM_HEAD**-0.5, x.dtype)
    y = torch.einsum("bch,bhn->bcn", m.float(), qn) + b_out.to(torch.float32).reshape(1, -1, 1)
    return (rmsnorm_reference(y, g) + x.float()).to(x.dtype)


def sp_backward_reference(dy, x, w_qkv, w_out, b_out, g, g_pre, stats, stats_local, reduce,
                          heads=4, dim_head=DIM_HEAD):
    """Plain K6c: K4's arithmetic in float32 on the rank's columns, with
    ``reduce`` at the one barrier (Z). ``stats`` are the all-reduced float32
    phase-0 sums of the backward's recompute, ``stats_local`` the rank's own.
    T = rows of D2 · bmat with bmat = A / s from ``stats``. Returns dx (in
    x's dtype) and this rank's partial weight gradients (dw_qkv, dw_out,
    db_out, dg, dg_pre), whose sum over the ranks is the gradient: dW_out
    and dW_v from the rank's own bmat (its A over the summed s) against the
    summed Z, the others summed over the rank's columns."""
    B, C, N = x.shape
    H = heads * dim_head
    rc = C**0.5
    wq, wk, wv, gp, kshift, qshift = _kernel_weights(x, w_qkv, g_pre, heads)
    wv, wo = wv.reshape(heads, DIM_HEAD, C), w_out.float().reshape(heads, DIM_HEAD, C)
    _, inv_s, m = sp_context(stats, w_qkv, w_out, heads)
    bmat = stats[..., :C] * inv_s[..., None]
    bmat_local = stats_local[..., :C] * inv_s[..., None]
    x32, dy32 = x.float(), dy.float()
    r0 = torch.clamp(x32.norm(dim=1, keepdim=True), min=1e-12)
    u0 = x32 / r0
    gpc = (gp * rc).reshape(1, C, 1)
    xh = u0 * gpc
    # pass 1: everything downstream of q; Z (summed over the ranks), db, dg
    q = torch.einsum("hc,bcn->bhn", wq, xh) - qshift[:, None]
    qn = torch.softmax(q.reshape(B, heads, DIM_HEAD, N), dim=2).reshape(B, H, N) * DIM_HEAD**-0.5
    u = torch.einsum("bch,bhn->bcn", m, qn) + b_out.float().reshape(1, C, 1)
    r = torch.clamp(u.norm(dim=1, keepdim=True), min=1e-12)
    yh = u / r
    dyh = dy32 * (g.float().reshape(1, C, 1) * rc)
    du = (dyh - yh * (dyh * yh).sum(1, keepdim=True)) / r
    db, dg = du.sum((0, 2)), (dy32 * yh).sum((0, 2)) * rc
    z = torch.einsum("bdn,bcn->bdc", qn, du).contiguous()
    reduce(z)
    # the row's D2 and T from Z and the summed (A, s); dW_out, dW_v
    dctx = torch.einsum("bhic,hjc->bhij", z.reshape(B, heads, DIM_HEAD, C), wo)
    d2 = torch.einsum("bhij,hjc->bhic", dctx, wv).reshape(B, H, C)
    t = (d2 * bmat).sum(2)
    ctx_local = torch.einsum("bhic,hjc->bhij", bmat_local.reshape(B, heads, DIM_HEAD, C), wv)
    dwo = torch.einsum("bhij,bhic->hjc", ctx_local, z.reshape(B, heads, DIM_HEAD, C))
    dwv = torch.einsum("bhij,bhic->hjc", dctx, bmat_local.reshape(B, heads, DIM_HEAD, C))
    # pass 2: dx, dW_q, dW_k, dg_pre
    dqn = torch.einsum("bcd,bcn->bdn", m, du)
    tq = (qn * dqn).reshape(B, heads, DIM_HEAD, N).sum(2, keepdim=True)
    dq = qn * (dqn - (tq / DIM_HEAD**-0.5).expand(-1, -1, DIM_HEAD, -1).reshape(B, H, N))
    kn = torch.exp(torch.einsum("hc,bcn->bhn", wk, xh) - kshift[:, None]) * inv_s[:, :, None]
    dk = kn * (torch.einsum("bdc,bcn->bdn", d2, xh) - t[:, :, None])
    dxn = (torch.einsum("dc,bdn->bcn", wq, dq) + torch.einsum("bdc,bdn->bcn", d2, kn)
           + torch.einsum("dc,bdn->bcn", wk, dk))
    dgpre = (dxn * u0).sum((0, 2)) * rc
    dx = (dxn * gpc - u0 * (dxn * gpc * u0).sum(1, keepdim=True)) / r0 + dy32
    dwq, dwk = (torch.einsum("bdn,bcn->dc", d, xh) for d in (dq, dk))
    grads = (torch.cat([dwq, dwk, dwv.reshape(H, C)], dim=0).t(), dwo.reshape(H, C), db, dg,
             dgpre)
    params = (w_qkv, w_out, b_out, g, g_pre)
    return (dx.to(x.dtype), *(d.reshape(p.shape).to(p.dtype) for d, p in zip(grads, params)))


def linear_attention_sp_stats(x, w_qkv, g_pre, heads=4, dim_head=DIM_HEAD, round_operands=True):
    """K6a: this rank's partials ``[A | s]`` (B, H, C + 1) over the columns of
    x (B, C, N_local). CPU tensors run :func:`sp_stats_reference`. CUDA
    tensors launch ``dq_linear_attention_sp_stats``
    (``csrc/linear_attention_sp.cu``): one cluster launch that reads w_qkv
    and g_pre as they are (the wrapper runs no torch op on them)."""
    if x.device.type == "cpu":
        return sp_stats_reference(x, w_qkv, g_pre, heads, dim_head, round_operands)
    _check_kernel_args("linear_attention_sp_stats", x, w_qkv, None, heads, dim_head)
    return _sp_stats_kernel(x, w_qkv, g_pre, heads, dim_head, round_operands)


def _sp_stats_kernel(x, w_qkv, g_pre, heads, dim_head, round_operands):
    """Launch K6a on checked arguments: the stats' allocation and one launch."""
    B, C, N = x.shape
    dev = x.device
    wargs, wbit = _tensor_args((w_qkv,), C, dev, "w_qkv")
    gargs, gbit = _tensor_args((g_pre,), C, dev, "g_pre", matrices=0)
    stats = torch.empty((B, heads * dim_head, C + 1), dtype=torch.float32, device=dev)
    code = _build.library().dq_linear_attention_sp_stats(
        x.data_ptr(), *wargs, *gargs, stats.data_ptr(), B, C, N, heads, wbit | gbit << 4,
        int(round_operands), int(x.dtype == torch.bfloat16), dev.index or 0, _build.stream_of(x),
    )
    _build.check(code, "dq_linear_attention_sp_stats")
    linear_attention_sp_stats.launches += 1
    return stats


def linear_attention_sp_apply(x, stats, w_qkv, w_out, b_out, g, g_pre, heads=4,
                              dim_head=DIM_HEAD):
    """K6b: ``RMSNorm_g(M q̂ + b_out) + x`` per local column of x (B, C,
    N_local), M the folded context of ``stats`` (B, H, C + 1), the float32
    ``[A | s]`` summed over the ranks. CPU tensors run
    :func:`sp_apply_reference` on :func:`sp_context`'s M (rounded to bf16 for
    bf16 x, as K1 rounds it). CUDA tensors launch
    ``dq_linear_attention_sp_apply``: one cluster launch of K1's kernel in
    its apply mode, which folds M from the stats and reads the weights as
    they are (the wrapper allocates y and launches)."""
    if x.device.type == "cpu":
        _, _, m = sp_context(stats, w_qkv, w_out, heads, round_m=x.dtype == torch.bfloat16)
        return sp_apply_reference(x, m, w_qkv, b_out, g, g_pre, heads, dim_head)
    _check_kernel_args("linear_attention_sp_apply", x, w_qkv, w_out, heads, dim_head)
    return _sp_apply_kernel(x, stats, w_qkv, w_out, b_out, g, g_pre, heads, dim_head)


def _check_stats(op, t, what, B, H, C, dev):
    if t.shape != (B, H, C + 1) or t.dtype != torch.float32 or t.device != dev \
            or not t.is_contiguous():
        raise ValueError(f"{op}: {what} must be contiguous float32 {(B, H, C + 1)} on {dev}")


def _sp_apply_kernel(x, stats, w_qkv, w_out, b_out, g, g_pre, heads, dim_head):
    """Launch K6b on checked arguments: y's allocation and one launch."""
    B, C, N = x.shape
    dev = x.device
    _check_stats("linear_attention_sp_apply", stats, "stats", B, heads * dim_head, C, dev)
    wargs, bits = _weight_args(x, w_qkv, w_out, b_out, g, g_pre)
    y = torch.empty_like(x)
    code = _build.library().dq_linear_attention_sp_apply(
        x.data_ptr(), y.data_ptr(), stats.data_ptr(), *wargs, B, C, N, heads, bits,
        int(x.dtype == torch.bfloat16), dev.index or 0, _build.stream_of(x),
    )
    _build.check(code, "dq_linear_attention_sp_apply")
    linear_attention_sp_apply.launches += 1
    return y


def linear_attention_sp_backward(dy, x, w_qkv, w_out, b_out, g, g_pre, stats, stats_local,
                                 reduce, heads=4, dim_head=DIM_HEAD):
    """K6c: dx and this rank's partial weight gradients (see
    :func:`sp_backward_reference`) for the cotangent ``dy`` of the local
    columns, given the all-reduced float32 ``stats`` of the backward's
    recompute and the rank's own ``stats_local``; ``reduce`` sums Z over the
    ranks, the call's one collective. JAX ``_fused_backward_sp_local`` also
    psums the weight gradients; here they stay partials, as every other
    parameter's gradient of a sequence-parallel model does, and the trainer
    sums them all over the group once. CPU tensors run
    :func:`sp_backward_reference`. CUDA tensors launch
    ``csrc/linear_attention_sp.cu``'s three kernels (K4's cluster kernel
    for Z, ``reduce``, K4's for dx and the partials, the fixed-order sum into
    the gradients), which read the weights as they are: the wrapper
    allocates and launches, and runs no torch op on the weights."""
    if x.device.type == "cpu":
        return sp_backward_reference(dy, x, w_qkv, w_out, b_out, g, g_pre, stats, stats_local,
                                     reduce, heads, dim_head)
    _check_kernel_args("linear_attention_sp_backward", x, w_qkv, w_out, heads, dim_head)
    return _sp_backward_kernel(dy, x, w_qkv, w_out, b_out, g, g_pre, stats, stats_local, reduce,
                               heads, dim_head)


def _sp_backward_kernel(dy, x, w_qkv, w_out, b_out, g, g_pre, stats, stats_local, reduce, heads,
                        dim_head):
    """Launch K6c on checked arguments: the allocations, launch 1, ``reduce``
    of Z, launches 2 and 3."""
    B, C, N = x.shape
    H = heads * dim_head
    dev = x.device
    for t, what in ((stats, "stats"), (stats_local, "stats_local")):
        _check_stats("linear_attention_sp_backward", t, what, B, H, C, dev)
    if dy.dtype != x.dtype or not dy.is_contiguous():
        dy = dy.to(x.dtype).contiguous()
    wargs, wbits = _weight_args(x, w_qkv, w_out, b_out, g, g_pre)
    # scratch stays bound until the launches are queued (see _backward_kernel)
    dx, grads, (gargs, gbits), scratch, (rowpart, ctapart) = _backward_buffers(
        x, w_qkv, w_out, b_out, g, g_pre, heads, dim_head)
    z = torch.empty((B, H, C), dtype=torch.float32, device=dev)
    lib, bf16, stream = _build.library(), int(x.dtype == torch.bfloat16), _build.stream_of(x)
    code = lib.dq_linear_attention_sp_bwd_z(
        x.data_ptr(), dy.data_ptr(), *wargs, stats.data_ptr(), z.data_ptr(), rowpart, B, C, N,
        heads, wbits, bf16, dev.index or 0, stream)
    _build.check(code, "dq_linear_attention_sp_bwd_z")
    reduce(z)
    code = lib.dq_linear_attention_sp_bwd_x(
        x.data_ptr(), dy.data_ptr(), dx.data_ptr(), *wargs, *gargs, stats.data_ptr(),
        stats_local.data_ptr(), z.data_ptr(), rowpart, ctapart, B, C, N, heads, wbits, gbits,
        bf16, dev.index or 0, stream)
    _build.check(code, "dq_linear_attention_sp_bwd_x")
    linear_attention_sp_backward.launches += 1
    return (dx, *grads)


class _LinearAttentionSpFn(torch.autograd.Function):
    """K6a -> reduce(A, s) -> K6b (which folds the context from the summed
    stats); the backward recomputes the stats (K6a, float32 operands), keeps
    the rank's own, reduces them and runs K6c (which reduces Z). Saves only
    ``(x, weights)``."""

    @staticmethod
    def forward(ctx, x, w_qkv, w_out, b_out, g, g_pre, heads, dim_head, reduce):
        ctx.save_for_backward(x, w_qkv, w_out, b_out, g, g_pre)
        ctx.heads, ctx.dim_head, ctx.reduce = heads, dim_head, reduce
        stats = linear_attention_sp_stats(x, w_qkv, g_pre, heads, dim_head)
        reduce(stats)
        return linear_attention_sp_apply(x, stats, w_qkv, w_out, b_out, g, g_pre, heads,
                                         dim_head)

    @staticmethod
    def backward(ctx, dy):
        x, w_qkv, w_out, b_out, g, g_pre = ctx.saved_tensors
        stats = linear_attention_sp_stats(x, w_qkv, g_pre, ctx.heads, ctx.dim_head,
                                          round_operands=False)
        local = stats.clone()
        ctx.reduce(stats)
        grads = linear_attention_sp_backward(dy, x, w_qkv, w_out, b_out, g, g_pre, stats, local,
                                             ctx.reduce, ctx.heads, ctx.dim_head)
        return (*grads, None, None, None)


def linear_attention_sp(x, w_qkv, w_out, b_out, g, g_pre, heads=4, dim_head=DIM_HEAD,
                        group=None):
    """The function of :func:`linear_attention` on the columns this rank
    holds of a sequence split over the ranks of ``group`` (a
    ``torch.distributed`` process group; every rank calls it together):
    ``x`` (B, C, N_local) is the rank's slice, and so is the result
    (:func:`dquartic_tpu.ops.linear_attention.fused_linear_attention_t`
    with ``sp_axis``).

    The forward is K6a, the sum of (A, s) over the ranks, K6b: two launches
    and one collective. The backward is K6a again, the sum, and K6c, with the
    sum of Z between its launches: two collectives. The weight gradients
    are this rank's partials (:func:`linear_attention_sp_backward`). On CPU
    tensors the bodies run their plain versions; the sums are the same
    collectives."""
    reduce = functools.partial(sp_all_reduce, group=group)
    return _LinearAttentionSpFn.apply(x, w_qkv, w_out, b_out, g, g_pre, heads, dim_head, reduce)


linear_attention_sp_stats.launches = 0
linear_attention_sp_apply.launches = 0
linear_attention_sp_backward.launches = 0
