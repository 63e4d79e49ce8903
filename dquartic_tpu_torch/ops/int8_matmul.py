"""Int8 weight-streaming matmul and conv1d for the UNet1d mid blocks (K3).

Port of :mod:`dquartic_tpu.ops.int8_matmul` (``int8_matmul`` /
``_matmul_kernel``). The canonical model's four mid-block convs hold
1.2 B of its parameters; each is a skinny product x (b·rt, 3·C_in) @
W (3·C_in, C_out) with M = 34, K = 30000, N = 10000 at batch 1. Weights
are stored once as int8 with one float32 scale per output column and are
never widened in device memory: the CUDA kernel (``csrc/int8_matmul.cu``)
reads the int8 bytes and converts them in registers, to bf16 operands of
the tensor cores (``mma.sync``) for bf16 x, to float32 on the CUDA cores
for float32 x.

Stored layout (the port's own): ``w_q`` (K, N) int8 row-major, rows
tap-major (``tap * C_in + c``, the im2col order of :func:`int8_conv1d`),
``scale`` (N,) float32. No padding: the TPU's 512/1024 tile padding
(``quant_pad_dims``) is not needed here.

Numerics: ``out = (x @ w_q) * scale`` with float32 accumulation, then
cast to x's dtype — the same contract as ``int8_matmul_reference``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

# CTA tiles of the kernel, by x's dtype: (output columns, K rows a stage,
# CTAs an SM). bf16: tensor cores, 8 warps x 32 columns, up to 64 rows of x
# a CTA; float32: CUDA cores, 32 lanes x 4 columns, 8 warps x up to 8 rows.
_TILES = {torch.bfloat16: (256, 64, 2), torch.float32: (128, 32, 4)}


def quantize_weight_matrix(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K, N) float -> (K, N) int8 + (N,) float32 per-column scales.

    Symmetric per-output-channel quantization, element for element the
    values of the JAX ``quantize_weight_matrix`` without its padding
    (``torch.round`` and ``jnp.round`` both round half to even)."""
    w32 = w.to(torch.float32)
    scale = torch.clamp(w32.abs().amax(dim=0) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(w32 / scale[None, :]), -127, 127).to(torch.int8)
    return q, scale


def quantize_conv_kernel(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """torch Conv1d weight (C_out, C_in, k) -> (k·C_in, C_out) int8 + scales,
    rows tap-major as :func:`int8_conv1d` builds its im2col."""
    c_out, c_in, k = weight.shape
    return quantize_weight_matrix(weight.permute(2, 1, 0).reshape(k * c_in, c_out))


def int8_matmul_reference(
    x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor
) -> torch.Tensor:
    """Plain version: ``(x @ w_q) * scale``, float32 accumulation, cast to
    x's dtype. int8 values and bf16 x are exact in float32, so the float32
    product equals a bf16 x bf16 -> f32 product."""
    acc = torch.matmul(x.to(torch.float32), w_q.to(torch.float32))
    return (acc * scale[None, :]).to(x.dtype)


def _split(M: int, K: int, N: int, dtype: torch.dtype, device) -> Tuple[int, int]:
    """(ksplit, kchunk): K cut into chunks of whole stages, as many as keep
    one wave of CTAs (``_TILES``' CTAs an SM on every SM) streaming. The
    partial sums are reduced in a fixed order (deterministic)."""
    block_n, block_k, per_sm = _TILES[dtype]
    rows = 64 if dtype == torch.bfloat16 else 8 * min(8, math.ceil(M / 8))
    tiles = math.ceil(N / block_n) * math.ceil(M / rows)
    steps = math.ceil(K / block_k)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    ksplit = max(1, min(steps, per_sm * sms // tiles))
    kchunk = math.ceil(math.ceil(K / ksplit) / block_k) * block_k
    return math.ceil(K / kchunk), kchunk


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) float32/bfloat16 @ dequant(w_q (K, N) int8, scale (N,)) -> (M, N).

    CPU tensors run :func:`int8_matmul_reference`; CUDA tensors launch the
    kernel. Inference-only: raises under autograd."""
    _build.require_no_grad("int8_matmul (frozen int8 weights)", x, scale)
    if x.device.type == "cpu":
        return int8_matmul_reference(x, w_q, scale)
    if x.device.type != "cuda":
        raise RuntimeError(f"int8_matmul: unsupported device {x.device}")
    M, K = x.shape
    if w_q.dtype != torch.int8 or w_q.dim() != 2 or w_q.shape[0] != K:
        raise ValueError(f"w_q must be (K={K}, N) int8, got {tuple(w_q.shape)} {w_q.dtype}")
    N = w_q.shape[1]
    if scale.shape != (N,) or scale.dtype != torch.float32:
        raise ValueError(f"scale must be ({N},) float32, got {tuple(scale.shape)} {scale.dtype}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"int8_matmul: x must be float32 or bfloat16, got {x.dtype}")
    for name, t in (("x", x), ("w_q", w_q), ("scale", scale)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"int8_matmul: {name} must be contiguous on {x.device}")

    ksplit, kchunk = _split(M, K, N, x.dtype, x.device)
    part = torch.empty((ksplit, M, N), dtype=torch.float32, device=x.device)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    lib = _build.library()
    code = lib.dq_int8_matmul(
        x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), part.data_ptr(),
        out.data_ptr(), M, K, N, ksplit, kchunk, int(x.dtype == torch.bfloat16),
        x.device.index or 0, _build.stream_of(x),
    )
    _build.check(code, "dq_int8_matmul")
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0  # kernel launches; reset by the caller


def int8_conv1d(
    x: torch.Tensor,
    w_q: torch.Tensor,
    scale: torch.Tensor,
    bias: Optional[torch.Tensor],
    kernel: int = 3,
    matmul=int8_matmul,
) -> torch.Tensor:
    """Same-padding stride-1 conv over the last axis with int8 weights.

    x (b, C_in, L) channel-first; ``w_q``/``scale`` from
    :func:`quantize_conv_kernel`. The im2col over L (k x the small
    activation) stays torch ops; the product runs ``matmul``
    (:func:`int8_matmul`, or its plain version).
    Returns (b, C_out, L) in x's dtype."""
    b, cin, length = x.shape
    pad = (kernel - 1) // 2
    xp = F.pad(x, (pad, pad))
    cols = torch.stack([xp[:, :, i : i + length] for i in range(kernel)], dim=1)
    xf = cols.permute(0, 3, 1, 2).reshape(b * length, kernel * cin)  # tap-major
    out = matmul(xf.contiguous(), w_q, scale).reshape(b, length, -1)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out.transpose(1, 2)
