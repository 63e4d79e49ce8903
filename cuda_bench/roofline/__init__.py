"""The benchmark's yardstick: the card's peaks, the shapes of each kernel
call from the configuration, each call's operations and bytes, and the
model FLOPs behind ``mfu``.

Peaks (NVIDIA's H100 SXM data sheet, dense, at the full 700 W): 3.35 TB/s
of HBM; 989 TFLOP/s for bf16 products and for products of float32 accuracy
(split bf16 on tensor cores reaches the bf16 rate); 1979 TOP/s for int8
weights. A kernel's bound is the larger of its bytes (each input byte
read once, each output byte written once) at the memory rate and its
operations at its rate; no float32 CUDA-core rate and no exponential
floor bound any of them.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12


def bound_s(nbytes: float, flops: float, peak: float = PEAK_BF16) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / peak)
