"""dquartic_tpu_torch — the DDIM deconvolution serving path in PyTorch + CUDA.

A port of :mod:`dquartic_tpu` (JAX/Pallas, the reference) to PyTorch on an
NVIDIA H100. It covers the inference path that ``predict`` runs: the
50-step DDIM reverse pass over the conditional UNet1d, with the three TPU
kernels of that path rewritten by hand in CUDA C++ for ``sm_90a``
(``csrc/``):

  * ``ops.linear_attention``  — fused pre-norm linear attention (K1)
  * ``ops.fused_resnet``      — fused ResnetBlock, transposed layout (K2)
  * ``ops.int8_matmul``       — int8 weight-streaming matmul (K3)

Each kernel wrapper runs its plain PyTorch version for CPU tensors and
launches the kernel for CUDA tensors. This package never imports JAX.
"""

__version__ = "0.1.0"
