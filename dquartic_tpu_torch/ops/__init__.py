"""Ops of the serving and training paths; K1-K9 launch
hand-written CUDA kernels on CUDA tensors and run their plain PyTorch
versions on CPU tensors."""

from . import flash_attention as _flash_attention
from . import fused_resnet as _fused_resnet
from . import int8_matmul as _int8_matmul
from . import linear_attention as _linear_attention

# The kernel wrappers; each counts its launches in ``.launches``.
KERNELS = {
    "linear_attention": _linear_attention.linear_attention,
    "fused_resnet_block_t": _fused_resnet.fused_resnet_block_t,
    "int8_matmul": _int8_matmul.int8_matmul,
    "linear_attention_backward": _linear_attention.linear_attention_backward,
    "fused_resnet_backward": _fused_resnet.fused_resnet_backward,
    "flash_attention": _flash_attention.flash_attention,
    "flash_attention_backward": _flash_attention.flash_attention_backward,
    "fused_linear_attention": _linear_attention.fused_linear_attention,
    "fused_linear_attention_two_call": _linear_attention.fused_linear_attention_two_call,
    "linear_attention_sp_stats": _linear_attention.linear_attention_sp_stats,
    "linear_attention_sp_apply": _linear_attention.linear_attention_sp_apply,
    "linear_attention_sp_backward": _linear_attention.linear_attention_sp_backward,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}
