"""Inference-time int8 quantization of the UNet1d mid blocks.

Port of :func:`dquartic_tpu.ops.quantization.quantize_mid_block_params`
as an in-place module conversion: the four mid-block convs
(``mid_block{1,2}.block{1,2}.proj``, 1.2 B of the canonical model's
parameters) become :class:`~dquartic_tpu_torch.models.layers.Int8Conv1d`
with symmetric per-output-channel int8 weights; everything else is left
as it is.
"""

from __future__ import annotations

from torch import nn

MID_CONVS = tuple(
    f"mid_block{i}.block{j}.proj" for i in (1, 2) for j in (1, 2)
)


def quantize_mid_block_params(model: nn.Module) -> nn.Module:
    """Replace the mid-block convs of ``model`` (a UNet1d) by int8 convs,
    quantized from their current weights; the float weights are released.
    Returns ``model``."""
    from ..models.layers import Int8Conv1d

    for name in MID_CONVS:
        parent_name, attr = name.rsplit(".", 1)
        parent = model.get_submodule(parent_name)
        conv = getattr(parent, attr)
        if isinstance(conv, nn.Conv1d):
            setattr(parent, attr, Int8Conv1d.from_conv(conv))
    return model
