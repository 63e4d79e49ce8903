"""Weight quantization for inference.

Port of :mod:`dquartic_tpu.ops.quantization`:

  * :func:`quantize_mid_block_params` — the UNet1d mid blocks, as an
    in-place module conversion: the four mid-block convs
    (``mid_block{1,2}.block{1,2}.proj``, 1.2 B of the canonical model's
    parameters) become :class:`~dquartic_tpu_torch.models.layers.Int8Conv1d`
    with symmetric per-output-channel int8 weights; everything else is left
    as it is.
  * :func:`quantize_params` / :func:`dequantize_params` /
    :func:`apply_quantized` / :func:`quantized_nbytes` — the generic half, on
    a state_dict: each large float weight ``name`` becomes int8 values
    ``name::q_values`` and float32 scales ``name::q_scale``, symmetric per
    output channel. JAX quantizes per flax's last axis, the output axis of
    a dense ``(in, out)`` or conv ``(k, in, out)`` kernel; in torch's
    ``(out, in[, k])`` layout that is axis 0, so the port reduces over
    every axis but 0, and its values and scales are JAX's transposed.
  * :func:`stochastic_round_to_int8` — the training-friendly variant, its
    draws from an explicit :class:`torch.Generator`.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch import nn

MID_CONVS = tuple(
    f"mid_block{i}.block{j}.proj" for i in (1, 2) for j in (1, 2)
)
QUANT_SUFFIX_VALUES = "::q_values"
QUANT_SUFFIX_SCALE = "::q_scale"
_MIN_QUANT_SIZE = 4096  # below this, int8 overhead beats the savings
# The UNet1d's norm gains and LayerNorm1d biases are stored (1, C, 1) in
# the port and (C,) in the JAX tree, where every 1-D leaf passes through.
_NORM_SUFFIXES = (".g", ".b")


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


def _scale_of(x32: torch.Tensor) -> torch.Tensor:
    """``max(absmax / 127, 1e-12)`` per index of axis 0, over every other
    axis (kept as size-1 axes); a 1-D tensor per element, as JAX's reduction
    over no axes."""
    absmax = x32.abs()
    if x32.dim() > 1:
        absmax = absmax.amax(dim=tuple(range(1, x32.dim())), keepdim=True)
    return torch.clamp(absmax / 127.0, min=1e-12)


def _quantize_leaf(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8: rounded half to even, as
    ``jnp.round``."""
    x32 = x.float()
    scale = _scale_of(x32)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_params(state_dict: Dict[str, torch.Tensor],
                    min_size: int = _MIN_QUANT_SIZE) -> Dict[str, torch.Tensor]:
    """Quantize a state_dict: each float tensor of at least ``min_size``
    elements and two dimensions (a norm's gain or bias aside, see
    ``_NORM_SUFFIXES``) ``name`` is replaced by ``name::q_values`` (int8) and
    ``name::q_scale`` (float32); the others pass through unchanged."""
    out: Dict[str, torch.Tensor] = {}
    for name, v in state_dict.items():
        if (v.numel() >= min_size and v.dim() >= 2 and v.is_floating_point()
                and not name.endswith(_NORM_SUFFIXES)):
            out[name + QUANT_SUFFIX_VALUES], out[name + QUANT_SUFFIX_SCALE] = _quantize_leaf(v)
        else:
            out[name] = v
    return out


def dequantize_params(qparams: Dict[str, torch.Tensor],
                      dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """Invert :func:`quantize_params`: ``values · scale`` in float32, cast
    to ``dtype``."""
    out: Dict[str, torch.Tensor] = {}
    for name, v in qparams.items():
        if name.endswith(QUANT_SUFFIX_VALUES):
            base = name[: -len(QUANT_SUFFIX_VALUES)]
            out[base] = (v.float() * qparams[base + QUANT_SUFFIX_SCALE]).to(dtype)
        elif not name.endswith(QUANT_SUFFIX_SCALE):
            out[name] = v
    return out


def apply_quantized(model: nn.Module, qparams: Dict[str, torch.Tensor], *args,
                    dtype: torch.dtype = torch.float32, **kwargs):
    """Run ``model`` on the weights of a quantized state_dict, dequantized
    for this call (``torch.func.functional_call``): the model's own
    tensors are not touched."""
    return torch.func.functional_call(model, dequantize_params(qparams, dtype), args, kwargs)


def quantized_nbytes(tree: Dict[str, Any]) -> int:
    """Bytes of the tensors of a (quantized) state_dict."""
    return sum(v.numel() * v.element_size() for v in tree.values())


def stochastic_round_to_int8(x: torch.Tensor, generator: torch.Generator
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stochastic-rounding int8 quantization, per index of axis 0 as
    :func:`quantize_params`: ``floor(x / scale)`` plus one with probability
    its fractional part (unbiased), the uniform draws from ``generator``
    (on x's device). Returns ``(q int8, scale float32)``."""
    x32 = x.float()
    scale = _scale_of(x32)
    scaled = x32 / scale
    floor = torch.floor(scaled)
    rnd = torch.rand(x32.shape, generator=generator, device=x32.device)
    q = torch.clamp(floor + (rnd < scaled - floor).float(), -127, 127).to(torch.int8)
    return q, scale
