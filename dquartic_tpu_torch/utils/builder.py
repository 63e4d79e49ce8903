"""Build the port's model and DDIM process from a config dict.

Port of ``build_model`` / ``build_process`` of
:mod:`dquartic_tpu.utils.builder` for the UNet1d serving path.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..core import DDIMProcess, make_schedule
from ..models.unet1d import UNet1d
from ..ops.quantization import quantize_mid_block_params

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}
# UNet1d keys of the JAX package that choose among its implementations
# (TPU kernels, remat, sharding); the port has one implementation.
_JAX_IMPL_KEYS = {
    "attn_impl", "linear_attn_impl", "fused_resnet", "quantize_mid", "remat_blocks",
    "remat_linear_attn", "kernel_dp_axis", "activation_sharding",
}
_UNET_KEYS = set(UNet1d.__init__.__code__.co_varnames[1 : UNet1d.__init__.__code__.co_argcount])


@torch.no_grad()
def init_weights(model: torch.nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights: norm gains 1, biases 0, other weights
    N(0, 1/fan_in) (LeCun normal, as the JAX initializers)."""
    for name, p in model.named_parameters():
        if name.endswith(".g"):
            p.fill_(1.0)
        elif name.endswith("bias"):
            p.zero_()
        else:
            p.normal_(0.0, p[0].numel() ** -0.5, generator=generator)


def build_model(config: Dict[str, Any], device="cpu", seed: int = 0) -> UNet1d:
    """UNet1d from ``config["model"]["UNet1d"]`` with seeded random weights
    on ``device``, in ``tpu.compute_dtype``; with ``tpu.quantize_mid`` the
    mid convs are int8. ``tpu.fused_resnet`` is accepted: the port's
    kernels are the fused path. Inference only (no parameter needs grad).

    The model is built on the meta device and materialized on ``device``,
    so the canonical 1.2 B-parameter model is never built on the host."""
    m = config["model"]
    if m["use_model"] != "UNet1d":
        raise NotImplementedError(f"the port builds UNet1d only (got {m['use_model']})")
    u = dict(m["UNet1d"])
    quantize = bool(config["tpu"].get("quantize_mid") or u.get("quantize_mid"))
    unknown = set(u) - _UNET_KEYS - _JAX_IMPL_KEYS
    if unknown:
        raise ValueError(f"Unknown UNet1d config keys: {sorted(unknown)}")
    u = {k: v for k, v in u.items() if k in _UNET_KEYS}
    dtype = _DTYPES[config["tpu"]["compute_dtype"]]

    device = torch.device(device)
    with torch.device("meta"):
        model = UNet1d(**u)
    model.to_empty(device=device)
    init_weights(model, torch.Generator(device=device).manual_seed(seed))
    if quantize:
        quantize_mid_block_params(model)
    for name, p in model.named_parameters():
        if not name.endswith(".g"):  # norm gains stay float32, as in JAX
            p.data = p.data.to(dtype)
    return model.requires_grad_(False).eval()


def build_process(config: Dict[str, Any]) -> DDIMProcess:
    m = config["model"]
    schedule = make_schedule(
        num_timesteps=m["num_timesteps"],
        schedule_type=m["beta_schedule_type"],
        pred_type=m["pred_type"],
        weighting=config["tpu"].get("loss_weighting", "reference"),
    )
    return DDIMProcess(
        schedule=schedule,
        auto_normalize=m["auto_normalize"],
        parity_neighbor_stepping=not config["tpu"].get("ddim_proper_stepping", False),
        clip_denoised=config["tpu"].get("clip_denoised", bool(m["auto_normalize"])),
    )
