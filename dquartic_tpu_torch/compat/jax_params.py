"""JAX parameter tree <-> PyTorch state_dict of the port's UNet1d.

:func:`jax_params_to_torch` is the inverse of
:func:`dquartic_tpu.compat.torch_ckpt.convert_unet1d_state_dict` (numpy
only), for handing both packages the same weights:

  * flax conv kernel (k, in, out)  -> torch Conv1d weight (out, in, k)
  * flax dense kernel (in, out)    -> torch Linear weight (out, in)
  * norm gain g (C,)               -> (1, C, 1)

It also accepts the tree of ``quantize_mid_block_params`` (JAX
``UNet1d(quantize_mid=True)``): each int8 mid conv ``{kernel_q (K_pad,
N_pad), kernel_scale (N_pad,), bias (N,)}`` becomes the port's
``weight_q`` (K, N) / ``scale`` (N,) / ``bias`` with the TPU tile padding
sliced off (the mid convs are square, C_in = C_out, so K = 3·C_out).

The other direction is the JAX converter itself: the port's names and
layouts are the reference PyTorch ones, so ``convert_unet1d_state_dict``
maps the port's ``state_dict()`` onto the JAX tree. The mapping is linear
(transposes and reshapes), so it maps gradients too:
``convert_unet1d_state_dict(grads_state_dict(model), dim_mults)`` is the
gradient tree ``jax.grad`` returns for the same loss, which is how the
tests compare the two packages' gradients.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch


def _conv(p: Dict[str, Any], name: str, out: Dict[str, np.ndarray]) -> None:
    out[f"{name}.weight"] = np.transpose(np.asarray(p["kernel"], np.float32), (2, 1, 0))
    if "bias" in p:
        out[f"{name}.bias"] = np.asarray(p["bias"], np.float32)


def _dense(p, name, out) -> None:
    out[f"{name}.weight"] = np.transpose(np.asarray(p["kernel"], np.float32), (1, 0))
    out[f"{name}.bias"] = np.asarray(p["bias"], np.float32)


def _norm(p, name, out) -> None:
    out[f"{name}.g"] = np.asarray(p["g"], np.float32).reshape(1, -1, 1)


def _proj(p, name, out) -> None:
    if "kernel_q" in p:
        n = np.asarray(p["bias"]).shape[0]
        out[f"{name}.weight_q"] = np.asarray(p["kernel_q"], np.int8)[: 3 * n, :n].copy()
        out[f"{name}.scale"] = np.asarray(p["kernel_scale"], np.float32)[:n].copy()
        out[f"{name}.bias"] = np.asarray(p["bias"], np.float32)
    else:
        _conv(p, name, out)


def _resnet(p, name, out) -> None:
    if "mlp" in p:
        _dense(p["mlp"], f"{name}.mlp.1", out)
    _proj(p["block1"]["proj"], f"{name}.block1.proj", out)
    _norm(p["block1"]["norm"], f"{name}.block1.norm", out)
    _proj(p["block2"]["proj"], f"{name}.block2.proj", out)
    _norm(p["block2"]["norm"], f"{name}.block2.norm", out)
    if "res_conv" in p:
        _conv(p["res_conv"], f"{name}.res_conv", out)


def _linattn(p_norm, p_fn, name, out) -> None:
    _norm(p_norm, f"{name}.fn.norm", out)
    _conv(p_fn["to_qkv"], f"{name}.fn.fn.to_qkv", out)
    _conv(p_fn["to_out_conv"], f"{name}.fn.fn.to_out.0", out)
    _norm(p_fn["to_out_norm"], f"{name}.fn.fn.to_out.1", out)


def jax_params_to_torch(params: Dict[str, Any], dim_mults: Sequence[int]) -> Dict[str, np.ndarray]:
    """UNet1d(simple=True, conditional=True) flax tree (with or without the
    ``{"params": ...}`` wrapper) -> port state_dict of numpy arrays."""
    p = params.get("params", params)
    out: Dict[str, np.ndarray] = {}
    n = len(dim_mults)
    _conv(p["init_conv"], "init_conv", out)
    _dense(p["time_mlp_1"], "time_mlp.1", out)
    _dense(p["time_mlp_3"], "time_mlp.3", out)
    _dense(p["init_cond_proj"]["to_scale_shift"], "init_cond_proj.to_scale_shift.1", out)
    _conv(p["attn_rt_conv1"], "attn_cond_proj.1.0", out)
    _conv(p["attn_rt_conv2"], "attn_cond_proj.1.2", out)
    for i in range(n):
        _resnet(p[f"downs_{i}_block1"], f"downs.{i}.0", out)
        _resnet(p[f"downs_{i}_block2"], f"downs.{i}.1", out)
        _linattn(p[f"downs_{i}_attn_norm"], p[f"downs_{i}_attn_fn"], f"downs.{i}.2", out)
        ds = p[f"downs_{i}_downsample"]
        _conv(ds.get("conv", ds), f"downs.{i}.3", out)
    _resnet(p["mid_block1"], "mid_block1", out)
    _norm(p["mid_attn_norm"], "mid_attn.fn.norm", out)
    for key in ("to_qv", "to_k", "to_out"):
        _conv(p["mid_attn_fn"][key], f"mid_attn.fn.fn.{key}", out)
    _resnet(p["mid_block2"], "mid_block2", out)
    for i in range(n):
        _resnet(p[f"ups_{i}_block1"], f"ups.{i}.0", out)
        _resnet(p[f"ups_{i}_block2"], f"ups.{i}.1", out)
        _linattn(p[f"ups_{i}_attn_norm"], p[f"ups_{i}_attn_fn"], f"ups.{i}.2", out)
        us = p[f"ups_{i}_upsample"]
        if "conv" in us:
            _conv(us["conv"], f"ups.{i}.3.1", out)
        else:
            _conv(us, f"ups.{i}.3", out)
    _resnet(p["final_res_block"], "final_res_block", out)
    _conv(p["final_conv"], "final_conv", out)
    return out


def grads_state_dict(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    """``{name: grad}`` of every parameter, float32 numpy, in the layout of
    ``model.state_dict()`` (zeros for a parameter with no gradient)."""
    return {
        name: (p.grad if p.grad is not None else torch.zeros_like(p))
        .detach().float().cpu().numpy()
        for name, p in model.named_parameters()
    }
