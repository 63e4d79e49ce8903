"""Reference PyTorch checkpoint -> the port's checkpoint (port of
:mod:`dquartic_tpu.compat.torch_ckpt`, the ``convert-checkpoint`` command).

The reference UNet1d's ``model_state_dict`` is read through a copy of the
JAX package's name table (``convert_unet1d_state_dict``: reference names
-> the flax tree; the reference CustomTransformer's through
``convert_custom_transformer_state_dict``, which splits each layer's packed
``attention.in_proj_weight`` (3h, h) into q, k and v) and mapped onto the
port's names and layouts by
:func:`~dquartic_tpu_torch.compat.jax_params.jax_params_to_torch`, so the
port reads exactly the entries the JAX package reads and fails where it
fails. For ``simple=True`` the two tables compose to the identity: the
port's names and layouts are the reference's, and the transposes there
and back leave the arrays as they were (views, no copy).

The output is the port's checkpoint of weights only, as the JAX package
writes it: ``{epoch, best_loss, step 0, params, ema_params = params}`` (one
copy of the tensors in the file), no optimizer state.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch

from .jax_params import _tensor, jax_params_to_torch


def _conv(sd: Dict[str, np.ndarray], torch_name: str) -> Dict[str, np.ndarray]:
    out = {"kernel": np.transpose(sd[f"{torch_name}.weight"], (2, 1, 0))}
    if f"{torch_name}.bias" in sd:
        out["bias"] = sd[f"{torch_name}.bias"]
    return out


def _dense(sd: Dict[str, np.ndarray], torch_name: str) -> Dict[str, np.ndarray]:
    out = {"kernel": np.transpose(sd[f"{torch_name}.weight"], (1, 0))}
    if f"{torch_name}.bias" in sd:
        out["bias"] = sd[f"{torch_name}.bias"]
    return out


def _chan_norm(sd: Dict[str, np.ndarray], torch_name: str) -> Dict[str, np.ndarray]:
    return {"g": sd[f"{torch_name}.g"].reshape(-1)}


def _resnet_block(sd, prefix: str) -> Dict[str, Any]:
    out = {
        "block1": {
            "proj": _conv(sd, f"{prefix}.block1.proj"),
            "norm": _chan_norm(sd, f"{prefix}.block1.norm"),
        },
        "block2": {
            "proj": _conv(sd, f"{prefix}.block2.proj"),
            "norm": _chan_norm(sd, f"{prefix}.block2.norm"),
        },
    }
    if f"{prefix}.mlp.1.weight" in sd:
        out["mlp"] = _dense(sd, f"{prefix}.mlp.1")
    if f"{prefix}.res_conv.weight" in sd:
        out["res_conv"] = _conv(sd, f"{prefix}.res_conv")
    return out


def _linear_attention(sd, prefix: str) -> Dict[str, Any]:
    return {
        "to_qkv": _conv(sd, f"{prefix}.to_qkv"),
        "to_out_conv": _conv(sd, f"{prefix}.to_out.0"),
        "to_out_norm": _chan_norm(sd, f"{prefix}.to_out.1"),
    }


def _attention(sd, prefix: str, cross: bool) -> Dict[str, Any]:
    out = {"to_out": _conv(sd, f"{prefix}.to_out")}
    if cross:
        out["to_qv"] = _conv(sd, f"{prefix}.to_qv")
        out["to_k"] = _conv(sd, f"{prefix}.to_k")
    else:
        out["to_qkv"] = _conv(sd, f"{prefix}.to_qkv")
    return out


def _f32_numpy(sd: Dict[str, Any]) -> Dict[str, np.ndarray]:
    return {k: v.detach().float().numpy() if torch.is_tensor(v) else np.asarray(v, np.float32)
            for k, v in sd.items()}


def convert_unet1d_state_dict(
    sd: Dict[str, Any], dim_mults: Sequence[int], conditional: bool = True,
    simple: bool = True,
) -> Dict[str, Any]:
    """A reference UNet1d state_dict, conditional or not -> the flax tree
    ``{"params": ...}`` (the JAX package's table)."""
    if not simple:
        raise NotImplementedError(
            "The reference simple=False Transformer1d forward crashes "
            "(unet1d.py:822); no reference checkpoints exist for it."
        )
    sd = _f32_numpy(sd)
    n_levels = len(dim_mults)
    p: Dict[str, Any] = {
        "init_conv": _conv(sd, "init_conv"),
        "time_mlp_1": _dense(sd, "time_mlp.1"),
        "time_mlp_3": _dense(sd, "time_mlp.3"),
    }
    if conditional:
        p["init_cond_proj"] = {"to_scale_shift": _dense(sd, "init_cond_proj.to_scale_shift.1")}
        p["attn_rt_conv1"] = _conv(sd, "attn_cond_proj.1.0")
        p["attn_rt_conv2"] = _conv(sd, "attn_cond_proj.1.2")
    for i in range(n_levels):
        is_last = i >= n_levels - 1
        p[f"downs_{i}_block1"] = _resnet_block(sd, f"downs.{i}.0")
        p[f"downs_{i}_block2"] = _resnet_block(sd, f"downs.{i}.1")
        p[f"downs_{i}_attn_norm"] = _chan_norm(sd, f"downs.{i}.2.fn.norm")
        p[f"downs_{i}_attn_fn"] = _linear_attention(sd, f"downs.{i}.2.fn.fn")
        conv = _conv(sd, f"downs.{i}.3")
        p[f"downs_{i}_downsample"] = conv if is_last else {"conv": conv}

    p["mid_block1"] = _resnet_block(sd, "mid_block1")
    p["mid_attn_norm"] = _chan_norm(sd, "mid_attn.fn.norm")
    p["mid_attn_fn"] = _attention(sd, "mid_attn.fn.fn", cross=conditional)
    p["mid_block2"] = _resnet_block(sd, "mid_block2")

    for i in range(n_levels):
        is_last = i == n_levels - 1
        p[f"ups_{i}_block1"] = _resnet_block(sd, f"ups.{i}.0")
        p[f"ups_{i}_block2"] = _resnet_block(sd, f"ups.{i}.1")
        p[f"ups_{i}_attn_norm"] = _chan_norm(sd, f"ups.{i}.2.fn.norm")
        p[f"ups_{i}_attn_fn"] = _linear_attention(sd, f"ups.{i}.2.fn.fn")
        if is_last:
            p[f"ups_{i}_upsample"] = _conv(sd, f"ups.{i}.3")
        else:
            p[f"ups_{i}_upsample"] = {"conv": _conv(sd, f"ups.{i}.3.1")}

    p["final_res_block"] = _resnet_block(sd, "final_res_block")
    p["final_conv"] = _conv(sd, "final_conv")
    return {"params": p}


def convert_custom_transformer_state_dict(
    sd: Dict[str, Any], num_layers: int, hidden_dim: int
) -> Dict[str, Any]:
    """A reference CustomTransformer state_dict -> the flax tree
    ``{"params": ...}`` (the JAX package's table): each layer's
    ``attention.in_proj_weight`` (3h, h) and ``in_proj_bias`` split into q,
    k and v, the feed-forward read from ``ff.0`` and ``ff.2``."""
    sd = _f32_numpy(sd)
    p: Dict[str, Any] = {
        "input_projection": _dense(sd, "input_projection"),
        "conditional_projection": _dense(sd, "conditional_projection"),
        "output_projection": _dense(sd, "output_projection"),
        "time_embedding": {
            "linear1": _dense(sd, "time_embedding.linear1"),
            "linear2": _dense(sd, "time_embedding.linear2"),
        },
    }
    h = hidden_dim
    for i in range(num_layers):
        pre = f"layers.{i}"
        w = sd[f"{pre}.attention.in_proj_weight"]  # (3h, h)
        b = sd[f"{pre}.attention.in_proj_bias"]  # (3h,)
        p[f"layers_{i}"] = {
            **{name: {"kernel": w[j * h:(j + 1) * h].T, "bias": b[j * h:(j + 1) * h]}
               for j, name in enumerate(("q_proj", "k_proj", "v_proj"))},
            "out_proj": _dense(sd, f"{pre}.attention.out_proj"),
            "norm1": {"scale": sd[f"{pre}.norm1.weight"], "bias": sd[f"{pre}.norm1.bias"]},
            "norm2": {"scale": sd[f"{pre}.norm2.weight"], "bias": sd[f"{pre}.norm2.bias"]},
            "ff1": _dense(sd, f"{pre}.ff.0"),
            "ff2": _dense(sd, f"{pre}.ff.2"),
        }
    return {"params": p}


def load_torch_state_dict(path: str) -> Dict[str, Any]:
    """``model_state_dict`` (or a bare state_dict), epoch and best_loss of a
    reference checkpoint."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "model_state_dict" in ckpt:
        return {"state_dict": ckpt["model_state_dict"],
                "epoch": int(ckpt.get("epoch", 0)),
                "best_loss": float(ckpt.get("best_loss", float("inf")))}
    return {"state_dict": ckpt, "epoch": 0, "best_loss": float("inf")}


def convert_checkpoint_file(torch_path: str, out_path: str, config_path: str) -> None:
    """Convert a reference ``.ckpt`` into the port's checkpoint file."""
    from ..train.checkpoint import save_checkpoint
    from ..utils.config import load_train_config

    config = load_train_config(config_path)
    m = config["model"]
    loaded = load_torch_state_dict(torch_path)
    if m["use_model"] == "UNet1d":
        u = m["UNet1d"]
        tree = convert_unet1d_state_dict(loaded["state_dict"], dim_mults=u["dim_mults"],
                                         conditional=u["conditional"], simple=u["simple"])
    elif m["use_model"] == "CustomTransformer":
        c = m["CustomTransformer"]
        tree = convert_custom_transformer_state_dict(
            loaded["state_dict"], num_layers=c["num_layers"], hidden_dim=c["hidden_dim"])
    else:
        raise ValueError(f"Unknown use_model: {m['use_model']}")
    params = {k: _tensor(v) for k, v in jax_params_to_torch(tree).items()}
    save_checkpoint(out_path, {
        "epoch": loaded["epoch"],
        "best_loss": loaded["best_loss"],
        "step": 0,
        "params": params,
        "opt_state": None,
        "ema_params": params,
    })
