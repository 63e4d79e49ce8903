"""JAX parameter tree <-> PyTorch state_dict of the port's UNet1d.

:func:`jax_params_to_torch` maps a flax tree onto the port's names and
layouts, :func:`torch_to_jax_params` maps back (numpy only), for handing
both packages the same weights:

  * flax conv kernel (k, in, out)  <-> torch Conv1d weight (out, in, k)
  * flax dense kernel (in, out)    <-> torch Linear weight (out, in)
  * norm gain g, LayerNorm bias b (C,) <-> (1, C, 1)

Both directions walk one table of (JAX path, torch name) pairs, so they
cover the same trees: ``simple=True`` and ``simple=False`` (the MS1 tower
``attn_mz_*`` <-> ``attn_cond_proj.0.{0,1,2,3}``, the transformers
``attn_rt_tfer`` <-> ``attn_cond_proj.1`` and ``mid_attn_fn`` <->
``mid_attn.fn.fn``, with ``layers_{i}_attn`` <-> ``layers.{i}.0`` and
``layers_{i}_ff`` <-> ``layers.{i}.1``). For ``simple=True``,
:func:`torch_to_jax_params` is what
:func:`dquartic_tpu.compat.torch_ckpt.convert_unet1d_state_dict` returns;
that converter refuses ``simple=False``.

:func:`jax_params_to_torch` also accepts the tree of
``quantize_mid_block_params`` (JAX ``UNet1d(quantize_mid=True)``): each
int8 mid conv ``{kernel_q (K_pad, N_pad), kernel_scale (N_pad,), bias
(N,)}`` becomes the port's ``weight_q`` (K, N) / ``scale`` (N,) / ``bias``
with the TPU tile padding sliced off (the mid convs are square, C_in =
C_out, so K = 3·C_out).

The mapping is linear (transposes and reshapes), so it maps gradients too:
``torch_to_jax_params(grads_state_dict(model), dim_mults)`` is the gradient
tree ``jax.grad`` returns for the same loss, which is how the tests compare
the two packages' gradients.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

Path = Tuple[str, ...]


class _ToTorch:
    """Reads a flax tree, writes a state_dict."""

    def __init__(self, params: Dict[str, Any]):
        self.p = params.get("params", params)
        self.out: Dict[str, np.ndarray] = {}

    def _at(self, path: Path):
        node = self.p
        for key in path:
            node = node[key]
        return node

    def has(self, path: Path, name: str) -> bool:
        node = self.p
        for key in path:
            if not isinstance(node, dict) or key not in node:
                return False
            node = node[key]
        return True

    def conv(self, path: Path, name: str) -> None:
        p = self._at(path)
        if "kernel_q" in p:
            n = np.asarray(p["bias"]).shape[0]
            self.out[f"{name}.weight_q"] = np.asarray(p["kernel_q"], np.int8)[: 3 * n, :n].copy()
            self.out[f"{name}.scale"] = np.asarray(p["kernel_scale"], np.float32)[:n].copy()
        else:
            self.out[f"{name}.weight"] = np.transpose(np.asarray(p["kernel"], np.float32), (2, 1, 0))
        if "bias" in p:
            self.out[f"{name}.bias"] = np.asarray(p["bias"], np.float32)

    def dense(self, path: Path, name: str) -> None:
        p = self._at(path)
        self.out[f"{name}.weight"] = np.transpose(np.asarray(p["kernel"], np.float32), (1, 0))
        self.out[f"{name}.bias"] = np.asarray(p["bias"], np.float32)

    def norm(self, path: Path, name: str) -> None:
        for key, v in self._at(path).items():  # g, and b of a LayerNorm
            self.out[f"{name}.{key}"] = np.asarray(v, np.float32).reshape(1, -1, 1)


class _ToJax:
    """Reads a state_dict, writes a flax tree."""

    def __init__(self, sd: Dict[str, Any]):
        self.sd = {k: np.asarray(v, np.float32) for k, v in sd.items()}
        self.p: Dict[str, Any] = {}

    def _put(self, path: Path, value: Dict[str, np.ndarray]) -> None:
        node = self.p
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value

    def has(self, path: Path, name: str) -> bool:
        return any(k.startswith(name + ".") for k in self.sd)

    def conv(self, path: Path, name: str) -> None:
        out = {"kernel": np.transpose(self.sd[f"{name}.weight"], (2, 1, 0))}
        if f"{name}.bias" in self.sd:
            out["bias"] = self.sd[f"{name}.bias"]
        self._put(path, out)

    def dense(self, path: Path, name: str) -> None:
        self._put(path, {"kernel": self.sd[f"{name}.weight"].T, "bias": self.sd[f"{name}.bias"]})

    def norm(self, path: Path, name: str) -> None:
        self._put(path, {key: self.sd[f"{name}.{key}"].reshape(-1) for key in ("g", "b")
                         if f"{name}.{key}" in self.sd})


def _resnet(m, path: Path, name: str) -> None:
    if m.has(path + ("mlp",), f"{name}.mlp"):
        m.dense(path + ("mlp",), f"{name}.mlp.1")
    for blk in ("block1", "block2"):
        m.conv(path + (blk, "proj"), f"{name}.{blk}.proj")
        m.norm(path + (blk, "norm"), f"{name}.{blk}.norm")
    if m.has(path + ("res_conv",), f"{name}.res_conv"):
        m.conv(path + ("res_conv",), f"{name}.res_conv")


def _linattn(m, key: str, name: str) -> None:
    m.norm((f"{key}_norm",), f"{name}.fn.norm")
    m.conv((f"{key}_fn", "to_qkv"), f"{name}.fn.fn.to_qkv")
    m.conv((f"{key}_fn", "to_out_conv"), f"{name}.fn.fn.to_out.0")
    m.norm((f"{key}_fn", "to_out_norm"), f"{name}.fn.fn.to_out.1")


def _transformer(m, key: str, name: str) -> None:
    i = 0
    while m.has((key, f"layers_{i}_attn"), f"{name}.layers.{i}.0"):
        attn, lname = (key, f"layers_{i}_attn"), f"{name}.layers.{i}.0"
        for conv in ("to_qkv", "to_mid", "to_qv", "to_k", "to_out"):
            if m.has(attn + (conv,), f"{lname}.{conv}"):
                m.conv(attn + (conv,), f"{lname}.{conv}")
        ff, fname = (key, f"layers_{i}_ff"), f"{name}.layers.{i}.1"
        m.norm(ff + ("norm",), f"{fname}.norm")
        m.conv(ff + ("conv1",), f"{fname}.conv1")
        m.conv(ff + ("conv2",), f"{fname}.conv2")
        i += 1


def _walk(m, n_levels: int) -> None:
    """Every parameter of the conditional UNet1d, ``simple`` either way."""
    simple = not m.has(("attn_mz_conv",), "attn_cond_proj.0.0")
    m.conv(("init_conv",), "init_conv")
    m.dense(("time_mlp_1",), "time_mlp.1")
    m.dense(("time_mlp_3",), "time_mlp.3")
    m.dense(("init_cond_proj", "to_scale_shift"), "init_cond_proj.to_scale_shift.1")
    if simple:
        m.conv(("attn_rt_conv1",), "attn_cond_proj.1.0")
        m.conv(("attn_rt_conv2",), "attn_cond_proj.1.2")
    else:
        m.conv(("attn_mz_conv",), "attn_cond_proj.0.0")
        _resnet(m, ("attn_mz_res1",), "attn_cond_proj.0.1")
        _resnet(m, ("attn_mz_res2",), "attn_cond_proj.0.2")
        _linattn(m, "attn_mz_attn", "attn_cond_proj.0.3")
        _transformer(m, "attn_rt_tfer", "attn_cond_proj.1")
    for i in range(n_levels):
        last = i == n_levels - 1
        _resnet(m, (f"downs_{i}_block1",), f"downs.{i}.0")
        _resnet(m, (f"downs_{i}_block2",), f"downs.{i}.1")
        _linattn(m, f"downs_{i}_attn", f"downs.{i}.2")
        m.conv((f"downs_{i}_downsample",) + (() if last else ("conv",)), f"downs.{i}.3")
    _resnet(m, ("mid_block1",), "mid_block1")
    m.norm(("mid_attn_norm",), "mid_attn.fn.norm")
    if simple:
        for key in ("to_qv", "to_k", "to_out"):
            m.conv(("mid_attn_fn", key), f"mid_attn.fn.fn.{key}")
    else:
        _transformer(m, "mid_attn_fn", "mid_attn.fn.fn")
    _resnet(m, ("mid_block2",), "mid_block2")
    for i in range(n_levels):
        last = i == n_levels - 1
        _resnet(m, (f"ups_{i}_block1",), f"ups.{i}.0")
        _resnet(m, (f"ups_{i}_block2",), f"ups.{i}.1")
        _linattn(m, f"ups_{i}_attn", f"ups.{i}.2")
        if last:
            m.conv((f"ups_{i}_upsample",), f"ups.{i}.3")
        else:
            m.conv((f"ups_{i}_upsample", "conv"), f"ups.{i}.3.1")
    _resnet(m, ("final_res_block",), "final_res_block")
    m.conv(("final_conv",), "final_conv")


def jax_params_to_torch(params: Dict[str, Any], dim_mults: Sequence[int]) -> Dict[str, np.ndarray]:
    """Conditional UNet1d flax tree (with or without the ``{"params": ...}``
    wrapper) -> port state_dict of numpy arrays."""
    m = _ToTorch(params)
    _walk(m, len(dim_mults))
    return m.out


def torch_to_jax_params(sd: Dict[str, Any], dim_mults: Sequence[int]) -> Dict[str, Any]:
    """Port state_dict (float weights, tensors or arrays) -> the conditional
    UNet1d flax tree ``{"params": ...}``."""
    m = _ToJax({k: v.detach().cpu().float().numpy() if torch.is_tensor(v) else v
                for k, v in sd.items()})
    _walk(m, len(dim_mults))
    return {"params": m.p}


def grads_state_dict(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    """``{name: grad}`` of every parameter, float32 numpy, in the layout of
    ``model.state_dict()`` (zeros for a parameter with no gradient)."""
    return {
        name: (p.grad if p.grad is not None else torch.zeros_like(p))
        .detach().float().cpu().numpy()
        for name, p in model.named_parameters()
    }
