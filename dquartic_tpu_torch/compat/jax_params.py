"""JAX parameter tree <-> PyTorch state_dict of the port's UNet1d and
CustomTransformer.

:func:`jax_params_to_torch` maps a flax tree onto the port's names and
layouts, :func:`torch_to_jax_params` maps back (numpy only), for handing
both packages the same weights:

  * flax conv kernel (k, in, out)  <-> torch Conv1d weight (out, in, k)
  * flax dense kernel (in, out)    <-> torch Linear weight (out, in)
  * norm gain g, LayerNorm bias b (C,) <-> (1, C, 1)
  * flax LayerNorm scale, bias (C,) <-> torch LayerNorm weight, bias (C,)

Both directions walk one table of (JAX path, torch name) pairs, so they
cover the same trees. The UNet1d's, conditional or not (the unconditional
tree has no ``init_cond_proj``, no MS1 tower, and the mid attention's
``to_qkv`` for the conditional ``to_qv``/``to_k``), ``simple=True`` and
``simple=False`` (the MS1 tower
``attn_mz_*`` <-> ``attn_cond_proj.0.{0,1,2,3}``, the transformers
``attn_rt_tfer`` <-> ``attn_cond_proj.1`` and ``mid_attn_fn`` <->
``mid_attn.fn.fn``, with ``layers_{i}_attn`` <-> ``layers.{i}.0`` and
``layers_{i}_ff`` <-> ``layers.{i}.1``). For ``simple=True``,
:func:`torch_to_jax_params` is what
:func:`dquartic_tpu.compat.torch_ckpt.convert_unet1d_state_dict` returns;
that converter refuses ``simple=False``. The CustomTransformer's tree
(``input_projection``, ``layers_{i}`` <-> ``layers.{i}``, ...) maps Dense
kernels and LayerNorms, nothing else; the family is read from the tree
(``input_projection``) or the state_dict.

:func:`jax_params_to_torch` also accepts the tree of
``quantize_mid_block_params`` (JAX ``UNet1d(quantize_mid=True)``): each
int8 mid conv ``{kernel_q (K_pad, N_pad), kernel_scale (N_pad,), bias
(N,)}`` becomes the port's ``weight_q`` (K, N) / ``scale`` (N,) / ``bias``
with the TPU tile padding sliced off (the mid convs are square, C_in =
C_out, so K = 3·C_out).

The mapping is linear (transposes and reshapes), so it maps gradients too:
``torch_to_jax_params(grads_state_dict(model), dim_mults)`` is the gradient
tree ``jax.grad`` returns for the same loss (``dim_mults`` may be left out,
the levels counted from the names), which is how the tests compare the two
packages' gradients.

:func:`jax_checkpoint_to_port` maps a whole JAX checkpoint (the payload of
``dquartic_tpu.train.Trainer``: ``{epoch, best_loss, state: {step, params,
opt_state, ema_params}}``) onto the port's checkpoint: the parameters and
the EMA as state_dicts, and optax's optimizer state keyed by parameter
name, in the port's layouts, for ``ClippedAdamW`` (``mu``, ``nu``,
``count``) or ``ClippedFactoredRMS`` (``v_row``, ``v_col``, ``v``,
``count``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

Path = Tuple[str, ...]


def _f32(v) -> np.ndarray:
    """A leaf as float32 numpy (a bfloat16 leaf reads as a torch tensor)."""
    return v.float().numpy() if torch.is_tensor(v) else np.asarray(v, np.float32)


def _tensor(a: np.ndarray) -> torch.Tensor:
    """A torch tensor over ``a``, copied only where ``a`` is not a
    contiguous, aligned, writable array."""
    return torch.from_numpy(np.require(a, requirements=["C", "A", "W"]))


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
            self.out[f"{name}.weight"] = np.transpose(_f32(p["kernel"]), (2, 1, 0))
        if "bias" in p:
            self.out[f"{name}.bias"] = _f32(p["bias"])

    def dense(self, path: Path, name: str) -> None:
        p = self._at(path)
        self.out[f"{name}.weight"] = np.transpose(_f32(p["kernel"]), (1, 0))
        self.out[f"{name}.bias"] = _f32(p["bias"])

    def norm(self, path: Path, name: str) -> None:
        for key, v in self._at(path).items():  # g, and b of a LayerNorm
            self.out[f"{name}.{key}"] = _f32(v).reshape(1, -1, 1)

    def layernorm(self, path: Path, name: str) -> None:
        p = self._at(path)
        self.out[f"{name}.weight"] = _f32(p["scale"])
        self.out[f"{name}.bias"] = _f32(p["bias"])


class _Layouts(_ToTorch):
    """Reads a flax tree, records for each torch name the flax path of its
    leaf and the axis order that maps one onto the other: torch axis i is
    flax axis ``perm[i]`` (None for a norm's (C,) -> (1, C, 1))."""

    def conv(self, path: Path, name: str) -> None:
        p = self._at(path)
        self.out[f"{name}.weight"] = (path + ("kernel",), (2, 1, 0))
        if "bias" in p:
            self.out[f"{name}.bias"] = (path + ("bias",), (0,))

    def dense(self, path: Path, name: str) -> None:
        self.out[f"{name}.weight"] = (path + ("kernel",), (1, 0))
        self.out[f"{name}.bias"] = (path + ("bias",), (0,))

    def norm(self, path: Path, name: str) -> None:
        for key in self._at(path):
            self.out[f"{name}.{key}"] = (path + (key,), None)

    def layernorm(self, path: Path, name: str) -> None:
        self.out[f"{name}.weight"] = (path + ("scale",), (0,))
        self.out[f"{name}.bias"] = (path + ("bias",), (0,))


class _NameLayouts(_Layouts):
    """:class:`_Layouts` from a state_dict's names alone (no flax tree): for
    each torch name, the flax path and axis order of its leaf. An int8
    conv's ``weight_q`` (K, N) and ``scale`` (N,) keep the axis order of
    the JAX tree's ``kernel_q`` and ``kernel_scale``."""

    def __init__(self, names):
        self.names = set(names)
        self.out = {}

    def has(self, path: Path, name: str) -> bool:
        return any(k.startswith(name + ".") for k in self.names)

    def conv(self, path: Path, name: str) -> None:
        if f"{name}.weight_q" in self.names:
            self.out[f"{name}.weight_q"] = (path + ("kernel_q",), (0, 1))
            self.out[f"{name}.scale"] = (path + ("kernel_scale",), (0,))
        else:
            self.out[f"{name}.weight"] = (path + ("kernel",), (2, 1, 0))
        if f"{name}.bias" in self.names:
            self.out[f"{name}.bias"] = (path + ("bias",), (0,))

    def norm(self, path: Path, name: str) -> None:
        for key in ("g", "b"):
            if f"{name}.{key}" in self.names:
                self.out[f"{name}.{key}"] = (path + (key,), None)


def torch_layouts(names) -> Dict[str, Tuple[Path, Optional[Tuple[int, ...]]]]:
    """``{torch name: (flax path, perm)}`` for the parameter names of a
    UNet1d or CustomTransformer state_dict: torch axis i of the leaf is
    flax axis ``perm[i]``; ``perm`` None is a norm's (C,) held as (1, C, 1)."""
    m = _NameLayouts(names)
    _walk(m)
    return m.out


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

    def layernorm(self, path: Path, name: str) -> None:
        self._put(path, {"scale": self.sd[f"{name}.weight"], "bias": self.sd[f"{name}.bias"]})


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


def _count(m, key: str, name: str) -> int:
    """How many of ``key.format(i)`` / ``name.format(i)`` the tree holds,
    from i = 0 up."""
    n = 0
    while m.has((key.format(n),), name.format(n)):
        n += 1
    return n


def _walk_transformer(m) -> None:
    """Every parameter of the CustomTransformer."""
    for key in ("input_projection", "conditional_projection", "output_projection"):
        m.dense((key,), key)
    for key in ("linear1", "linear2"):
        m.dense(("time_embedding", key), f"time_embedding.{key}")
    for i in range(_count(m, "layers_{}", "layers.{}")):
        for key in ("q_proj", "k_proj", "v_proj", "out_proj", "ff1", "ff2"):
            m.dense((f"layers_{i}", key), f"layers.{i}.{key}")
        for key in ("norm1", "norm2"):
            m.layernorm((f"layers_{i}", key), f"layers.{i}.{key}")


def _walk(m, n_levels: Optional[int] = None) -> None:
    """Every parameter of the UNet1d, conditional or not, ``simple`` either
    way (``n_levels`` None: counted from the tree), or of the
    CustomTransformer."""
    if m.has(("input_projection",), "input_projection"):
        return _walk_transformer(m)
    if n_levels is None:
        n_levels = _count(m, "downs_{}_block1", "downs.{}.0")
    conditional = m.has(("init_cond_proj",), "init_cond_proj")
    simple = not m.has(("mid_attn_fn", "layers_0_attn"), "mid_attn.fn.fn.layers.0.0")
    m.conv(("init_conv",), "init_conv")
    m.dense(("time_mlp_1",), "time_mlp.1")
    m.dense(("time_mlp_3",), "time_mlp.3")
    if conditional:
        m.dense(("init_cond_proj", "to_scale_shift"), "init_cond_proj.to_scale_shift.1")
    if conditional and simple:
        m.conv(("attn_rt_conv1",), "attn_cond_proj.1.0")
        m.conv(("attn_rt_conv2",), "attn_cond_proj.1.2")
    elif conditional:
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
        for key in ("to_qkv", "to_qv", "to_k", "to_out"):
            if m.has(("mid_attn_fn", key), f"mid_attn.fn.fn.{key}"):
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


def jax_params_to_torch(params: Dict[str, Any],
                        dim_mults: Optional[Sequence[int]] = None) -> Dict[str, np.ndarray]:
    """UNet1d or CustomTransformer flax tree (with or without the
    ``{"params": ...}`` wrapper) -> port state_dict of numpy arrays. A
    UNet1d's number of levels is that of ``dim_mults``, or of the tree when
    it is None."""
    m = _ToTorch(params)
    _walk(m, None if dim_mults is None else len(dim_mults))
    return m.out


def _state_dict(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    return {k: _tensor(v) for k, v in jax_params_to_torch(tree).items()}


def _unwrap(tree: Dict[str, Any]) -> Dict[str, Any]:
    return tree.get("params", tree)


def _factored_to_port(st: Dict[str, Any], params: Dict[str, Any]) -> Dict[str, Any]:
    """optax ``FactoredState`` in flax layouts -> the port's, by name. A
    parameter is factored where its ``v`` is optax's (1,) placeholder; its
    two largest axes are then factored in either layout (argsort of the
    sizes, as optax's ``_factored_dims``), the same physical axes: where
    two of them tie in size, both are factored in both layouts, and a tie
    with a conv's kernel axis (4 at most) stays below optax's threshold of
    128. The statistic that averages out one of the axes goes to the slot
    that averages out the same axis in the torch layout, its other axes put
    in the torch order."""
    layouts = _Layouts(params)
    _walk(layouts)
    trees = {k: _unwrap(st[k]) for k in ("v_row", "v_col", "v")}

    def at(tree, path):
        for key in path:
            tree = tree[key]
        return tree

    def two_largest(shape):
        order = np.argsort(shape)
        return int(order[-2]), int(order[-1])

    out: Dict[str, Any] = {"kind": "factored", "count": int(st["count"]),
                           "v_row": {}, "v_col": {}, "v": {}}
    for name, (path, perm) in layouts.out.items():
        fshape = tuple(np.shape(at(layouts.p, path)))
        tshape = (1, fshape[0], 1) if perm is None else tuple(fshape[a] for a in perm)
        v = _f32(at(trees["v"], path))
        for k in ("v_row", "v_col", "v"):
            out[k][name] = None
        if v.shape == fshape:
            out["v"][name] = _tensor(v.reshape(tshape) if perm is None else np.transpose(v, perm))
            continue
        if perm is None:
            raise ValueError(f"{name}: a factored statistic of a 1-D parameter {fshape}")
        fdims, tdims = two_largest(fshape), two_largest(tshape)
        flax_slot = {fdims[1]: "v_row", fdims[0]: "v_col"}  # the axis each averages out
        for k, removed in (("v_row", tdims[1]), ("v_col", tdims[0])):
            axis = perm[removed]
            if axis not in flax_slot:
                raise ValueError(
                    f"{name}: flax {fshape} and torch {tshape} factor different axes (a tie "
                    "with the kernel axis, below optax's threshold of 128)")
            src = _f32(at(trees[flax_slot[axis]], path))
            rest = [a for a in range(len(fshape)) if a != axis]
            order = [perm[i] for i in range(len(tshape)) if i != removed]
            out[k][name] = _tensor(np.transpose(src, [rest.index(a) for a in order]))
    return out


def _opt_state_to_port(opt_state, params) -> Optional[Dict[str, Any]]:
    """The optax chain's state (clip, then Adam and weight decay, or the
    factored RMS) -> the port's name-keyed optimizer state, or None."""
    if opt_state is None:
        return None
    parts = opt_state.values() if isinstance(opt_state, dict) else opt_state
    for part in parts:
        if isinstance(part, dict) and "mu" in part:
            return {"kind": "adamw", "count": int(part["count"]),
                    "exp_avg": _state_dict(part["mu"]), "exp_avg_sq": _state_dict(part["nu"])}
        if isinstance(part, dict) and "v_row" in part:
            return _factored_to_port(part, params)
    raise ValueError("unknown optimizer state in the JAX checkpoint: "
                     f"{[sorted(p) if isinstance(p, dict) else p for p in parts]}")


def jax_checkpoint_to_port(payload: Dict[str, Any]) -> Dict[str, Any]:
    """A JAX package checkpoint as ``read_jax_checkpoint`` returns it ->
    the port's payload ``{epoch, best_loss, step, params, opt_state,
    ema_params}``: float32 state_dicts of the UNet1d (conditional or not,
    the number of levels read from the tree) or the CustomTransformer, the
    optimizer state keyed by name
    (None for a converted reference checkpoint, which has none), and the
    EMA (None where the run kept none)."""
    state = payload["state"]
    params = state["params"]
    ema = state.get("ema_params")
    return {
        "epoch": int(payload["epoch"]),
        "best_loss": float(payload["best_loss"]),
        "step": int(state["step"]),
        "params": _state_dict(params),
        "opt_state": _opt_state_to_port(state.get("opt_state"), params),
        "ema_params": None if ema is None else _state_dict(ema),
    }


def torch_to_jax_params(sd: Dict[str, Any],
                        dim_mults: Optional[Sequence[int]] = None) -> Dict[str, Any]:
    """Port state_dict (float weights, tensors or arrays) -> the UNet1d or
    CustomTransformer flax tree ``{"params": ...}``; a UNet1d's levels are
    those of ``dim_mults``, or counted from the names when it is None."""
    m = _ToJax({k: v.detach().cpu().float().numpy() if torch.is_tensor(v) else v
                for k, v in sd.items()})
    _walk(m, None if dim_mults is None else len(dim_mults))
    return {"params": m.p}


def grads_state_dict(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    """``{name: grad}`` of every parameter, float32 numpy, in the layout of
    ``model.state_dict()`` (zeros for a parameter with no gradient)."""
    return {
        name: (p.grad if p.grad is not None else torch.zeros_like(p))
        .detach().float().cpu().numpy()
        for name, p in model.named_parameters()
    }
