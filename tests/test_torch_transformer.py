"""The port's transformer modules against the JAX package on the same
weights: LayerNorm1d, FeedForward1d, Attention (self and cross),
HybridSelfAndCrossAttention and Transformer1d; and the simple=True
parameter mapping and the builder's norm parameters.

Weights are made with numpy from a seed in the JAX tree's shapes; modules
get them by their torch names (a rule independent of the mapping under
test). Everything runs in float32 on the CPU, where the port's flash op
runs its plain version and the JAX flash kernel runs in interpret mode.
UNet1d(simple=False) itself is held against JAX in test_torch_unet_tfer.py.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dquartic_tpu.compat.torch_ckpt import convert_unet1d_state_dict
from dquartic_tpu.models import attention as jatt
from dquartic_tpu.models import layers as jlayers
from dquartic_tpu_torch.compat.jax_params import torch_to_jax_params
from dquartic_tpu_torch.models import UNet1d
from dquartic_tpu_torch.models import attention as tatt
from dquartic_tpu_torch.models import layers as tlayers
from dquartic_tpu_torch.utils.builder import build_model
from dquartic_tpu_torch.utils.config import load_train_config
from test_torch_model import SMALL, random_params

# float32 on both sides, summation order only (the layer tolerance of
# tests/test_torch_model.py); the transformer stacks residual layers whose
# outputs grow to O(10), hence the same 1e-4 as the whole model there.
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
STACK_TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_leaf(tree, torch_name):
    """The value of a port parameter in a JAX module tree, by its torch
    name: ``layers.{i}.{0,1}`` -> ``layers_{i}_{attn,ff}``; ``weight`` ->
    the conv kernel transposed; ``g``/``b`` -> reshaped to (1, C, 1)."""
    parts, path = torch_name.split("."), []
    i = 0
    while i < len(parts) - 1:
        if parts[i] == "layers":
            path.append(f"layers_{parts[i + 1]}_{('attn', 'ff')[int(parts[i + 2])]}")
            i += 3
        else:
            path.append(parts[i])
            i += 1
    node = tree["params"]
    for key in path:
        node = node[key]
    leaf = parts[-1]
    if leaf == "weight":
        return np.transpose(np.asarray(node["kernel"]), (2, 1, 0))
    if leaf == "bias":
        return np.asarray(node["bias"])
    return np.asarray(node[leaf]).reshape(1, -1, 1)


def _both(jmod, tmod, x, cond=None, seed=0):
    """JAX module (feature-last) and port module (channel-first) on the same
    weights and input; returns (port, jax) outputs feature-last."""
    jargs = (x,) if cond is None else (x, cond)
    params = random_params(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), *jargs), seed)
    ref = jmod.apply(params, *map(jnp.asarray, jargs))
    tmod.load_state_dict({n: _t(_jax_leaf(params, n)) for n in tmod.state_dict()}, strict=True)
    targs = [_t(a).transpose(1, 2) for a in jargs]
    with torch.no_grad():
        out = tmod(*targs).transpose(1, 2)
    return out.numpy(), np.asarray(ref)


def _x(b, n, c, seed):
    return np.random.default_rng(seed).normal(size=(b, n, c)).astype(np.float32)


# --------------------------------------------------------------------- #
# modules                                                               #
# --------------------------------------------------------------------- #


def test_layernorm1d_matches_jax():
    x = _x(2, 12, 48, 1) * 3 + 1
    out, ref = _both(jlayers.LayerNorm1d(48), tlayers.LayerNorm1d(48), x, seed=2)
    np.testing.assert_allclose(out, ref, **LAYER_TOL)


def test_feedforward1d_matches_jax():
    out, ref = _both(jlayers.FeedForward1d(32), tlayers.FeedForward1d(32), _x(2, 10, 32, 3),
                     seed=4)
    np.testing.assert_allclose(out, ref, **LAYER_TOL)


@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
@pytest.mark.parametrize("cross", [False, True])
def test_attention_matches_jax(attn_impl, cross):
    x, cond = _x(2, 10, 24, 5), _x(2, 10, 16, 6)
    jmod = jatt.Attention(24, use_xattn=cross, cond_dim=16, attn_impl=attn_impl)
    tmod = tatt.Attention(24, cond_dim=16 if cross else None, attn_impl=attn_impl)
    out, ref = _both(jmod, tmod, x, cond if cross else None, seed=7)
    np.testing.assert_allclose(out, ref, **LAYER_TOL)


@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
def test_hybrid_attention_matches_jax(attn_impl):
    jmod = jatt.HybridSelfAndCrossAttention(32, cond_dim=16, attn_impl=attn_impl)
    tmod = tatt.HybridSelfAndCrossAttention(32, cond_dim=16, attn_impl=attn_impl)
    out, ref = _both(jmod, tmod, _x(2, 8, 32, 8), _x(2, 8, 16, 9), seed=10)
    np.testing.assert_allclose(out, ref, **LAYER_TOL)


@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
@pytest.mark.parametrize("depth,use_xattn", [(2, False), (2, True), (4, False), (4, True)])
def test_transformer1d_matches_jax(attn_impl, depth, use_xattn):
    x, cond = _x(2, 6, 64, 11), _x(2, 6, 16, 12)
    kw = dict(depth=depth, use_xattn=use_xattn, cond_dim=16, attn_impl=attn_impl)
    out, ref = _both(jatt.Transformer1d(64, **kw), tatt.Transformer1d(64, **kw), x,
                     cond if use_xattn else None, seed=13)
    np.testing.assert_allclose(out, ref, **STACK_TOL)


# --------------------------------------------------------------------- #
# parameter mapping and builder                                         #
# --------------------------------------------------------------------- #


def test_torch_to_jax_params_equals_converter_for_simple_model():
    torch.manual_seed(0)
    sd = {k: v.numpy() for k, v in UNet1d(**SMALL, fused_resnet=True).state_dict().items()}
    got = _flat(torch_to_jax_params(sd, SMALL["dim_mults"]))
    ref = _flat(convert_unet1d_state_dict(sd, SMALL["dim_mults"]))
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("trainable", [False, True])
def test_build_model_simple_false_norm_params(trainable):
    """LayerNorm1d's bias starts at 0 and, as every norm gain, stays
    float32 in a bf16 serving model."""
    cfg = load_train_config("dquartic_train_config.json")
    cfg["model"]["UNet1d"].update(dim_mults=[1, 2], downsample_dim=64, simple=False)
    cfg["tpu"].update(compute_dtype="bfloat16", attn_impl="pallas")
    model = build_model(json.loads(json.dumps(cfg)), device="cpu", seed=1, trainable=trainable)
    params = dict(model.named_parameters())
    biases = [n for n in params if n.endswith(".b")]
    assert len(biases) == 6  # the FeedForward1d norms: 2 tower layers + 4 mid layers
    for n, p in params.items():
        if n.endswith((".g", ".b")) or trainable:
            assert p.dtype == torch.float32, n
        else:
            assert p.dtype == torch.bfloat16, n
    assert all(not params[n].any() for n in biases)
    assert all(m.attn_impl == "pallas" for m in model.modules() if hasattr(m, "attn_impl"))
