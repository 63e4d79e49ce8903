"""The port's layers and UNet1d against the JAX package on the same weights.

Weights are made with numpy from a seed in the JAX tree's shapes and
carried to the port by ``jax_params_to_torch``; inputs are shared numpy
arrays. Everything runs in float32 on the CPU, where the port's kernel
wrappers run their plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dquartic_tpu.compat.torch_ckpt import convert_unet1d_state_dict
from dquartic_tpu.models import UNet1d as JaxUNet1d
from dquartic_tpu.models import attention as jatt
from dquartic_tpu.models import layers as jlayers
from dquartic_tpu.ops.quantization import quantize_mid_block_params as jax_quantize_mid
from dquartic_tpu_torch.compat.jax_params import jax_params_to_torch
from dquartic_tpu_torch.models import UNet1d
from dquartic_tpu_torch.models import attention as tatt
from dquartic_tpu_torch.models import layers as tlayers
from dquartic_tpu_torch.ops.quantization import quantize_mid_block_params

SMALL = dict(
    dim=4, channels=1, dim_mults=(1, 2, 2), conditional=True, init_cond_channels=1,
    attn_cond_channels=1, downsample_dim=256, simple=True,
)
RT, MZ = 4, 256

# float32 on both sides. Each layer differs only in summation order
# (~1e-6 relative); through the 3-level net with its RMSNorms and the
# residual stream that grows to O(10) the differences stay below 1e-4.
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def random_params(shapes, seed):
    """Numpy weights in a flax tree's shapes: gains ~1, small biases,
    kernels N(0, 1/fan_in)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path[-1:])
        if "'g'" in name:
            return (1.0 + 0.1 * rng.normal(size=s.shape)).astype(np.float32)
        if "bias" in name:
            return (0.1 * rng.normal(size=s.shape)).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _inputs(b, seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.normal(size=(b, RT, MZ)).astype(np.float32),
        t=rng.integers(0, 1000, size=(b,)).astype(np.int32),
        ic=rng.uniform(-1, 1, size=(b, RT, MZ)).astype(np.float32),
        ac=rng.uniform(-1, 1, size=(b, RT)).astype(np.float32),
    )


@pytest.fixture(scope="module")
def jax_model():
    model = JaxUNet1d(**SMALL)
    i = _inputs(1)
    shapes = jax.eval_shape(
        model.init, jax.random.PRNGKey(0), i["x"], i["t"], i["ic"], i["ac"]
    )
    return model, random_params(shapes, seed=1)


def _port(params, quantized=False):
    model = UNet1d(**SMALL, fused_resnet=True)
    if quantized:
        quantize_mid_block_params(model)
    sd = {k: _t(v) for k, v in jax_params_to_torch(params, SMALL["dim_mults"]).items()}
    model.load_state_dict(sd, strict=True)
    return model.eval()


def _run_port(model, i):
    with torch.no_grad():
        return model(_t(i["x"]), _t(i["t"]).long(), _t(i["ic"]), _t(i["ac"])).numpy()


def test_sinusoidal_pos_emb_matches_jax():
    t = np.array([0, 1, 17, 999], np.int32)
    np.testing.assert_allclose(
        tlayers.sinusoidal_pos_emb(_t(t), 16).numpy(),
        np.asarray(jlayers.sinusoidal_pos_emb(jnp.asarray(t), 16)),
        **LAYER_TOL,
    )


def test_rope_rotate_matches_jax():
    x = np.random.default_rng(2).normal(size=(2, 4, 34, 32)).astype(np.float32)
    np.testing.assert_allclose(
        tatt.rope_rotate(_t(x), 16).numpy(), np.asarray(jatt.rope_rotate(jnp.asarray(x), 16)),
        **LAYER_TOL,
    )


def test_cross_attention_matches_jax():
    rng = np.random.default_rng(3)
    dim, cond_dim, n = 24, 8, 34
    x = rng.normal(size=(2, n, dim)).astype(np.float32)  # JAX feature-last
    cond = rng.normal(size=(2, n, cond_dim)).astype(np.float32)
    m = jatt.Attention(dim, use_xattn=True, cond_dim=cond_dim)
    params = random_params(jax.eval_shape(m.init, jax.random.PRNGKey(0), x, cond), 4)
    ref = m.apply(params, jnp.asarray(x), cond=jnp.asarray(cond))

    port = tatt.Attention(dim, cond_dim=cond_dim)
    p = params["params"]
    port.load_state_dict({
        "to_qv.weight": _t(np.transpose(p["to_qv"]["kernel"], (2, 1, 0))),
        "to_k.weight": _t(np.transpose(p["to_k"]["kernel"], (2, 1, 0))),
        "to_out.weight": _t(np.transpose(p["to_out"]["kernel"], (2, 1, 0))),
        "to_out.bias": _t(p["to_out"]["bias"]),
    })
    with torch.no_grad():
        out = port(_t(x).transpose(1, 2), _t(cond).transpose(1, 2)).transpose(1, 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **LAYER_TOL)


@pytest.mark.parametrize("kind", ["down", "up"])
def test_down_and_upsample_match_jax(kind):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 64, 8)).astype(np.float32)  # JAX (b, L, C)
    m = jlayers.Downsample(12) if kind == "down" else jlayers.Upsample(12)
    params = random_params(jax.eval_shape(m.init, jax.random.PRNGKey(0), x), 6)
    ref = m.apply(params, jnp.asarray(x))
    port = tlayers.Downsample(8, 12) if kind == "down" else tlayers.Upsample(8, 12)
    conv = port if kind == "down" else port[1]
    c = params["params"]["conv"]
    conv.weight.data = _t(np.transpose(c["kernel"], (2, 1, 0)))
    conv.bias.data = _t(c["bias"])
    with torch.no_grad():
        out = port(_t(x).transpose(1, 2)).transpose(1, 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **LAYER_TOL)


def test_state_dict_round_trips_through_jax_converter(jax_model):
    """The port's names and layouts are the reference torch ones: the JAX
    converter maps the port's state_dict back onto the JAX tree exactly."""
    _, params = jax_model
    port = _port(params)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    back = convert_unet1d_state_dict(sd, SMALL["dim_mults"])
    flat_a = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    flat_b = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    assert flat_a.keys() == flat_b.keys()
    for k in flat_a:
        np.testing.assert_array_equal(flat_a[k], flat_b[k], err_msg=jax.tree_util.keystr(k))


@pytest.mark.parametrize("b", [1, 2])
def test_unet_matches_jax_xla_config(jax_model, b):
    model, params = jax_model
    i = _inputs(b, seed=b)
    ref = model.apply(params, i["x"], i["t"], i["ic"], i["ac"])
    out = _run_port(_port(params), i)
    assert out.shape == (b, RT, MZ)
    np.testing.assert_allclose(out, np.asarray(ref), **MODEL_TOL)


@pytest.mark.parametrize("b", [1, 2])
def test_unet_matches_jax_kernel_config(jax_model, b):
    """The JAX shipping inference config — fused ResnetBlocks, the pallas_t
    linear-attention kernel and int8 mid convs, Pallas in interpret mode —
    against the port on the same int8 weights."""
    model, params = jax_model
    kmodel = model.clone(fused_resnet=True, linear_attn_impl="pallas_t", quantize_mid=True)
    qparams = jax_quantize_mid(params)
    i = _inputs(b, seed=10 + b)
    ref = kmodel.apply(qparams, i["x"], i["t"], i["ic"], i["ac"])
    out = _run_port(_port(qparams, quantized=True), i)
    np.testing.assert_allclose(out, np.asarray(ref), **MODEL_TOL)


def test_unet_rejects_bad_mz(jax_model):
    _, params = jax_model
    i = _inputs(1)
    i = {k: (v[..., :102] if k in ("x", "ic") else v) for k, v in i.items()}
    with pytest.raises(ValueError, match="divisible"):
        _run_port(_port(params), i)
