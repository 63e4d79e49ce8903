"""FourierFeatures and the generic int8 quantization of the port against
the JAX package: the Fourier filter on the same input and weight (the
port channel-first, JAX feature-last), ``quantize_params`` and
``dequantize_params`` bitwise on Dense and Conv leaves (transposed to the
flax layout), ``apply_quantized``, ``quantized_nbytes``, and
``stochastic_round_to_int8``. Everything runs on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dquartic_tpu.models import CustomTransformer as JaxCT
from dquartic_tpu.models import FourierFeatures as JaxFourier
from dquartic_tpu.models import UNet1d as JaxUNet1d
from dquartic_tpu.ops import quantization as jq
from dquartic_tpu_torch.compat.jax_params import jax_params_to_torch
from dquartic_tpu_torch.models import CustomTransformer, FourierFeatures, UNet1d
from dquartic_tpu_torch.ops import quantization as tq
from test_torch_custom_transformer import CT, random_ct_params
from test_torch_model import random_params

# float32 FFTs on both sides (pocketfft / ducc): summation order only
FOURIER_TOL = dict(rtol=1e-4, atol=1e-5)
TINY = dict(dim=4, channels=1, dim_mults=(1, 2), conditional=True, init_cond_channels=1,
            attn_cond_channels=1, downsample_dim=64, simple=True)
RT, MZ = 4, 64
# float32 models run on the same dequantized weights: 1e-4, the model
# tolerance of tests/test_torch_model.py
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------- #
# FourierFeatures                                                       #
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("h, w, dim", [(12, 6, 3), (10, 7, 2), (40, 34, 4)])
def test_fourier_matches_jax(h, w, dim):
    """The port takes (b, dim, h, w); JAX (b, h, w, dim): the test
    transposes. The weight (dim, h, w, 2) carries across as it is."""
    rng = np.random.default_rng(h)
    x = rng.normal(size=(2, h, w, dim)).astype(np.float32)
    weight = (rng.normal(size=(dim, h, w, 2)) * 0.1).astype(np.float32)
    ref = JaxFourier(dim=dim, h=h, w=w).apply({"params": {"complex_weight": weight}},
                                              jnp.asarray(x))
    m = FourierFeatures(dim, h, w)
    m.load_state_dict({"complex_weight": _t(weight)})
    with torch.no_grad():
        out = m(_t(np.transpose(x, (0, 3, 1, 2))))
    np.testing.assert_allclose(out.numpy(), np.transpose(np.asarray(ref), (0, 3, 1, 2)),
                               **FOURIER_TOL)


def test_fourier_identity_weight_and_dtype():
    h, w, dim = 12, 6, 3
    x = _t(np.random.default_rng(0).normal(size=(2, dim, h, w)).astype(np.float32))
    m = FourierFeatures(dim, h, w, dtype=torch.bfloat16)
    assert m.complex_weight.shape == (dim, h, w, 2)
    with torch.no_grad():
        m.complex_weight.copy_(torch.stack([torch.ones(dim, h, w), torch.zeros(dim, h, w)], -1))
        out = m(x)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), x.numpy(), rtol=2 ** -7, atol=1e-5)


# --------------------------------------------------------------------- #
# generic quantization                                                  #
# --------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def unet_params():
    model = JaxUNet1d(**TINY)
    x = np.zeros((1, RT, MZ), np.float32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), x, np.zeros((1,), np.int32), x,
                            np.zeros((1, RT), np.float32))
    return model, random_params(shapes, seed=3)


@pytest.fixture(scope="module")
def ct_params():
    model = JaxCT(**CT)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), np.zeros((1, 8, 64), np.float32),
                            np.zeros((1,), np.int32), None, np.zeros((1, 8), np.float32))
    return model, random_ct_params(shapes, seed=4)


def _jax_in_torch_layout(params, jqt, suffix):
    """JAX's quantized leaves ending in ``suffix`` (int8 values or scales,
    as float32 broadcast to their parameter's shape) in the port's names
    and layouts, through the port's map; a leaf JAX left unquantized is
    NaN."""
    def walk(p, q):
        out = {}
        for k, v in p.items():
            if isinstance(v, dict):
                out[k] = walk(v, q[k])
            elif k + suffix in q:
                out[k] = np.broadcast_to(np.asarray(q[k + suffix], np.float32), np.shape(v))
            else:
                out[k] = np.full(np.shape(v), np.nan, np.float32)
        return out

    return jax_params_to_torch(walk(params["params"], jqt))


@pytest.mark.parametrize("family", ["unet", "custom_transformer"])
def test_quantize_params_is_jax_bitwise(family, unet_params, ct_params):
    """Per output channel: JAX's last flax axis is the port's axis 0, so on
    every Dense and Conv leaf the int8 values and the scales are JAX's,
    transposed, bit for bit, and the same leaves pass through; dequantized
    weights are JAX's bit for bit; the byte counts agree."""
    _, params = unet_params if family == "unet" else ct_params
    sd = {k: _t(v) for k, v in jax_params_to_torch(params).items()}
    min_size = 256
    jqt = jq.quantize_params(params["params"], min_size=min_size)
    qsd = tq.quantize_params(sd, min_size=min_size)
    values = _jax_in_torch_layout(params, jqt, tq.QUANT_SUFFIX_VALUES)
    scales = _jax_in_torch_layout(params, jqt, tq.QUANT_SUFFIX_SCALE)
    n_quantized = 0
    for name, v in sd.items():
        if name + tq.QUANT_SUFFIX_VALUES not in qsd:
            assert name in qsd and np.isnan(values[name]).all(), name
            continue
        n_quantized += 1
        q, scale = qsd[name + tq.QUANT_SUFFIX_VALUES], qsd[name + tq.QUANT_SUFFIX_SCALE]
        assert q.dtype == torch.int8 and scale.dtype == torch.float32 and q.shape == v.shape
        assert np.array_equal(q.float().numpy(), values[name]), name
        assert np.array_equal(np.broadcast_to(scale.numpy(), v.shape), scales[name]), name
    assert n_quantized > 0

    deq_j = jax_params_to_torch({"params": jq.dequantize_params(jqt)})
    deq = tq.dequantize_params(qsd)
    assert deq.keys() == sd.keys()
    for k in sd:
        assert deq[k].dtype == torch.float32
        assert np.array_equal(deq[k].numpy(), deq_j[k]), k
    assert tq.quantized_nbytes(qsd) == jq.quantized_nbytes(jqt)
    assert tq.quantized_nbytes(qsd) < 0.5 * tq.quantized_nbytes(sd)


def test_apply_quantized_matches_dequantized_model(unet_params):
    """apply_quantized runs the model on the dequantized weights
    (functional_call) without touching its own: the model loaded with them
    to float32 summation order (the CPU convolutions take another path on
    the swapped-in tensors: 3e-6 apart, repeatable), and at the model
    tolerance JAX's apply_quantized."""
    jmodel, params = unet_params
    rng = np.random.default_rng(5)
    x = rng.normal(size=(1, RT, MZ)).astype(np.float32)
    t = np.array([400], np.int32)
    ic = rng.uniform(-1, 1, size=(1, RT, MZ)).astype(np.float32)
    ac = rng.uniform(-1, 1, size=(1, RT)).astype(np.float32)
    model = UNet1d(**TINY, fused_resnet=True).eval()
    model.load_state_dict({k: _t(v) for k, v in jax_params_to_torch(params).items()})
    before = {k: v.clone() for k, v in model.state_dict().items()}
    qsd = tq.quantize_params(model.state_dict(), min_size=1024)
    args = (_t(x), _t(t).long(), _t(ic), _t(ac))
    with torch.no_grad():
        out = tq.apply_quantized(model, qsd, *args)
        assert all(torch.equal(v, model.state_dict()[k]) for k, v in before.items())
        model.load_state_dict(tq.dequantize_params(qsd))
        np.testing.assert_allclose(out.numpy(), model(*args).numpy(), rtol=1e-5, atol=1e-5)
    ref = jq.apply_quantized(jmodel, jq.quantize_params(params, min_size=1024), x, t, ic, ac)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **MODEL_TOL)


def test_quantized_custom_transformer_serves_close_to_float(ct_params):
    _, params = ct_params
    model = CustomTransformer(**CT).eval()
    model.load_state_dict({k: _t(v) for k, v in jax_params_to_torch(params).items()})
    rng = np.random.default_rng(6)
    args = (_t(rng.normal(size=(2, 8, 64)).astype(np.float32)), torch.tensor([3, 700]), None,
            _t(rng.uniform(0, 1, (2, 8)).astype(np.float32)))
    with torch.no_grad():
        ref = model(*args)
        out = tq.apply_quantized(model, tq.quantize_params(model.state_dict(), min_size=256), *args)
    # per-channel int8: each weight within scale/2 = absmax/254 of its own
    assert float((out - ref).norm() / ref.norm()) < 0.05


def test_stochastic_rounding_unbiased_and_reproducible():
    """JAX's test (tests/test_quantization.py): the mean over 20 draws of a
    constant 0.25 lands within 0.01; the port's draws come from its
    generator, so one seed gives one result and another seed another."""
    x = torch.full((8, 1000), 0.25)
    qs = []
    for i in range(20):
        q, s = tq.stochastic_round_to_int8(x, torch.Generator().manual_seed(i))
        assert q.dtype == torch.int8 and s.shape == (8, 1)
        qs.append(q.float() * s)
    assert abs(float(torch.stack(qs).mean()) - 0.25) < 0.01
    rng = np.random.default_rng(7)
    y = _t(rng.normal(size=(16, 40)).astype(np.float32))
    a = tq.stochastic_round_to_int8(y, torch.Generator().manual_seed(1))
    b = tq.stochastic_round_to_int8(y, torch.Generator().manual_seed(1))
    c = tq.stochastic_round_to_int8(y, torch.Generator().manual_seed(2))
    assert torch.equal(a[0], b[0]) and not torch.equal(a[0], c[0])
    # floor or ceil of x / scale, per row's scale (JAX's, transposed)
    _, js = jq.stochastic_round_to_int8(jnp.asarray(y.numpy().T), jax.random.PRNGKey(0))
    assert np.array_equal(a[1].numpy(), np.asarray(js).T)
    scaled = y / a[1]
    assert bool(((a[0].float() == torch.floor(scaled)) | (a[0].float() == torch.ceil(scaled))).all())
