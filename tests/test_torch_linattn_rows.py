"""The row-blocked linear-attention ops (K8 single call, K9 two calls), the
``linear_attn_impl`` dispatch and the unfused UNet1d against the JAX
package, and the builder's routing of ``linear_attn_impl``,
``fused_resnet``, ``remat_linear_attn`` and the device.

Inputs and weights are made with numpy from a seed and handed to both
packages. On the CPU the port's ops run their plain versions; the JAX
package's Pallas kernels run in interpret mode, as
``tests/test_linear_attention_fused.py`` runs them. The CUDA kernels are
held against the plain versions by the tests marked ``cuda``, which skip
without a card; on a CUDA machine without JAX, run them with

    python -m pytest tests/test_torch_linattn_rows.py -m cuda --noconftest -q
"""

import json

import numpy as np
import pytest
import torch

import dquartic_tpu_torch.models.attention as tatt
import dquartic_tpu_torch.ops.linear_attention as tla
from dquartic_tpu_torch.models import UNet1d
from dquartic_tpu_torch.models.fused_blocks import ResnetBlockT
from test_torch_ops import _AtenLog
from test_torch_train_ops import _ALLOCATIONS

try:  # the JAX reference; a CUDA machine without JAX runs only `-m cuda`
    import jax
    import jax.numpy as jnp

    from dquartic_tpu.core import DDIMProcess as JaxDDIMProcess
    from dquartic_tpu.core import make_schedule as jax_make_schedule
    from dquartic_tpu.models import UNet1d as JaxUNet1d
    from dquartic_tpu.models import attention as jatt
    from dquartic_tpu.ops import linear_attention as jla
    from test_torch_model import random_params
except ImportError:
    jax = jnp = JaxDDIMProcess = jax_make_schedule = JaxUNet1d = jatt = jla = None

# The tolerances of tests/test_linear_attention_fused.py for the same
# kernels: float32 2e-4 / 2e-5 (sums over N in another order), bf16 5e-2
# (the output rounds once to bf16). Whole models: MODEL_TOL of
# tests/test_torch_model.py; gradients: GRAD_TOL of
# tests/test_torch_unet_tfer.py.
OP_TOL = dict(rtol=2e-4, atol=2e-5)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)
MODULE_TOL = dict(rtol=1e-4, atol=1e-4)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = 1e-4

SMALL = dict(dim=4, channels=1, dim_mults=(1, 2, 2), conditional=True, init_cond_channels=1,
             attn_cond_channels=1, downsample_dim=256, simple=True)
RT, MZ = 4, 256


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels only run on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _weights(C, seed, heads=4, dim_head=32):
    rng = np.random.default_rng(seed)
    H = heads * dim_head
    return [(rng.normal(size=s) * sc).astype(np.float32)
            for s, sc in (((C, 3 * H), 0.1), ((H, C), 0.1), ((C,), 0.1), ((C,), 1.0))]


def _x(B, N, C, seed):
    return np.random.default_rng(seed).normal(size=(B, N, C)).astype(np.float32)


def _t(a, dtype="float32", device="cpu"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=getattr(torch, dtype))


def _j(a, dtype="float32"):
    return jnp.asarray(a).astype(getattr(jnp, dtype))


def _np(x):
    return np.asarray(x.float() if torch.is_tensor(x) else x.astype(jnp.float32), np.float32)


# --------------------------------------------------------------------- #
# the ops against the JAX kernels (interpret mode)                      #
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("C", [4, 8, 16])
@pytest.mark.parametrize("N", [1, 64, 700, 1025])
def test_k8_op_matches_jax(N, C):
    """``fused_linear_attention`` (its plain version on CPU tensors) against
    the JAX ``fused_linear_attention`` (K8, ``_fused_forward_single``)."""
    w = _weights(C, seed=C)
    x = _x(2, N, C, seed=N)
    ref = jla.fused_linear_attention(_j(x), *map(_j, w))
    out = tla.fused_linear_attention(_t(x), *map(_t, w))
    assert out.shape == (2, N, C) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **OP_TOL)


@pytest.mark.parametrize("C", [4, 16])
@pytest.mark.parametrize("N", [1, 700, 1025])
def test_k9_op_matches_jax(N, C):
    """``fused_linear_attention_two_call`` against JAX ``_fused_forward``
    (K9) with 512-row blocks, so N = 700 and 1025 span blocks."""
    w = _weights(C, seed=10 + C)
    x = _x(2, N, C, seed=10 + N)
    ref = jla._fused_forward(_j(x), *map(_j, w), 4, 32, 512, None)
    out = tla.fused_linear_attention_two_call(_t(x), *map(_t, w))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **OP_TOL)


@pytest.mark.parametrize("N,C", [(700, 4), (1025, 16)])
def test_k9_plain_launches_compose_to_jax(N, C):
    """The plain versions of K9's two launches, the context mode's M then
    the apply mode's y, composed, against JAX ``_fused_forward`` with
    512-row blocks (interpret mode)."""
    w = _weights(C, seed=40 + C)
    x = _x(2, N, C, seed=40 + N)
    ref = jla._fused_forward(_j(x), *map(_j, w), 4, 32, 512, None)
    m = tla.rows_context_reference(_t(x), w_qkv=_t(w[0]), w_out=_t(w[1]))
    assert m.shape == (2, C, 128) and m.dtype == torch.float32
    out = tla.rows_apply_reference(_t(x), m, _t(w[0]), _t(w[2]), _t(w[3]))
    assert out.shape == (2, N, C) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **OP_TOL)


@pytest.mark.parametrize("two_call", [False, True])
def test_rows_ops_bf16_match_jax(two_call):
    """bf16 inputs, float32 weights: the output in bf16, against the JAX
    kernel on the same bf16 values."""
    w = _weights(8, seed=20)
    x = _x(2, 300, 8, seed=21)
    if two_call:
        ref = jla._fused_forward(_j(x, "bfloat16"), *map(_j, w), 4, 32, 512, None)
        out = tla.fused_linear_attention_two_call(_t(x, "bfloat16"), *map(_t, w))
    else:
        ref = jla.fused_linear_attention(_j(x, "bfloat16"), *map(_j, w))
        out = tla.fused_linear_attention(_t(x, "bfloat16"), *map(_t, w))
    assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    np.testing.assert_allclose(_np(out), _np(ref), **BF16_TOL)


def test_k8_op_gradient_is_the_reference_gradient():
    """On CPU tensors autograd differentiates the plain reference: its
    gradients equal ``jax.grad`` of the JAX op (whose ``_fused`` custom_vjp
    differentiates the same reference)."""
    w = _weights(4, seed=30)
    x = _x(1, 96, 4, seed=31)

    def jloss(*a):
        return jnp.sum(jla.fused_linear_attention(*a) ** 2)

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(_j(x), *map(_j, w))
    ts = [_t(a).requires_grad_(True) for a in (x, *w)]
    (tla.fused_linear_attention(*ts) ** 2).sum().backward()
    for t, g in zip(ts, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("x_grad", [True, False])
def test_k8_function_gradient_is_the_reference_vjp(monkeypatch, x_grad):
    """The op's autograd function on CUDA tensors (here with the kernel's
    launch replaced by its plain version on the CPU): the kernel is the
    primal, and the gradient of every input that wants one is ``jax.grad``
    of the JAX op; an input that wants none gets none."""
    def launcher(op, x, *a, two_call):
        y = torch.empty_like(x)
        return lambda: y.copy_(tla.linear_attention_rows_reference(x, *a)), y

    monkeypatch.setattr(tla, "rows_launcher", launcher)
    w = _weights(8, seed=32)
    x = _x(2, 130, 8, seed=33)
    jg = jax.grad(lambda *a: jnp.sum(jla.fused_linear_attention(*a) ** 2),
                  argnums=(0, 1, 2, 3, 4))(_j(x), *map(_j, w))
    ts = [_t(x).requires_grad_(x_grad)] + [_t(a).requires_grad_(True) for a in w]
    before = tla.fused_linear_attention.launches
    y = tla._RowsFn.apply(*ts, 4, 32)
    assert tla.fused_linear_attention.launches == before + 1
    (y**2).sum().backward()
    assert (ts[0].grad is not None) == x_grad
    for t, g in zip(ts, jg):
        if t.requires_grad:
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["channel_first", "row_major"])
def test_k8_wrapper_hands_the_weights_over_as_they_are(monkeypatch, dtype, layout):
    """K8's wrapper runs no aten op but y's allocation: one launch, which
    gets x's and y's own memory and strides (the model's channel-first
    memory through its transposed view, or row-major x) and the weights'
    own memory, strides and dtypes (the module's views of its conv weights
    in the compute dtype, float32 gains: no cast, transpose or scaling on
    the host), and the counter advances by one."""
    calls = []

    class FakeLibrary:
        def dq_linear_attention_rows_fused(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(tla, "_check_rows_args", lambda *a: None)
    monkeypatch.setattr(tla._build, "library", FakeLibrary)
    monkeypatch.setattr(tla._build, "stream_of", lambda t: 0)
    dt = getattr(torch, dtype)
    B, N, C, H = 2, 10, 4, 128
    w_qkv, w_out, b_out, g = map(_t, _weights(C, seed=140))
    conv_qkv, conv_out = w_qkv.t().contiguous().to(dt), w_out.t().contiguous().to(dt)
    w = [conv_qkv.t(), conv_out.t(), b_out.to(dt).reshape(1, C, 1), g]
    xc = _t(np.random.default_rng(141).normal(size=(B, C, N))).to(dt)
    x = xc.transpose(1, 2) if layout == "channel_first" else xc.transpose(1, 2).contiguous()
    before = tla.fused_linear_attention.launches
    with _AtenLog() as log:
        y = tla._rows_kernel(x, *w, 4, 32)
    assert set(log.ops) <= _ALLOCATIONS, log.ops
    assert tla.fused_linear_attention.launches == before + 1
    (args,) = calls
    assert args[:2] == (x.data_ptr(), y.data_ptr())
    assert args[2:8] == (*x.stride(), *y.stride()) and y.stride() == x.stride()
    assert args[8:14] == (conv_qkv.data_ptr(), 1, C, conv_out.data_ptr(), 1, H)
    assert args[14:18] == (w[2].data_ptr(), 1, g.data_ptr(), 1)
    bits = 0b0111 if dtype == "bfloat16" else 0  # w_qkv, w_out, b_out in the compute dtype
    # B, C, N, heads, weight dtype bits, bf16 x, device
    assert args[18:25] == (B, C, N, 4, bits, int(dtype == "bfloat16"), 0)
    assert y.shape == x.shape and y.dtype == dt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["channel_first", "row_major"])
def test_k9_wrapper_hands_the_weights_over_as_they_are(monkeypatch, dtype, layout):
    """K9's launch runs no aten op but the allocations of y and of the rows'
    M, float32 (B, C, H): one call of its entry point, which gets K8's
    arguments (x's and y's own memory and strides, the weights' own
    memory, strides and dtypes) and M after the weights."""
    calls = []

    class FakeLibrary:
        def dq_linear_attention_rows(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(tla, "_check_rows_args", lambda *a: None)
    monkeypatch.setattr(tla._build, "library", FakeLibrary)
    monkeypatch.setattr(tla._build, "stream_of", lambda t: 0)
    dt = getattr(torch, dtype)
    B, N, C, H = 2, 10, 4, 128
    w_qkv, w_out, b_out, g = map(_t, _weights(C, seed=142))
    conv_qkv, conv_out = w_qkv.t().contiguous().to(dt), w_out.t().contiguous().to(dt)
    w = [conv_qkv.t(), conv_out.t(), b_out.to(dt).reshape(1, C, 1), g]
    xc = _t(np.random.default_rng(143).normal(size=(B, C, N))).to(dt)
    x = xc.transpose(1, 2) if layout == "channel_first" else xc.transpose(1, 2).contiguous()
    with _AtenLog() as log:
        launch, y = tla.rows_launcher("fused_linear_attention_two_call", x, *w, 4, 32,
                                      two_call=True)
        launch()
    assert set(log.ops) <= _ALLOCATIONS and len(log.ops) == 2, log.ops
    (args,) = calls
    assert args[:2] == (x.data_ptr(), y.data_ptr())
    assert args[2:8] == (*x.stride(), *y.stride()) and y.stride() == x.stride()
    assert args[8:14] == (conv_qkv.data_ptr(), 1, C, conv_out.data_ptr(), 1, H)
    assert args[14:18] == (w[2].data_ptr(), 1, g.data_ptr(), 1)
    m = launch.tensors[2]
    assert m.shape == (B, C, H) and m.dtype == torch.float32 and args[18] == m.data_ptr()
    bits = 0b0111 if dtype == "bfloat16" else 0
    assert args[19:26] == (B, C, N, 4, bits, int(dtype == "bfloat16"), 0)
    assert y.shape == x.shape and y.dtype == dt


# --------------------------------------------------------------------- #
# the LinearAttention module by impl                                    #
# --------------------------------------------------------------------- #


def _module_pair(C, impl, dtype, seed):
    """The JAX module and the port's on the same weights; the port's
    parameters stay float32, as flax's do, whatever the compute dtype."""
    w_qkv, w_out, b_out, g = _weights(C, seed)
    jm = jatt.LinearAttention(C, impl=impl, dtype=getattr(jnp, dtype))
    params = {"params": {"to_qkv": {"kernel": w_qkv[None]},
                         "to_out_conv": {"kernel": w_out[None], "bias": b_out},
                         "to_out_norm": {"g": g}}}
    port = tatt.LinearAttention(C, impl=impl)
    port.load_state_dict({
        "to_qkv.weight": _t(w_qkv.T[:, :, None]),
        "to_out.0.weight": _t(w_out.T[:, :, None]),
        "to_out.0.bias": _t(b_out),
        "to_out.1.g": _t(g.reshape(1, -1, 1)),
    })
    return jm, params, port


@pytest.mark.parametrize("impl,dtype", [
    ("xla", "float32"), ("xla", "bfloat16"), ("pallas", "float32"), ("pallas", "bfloat16"),
    ("pallas_t", "float32"),
])
def test_linear_attention_module_matches_jax(impl, dtype):
    """``x + mixer(RMSNorm_{g_pre}(x))`` by each impl against the JAX
    module with the same impl (its Pallas kernels in interpret mode); bf16
    holds the "xla" path's roundings against JAX's."""
    C, N = 8, 200
    jm, params, port = _module_pair(C, impl, dtype, seed=40)
    x = _x(2, N, C, seed=41)
    g_pre = (1.0 + 0.1 * np.random.default_rng(42).normal(size=(C,))).astype(np.float32)
    ref = jm.apply(params, _j(x, dtype), jnp.asarray(g_pre), True)
    with torch.no_grad():
        out = port(_t(x, dtype).transpose(1, 2), _t(g_pre)).transpose(1, 2)
    assert out.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(out), _np(ref), **(MODULE_TOL if dtype == "float32" else BF16_TOL))


def test_auto_resolution(monkeypatch):
    """The JAX rule: an explicit impl wins (an unknown one is the "xla"
    path); "auto" takes DQUARTIC_LINATTN_IMPL when it names an impl, else
    K1 ("pallas_t"), and the "xla" path below DQUARTIC_LINATTN_MIN_SEQ,
    whose default is LINATTN_MIN_SEQ."""
    r = tatt.resolve_linear_attn_impl
    monkeypatch.delenv("DQUARTIC_LINATTN_IMPL", raising=False)
    monkeypatch.delenv("DQUARTIC_LINATTN_MIN_SEQ", raising=False)
    big = max(tatt.LINATTN_MIN_SEQ, 1)
    assert r("auto", big) == "pallas_t"
    if tatt.LINATTN_MIN_SEQ > 1:
        assert r("auto", tatt.LINATTN_MIN_SEQ - 1) == "xla"
    monkeypatch.setenv("DQUARTIC_LINATTN_MIN_SEQ", "100")
    assert r("auto", 99) == "xla" and r("auto", 100) == "pallas_t"
    for impl in ("pallas", "pallas_t", "xla"):
        assert r(impl, 1) == impl  # explicit: no floor
    assert r("nope", 1000) == "xla"
    monkeypatch.setenv("DQUARTIC_LINATTN_IMPL", "pallas")
    assert r("auto", 100) == "pallas" and r("auto", 99) == "xla"
    assert r("pallas_t", 100) == "pallas_t"
    monkeypatch.setenv("DQUARTIC_LINATTN_IMPL", "bogus")
    assert r("auto", 100) == "pallas_t"


def test_module_dispatches_by_impl(monkeypatch):
    """Each impl reaches its op, and ``kernels=False`` the op's plain
    version, with the same numbers in float32."""
    calls = []
    for name in ("linear_attention", "fused_linear_attention"):
        real = getattr(tatt, name)
        monkeypatch.setattr(tatt, name, lambda *a, _n=name, _r=real: calls.append(_n) or _r(*a))
    monkeypatch.delenv("DQUARTIC_LINATTN_IMPL", raising=False)
    monkeypatch.setenv("DQUARTIC_LINATTN_MIN_SEQ", "64")
    _, _, port = _module_pair(4, "auto", "float32", seed=50)
    x, g_pre = _t(_x(2, 64, 4, seed=51)).transpose(1, 2), torch.ones(4)
    outs = {}
    with torch.no_grad():
        for impl, expect in (("pallas_t", ["linear_attention"]),
                             ("pallas", ["fused_linear_attention"]), ("xla", []),
                             ("auto", ["linear_attention"])):
            calls.clear()
            port.impl = impl
            outs[impl] = port(x, g_pre)
            assert calls == expect, impl
        port.impl, port.kernels = "pallas", False
        calls.clear()
        plain = port(x, g_pre)
        assert not calls
        calls.clear()
        port.impl, port.kernels = "auto", True
        port(x[..., :63], g_pre)
        assert calls == []  # "auto" below the floor: the "xla" path
    for impl in ("pallas", "xla"):
        np.testing.assert_allclose(outs[impl].numpy(), outs["pallas_t"].numpy(), **MODULE_TOL)
    np.testing.assert_array_equal(plain.numpy(), outs["pallas"].numpy())


# --------------------------------------------------------------------- #
# the unfused UNet1d against JAX                                        #
# --------------------------------------------------------------------- #


def _unet_inputs(b, seed, rt=RT, mz=MZ):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.normal(size=(b, rt, mz)).astype(np.float32),
        t=rng.integers(0, 1000, size=(b,)).astype(np.int32),
        ic=rng.uniform(-1, 1, size=(b, rt, mz)).astype(np.float32),
        ac=rng.uniform(-1, 1, size=(b, rt)).astype(np.float32),
    )


def _jax_unet_params(cfg, seed):
    i = _unet_inputs(1, 0, mz=cfg["downsample_dim"])
    shapes = jax.eval_shape(JaxUNet1d(**cfg).init, jax.random.PRNGKey(0),
                            i["x"], i["t"], i["ic"], i["ac"])
    return random_params(shapes, seed)


def _port_unet(params, cfg, **kw):
    from dquartic_tpu_torch.compat.jax_params import jax_params_to_torch

    model = UNet1d(**cfg, **kw)
    sd = jax_params_to_torch(params, cfg["dim_mults"])
    model.load_state_dict({k: _t(v) for k, v in sd.items()}, strict=True)
    return model.eval()


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_unfused_unet_matches_jax(impl):
    """UNet1d(fused_resnet=False) with every mixer on ``impl``: plain
    ResnetBlocks and, under "pallas", the K8 op's plain version, against
    ``UNet1d.apply`` with the same flags (its K8 kernel in interpret
    mode), b = 2."""
    params = _jax_unet_params(SMALL, seed=60)
    jmodel = JaxUNet1d(**SMALL, fused_resnet=False, linear_attn_impl=impl)
    i = _unet_inputs(2, seed=61)
    ref = jax.jit(jmodel.apply)(params, i["x"], i["t"], i["ic"], i["ac"])
    port = _port_unet(params, SMALL, fused_resnet=False, linear_attn_impl=impl)
    assert not any(isinstance(m, ResnetBlockT) for m in port.modules())
    with torch.no_grad():
        out = port(_t(i["x"]), torch.from_numpy(i["t"]).long(), _t(i["ic"]), _t(i["ac"]))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **MODEL_TOL)


def test_unfused_unet_simple_false_matches_jax():
    """simple=False under "pallas": the MS1 tower's mixer runs K8 at N = 1
    (the scalar MS1 condition), the U-Net's at N = 64 and 32."""
    cfg = dict(SMALL, dim_mults=(1, 2), downsample_dim=64, simple=False, tfer_depth=2)
    params = _jax_unet_params(cfg, seed=70)
    jmodel = JaxUNet1d(**cfg, fused_resnet=False, linear_attn_impl="pallas")
    i = _unet_inputs(2, seed=71, rt=6, mz=64)
    ref = jax.jit(jmodel.apply)(params, i["x"], i["t"], i["ic"], i["ac"])
    port = _port_unet(params, cfg, fused_resnet=False, linear_attn_impl="pallas")
    with torch.no_grad():
        out = port(_t(i["x"]), torch.from_numpy(i["t"]).long(), _t(i["ic"]), _t(i["ac"]))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **MODEL_TOL)


def test_unfused_unet_pallas_gradients_match_jax():
    """One ``train_loss`` gradient under "pallas" with the JAX rng's (t,
    eps) injected, against ``jax.grad`` (JAX's ``_fused`` custom_vjp: the
    reference's gradient), float32."""
    from dquartic_tpu_torch.compat.jax_params import grads_state_dict, torch_to_jax_params
    from dquartic_tpu_torch.core import DDIMProcess, make_schedule

    params = _jax_unet_params(SMALL, seed=80)
    rng = np.random.default_rng(81)
    x0, ms2 = (rng.uniform(0, 1, (2, RT, MZ)).astype(np.float32) for _ in range(2))
    ms1 = rng.uniform(0, 1, (2, RT)).astype(np.float32)
    key = jax.random.PRNGKey(82)
    t_rng, noise_rng = jax.random.split(key)
    t = np.array(jax.random.randint(t_rng, (2,), 0, 1000))
    eps = np.array(jax.random.normal(noise_rng, x0.shape, dtype=jnp.float32))
    jmodel = JaxUNet1d(**SMALL, fused_resnet=False, linear_attn_impl="pallas")
    jproc = JaxDDIMProcess(schedule=jax_make_schedule(1000, "cosine", "eps"))

    def jloss(p):
        fn = lambda x, tt, ic, ac: jmodel.apply(p, x, tt, ic, ac)  # noqa: E731
        return jproc.train_loss(fn, key, jnp.asarray(x0), jnp.asarray(ms2), jnp.asarray(ms1))[0]

    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    port = _port_unet(params, SMALL, fused_resnet=False, linear_attn_impl="pallas")
    proc = DDIMProcess(schedule=make_schedule(1000, "cosine", "eps"))
    loss, _ = proc.train_loss(port, _t(x0), _t(ms2), _t(ms1), t=torch.tensor(t), eps=_t(eps))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    flat = lambda tree: {jax.tree_util.keystr(k): np.asarray(v)  # noqa: E731
                         for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    got = flat(torch_to_jax_params(grads_state_dict(port), SMALL["dim_mults"]))
    ref = flat(jg)
    assert got.keys() == ref.keys()
    for k in ref:
        err = np.max(np.abs(got[k] - ref[k])) / (np.max(np.abs(ref[k])) + 1e-12)
        assert err < GRAD_TOL, (k, err)


def test_jax_params_carry_the_unfused_tree():
    """The unfused JAX tree has the fused one's structure (``_BlockParams``
    match ``ResnetBlock``), loads into the unfused port strictly and maps
    back unchanged."""
    from dquartic_tpu_torch.compat.jax_params import jax_params_to_torch, torch_to_jax_params

    i = _unet_inputs(1, 0)
    trees = [jax.eval_shape(JaxUNet1d(**SMALL, fused_resnet=f).init, jax.random.PRNGKey(0),
                            i["x"], i["t"], i["ic"], i["ac"]) for f in (False, True)]
    assert jax.tree_util.tree_structure(trees[0]) == jax.tree_util.tree_structure(trees[1])
    params = _jax_unet_params(SMALL, seed=90)
    sd = jax_params_to_torch(params, SMALL["dim_mults"])
    assert sd.keys() == UNet1d(**SMALL, fused_resnet=False).state_dict().keys()
    back = torch_to_jax_params(sd, SMALL["dim_mults"])
    a, b = (jax.tree_util.tree_flatten_with_path(t)[0] for t in (back, params))
    assert [k for k, _ in a] == [k for k, _ in b]
    for (k, u), (_, v) in zip(a, b):
        np.testing.assert_array_equal(u, v, err_msg=jax.tree_util.keystr(k))


# --------------------------------------------------------------------- #
# the builder: routing of the config keys, the device                   #
# --------------------------------------------------------------------- #


def _cfg(tpu=None, unet=None):
    from dquartic_tpu_torch.utils.config import load_train_config

    cfg = load_train_config("dquartic_train_config.json")
    cfg["model"]["UNet1d"].update(dim_mults=[1, 2, 2], downsample_dim=128, **(unet or {}))
    cfg["tpu"].update(tpu or {})
    return json.loads(json.dumps(cfg))


def _mixers(model):
    return [m for m in model.modules() if isinstance(m, tatt.LinearAttention)]


@pytest.mark.parametrize("tpu,unet,expect", [
    ({}, {}, "auto"),
    ({"linear_attn_impl": "xla"}, {}, "xla"),
    ({"linear_attn_impl": "xla"}, {"linear_attn_impl": "pallas"}, "pallas"),
    ({"linear_attn_impl": "pallas_t"}, {"simple": False}, "pallas_t"),
])
def test_config_linear_attn_impl_reaches_every_mixer(tpu, unet, expect):
    """``tpu.linear_attn_impl`` reaches every mixer (the MS1 tower's too),
    and a key in the UNet1d block overrides it, as the JAX builder's
    ``setdefault`` does."""
    from dquartic_tpu_torch.utils.builder import build_model

    model = build_model(_cfg(tpu, unet), device="cpu")
    mixers = _mixers(model)
    assert len(mixers) == 6 + (0 if unet.get("simple", True) else 1)
    assert {m.impl for m in mixers} == {expect}


@pytest.mark.parametrize("tpu_fused,unet_fused,fused", [
    (False, None, False), (True, None, True), (False, True, True), (True, False, True),
])
def test_config_fused_resnet_from_either_place(tpu_fused, unet_fused, fused):
    """``fused_resnet`` is on when the tpu key or the UNet1d key is, as the
    JAX ``build_trainer`` and ``predict`` resolve it; off, the down/up and
    final blocks are plain ResnetBlocks."""
    from dquartic_tpu_torch.utils.builder import build_model, build_trainer

    unet = {} if unet_fused is None else {"fused_resnet": unet_fused}
    cfg = _cfg({"fused_resnet": tpu_fused}, unet)
    for model in (build_model(cfg, device="cpu"), build_trainer(cfg, device="cpu").model):
        n_fused = sum(isinstance(m, ResnetBlockT) for m in model.modules())
        assert model.fused_resnet == fused and n_fused == (13 if fused else 0)


def test_config_pallas_runs_k8_at_every_mixer(monkeypatch):
    """``tpu.linear_attn_impl = "pallas"`` on the unfused model: one K8 op
    call per mixer and no K1 or K2 op call in a forward."""
    from dquartic_tpu_torch.ops import fused_resnet as tfr
    from dquartic_tpu_torch.utils.builder import build_model

    calls = []
    real = tatt.fused_linear_attention
    monkeypatch.setattr(tatt, "fused_linear_attention", lambda *a: calls.append(1) or real(*a))
    monkeypatch.setattr(tatt, "linear_attention", lambda *a: pytest.fail("K1 op called"))
    monkeypatch.setattr(tfr, "fused_resnet_block_t", lambda *a: pytest.fail("K2 op called"))
    model = build_model(_cfg({"linear_attn_impl": "pallas", "compute_dtype": "bfloat16"}),
                        device="cpu")
    rng = np.random.default_rng(100)
    x = _t(rng.normal(size=(1, RT, 128)).astype(np.float32))
    with torch.no_grad():
        out = model(x, torch.tensor([10]), x, _t(rng.uniform(size=(1, RT)).astype(np.float32)))
    assert out.shape == (1, RT, 128) and out.dtype == torch.bfloat16
    assert bool(torch.isfinite(out.float()).all()) and len(calls) == 6


def _grads(model, seed=110):
    rng = np.random.default_rng(seed)
    x, ic = (_t(rng.uniform(-1, 1, (2, RT, 128)).astype(np.float32)) for _ in range(2))
    ac = _t(rng.uniform(-1, 1, (2, RT)).astype(np.float32))
    model.zero_grad(set_to_none=True)
    out = model(x, torch.tensor([5, 700]), ic, ac)
    (out.float() ** 2).mean().backward()
    return out.detach(), [p.grad.clone() for p in model.parameters()]


def test_dropout_and_remat_leave_the_numbers_unchanged():
    """Unfused: dropout > 0 computes the deterministic model, and
    remat_blocks / remat_linear_attn recompute without changing the output
    or any gradient; fused (or remat) with dropout > 0 raises, as in JAX."""
    from dquartic_tpu_torch.utils.builder import build_model

    base = _cfg({"linear_attn_impl": "pallas"})
    ref_out, ref_g = _grads(build_model(base, device="cpu", seed=3, trainable=True))
    for unet in ({"dropout": 0.1}, {"remat_blocks": True}, {"remat_linear_attn": True},
                 {"remat_blocks": True, "remat_linear_attn": True}):
        cfg = json.loads(json.dumps(base))
        cfg["model"]["UNet1d"].update(unet)
        out, grads = _grads(build_model(cfg, device="cpu", seed=3, trainable=True))
        torch.testing.assert_close(out, ref_out, rtol=0, atol=0)
        for g, r in zip(grads, ref_g):
            torch.testing.assert_close(g, r, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="fused_resnet requires dropout"):
        UNet1d(**SMALL, dropout=0.1, fused_resnet=True)
    with pytest.raises(ValueError, match="remat_blocks requires dropout"):
        UNet1d(**SMALL, dropout=0.1, fused_resnet=False, remat_blocks=True)


def test_entry_points_need_the_card_unless_told(monkeypatch):
    """Without a CUDA device, ``build_model``, ``build_trainer`` and
    ``DDIMSampler.predict`` raise when no device is named, rather than run
    on the CPU."""
    from dquartic_tpu_torch.infer import DDIMSampler
    from dquartic_tpu_torch.utils.builder import build_model, build_process, build_trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _cfg()
    with pytest.raises(RuntimeError, match="build_model: no CUDA device"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="build_trainer: no CUDA device"):
        build_trainer(cfg)
    sampler = DDIMSampler(build_model(cfg, device="cpu"), build_process(cfg))
    with pytest.raises(RuntimeError, match="predict: no CUDA device"):
        sampler.predict([], num_steps=1)


# --------------------------------------------------------------------- #
# the CUDA kernels (run on the card only)                               #
# --------------------------------------------------------------------- #

# float32 on the card: sums in another order (slices of N merged across a
# cluster) and exp2f with log2(e)-scaled weights; values O(1): 1e-4. bf16:
# the kernels take the bf16 values and compute in float32; the output
# rounds once (held against the plain version run in float32).
CARD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _rows_oracle(xc, w):
    """The plain version on the values of x (B, C, N) and the weights in
    float64, in (B, N, C) float32: run in float32 on the card, its own sums
    over 40000 equal columns drift from float64 past the card tolerance
    (cuBLAS adds a row's like terms in turn; ``chip_smoke.py`` phase 9 logs
    the drift beside K8's error)."""
    return tla.linear_attention_rows_reference(
        xc.double().transpose(1, 2), *(t.double() for t in w)).float()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C,N", [(4, 4096), (16, 1), (8, 700), (12, 1025)])
@pytest.mark.parametrize("two_call", [False, True])
def test_rows_kernels_on_card(cuda, dtype, C, N, two_call):
    """K8 / K9 on channel-first memory (the model's) and on row-major
    memory, against the plain version; y keeps x's strides; one count per
    call."""
    op = tla.fused_linear_attention_two_call if two_call else tla.fused_linear_attention
    w = [_t(a, device=cuda) for a in _weights(C, seed=120)]
    xc = _t(np.random.default_rng(121).normal(size=(3, C, N)), dtype, cuda)
    ref = tla.linear_attention_rows_reference(xc.float().transpose(1, 2), *w)
    tol = CARD_TOL[dtype]
    for x in (xc.transpose(1, 2), xc.transpose(1, 2).contiguous()):
        before = op.launches
        with torch.no_grad():
            y = op(x, *w)
        torch.cuda.synchronize()
        assert op.launches == before + 1
        assert y.dtype == x.dtype and y.stride() == x.stride()
        torch.testing.assert_close(y.float(), ref, rtol=tol, atol=tol)


def _rows_card_case(C, N, dtype, dev, seed, case="random"):
    """x (34, C, N) in ``dtype`` on ``dev`` and the weights, float32: random;
    "late_max", a row whose largest k of every feature sits in the last
    tile of each CTA's slice (so phase 0 rescales what it summed); "equal",
    columns all equal within each row."""
    rng = np.random.default_rng(seed)
    w = [_t(a, device=dev) for a in _weights(C, seed=seed + 1)]
    x = rng.normal(size=(34, C, N)).astype(np.float32)
    if case == "late_max":  # small columns, then large ones at the end of each 1/8 of N
        x *= 0.1
        for r in range(8):
            end = min(N, (r + 1) * -(-N // 8))
            x[:, :, max(0, end - 5):end] *= 30.0
    elif case == "equal":
        x[:] = x[:, :, :1]
    return _t(x, dtype, dev), w


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [4, 8, 12, 16])
@pytest.mark.parametrize("N", [1, 127, 128, 129, 700, 1025, 40000])
def test_k8_kernel_on_card(cuda, dtype, C, N):
    """K8 on channel-first memory (the model's) and on row-major memory at
    every width the model runs and N across the tile and slice edges,
    against the plain version in float64 on the same values; y keeps x's
    strides; one launch and one count a call; two calls bitwise equal."""
    xc, w = _rows_card_case(C, N, dtype, cuda, seed=150 + C + N)
    ref = _rows_oracle(xc, w)
    tol = CARD_TOL[dtype]
    for x in (xc.transpose(1, 2), xc.transpose(1, 2).contiguous()):
        before = tla.fused_linear_attention.launches
        with torch.no_grad():
            y = tla.fused_linear_attention(x, *w)
            again = tla.fused_linear_attention(x, *w)
        torch.cuda.synchronize()
        assert tla.fused_linear_attention.launches == before + 2
        assert y.dtype == x.dtype and y.stride() == x.stride()
        torch.testing.assert_close(y.float(), ref, rtol=tol, atol=tol)
        assert torch.equal(y, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["late_max", "equal"])
@pytest.mark.parametrize("C,N", [(4, 40000), (12, 2500), (16, 129)])
def test_k8_kernel_running_max_on_card(cuda, dtype, case, C, N):
    """K8 where phase 0's running max grows in the last tile of each CTA's
    slice (the rescale path) and where a row's columns are all equal (every
    p is 1), both layouts, against the plain version in float64."""
    xc, w = _rows_card_case(C, N, dtype, cuda, seed=170 + C, case=case)
    ref = _rows_oracle(xc, w)
    tol = CARD_TOL[dtype]
    for x in (xc.transpose(1, 2), xc.transpose(1, 2).contiguous()):
        with torch.no_grad():
            y = tla.fused_linear_attention(x, *w)
        torch.cuda.synchronize()
        torch.testing.assert_close(y.float(), ref, rtol=tol, atol=tol)


# (C, N) of the 14 mixers of the canonical model, then ragged N and N = 1
# (chip_smoke.py's ROWS_SHAPES and ROWS_EXTRA)
ROWS_SHAPES = ((4, 40000), (4, 20000), (8, 10000), (8, 5000), (12, 2500), (12, 1250),
               (16, 625), (16, 1250), (12, 5000), (8, 20000))
ROWS_EXTRA = ((8, 700), (12, 1025), (8, 1), (16, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C,N", ROWS_SHAPES + ROWS_EXTRA)
def test_k9_kernel_on_card(cuda, dtype, C, N):
    """K9 (K8's kernel in its context mode, then its apply mode) at every
    mixer shape of the canonical model, ragged N and N = 1, on channel-first
    and row-major memory, against the plain version in float64 on the same
    values; its M against the plain context launch's in float64; y keeps
    x's strides; one count a call; two calls bitwise equal."""
    xc, w = _rows_card_case(C, N, dtype, cuda, seed=190 + C + N)
    ref = _rows_oracle(xc, w)
    tol = CARD_TOL[dtype]
    m_ref = tla.rows_context_reference(xc.double().transpose(1, 2), w[0].double(),
                                       w[1].double()).float()
    for x in (xc.transpose(1, 2), xc.transpose(1, 2).contiguous()):
        before = tla.fused_linear_attention_two_call.launches
        with torch.no_grad():
            y = tla.fused_linear_attention_two_call(x, *w)
            again = tla.fused_linear_attention_two_call(x, *w)
        launch, y3 = tla.rows_launcher("fused_linear_attention_two_call", x, *w, 4, 32,
                                       two_call=True)
        launch()
        torch.cuda.synchronize()
        assert tla.fused_linear_attention_two_call.launches == before + 2
        assert y.dtype == x.dtype and y.stride() == x.stride()
        torch.testing.assert_close(y.float(), ref, rtol=tol, atol=tol)
        assert torch.equal(y, again) and torch.equal(y, y3)
        torch.testing.assert_close(launch.tensors[2], m_ref, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_k8_under_autograd_launches_the_kernel_on_card(cuda):
    """With a gradient wanted the op still launches K8, once, and its
    gradients are autograd's of the reference; K9 refuses a gradient."""
    w = [_t(a, device=cuda).requires_grad_(True) for a in _weights(4, seed=130)]
    xc = _t(np.random.default_rng(131).normal(size=(2, 4, 640)), device=cuda).requires_grad_(True)
    x = xc.transpose(1, 2)  # the model's channel-first memory
    before = tla.fused_linear_attention.launches
    (tla.fused_linear_attention(x, *w) ** 2).sum().backward()
    assert tla.fused_linear_attention.launches == before + 1
    got = [t.grad.clone() for t in (xc, *w)]
    for t in (xc, *w):
        t.grad = None
    (tla.linear_attention_rows_reference(x, *w) ** 2).sum().backward()
    for g, t in zip(got, (xc, *w)):
        torch.testing.assert_close(g, t.grad, rtol=1e-4, atol=1e-4)
    with pytest.raises(RuntimeError, match="forward only"):
        tla.fused_linear_attention_two_call(x, *w)
