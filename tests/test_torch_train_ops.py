"""Gradients of the port's kernel ops (K4, K5) against the JAX package.

On the CPU the ops run their plain versions, which autograd
differentiates: those gradients are held against ``jax.vjp`` of the JAX
plain references and against the JAX Pallas backward kernels run in
interpret mode. The ``torch.autograd.Function`` that pairs each forward
kernel with its backward kernel is exercised on the CPU with the forward
launch swapped for the plain version. The CUDA kernels themselves are held
against autograd of the plain versions by the tests marked ``cuda``, which
skip without a card. On a CUDA machine without JAX run them with

    python -m pytest tests/test_torch_train_ops.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

import dquartic_tpu_torch.ops.fused_resnet as tfr
import dquartic_tpu_torch.ops.linear_attention as tla
from test_torch_ops import (MIXER_SHAPES, RESNET_SHAPES, _RESNET_KEYS, _AtenLog, _linattn_args,
                            _resnet_args, _resnet_operands, _t)

try:  # the JAX reference; a CUDA machine without JAX runs only `-m cuda`
    import jax
    import jax.numpy as jnp

    import dquartic_tpu.ops.fused_resnet as jfr
    import dquartic_tpu.ops.linear_attention as jla
    import test_torch_trainer as ttr
except ImportError:
    jax = jnp = jfr = jla = ttr = None

_LA_KEYS = ("x", "w_qkv", "w_out", "b_out", "g", "g_pre")


def _scaled_err(a, b):
    """max |a - b| / max |b|: the error measure of the JAX backward tests."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12)


def _assert_grads(got, ref, tol, names):
    assert len(got) == len(ref)
    for name, a, b in zip(names, got, ref):
        if b is None:
            assert a is None, name
            continue
        assert a.shape == b.shape, (name, a.shape, b.shape)
        err = _scaled_err(a, b)
        assert err < tol, f"{name}: scaled error {err:.2e} >= {tol:g}"


def _torch_la_grads(a, dy, op=tla.linear_attention):
    t = {k: _t(v).requires_grad_(True) for k, v in a.items()}
    y = op(*(t[k] for k in _LA_KEYS), 4, 32)
    y.backward(_t(dy))
    return [t[k].grad.numpy() for k in _LA_KEYS]


def _jax_la_layout(a, dy):
    """JAX takes (B, N, C) activations."""
    j = {k: jnp.asarray(v) for k, v in a.items()}
    j["x"] = jnp.swapaxes(j["x"], 1, 2)
    return j, jnp.swapaxes(jnp.asarray(dy), 1, 2)


# Float32 gradients of linear attention carry up to ~5e-3 of intrinsic
# noise against float64 (tests/test_linear_attention_fused.py:362-365,
# for the XLA vjp and the Pallas backward alike), which bounds how far two
# float32 implementations may drift on ill-conditioned inputs. These
# inputs are well conditioned and short (N <= 700): the two packages
# differ by ~1e-6 of the largest entry, so 1e-4 keeps a 100x margin and
# still catches a wrong term.
LA_GRAD_TOL = 1e-4


@pytest.mark.parametrize("N", [256, 700])
def test_linear_attention_grads_match_jax_vjp(N):
    rng = np.random.default_rng(20 + N)
    a = _linattn_args(rng, 2, 4, N)
    dy = rng.normal(size=a["x"].shape).astype(np.float32)
    j, jdy = _jax_la_layout(a, dy)
    _, vjp = jax.vjp(
        lambda *w: jla.linear_attention_nr_reference(*w, heads=4, dim_head=32),
        *(j[k] for k in _LA_KEYS),
    )
    ref = list(vjp(jdy))
    ref[0] = jnp.swapaxes(ref[0], 1, 2)
    _assert_grads(_torch_la_grads(a, dy), [np.asarray(r) for r in ref], LA_GRAD_TOL, _LA_KEYS)


@pytest.mark.parametrize("N", [256, 700])
def test_linear_attention_grads_match_jax_kernel_interpret(N):
    """Against the JAX Pallas backward (``_fused_backward_t``, prenorm +
    residual, interpret mode); N = 700 leaves a padded tail in its 512-wide
    blocks, which must contribute nothing."""
    rng = np.random.default_rng(30 + N)
    a = _linattn_args(rng, 2, 8, N)
    dy = rng.normal(size=a["x"].shape).astype(np.float32)
    j, jdy = _jax_la_layout(a, dy)
    ref = list(jla._fused_backward_t(
        j["x"], j["w_qkv"], j["w_out"], j["b_out"], j["g"], jdy, 4, 32, 512,
        g_pre=j["g_pre"], residual=True,
    ))
    ref[0] = jnp.swapaxes(ref[0], 1, 2)
    got = tla.linear_attention_backward(_t(dy), *(_t(a[k]) for k in _LA_KEYS))
    _assert_grads([g.numpy() for g in got], [np.asarray(r) for r in ref], LA_GRAD_TOL, _LA_KEYS)


def _plain_forward_la(x, w_qkv, w_out, b_out, g, g_pre, heads, dim_head):
    with torch.no_grad():
        return tla.linear_attention_nr_reference(x, w_qkv, w_out, b_out, g, g_pre, heads, dim_head)


def test_linear_attention_function_pairs_forward_and_backward(monkeypatch):
    """The autograd Function of the CUDA path, with its forward launch
    swapped for the plain version (its backward wrapper runs the plain
    backward on CPU tensors): the same gradients as autograd of the plain
    op, nothing tracked under inference mode."""
    monkeypatch.setattr(tla, "_forward_kernel", _plain_forward_la)
    rng = np.random.default_rng(40)
    a = _linattn_args(rng, 2, 4, 50)
    dy = rng.normal(size=a["x"].shape).astype(np.float32)
    got = _torch_la_grads(a, dy, op=tla._LinearAttentionFn.apply)
    ref = _torch_la_grads(a, dy, op=tla.linear_attention_nr_reference)
    for k, g, r in zip(_LA_KEYS, got, ref):
        np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-7, err_msg=k)
    with torch.inference_mode():
        y = tla._LinearAttentionFn.apply(*(_t(a[k]) for k in _LA_KEYS), 4, 32)
    assert not y.requires_grad


# Both sides compute the block in float32 and differ in summation order
# only (the JAX kernel's block-diagonal weight sums included): 1e-4 of the
# largest entry covers the sums of a few hundred terms per gradient.
RESNET_GRAD_TOL = 1e-4


def _torch_resnet_grads(a, dy, op=tfr.fused_resnet_block_t):
    t = {k: None if v is None else _t(v).requires_grad_(True) for k, v in a.items()}
    op(*(t[k] for k in _RESNET_KEYS)).backward(_t(dy))
    return [None if t[k] is None else t[k].grad.numpy() for k in _RESNET_KEYS]


@pytest.mark.parametrize("film", [True, False])
@pytest.mark.parametrize("res", [True, False])
def test_fused_resnet_grads_match_jax_kernel_interpret(film, res):
    """``jax.grad`` through the JAX fused op (Pallas forward and backward,
    interpret mode) against autograd of the port's op, for every gradient;
    N = 300 is not a multiple of the JAX backward's 256-wide blocks."""
    c_in, c_out = (8, 4) if res else (4, 4)
    rng = np.random.default_rng(50 + 2 * film + res)
    a = _resnet_args(rng, 2, c_in, c_out, 300, film, res)
    dy = rng.normal(size=(2, c_out, 300)).astype(np.float32)
    live = [k for k in _RESNET_KEYS if a[k] is not None]

    def loss(*vals):
        args = dict(zip(live, vals))
        out = jfr.fused_resnet_block_t(
            *(args.get(k) for k in _RESNET_KEYS), block_n=512, interpret=True)
        return jnp.sum(out * jnp.asarray(dy))

    ref = jax.grad(loss, argnums=tuple(range(len(live))))(*(jnp.asarray(a[k]) for k in live))
    ref = dict(zip(live, ref))
    _assert_grads(
        _torch_resnet_grads(a, dy), [None if k not in ref else np.asarray(ref[k]) for k in _RESNET_KEYS],
        RESNET_GRAD_TOL, _RESNET_KEYS,
    )


def _plain_forward_rn(*args):
    with torch.no_grad():
        return tfr.resnet_block_t_reference(*args)


@pytest.mark.parametrize("res", [True, False])
def test_fused_resnet_function_pairs_forward_and_backward(monkeypatch, res):
    monkeypatch.setattr(tfr, "_forward_kernel", _plain_forward_rn)
    rng = np.random.default_rng(60 + res)
    a = _resnet_args(rng, 2, 8 if res else 4, 4, 40, True, res)
    dy = rng.normal(size=(2, 4, 40)).astype(np.float32)
    got = _torch_resnet_grads(a, dy, op=tfr._FusedResnetFn.apply)
    ref = _torch_resnet_grads(a, dy, op=tfr.resnet_block_t_reference)
    for k, g, r in zip(_RESNET_KEYS, got, ref):
        if r is None:
            assert g is None, k
        else:
            np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-7, err_msg=k)


def test_unet_grads_match_jax_kernel_config_interpret():
    """Model-level gradients through the kernels: one UNet1d level (as JAX
    test_unet_fused_grads_match_unfused) in the JAX training config,
    fused ResnetBlocks and the pallas_t linear attention in interpret
    mode, forward and backward, against autograd of the port."""
    kw = dict(dim_mults=(1,), downsample_dim=32)
    model = ttr.JaxUNet1d(**{**ttr.SMALL, **kw}, fused_resnet=True, linear_attn_impl="pallas_t")
    i = ttr._grad_inputs(2, 3, 32, 3)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), i["x"], i["t"], i["x"], i["ms1"])
    params = ttr.random_params(shapes, seed=4)
    got, ref = ttr._grads_both(model, params, ttr._port_model(params, **kw), i, (1,))
    for k in ref:
        assert _scaled_err(got[k], ref[k]) < ttr.UNET_GRAD_TOL, k


# The allocations a kernel wrapper may make; any other aten op would be
# host work on the weights (a cast, a copy, a transpose).
_ALLOCATIONS = {"aten.empty", "aten.empty_like", "aten.empty_strided"}


def _recording_library(monkeypatch, mod, entry):
    """Route ``entry`` of ``mod``'s kernel library to a recorder; returns the
    list of argument tuples it was called with."""
    passed = []

    class FakeLibrary:
        pass

    setattr(FakeLibrary, entry, lambda self, *args: passed.append(args) or 0)
    monkeypatch.setattr(mod._build, "library", FakeLibrary)
    monkeypatch.setattr(mod._build, "stream_of", lambda t: 0)
    return passed


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear_attention_backward_wrapper_hands_the_weights_over_as_they_are(monkeypatch, dtype):
    """K4's wrapper runs no aten op but allocations: the kernel gets each
    weight's own memory, strides and dtype (the module's views of its conv
    weights in the compute dtype, float32 norm gains, g_pre seen as (1, C,
    1)), and the gradients come back in each parameter's shape, dtype and
    (for the two matrices) strides, allocated by the wrapper and written by
    the kernel; the launch counter advances by one."""
    passed = _recording_library(monkeypatch, tla, "dq_linear_attention_bwd")
    dt = getattr(torch, dtype)
    B, C, N = 2, 4, 10
    a = _linattn_args(np.random.default_rng(15), B, C, N)
    x, dy = _t(a["x"]).to(dt), _t(a["x"][::-1].copy()).to(dt)
    conv_qkv = _t(a["w_qkv"]).t().contiguous().to(dt)  # (3H, C)
    conv_out = _t(a["w_out"]).t().contiguous().to(dt)  # (C, H)
    w = [conv_qkv.t(), conv_out.t(), _t(a["b_out"]).to(dt), _t(a["g"]),
         _t(a["g_pre"]).reshape(1, C, 1)]
    before = tla.linear_attention_backward.launches
    with _AtenLog() as log:
        grads = tla._backward_kernel(dy, x, *w, 4, 32)
    assert set(log.ops) <= _ALLOCATIONS, log.ops
    assert tla.linear_attention_backward.launches == before + 1
    (args,) = passed
    dx, dw_qkv, dw_out, db_out, dg, dg_pre = grads
    assert args[:3] == (x.data_ptr(), dy.data_ptr(), dx.data_ptr())
    assert args[3:9] == (conv_qkv.data_ptr(), 1, C, conv_out.data_ptr(), 1, 128)
    assert args[9:15] == (w[2].data_ptr(), 1, w[3].data_ptr(), 1, w[4].data_ptr(), 1)
    assert args[15:21] == (dw_qkv.data_ptr(), *dw_qkv.stride(), dw_out.data_ptr(), *dw_out.stride())
    assert args[21:27] == (db_out.data_ptr(), 1, dg.data_ptr(), 1, dg_pre.data_ptr(), 1)
    bits = 0b00111 if dtype == "bfloat16" else 0  # w_qkv, w_out, b_out in the compute dtype
    # B, C, N, heads, weight dtype bits, gradient dtype bits, bf16 x, device
    assert args[29:37] == (B, C, N, 4, bits, bits, int(dtype == "bfloat16"), 0)
    assert dx.shape == x.shape and dx.dtype == dt
    for gr, p in zip(grads[1:], w):
        assert gr.shape == p.shape and gr.dtype == p.dtype
    assert dw_qkv.stride() == w[0].stride() and dw_out.stride() == w[1].stride()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("film", [True, False])
@pytest.mark.parametrize("res", [True, False])
def test_fused_resnet_backward_wrapper_hands_the_weights_over_as_they_are(monkeypatch, dtype,
                                                                          film, res):
    """K5's wrapper runs no aten op but allocations: the kernel gets each
    parameter's own memory, strides and dtype as ResnetBlockT hands them to
    K2 (the torch conv weights seen through permute, float32 gains, FiLM
    halves of one (B, 2 C_out) tensor), and each gradient comes back in its
    parameter's shape, dtype and strides, None where the parameter is None;
    the launch counter advances by one."""
    passed = _recording_library(monkeypatch, tfr, "dq_fused_resnet_bwd")
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(16 + 2 * film + res)
    B, c_out, N = 2, 4, 10
    c_in = 8 if res else 4
    x = _t(rng.normal(size=(B, c_in, N)).astype(np.float32)).to(dt)
    dy = _t(rng.normal(size=(B, c_out, N)).astype(np.float32)).to(dt)

    def conv(i, o):  # torch conv weight (out, in, k) seen as flax (k, in, out)
        return _t(rng.normal(size=(o, i, 3)).astype(np.float32)).to(dt)

    conv1, conv2 = conv(c_in, c_out), conv(c_out, c_out)
    film_t = _t(rng.normal(size=(B, 2 * c_out)).astype(np.float32)).to(dt)
    scale, shift = film_t.chunk(2, dim=-1) if film else (None, None)
    vec = [_t(rng.normal(size=(c_out,)).astype(np.float32)).to(dt) for _ in range(3)]
    gains = [_t(rng.normal(size=(1, c_out, 1)).astype(np.float32)).reshape(-1) for _ in "12"]
    conv_res = _t(rng.normal(size=(c_out, c_in, 1)).astype(np.float32)).to(dt)
    params = [conv1.permute(2, 1, 0), vec[0], gains[0], scale, shift, conv2.permute(2, 1, 0),
              vec[1], gains[1], conv_res.permute(2, 1, 0) if res else None,
              vec[2] if res else None]
    before = tfr.fused_resnet_backward.launches
    with _AtenLog() as log:
        grads = tfr._backward_kernel(dy, x, *params)
    assert set(log.ops) <= _ALLOCATIONS, log.ops
    assert tfr.fused_resnet_backward.launches == before + 1
    (args,) = passed
    dx = grads[0]
    assert args[:3] == (x.data_ptr(), dy.data_ptr(), dx.data_ptr())
    assert dx.shape == x.shape and dx.dtype == dt

    def expect(ts):  # pointers and the strides K2 reads, as _operand_args gives them
        out = []
        for t, n in zip(ts, tfr._NSTRIDES):
            out += [None] + [0] * n if t is None else [t.data_ptr(), *t.stride()[-n:]]
        return tuple(out)

    assert args[3:30] == expect(params)
    assert args[3:7] == (conv1.data_ptr(), 1, 3, 3 * c_in)  # w1 over conv1's own memory
    assert args[30:57] == expect(grads[1:])
    for gr, p in zip(grads[1:], params):
        assert (gr is None) == (p is None)
        if p is not None:
            assert gr.shape == p.shape and gr.dtype == p.dtype
            if p.dim() == 3:
                assert gr.stride() == p.stride()
    bits = sum(1 << i for i, p in enumerate(params) if p is not None and p.dtype == torch.bfloat16)
    flags = film | res << 1 | res << 2
    # B, C_in, C_out, N, flags, dtype bits, gradient dtype bits, bf16 x, device
    assert args[58:67] == (B, c_in, c_out, N, flags, bits, bits, int(dtype == "bfloat16"), -1)


# --------------------------------------------------------------------- #
# on the card: each backward kernel against autograd of its plain version #
# --------------------------------------------------------------------- #

# float32 (TF32 off): the kernels sum in another order, over up to 40000
# columns per row, and form dW_k as the difference dW_k' - bmat T of two
# larger terms (the JAX kernel does the same) where autograd goes through
# the softmax: the float32 noise of the last note above, 1e-3 of the
# largest entry. bf16: the kernels take the bf16 activations and cotangent
# and compute in float32, so they match the plain version run in float32
# on the same bf16 values as closely as in float32, except dx, rounded once
# to bf16 (2^-8 relative) where the reference stays float32.
CARD_TOL = {"float32": 1e-3, "bfloat16": 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels only run on the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bf16_values(t):
    return None if t is None else t.to(torch.bfloat16).to(torch.float32)


# K4 at every mixer shape of the canonical model and the MS1 tower (N = 1),
# ragged N, B = 1 and 34, (8, 1000), a slice past the staging budget
# (16, 200000), and every head count 1-8 (heads * 32 <= 256)
LA_BWD_CASES = (
    [(B, C, N, 4) for C, N in MIXER_SHAPES + [(8, 1000)] for B in (1, 34)]
    + [(1, 16, 200000, 4), (3, 16, 200000, 4)]
    + [(B, C, N, h) for h in (1, 2, 3, 5, 6, 7, 8) for B, C, N in ((34, 4, 5000), (2, 16, 1025))]
)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,C,N,heads", LA_BWD_CASES)
def test_linear_attention_backward_kernel_on_card(cuda, dtype, B, C, N, heads):
    """K4: one call a launch counts once, two calls give bitwise equal
    gradients, each in its input's dtype and within CARD_TOL of autograd of
    the plain version run in float32 on the same values. bf16 takes its
    weights as the module passes them (bf16 views of the conv weights)."""
    rng = np.random.default_rng(70 + C * 7 + N + B + heads)
    a = _linattn_args(rng, B, C, N, heads=heads)
    t = {k: _t(v, cuda) for k, v in a.items()}
    dt = getattr(torch, dtype)
    x, dy = t["x"].to(dt), _t(rng.normal(size=a["x"].shape).astype(np.float32), cuda).to(dt)
    w = [t[k] for k in _LA_KEYS[1:]]
    if dtype == "bfloat16":  # (3H, C) and (C, H) conv weights seen as (C, 3H), (H, C)
        w[0] = w[0].t().contiguous().to(dt).t()
        w[1] = w[1].t().contiguous().to(dt).t()
        w[2] = w[2].to(dt)
    before = tla.linear_attention_backward.launches
    got = tla.linear_attention_backward(dy, x, *w, heads=heads)
    again = tla.linear_attention_backward(dy, x, *w, heads=heads)
    assert tla.linear_attention_backward.launches == before + 2
    ref = tla.linear_attention_backward_reference(dy.float(), x.float(), *(v.float() for v in w),
                                                  heads, 32)
    torch.cuda.synchronize()
    for g, h, p in zip(got, again, [x, *w]):  # deterministic: no atomics
        assert torch.equal(g, h) and g.dtype == p.dtype and g.shape == p.shape
    if N == 200000:
        assert not tla.linear_attention_backward_plan(B, C, N, heads, dtype == "bfloat16")["staged"]
    _assert_grads([g.float().cpu().numpy() for g in got], [r.cpu().numpy() for r in ref],
                  CARD_TOL[dtype], _LA_KEYS)


# K5 at the 14 distinct ResnetBlock shapes of the canonical model with FiLM,
# and one block without FiLM
RESNET_BWD_CASES = [(ci, co, N, True) for ci, co, N in sorted(set(RESNET_SHAPES))] + [
    (12, 8, 1000, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["module", "masters"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B", [1, 34])
@pytest.mark.parametrize("c_in,c_out,N,film", RESNET_BWD_CASES)
def test_fused_resnet_backward_kernel_on_card(cuda, dtype, c_in, c_out, N, film, B, form):
    """K5 with the parameters as the module hands them over (``form``, see
    ``_resnet_operands``): two calls give bitwise equal gradients, each in
    its parameter's shape and dtype, within CARD_TOL of autograd of the
    plain version run in float32 on the same values (the conv weights
    rounded to x's dtype, as K5 uses them)."""
    rng = np.random.default_rng(80 + c_in * 1000 + N + B)
    a = _resnet_args(rng, B, c_in, c_out, N, film, c_in != c_out)
    dt = getattr(torch, dtype)
    args = _resnet_operands(a, dt, form)
    dy = _t(rng.normal(size=(B, c_out, N)).astype(np.float32), cuda).to(dt)
    before = tfr.fused_resnet_backward.launches
    got = tfr.fused_resnet_backward(dy, *args)
    again = tfr.fused_resnet_backward(dy, *args)
    assert tfr.fused_resnet_backward.launches == before + 2
    rounded = [None if v is None else (_bf16_values(v) if dtype == "bfloat16" and i in (0, 1, 6, 9)
                                       else v.float()) for i, v in enumerate(args)]
    ref = tfr.resnet_block_t_backward_reference(dy.float(), *rounded)
    torch.cuda.synchronize()
    for g, h, p in zip(got, again, args):
        assert (g is None and h is None and p is None) or (
            torch.equal(g, h) and g.dtype == p.dtype and g.shape == p.shape)
    _assert_grads([None if g is None else g.float().cpu().numpy() for g in got],
                  [None if r is None else r.cpu().numpy() for r in ref], CARD_TOL[dtype],
                  _RESNET_KEYS)
