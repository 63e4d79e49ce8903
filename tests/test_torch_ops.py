"""The port's kernel ops (dquartic_tpu_torch.ops) against the JAX package.

Each op's plain PyTorch version — what the wrapper runs on CPU tensors —
is held against the JAX plain reference on the same numpy inputs in
float32, and once against the JAX Pallas kernel run in interpret mode, as
the JAX package's own tests run it on the CPU. The CUDA kernels
themselves are held against the plain versions by the tests marked
``cuda``, which skip without a card. On a CUDA machine without JAX (which
then cannot load tests/conftest.py), run them with

    python -m pytest tests/test_torch_ops.py -m cuda --noconftest -q
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import dquartic_tpu_torch.ops.fused_resnet as tfr
import dquartic_tpu_torch.ops.int8_matmul as tim
import dquartic_tpu_torch.ops.linear_attention as tla

try:  # the JAX reference; a CUDA machine without JAX runs only `-m cuda`
    import jax.numpy as jnp

    import dquartic_tpu.ops.fused_resnet as jfr
    import dquartic_tpu.ops.int8_matmul as jim
    import dquartic_tpu.ops.linear_attention as jla
except ImportError:
    jnp = jfr = jim = jla = None

# float32 on both sides; the remaining difference is summation order over
# at most a few thousand terms, followed by normalizations that keep values
# O(1): 1e-5 absolute / relative is ~100 float32 ulps.
F32_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels only run on the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _t(a, device="cpu"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _linattn_args(rng, B, C, N, heads=4, dim_head=32):
    H = heads * dim_head
    return dict(
        x=rng.normal(size=(B, C, N)).astype(np.float32),
        w_qkv=(rng.normal(size=(C, 3 * H)) * 0.3).astype(np.float32),
        w_out=(rng.normal(size=(H, C)) * 0.1).astype(np.float32),
        b_out=(rng.normal(size=(C,)) * 0.1).astype(np.float32),
        g=rng.normal(size=(C,)).astype(np.float32),
        g_pre=(1.0 + 0.2 * rng.normal(size=(C,))).astype(np.float32),
    )


def _jax_linattn_nr(a):
    xt = jnp.swapaxes(jnp.asarray(a["x"]), 1, 2)  # JAX takes (B, N, C)
    out = jla.linear_attention_nr_reference(
        xt, *(jnp.asarray(a[k]) for k in ("w_qkv", "w_out", "b_out", "g", "g_pre")),
        heads=4, dim_head=32,
    )
    return np.swapaxes(np.asarray(out), 1, 2)


def _torch_linattn(a, op=tla.linear_attention_nr_reference):
    t = {k: _t(v) for k, v in a.items()}
    return op(t["x"], t["w_qkv"], t["w_out"], t["b_out"], t["g"], t["g_pre"], 4, 32)


@pytest.mark.parametrize("C,N", [(4, 1025), (8, 300), (16, 64)])
def test_linear_attention_plain_matches_jax_reference(C, N):
    a = _linattn_args(np.random.default_rng(0), 3, C, N)
    np.testing.assert_allclose(_torch_linattn(a).numpy(), _jax_linattn_nr(a), **F32_TOL)


def test_linear_attention_matches_jax_kernel_interpret():
    """The JAX kernel (static shifts, exp2, folded W_out) computes the same
    function; 2e-5 allows its exp2/log2(e) rescale on top of F32_TOL."""
    a = _linattn_args(np.random.default_rng(1), 2, 4, 200)
    xt = jnp.swapaxes(jnp.asarray(a["x"]), 1, 2)
    out = jla.fused_linear_attention_t(
        xt, *(jnp.asarray(a[k]) for k in ("w_qkv", "w_out", "b_out", "g")),
        heads=4, dim_head=32, g_pre=jnp.asarray(a["g_pre"]), residual=True,
    )
    np.testing.assert_allclose(
        _torch_linattn(a).numpy(), np.swapaxes(np.asarray(out), 1, 2), rtol=2e-5, atol=2e-5
    )
    # the CPU wrapper is the plain version
    np.testing.assert_array_equal(
        _torch_linattn(a, tla.linear_attention).numpy(), _torch_linattn(a).numpy()
    )


def _resnet_args(rng, B, c_in, c_out, N, film, res):
    a = dict(
        x_t=rng.normal(size=(B, c_in, N)).astype(np.float32),
        w1=(rng.normal(size=(3, c_in, c_out)) * 0.3).astype(np.float32),
        b1=(rng.normal(size=(c_out,)) * 0.1).astype(np.float32),
        g1=(1.0 + 0.2 * rng.normal(size=(c_out,))).astype(np.float32),
        scale=(rng.normal(size=(B, c_out)) * 0.2).astype(np.float32) if film else None,
        shift=(rng.normal(size=(B, c_out)) * 0.2).astype(np.float32) if film else None,
        w2=(rng.normal(size=(3, c_out, c_out)) * 0.3).astype(np.float32),
        b2=(rng.normal(size=(c_out,)) * 0.1).astype(np.float32),
        g2=(1.0 + 0.2 * rng.normal(size=(c_out,))).astype(np.float32),
        w_res=(rng.normal(size=(1, c_in, c_out)) * 0.3).astype(np.float32) if res else None,
        b_res=(rng.normal(size=(c_out,)) * 0.1).astype(np.float32) if res else None,
    )
    return a


_RESNET_KEYS = ("x_t", "w1", "b1", "g1", "scale", "shift", "w2", "b2", "g2", "w_res", "b_res")


def _torch_resnet(a, op=tfr.resnet_block_t_reference):
    return op(*(None if a[k] is None else _t(a[k]) for k in _RESNET_KEYS))


def _jax_args(a):
    return [None if a[k] is None else jnp.asarray(a[k]) for k in _RESNET_KEYS]


@pytest.mark.parametrize("film", [True, False])
@pytest.mark.parametrize("res", [True, False])
def test_fused_resnet_plain_matches_jax_reference(film, res):
    c_in, c_out = (12, 8) if res else (8, 8)
    a = _resnet_args(np.random.default_rng(2), 3, c_in, c_out, 129, film, res)
    ref = jfr.resnet_block_t_reference(*_jax_args(a))
    np.testing.assert_allclose(_torch_resnet(a).numpy(), np.asarray(ref), **F32_TOL)


def test_fused_resnet_matches_jax_kernel_interpret():
    a = _resnet_args(np.random.default_rng(3), 2, 8, 4, 300, True, True)
    out = jfr.fused_resnet_block_t(*_jax_args(a), block_n=256, interpret=True)
    np.testing.assert_allclose(_torch_resnet(a).numpy(), np.asarray(out), **F32_TOL)
    np.testing.assert_array_equal(
        _torch_resnet(a, tfr.fused_resnet_block_t).numpy(), _torch_resnet(a).numpy()
    )


def test_quantization_matches_jax_exactly():
    """Same int8 values and scales as quantize_conv_kernel, padding sliced
    off (both round half to even; the division is the same float32 op)."""
    rng = np.random.default_rng(4)
    w = rng.normal(size=(70, 33, 3)).astype(np.float32)  # torch (out, in, k)
    q, s = tim.quantize_conv_kernel(_t(w))
    jq, js = jim.quantize_conv_kernel(jnp.asarray(np.transpose(w, (2, 1, 0))))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq)[: 3 * 33, :70])
    np.testing.assert_array_equal(s.numpy(), np.asarray(js)[:70])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_matmul_plain_matches_jax_reference(dtype):
    """float32: sums in another order. bfloat16: both accumulate exact products in float32
    and round once to bf16, so they differ by at most one bf16 ulp (2^-8
    relative) where the summation orders round differently."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(34, 150)).astype(np.float32)
    w = rng.normal(size=(150, 70)).astype(np.float32)
    q, s = tim.quantize_weight_matrix(_t(w))
    jq, js = jim.quantize_weight_matrix(jnp.asarray(w))
    xt = _t(x).to(getattr(torch, dtype))
    out = tim.int8_matmul_reference(xt, q, s).float().numpy()
    ref = jim.int8_matmul_reference(jnp.asarray(x, getattr(jnp, dtype)), jq, js)
    ref = np.asarray(ref.astype(jnp.float32))[:, :70]
    tol = dict(rtol=1e-5, atol=1e-6 * np.abs(ref).max())  # as in the test below
    if dtype == "bfloat16":
        tol = dict(rtol=2**-8, atol=1e-6)
    np.testing.assert_allclose(out, ref, **tol)


def test_int8_matmul_matches_jax_kernel_interpret():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(34, 600)).astype(np.float32)
    w = rng.normal(size=(600, 40)).astype(np.float32)
    q, s = tim.quantize_weight_matrix(_t(w))
    jq, js = jim.quantize_weight_matrix(jnp.asarray(w))
    ref = np.asarray(jim.int8_matmul(jnp.asarray(x), jq, js, interpret=True))[:, :40]
    # sums of 600 O(1) products in another order: the rounding error scales
    # with the size of the sums, not of each (possibly cancelled) result
    np.testing.assert_allclose(
        tim.int8_matmul(_t(x), q, s).numpy(), ref, rtol=1e-5, atol=1e-6 * np.abs(ref).max()
    )


def test_int8_conv1d_matches_jax():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 24, 9)).astype(np.float32)  # (b, C_in, L)
    w = (rng.normal(size=(16, 24, 3)) * 0.2).astype(np.float32)  # torch (out, in, k)
    bias = rng.normal(size=(16,)).astype(np.float32)
    q, s = tim.quantize_conv_kernel(_t(w))
    out = tim.int8_conv1d(_t(x), q, s, _t(bias))
    jq, js = jim.quantize_conv_kernel(jnp.asarray(np.transpose(w, (2, 1, 0))))
    ref = jim.int8_conv1d(
        jnp.asarray(np.transpose(x, (0, 2, 1))), jq, js, jnp.asarray(bias), 3, 16, impl="xla"
    )
    np.testing.assert_allclose(out.numpy(), np.transpose(np.asarray(ref), (0, 2, 1)), **F32_TOL)


def test_ops_refuse_gradients():
    """Only the inference-only op refuses a gradient: int8_matmul raises
    under autograd (frozen int8 weights, as in JAX), while gradients flow
    through the K1 and K2 ops (on CPU through their plain versions) to
    the input and every weight."""
    rng = np.random.default_rng(8)
    a = {k: _t(v).requires_grad_(True) for k, v in _linattn_args(rng, 1, 4, 16).items()}
    tla.linear_attention(a["x"], a["w_qkv"], a["w_out"], a["b_out"], a["g"], a["g_pre"]).sum().backward()
    for k, v in a.items():
        assert v.grad is not None and torch.isfinite(v.grad).all() and v.grad.abs().sum() > 0, k
    r = {k: None if v is None else _t(v).requires_grad_(True)
         for k, v in _resnet_args(rng, 1, 4, 4, 8, True, False).items()}
    tfr.fused_resnet_block_t(*(r[k] for k in _RESNET_KEYS)).square().sum().backward()
    for k, v in r.items():
        if v is not None:
            assert v.grad is not None and torch.isfinite(v.grad).all() and v.grad.abs().sum() > 0, k
    x = torch.ones(2, 6, requires_grad=True)
    q, s = tim.quantize_weight_matrix(torch.ones(6, 4))
    with pytest.raises(RuntimeError, match="forward only"):
        tim.int8_matmul(x, q, s)
    with torch.no_grad():
        assert tim.int8_matmul(x, q, s).shape == (2, 4)


def test_port_imports_no_jax():
    code = (
        "import sys, dquartic_tpu_torch.infer, dquartic_tpu_torch.utils.builder, "
        "dquartic_tpu_torch.compat.jax_params; "
        "assert 'jax' not in sys.modules, 'jax imported'; print('ok')"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_linear_attention_wrapper_hands_the_weights_over_as_they_are(monkeypatch):
    """K1's wrapper runs no torch op on the weights: the kernel gets their
    own memory, strides and dtypes (here the module's bf16 views of the
    conv weights beside float32 norm gains), and the wrapper allocates y."""
    passed = []

    class FakeLibrary:
        def dq_linear_attention(self, *args):
            passed.append(args)
            return 0

    monkeypatch.setattr(tla, "_check_kernel_args", lambda *a: None)
    monkeypatch.setattr(tla._build, "library", FakeLibrary)
    monkeypatch.setattr(tla._build, "stream_of", lambda t: 0)
    a = _linattn_args(np.random.default_rng(12), 2, 4, 10)
    x = _t(a["x"]).to(torch.bfloat16)
    conv_qkv = _t(a["w_qkv"]).t().contiguous().to(torch.bfloat16)  # (3H, C)
    conv_out = _t(a["w_out"]).t().contiguous().to(torch.bfloat16)  # (C, H)
    w = [conv_qkv.t(), conv_out.t(), _t(a["b_out"]).to(torch.bfloat16), _t(a["g"]),
         _t(a["g_pre"]).reshape(1, 4, 1)]
    before = tla.linear_attention.launches
    y = tla._forward_kernel(x, *w, 4, 32)
    assert tla.linear_attention.launches == before + 1
    (args,) = passed
    assert args[:2] == (x.data_ptr(), y.data_ptr())
    assert args[2:5] == (conv_qkv.data_ptr(), 1, 4) and args[5:8] == (conv_out.data_ptr(), 1, 128)
    assert args[8:14] == (w[2].data_ptr(), 1, w[3].data_ptr(), 1, w[4].data_ptr(), 1)
    assert args[14:20] == (2, 4, 10, 4, 0b00111, 1)  # B, C, N, heads, bf16 weights, bf16 x
    with pytest.raises(ValueError, match="b_out, g and g_pre"):
        tla._forward_kernel(x, *w[:3], w[3][:3], w[4], 4, 32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads", [1, 3, 6, 8])
def test_linear_attention_wrapper_takes_every_head_count(monkeypatch, heads, dtype):
    """K1's wrapper hands every heads·32 <= 256 to the kernel, bf16 as
    float32 (as K4 and the JAX kernel take them)."""
    passed = []

    class FakeLibrary:
        def dq_linear_attention(self, *args):
            passed.append(args)
            return 0

    monkeypatch.setattr(tla, "_check_kernel_args", lambda *a: None)
    monkeypatch.setattr(tla._build, "library", FakeLibrary)
    monkeypatch.setattr(tla._build, "stream_of", lambda t: 0)
    a = _linattn_args(np.random.default_rng(13), 1, 8, 5, heads=heads)
    x = _t(a["x"]).to(getattr(torch, dtype))
    tla._forward_kernel(x, *(_t(a[k]) for k in ("w_qkv", "w_out", "b_out", "g", "g_pre")),
                        heads, 32)
    (args,) = passed
    assert args[14:18] == (1, 8, 5, heads) and args[19] == int(dtype == "bfloat16")


def _fake_fused_resnet_library(monkeypatch):
    """Route K2's launch to a recorder; returns the list of argument tuples."""
    passed = []

    class FakeLibrary:
        def dq_fused_resnet(self, *args):
            passed.append(args)
            return 0

    monkeypatch.setattr(tfr._build, "library", FakeLibrary)
    monkeypatch.setattr(tfr._build, "stream_of", lambda t: 0)
    return passed


class _AtenLog(torch.utils._python_dispatch.TorchDispatchMode):
    """Records every aten op run under it."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


def test_fused_resnet_wrapper_hands_the_weights_over_as_they_are(monkeypatch):
    """K2's wrapper runs no torch op on the parameters: the kernel gets their
    own memory, strides and dtypes (bf16 views of the torch conv weights,
    float32 gains, FiLM halves of one (B, 2 C_out) tensor), a missing
    residual bias is a flag, out is the one allocation and the launch
    counter advances by one."""
    passed = _fake_fused_resnet_library(monkeypatch)
    rng = np.random.default_rng(14)
    B, c_in, c_out, N = 2, 8, 4, 10
    x = _t(rng.normal(size=(B, c_in, N)).astype(np.float32)).to(torch.bfloat16)
    conv1 = _t(rng.normal(size=(c_out, c_in, 3)).astype(np.float32)).to(torch.bfloat16)
    conv2 = _t(rng.normal(size=(c_out, c_out, 3)).astype(np.float32)).to(torch.bfloat16)
    conv_res = _t(rng.normal(size=(c_out, c_in, 1)).astype(np.float32)).to(torch.bfloat16)
    film = _t(rng.normal(size=(B, 2 * c_out)).astype(np.float32)).to(torch.bfloat16)
    scale, shift = film.chunk(2, dim=-1)
    b1, b2 = (_t(rng.normal(size=(c_out,)).astype(np.float32)).to(torch.bfloat16) for _ in "12")
    g1, g2 = (_t(rng.normal(size=(1, c_out, 1)).astype(np.float32)).reshape(-1) for _ in "12")
    params = [conv1.permute(2, 1, 0), b1, g1, scale, shift, conv2.permute(2, 1, 0), b2, g2,
              conv_res.permute(2, 1, 0), None]
    before = tfr.fused_resnet_block_t.launches
    with _AtenLog() as log:
        out = tfr._forward_kernel(x, *params)
    assert log.ops == ["aten.empty"] and out.shape == (B, c_out, N)
    assert tfr.fused_resnet_block_t.launches == before + 1
    (args,) = passed
    assert args[:2] == (x.data_ptr(), out.data_ptr())
    assert args[2:6] == (conv1.data_ptr(), 1, 3, 3 * c_in)  # w1 (3, C_in, C_out) over conv1
    assert args[6:10] == (b1.data_ptr(), 1, g1.data_ptr(), 1)
    assert args[10:16] == (film.data_ptr(), 2 * c_out, 1, film.data_ptr() + 2 * c_out, 2 * c_out, 1)
    assert args[16:20] == (conv2.data_ptr(), 1, 3, 3 * c_out)
    assert args[20:24] == (b2.data_ptr(), 1, g2.data_ptr(), 1)
    assert args[24:29] == (conv_res.data_ptr(), 1, c_in, None, 0)  # no residual bias
    # B, C_in, C_out, N, flags (FiLM | residual conv), dtype bits, bf16 x
    bits = sum(1 << i for i in (0, 1, 3, 4, 5, 6, 8))  # all but the gains
    assert args[29:36] == (B, c_in, c_out, N, 0b011, bits, 1)
    with pytest.raises(ValueError, match="biases and gains"):
        tfr._forward_kernel(x, *params[:2], g1[:3], *params[3:])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resnet_block_hands_its_parameters_to_the_kernel_without_a_copy(monkeypatch, dtype):
    """A ResnetBlockT forward passes its conv weights, biases and gains to
    K2 as stored (no cast, no contiguous copy): bf16 in a serving model,
    float32 masters in training."""
    from dquartic_tpu_torch.models import fused_blocks

    passed = _fake_fused_resnet_library(monkeypatch)
    monkeypatch.setattr(fused_blocks, "fused_resnet_block_t", tfr._forward_kernel)
    dt = getattr(torch, dtype)
    block = fused_blocks.ResnetBlockT(12, 8, 16)
    for name, p in block.named_parameters():
        if dtype == "bfloat16" and not name.endswith(".g"):
            p.data = p.data.to(dt)  # the serving model's storage
    x = torch.randn(3, 12, 20).to(dt)
    with torch.no_grad():
        block(x, torch.randn(3, 16).to(dt))
    (args,) = passed
    w1, w2, wr = (c.weight for c in (block.block1.proj, block.block2.proj, block.res_conv))
    assert args[2:6] == (w1.data_ptr(), 1, 3, 3 * 12)
    assert args[16:20] == (w2.data_ptr(), 1, 3, 3 * 8)
    assert args[24:27] == (wr.data_ptr(), 1, 12)
    assert args[6] == block.block1.proj.bias.data_ptr() and args[8] == block.block1.norm.g.data_ptr()
    assert args[20] == block.block2.proj.bias.data_ptr() and args[27] == block.res_conv.bias.data_ptr()
    bf16 = dtype == "bfloat16"  # then all but the gains are bf16
    bits = sum(1 << i for i in (0, 1, 3, 4, 5, 6, 8, 9)) if bf16 else 0
    assert args[33:36] == (0b111, bits, int(bf16))


# --------------------------------------------------------------------- #
# on the card: each CUDA kernel against its plain version               #
# --------------------------------------------------------------------- #

# In bf16 the kernels take bf16 activations (K2 also rounds its conv
# weights to bf16) and compute in float32, rounding only matmul operands
# (K1) and the output. They are held against the plain version run in
# float32 on the same bf16 values: the plain version's own bf16 rounding
# points differ from the kernel's, and an RMSNorm over 4 channels whose
# norm cancels amplifies those roundings far beyond a bf16 ulp. Outputs
# are O(1) to O(10) (RMSNorm-scaled plus a unit-normal residual), where one
# bf16 ulp is up to 2^-5.
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
F32_CARD_TOL = dict(rtol=1e-4, atol=1e-4)  # sums in another order, exp2


def _bf16_values(t):
    return None if t is None else t.to(torch.bfloat16).to(torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
# (8, 1): the MS1 tower's mixer of UNet1d(simple=False), one column per row
@pytest.mark.parametrize("C,N", [(4, 40000), (16, 625), (8, 1000), (8, 1)])
def test_linear_attention_kernel_on_card(cuda, dtype, C, N):
    a = _linattn_args(np.random.default_rng(9), 34, C, N)
    t = {k: _t(v, cuda) for k, v in a.items()}
    x = t["x"].to(getattr(torch, dtype))
    w = [t[k] for k in ("w_qkv", "w_out", "b_out", "g", "g_pre")]
    before = tla.linear_attention.launches
    out = tla.linear_attention(x, *w)
    assert tla.linear_attention.launches == before + 1
    ref = tla.linear_attention_nr_reference(x.to(torch.float32), *w, 4, 32)
    torch.cuda.synchronize()
    tol = F32_CARD_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.cpu().numpy(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "c_in,c_out,N,film", [(4, 4, 40000, True), (32, 16, 625, True), (8, 4, 40000, True),
                          (12, 8, 1000, False)]
)
def test_fused_resnet_kernel_on_card(cuda, dtype, c_in, c_out, N, film):
    a = _resnet_args(np.random.default_rng(10), 34, c_in, c_out, N, film, c_in != c_out)
    t = {k: None if v is None else _t(v, cuda) for k, v in a.items()}
    t["x_t"] = t["x_t"].to(getattr(torch, dtype))
    out = tfr.fused_resnet_block_t(*(t[k] for k in _RESNET_KEYS))
    if dtype == "bfloat16":
        t = {k: _bf16_values(v) if k in ("x_t", "w1", "w2", "w_res") else v for k, v in t.items()}
    ref = tfr.resnet_block_t_reference(*(t[k] for k in _RESNET_KEYS))
    torch.cuda.synchronize()
    tol = F32_CARD_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.cpu().numpy(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N", [(34, 30000, 10000), (7, 1537, 130), (100, 600, 48)])
def test_int8_matmul_kernel_on_card(cuda, dtype, M, K, N):
    rng = np.random.default_rng(11)
    x = _t(rng.normal(size=(M, K)).astype(np.float32), cuda).to(getattr(torch, dtype))
    q, s = tim.quantize_weight_matrix(_t(rng.normal(size=(K, N)).astype(np.float32), cuda))
    out = tim.int8_matmul(x, q, s).float()
    ref = tim.int8_matmul_reference(x, q, s).float()
    torch.cuda.synchronize()
    # float32 sums of K products in another order: relative to sqrt(K)·|x||w|
    scale = float(ref.abs().max())
    tol = dict(rtol=1e-5, atol=1e-5 * scale) if dtype == "float32" else dict(
        rtol=2**-7, atol=2**-8 * scale
    )
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), **tol)


# K3 at every tile edge of its bf16 tensor-core body: rows around the n8
# tiles (1, 7, 16, 17, 34, 35) and the 64-row block (64, 65), batch 8 (272)
# and the production rows (340); the canonical and production mid convs, a
# ragged K with N % 16 != 0 (rows not 16-byte aligned), and a tiny case
K3_MS = (1, 7, 16, 17, 34, 35, 64, 65, 272, 340)
K3_KN = ((30000, 10000), (22512, 7504), (1537, 130), (48, 17))
_K3_WEIGHTS = {}


def _k3_weights(device, K, N):
    """Quantized (K, N) weights, made once per shape on the card."""
    if (K, N) not in _K3_WEIGHTS:
        _K3_WEIGHTS.clear()
        gen = torch.Generator(device=device).manual_seed(K + N)
        _K3_WEIGHTS[K, N] = tim.quantize_weight_matrix(
            torch.randn((K, N), generator=gen, device=device))
    return _K3_WEIGHTS[K, N]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,N", K3_KN)
@pytest.mark.parametrize("M", K3_MS)
def test_int8_matmul_kernel_every_tile_edge_on_card(cuda, dtype, M, K, N):
    """One launch a call, bitwise equal over two calls, within the
    tolerances of test_int8_matmul_kernel_on_card."""
    q, s = _k3_weights(cuda, K, N)
    gen = torch.Generator(device=cuda).manual_seed(M)
    x = torch.randn((M, K), generator=gen, device=cuda).to(getattr(torch, dtype))
    before = tim.int8_matmul.launches
    with torch.no_grad():
        out = tim.int8_matmul(x, q, s)
        again = tim.int8_matmul(x, q, s)
    assert tim.int8_matmul.launches == before + 2
    ref = tim.int8_matmul_reference(x, q, s).float()
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    scale = float(ref.abs().max())
    tol = dict(rtol=1e-5, atol=1e-5 * scale) if dtype == "float32" else dict(
        rtol=2**-7, atol=2**-8 * scale
    )
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.cpu().numpy(), **tol)


# (C_in, C_out, N) of the 29 ResnetBlocks of the canonical UNet1d forward (dim
# 4, dim_mults (1, 2, 2, 3, 3, 4, 4), m/z 40000): two a level down, two a level
# up on the concatenated skips, then final_res_block; 14 distinct shapes
RESNET_SHAPES = (
    [(c, c, 40000 >> i) for i, c in enumerate((4, 4, 8, 8, 12, 12, 16)) for _ in "12"]
    + [(i + o, o, 625 << j) for j, (i, o) in enumerate(
        ((16, 16), (12, 16), (12, 12), (8, 12), (8, 8), (4, 8), (4, 4))) for _ in "12"]
    + [(8, 4, 40000)]
)


def _resnet_operands(a, dt, form):
    """The op's operands from ``_resnet_args`` numpy arrays, on the card, as
    a model hands them over: ``"module"`` the torch conv weights (out, in, k)
    stored in x's dtype and seen through ``permute``, biases in x's dtype,
    FiLM as the two halves of one (B, 2 C_out) tensor; ``"masters"`` the
    same views of float32 weights (training)."""
    wd = dt if form == "module" else torch.float32

    def conv(w):  # flax (k, in, out) -> torch (out, in, k) storage, viewed back
        return None if w is None else _t(np.transpose(w, (2, 1, 0))).cuda().to(wd).permute(2, 1, 0)

    def vec(v, d=wd):
        return None if v is None else _t(v).cuda().to(d)

    film = None
    if a["scale"] is not None:
        film = _t(np.concatenate([a["scale"], a["shift"]], axis=1)).cuda().to(dt).chunk(2, dim=-1)
    return [_t(a["x_t"]).cuda().to(dt), conv(a["w1"]), vec(a["b1"]), vec(a["g1"], torch.float32),
            *(film or (None, None)), conv(a["w2"]), vec(a["b2"]), vec(a["g2"], torch.float32),
            conv(a["w_res"]), vec(a["b_res"])]


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["module", "masters"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B", [1, 34])
@pytest.mark.parametrize("c_in,c_out,N", sorted(set(RESNET_SHAPES)))
def test_fused_resnet_kernel_every_block_shape_on_card(cuda, c_in, c_out, N, B, dtype, form):
    """K2 at every ResnetBlock shape of the canonical forward, with the
    parameters as the module hands them over: one launch a call, bitwise
    equal over two calls, and within tolerance of the plain version run in
    float32 on the same values (the conv weights rounded to x's dtype, as
    K2 uses them)."""
    a = _resnet_args(np.random.default_rng(c_in * 1000 + N + B), B, c_in, c_out, N, True,
                     c_in != c_out)
    dt = getattr(torch, dtype)
    ops = _resnet_operands(a, dt, form)
    before = tfr.fused_resnet_block_t.launches
    with torch.no_grad():
        out = tfr.fused_resnet_block_t(*ops)
        again = tfr.fused_resnet_block_t(*ops)
    assert tfr.fused_resnet_block_t.launches == before + 2
    ref_ops = [None if v is None else (_bf16_values(v) if dtype == "bfloat16" and i in (1, 6, 9)
                                       else v.float()) for i, v in enumerate(ops)]
    ref = tfr.resnet_block_t_reference(*ref_ops)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    tol = F32_CARD_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.cpu().numpy(), **tol)


# (C, N) of the 14 mixers of the canonical UNet1d, then a ragged N and one
# column (the MS1 tower's mixer); (16, 200000): a CTA's slice of x exceeds
# K1's staging budget, so its passes read x from device memory
MIXER_SHAPES = [(4, 40000), (4, 20000), (8, 10000), (8, 5000), (12, 2500), (12, 1250),
                (16, 625), (16, 1250), (12, 5000), (8, 20000), (8, 700), (12, 1025), (8, 1),
                (16, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,C,N", [(B, C, N) for C, N in MIXER_SHAPES for B in (1, 34)]
                         + [(1, 16, 200000), (3, 16, 200000)])
def test_linear_attention_kernel_every_mixer_shape_on_card(cuda, dtype, B, C, N):
    """K1 at every mixer shape: one launch per call, bitwise equal over two
    calls, within tolerance of the plain version. bf16 takes its weights as
    the module passes them: bf16 views of the conv weights (transposed,
    not copied); float32 takes contiguous float32 weights."""
    a = _linattn_args(np.random.default_rng(C * 7 + N + B), B, C, N)
    t = {k: _t(v, cuda) for k, v in a.items()}
    dt = getattr(torch, dtype)
    x = t["x"].to(dt)
    w = [t[k] for k in ("w_qkv", "w_out", "b_out", "g", "g_pre")]
    if dtype == "bfloat16":  # (3H, C) and (C, H) conv weights seen as (C, 3H), (H, C)
        w[0] = w[0].t().contiguous().to(dt).t()
        w[1] = w[1].t().contiguous().to(dt).t()
        w[2] = w[2].to(dt)
    before = tla.linear_attention.launches
    with torch.no_grad():
        out = tla.linear_attention(x, *w)
        again = tla.linear_attention(x, *w)
    assert tla.linear_attention.launches == before + 2
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    plan = tla.linear_attention_plan(C, N, bf16=dtype == "bfloat16")
    assert plan["staged"] == (N != 200000), plan
    ref = tla.linear_attention_nr_reference(x.float(), *(v.float() for v in w), 4, 32)
    tol = F32_CARD_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.cpu().numpy(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads", [1, 2, 3, 5, 6, 7, 8])
@pytest.mark.parametrize("B,C,N", [(34, 4, 5000), (2, 16, 1025), (1, 16, 200000)])
def test_linear_attention_kernel_every_head_count_on_card(cuda, dtype, heads, B, C, N):
    """K1 at every heads·32 <= 256: head counts whose features do not fill
    whole thread groups or warps (3, 5, 6, 7), and bf16 above 128 features,
    where phase 0 runs its feature blocks in two passes; bitwise equal over
    two calls, within tolerance of the plain version."""
    a = _linattn_args(np.random.default_rng(heads * 31 + C + N), B, C, N, heads=heads)
    t = {k: _t(v, cuda) for k, v in a.items()}
    dt = getattr(torch, dtype)
    x = t["x"].to(dt)
    w = [t[k] for k in ("w_qkv", "w_out", "b_out", "g", "g_pre")]
    if dtype == "bfloat16":
        w[:3] = [v.to(dt) for v in w[:3]]
    with torch.no_grad():
        out = tla.linear_attention(x, *w, heads=heads)
        again = tla.linear_attention(x, *w, heads=heads)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    ref = tla.linear_attention_nr_reference(x.float(), *(v.float() for v in w), heads, 32)
    tol = F32_CARD_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.cpu().numpy(), **tol)
