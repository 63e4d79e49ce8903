"""The port's flash-attention op (K7) and the attention dispatch against the
JAX package.

The op's plain versions — what :func:`flash_attention` runs on CPU
tensors, forward and backward through its autograd Function — are held
against the JAX flash kernel run in interpret mode, as ``tests/test_ops.py``
runs it on the CPU, with the tolerances of that file. The CUDA kernels are
held against the plain versions by the tests marked ``cuda``, which skip
without a card. On a CUDA machine without JAX (which then cannot load
tests/conftest.py), run them with

    python -m pytest tests/test_torch_flash.py -m cuda --noconftest -q
"""

import json

import numpy as np
import pytest
import torch

import dquartic_tpu_torch.ops.flash_attention as tfa
from dquartic_tpu_torch.ops import attention_dispatch as tad
from test_torch_ops import _AtenLog

try:  # the JAX reference; a CUDA machine without JAX runs only `-m cuda`
    import jax
    import jax.numpy as jnp

    from dquartic_tpu.ops import dot_product_attention as jax_dot_product_attention
    from dquartic_tpu.ops import flash_attention as jfa
except ImportError:
    jax = jnp = jax_dot_product_attention = jfa = None

# float32: the tolerances of tests/test_ops.py for the same kernel (forward
# 2e-5; gradients 2e-4, sums over up to 520 kv rows in another order).
# bf16: both sides take the same bf16 values and compute in float32; the
# outputs round once to bf16 (3e-2), the gradients are held against the
# JAX kernel's bf16 gradients (6e-2), as tests/test_ops.py holds them.
FWD_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
GRAD_TOL = {"float32": 2e-4, "bfloat16": 6e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels only run on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(b, h, n, m, seed, d=32):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, h, x, d)).astype(np.float32) for x in (n, m, m)]


def _t(a, dtype="float32", device="cpu"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=getattr(torch, dtype))


def _j(a, dtype="float32"):
    return jnp.asarray(a).astype(getattr(jnp, dtype))


def _np(x):
    return np.asarray(x.float() if torch.is_tensor(x) else x.astype(jnp.float32), np.float32)


# --------------------------------------------------------------------- #
# the op's plain versions vs the JAX kernel (interpret mode)            #
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("n,m,dtype,scale", [
    (50, 70, "float32", None), (128, 128, "float32", None), (1, 5, "float32", None),
    (200, 34, "float32", None), (130, 257, "float32", None), (50, 70, "float32", 0.5),
    (50, 70, "bfloat16", None),
])
def test_flash_forward_matches_jax(n, m, dtype, scale):
    """out and lse of the plain forward against JAX ``_flash_forward``."""
    q, k, v = _qkv(2, 3, n, m, seed=n + m)
    s = 32 ** -0.5 if scale is None else scale
    jout, jlse = jfa._flash_forward(_j(q, dtype), _j(k, dtype), _j(v, dtype), s)
    out, lse = tfa.flash_attention_reference(_t(q, dtype), _t(k, dtype), _t(v, dtype), s)
    assert out.dtype == getattr(torch, dtype) and lse.dtype == torch.float32
    tol = FWD_TOL[dtype]
    np.testing.assert_allclose(_np(out), _np(jout), rtol=tol, atol=tol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=tol, atol=tol)
    # the differentiable op returns the same output
    op = tfa.flash_attention(_t(q, dtype), _t(k, dtype), _t(v, dtype), scale=scale)
    np.testing.assert_array_equal(_np(op), _np(out))


@pytest.mark.parametrize("n,m,dtype", [
    (200, 34, "float32"), (130, 257, "float32"), (520, 520, "float32"), (100, 100, "bfloat16"),
])
def test_flash_gradients_match_jax(n, m, dtype):
    """Gradients through the autograd Function (its backward is the plain
    version of K7b on CPU tensors) against ``jax.grad`` of the JAX flash op
    (its blockwise Pallas backward in interpret mode)."""
    q, k, v = _qkv(1, 2, n, m, seed=3)

    def jloss(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v).astype(jnp.float32) ** 2)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(_j(q, dtype), _j(k, dtype), _j(v, dtype))
    ts = [_t(a, dtype).requires_grad_(True) for a in (q, k, v)]
    (tfa.flash_attention(*ts).float() ** 2).sum().backward()
    tol = GRAD_TOL[dtype]
    for t, g in zip(ts, jg):
        assert t.grad.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(_np(t.grad), _np(g), rtol=tol, atol=tol)


def test_flash_backward_reference_is_autograd_of_forward():
    """The backward formulas (from the rows' statistics, without the
    softmax) equal autograd of the plain forward: float32, 1e-5 (summation
    order)."""
    q, k, v = (_t(a) for a in _qkv(2, 2, 40, 23, seed=7))
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(1))
    out, stats = tfa._reference_f32(q, k, v, 0.3)
    got = tfa.flash_attention_backward_reference(q, k, v, out, stats, do, 0.3)
    ref = torch.autograd.grad(
        tfa.flash_attention_plain(*[t.requires_grad_(True) for t in (q, k, v)], 0.3), (q, k, v), do)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


def test_flash_backward_gets_the_float32_output(monkeypatch):
    """For bf16 inputs the autograd Function hands its backward the float32
    output, not the one rounded to bf16, so D = rowsum(dO ∘ O) carries no
    rounding shared by every key of a row; its gradients are then those of
    autograd through the plain version, up to their own rounding to bf16.
    The kernel writes that output and the rows' statistics only where
    autograd will need them."""
    seen = []
    real = tfa.flash_attention_backward
    monkeypatch.setattr(tfa, "flash_attention_backward",
                        lambda q, k, v, o, *a: seen.append(o) or real(q, k, v, o, *a))
    q, k, v = (_t(a, "bfloat16") for a in _qkv(1, 2, 30, 20, seed=13))
    do = _t(np.random.default_rng(14).normal(size=q.shape), "bfloat16")
    ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(tfa.flash_attention(*ts), ts, do)
    (o,) = seen
    ref32, _ = tfa.flash_attention_reference(q.float(), k.float(), v.float(), 32 ** -0.5)
    assert o.dtype == torch.float32
    torch.testing.assert_close(o, ref32, rtol=1e-6, atol=1e-6)
    ps = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = torch.autograd.grad(tfa.flash_attention_plain(*ps), ps, do)
    for g, r in zip(got, ref):
        assert g.dtype == torch.bfloat16
        torch.testing.assert_close(g.float(), r.float(), rtol=2**-7, atol=1e-6)

    # The kernel path's buffers, with the kernel library faked: an untracked
    # call (serving) passes the kernel neither the float32 output nor the
    # statistics, a call autograd tracks passes both, for the backward.
    passed = []

    class FakeLibrary:
        def dq_flash_attention(self, q, k, v, out, out32, stats, *rest):
            passed.append((out32 is not None, stats is not None))
            return 0

    monkeypatch.setattr(tfa, "_plain", lambda t: False)
    monkeypatch.setattr(tfa, "_check_kernel_args", lambda *a: None)
    monkeypatch.setattr(tfa._build, "library", FakeLibrary)
    monkeypatch.setattr(tfa._build, "stream_of", lambda t: 0)
    with torch.no_grad():
        tfa.flash_attention(*ts)
    tfa.flash_attention(q, k, v)  # no input requires grad
    tfa.flash_attention(*ts)
    assert passed == [(False, False), (False, False), (True, True)]


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("b,n", [(1, 34), (8, 34), (1, 340), (8, 340)])
def test_flash_backward_plan_is_one_launch_at_the_model_shapes(b, n, bf16):
    """K7b at the UNet's RT lengths (34 canonical, 340 production) and
    batches 1 and 8: one cluster launch a call, ceil(m / 64) CTAs a head."""
    plan = tfa.flash_backward_plan(b, 4, n, n, bf16)
    assert plan == dict(launches=1, cluster=-(-n // 64), tensor_cores=bf16)


@pytest.mark.parametrize("n,m", [(513, 34), (34, 513), (16384, 16384)])
def test_flash_backward_plan_is_two_launches_past_the_limit(n, m):
    """Past FLASH_BWD_ONE_LAUNCH rows on either side: dq, then dk and dv."""
    assert tfa.FLASH_BWD_ONE_LAUNCH == 512
    assert tfa.flash_backward_plan(1, 4, 512, 512)["launches"] == 1
    assert tfa.flash_backward_plan(1, 4, n, m) == dict(launches=2, cluster=0, tensor_cores=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,m", [(34, 34), (600, 130)])
def test_flash_backward_wrapper_allocates_only_the_gradients(monkeypatch, dtype, n, m):
    """K7b's wrapper, with the kernel library faked: given dense, aligned
    inputs in the kernel's dtypes (the float32 output and the rows'
    statistics autograd saves), it runs no aten op but the allocations of
    dq, dk and dv, hands the kernel the inputs' own memory and the cluster
    size of flash_backward_plan, and counts one call."""
    passed = []

    class FakeLibrary:
        def dq_flash_attention_bwd(self, *args):
            passed.append(args)
            return 0

    monkeypatch.setattr(tfa, "_plain", lambda t: False)
    monkeypatch.setattr(tfa, "_check_kernel_args", lambda *a: None)
    monkeypatch.setattr(tfa._build, "library", FakeLibrary)
    monkeypatch.setattr(tfa._build, "stream_of", lambda t: 0)
    q, k, v = (_t(a, dtype) for a in _qkv(1, 2, n, m, seed=17))
    o = _t(np.random.default_rng(18).normal(size=q.shape))
    stats = _t(np.random.default_rng(21).uniform(1, 2, size=(*q.shape[:3], 2)))
    do = _t(np.random.default_rng(20).normal(size=q.shape), dtype)
    before = tfa.flash_attention_backward.launches
    with _AtenLog() as log:
        dq, dk, dv = tfa.flash_attention_backward(q, k, v, o, stats, do, 0.25)
    assert log.ops == ["aten.empty_like"] * 3, log.ops
    assert tfa.flash_attention_backward.launches == before + 1
    (args,) = passed
    ptrs = tuple(t.data_ptr() for t in (q, k, v, o, stats, do, dq, dk, dv))
    plan = tfa.flash_backward_plan(1, 2, n, m, dtype == "bfloat16")
    assert args[:9] == ptrs
    assert args[9:12] == (2, n, m) and args[12] == 0.25
    assert args[13:16] == (int(dtype == "bfloat16"), plan["cluster"], 0)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    assert dq.dtype == dk.dtype == dv.dtype == q.dtype


# --------------------------------------------------------------------- #
# P rebuilt at large logits: the rows' statistics (m, l)                #
# --------------------------------------------------------------------- #

# |logits| the backward is held at: the full UNet1d's transformer reached
# 1e4 to 1.36e8 in training, where P rebuilt from lse went wrong
LOGIT_SCALES = (1e2, 1e4, 1e6, 1.4e8)


def _logit_inputs(b, h, n, m, target, seed):
    """q and k of small integers times powers of two, so every score is an
    exact integer multiple in float32 and in float64 whatever the order of
    its sums (rows tie exactly, and a tie stays one); scaled so the largest
    |logit| (``q·kᵀ·d^-0.5``) is within a factor of two of ``target``; v
    and dO standard normal."""
    rng = np.random.default_rng(seed)
    qi = rng.integers(-3, 4, size=(b, h, n, 32)).astype(np.float64)
    ki = rng.integers(-3, 4, size=(b, h, m, 32)).astype(np.float64)
    top = np.abs(qi @ np.swapaxes(ki, -1, -2)).max() * 32 ** -0.5
    e = int(round(np.log2(target / top)))
    q, k = qi * 2.0 ** (e // 2), ki * 2.0 ** (e - e // 2)
    v, do = (rng.normal(size=(b, h, x, 32)) for x in (m, n))
    return q, k, v, do


def _softmax_backward64(q, k, v, do, scale):
    """dq, dk, dv in float64 by autograd of a plain softmax attention, from
    q, k, v and dO alone, and for each the norm it would have were all its
    terms of one sign: ``|dS|`` bounded by ``P ∘ (|dP| + |D|)``. That norm
    stays clear of 0 where a row is one-hot and the true dq, dk vanish."""
    q, k, v, do = (torch.as_tensor(np.asarray(t, np.float64)) for t in (q, k, v, do))
    ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
    p = torch.softmax(ts[0] @ ts[1].transpose(-1, -2) * scale, dim=-1)
    grads = torch.autograd.grad(p @ ts[2], ts, do)
    p = p.detach()
    d = (do * (p @ v)).sum(-1, keepdim=True)
    ds = p * ((do @ v.transpose(-1, -2)).abs() + d.abs())
    norms = ((ds @ k.abs()).norm() * scale, (ds.transpose(-1, -2) @ q.abs()).norm() * scale,
             (p.transpose(-1, -2) @ do.abs()).norm())
    return grads, [float(x) for x in norms]


def _gap(got, ref, norm):
    return float((got.double().cpu() - ref).norm()) / norm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("target", LOGIT_SCALES)
def test_plain_backward_at_large_logits(dtype, target):
    """The op's plain backward (its autograd Function on CPU tensors, P
    rebuilt from the saved statistics) against float64 autograd of a plain
    softmax attention on the same values, at |logits| from 1e2 to 1.4e8.
    Each gradient's error over the norm it would have were its terms of one
    sign. float32: 1e-4 (the scaled scores round once, 2^-24 of |s|, which
    moves a P that is not one-hot by ~1e-5 at 1e2). bf16: 1e-2 (the
    gradients round once to bf16, 2^-9)."""
    q, k, v, do = _logit_inputs(1, 2, 34, 34, target, seed=int(target) % 1000)
    ts = [_t(a, dtype).requires_grad_(True) for a in (q, k, v)]
    got = torch.autograd.grad(tfa.flash_attention(*ts), ts, _t(do, dtype))
    ref, norms = _softmax_backward64(*(t.detach().double() for t in ts), do, 32 ** -0.5)
    for g, r, norm in zip(got, ref, norms):
        assert g.dtype == getattr(torch, dtype)
        assert _gap(g, r, norm) < (1e-4 if dtype == "float32" else 1e-2), (target, norm)


@pytest.mark.parametrize("target", LOGIT_SCALES)
def test_row_statistics_are_the_rows_max_and_sum(target):
    """The statistics: m the row's largest scaled score (log2 units) and l
    the sum of exp2(score - m), against float64 (m to float32's rounding of
    the scaled score, l within 1e-6 of its float64 sum, so that P = exp2(s -
    m) / l sums to 1 within 1e-5 on every row, even at 1.4e8, where lse
    loses log l and several units of m)."""
    q, k, _, _ = _logit_inputs(2, 2, 40, 23, target, seed=5)
    stats = tfa._reference_f32(_t(q), _t(k), _t(k), 32 ** -0.5)[1]
    s2 = q @ np.swapaxes(k, -1, -2) * float(np.float32(32 ** -0.5) * np.float32(np.log2(np.e)))
    m = s2.max(-1)
    assert stats.shape == (2, 2, 40, 2) and stats.dtype == torch.float32
    np.testing.assert_allclose(stats[..., 0].numpy(), m, rtol=2 ** -23, atol=0)
    np.testing.assert_allclose(stats[..., 1].numpy(), np.exp2(s2 - m[..., None]).sum(-1),
                               rtol=1e-6)
    p = torch.exp2(tfa._scaled_scores(_t(q), _t(k), 32 ** -0.5) - stats[..., :1]) \
        / stats[..., 1:]
    assert float(p.max()) <= 1 + 2 ** -23
    np.testing.assert_allclose(p.sum(-1).numpy(), 1.0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("path", ["plain", "kernel"])
def test_flash_fn_saves_the_statistics(monkeypatch, path, dtype):
    """The autograd Function saves (q, k, v, out32, stats) on both paths,
    and nothing else (no lse): on CPU tensors the plain forward's; on the
    kernel path (the library faked) the buffers K7a was handed, stats
    (b, h, n, 2) float32; and its backward hands those statistics on."""
    q, k, v = (_t(a, dtype).requires_grad_(True) for a in _qkv(1, 2, 30, 20, seed=31))
    handed = {}
    if path == "kernel":
        class FakeLibrary:
            def dq_flash_attention(self, q, k, v, out, out32, stats, *rest):
                handed.update(out32=out32, stats=stats)
                return 0

        monkeypatch.setattr(tfa, "_plain", lambda t: False)
        monkeypatch.setattr(tfa, "_check_kernel_args", lambda *a: None)
        monkeypatch.setattr(tfa._build, "library", FakeLibrary)
        monkeypatch.setattr(tfa._build, "stream_of", lambda t: 0)
    out = tfa.flash_attention(q, k, v)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 5 and all(a is b for a, b in zip(saved[:3], (q, k, v)))
    out32, stats = saved[3:]
    assert out32.dtype == stats.dtype == torch.float32
    assert out32.shape == q.shape and stats.shape == (*q.shape[:3], 2)
    if path == "plain":
        assert torch.equal(stats, tfa._reference_f32(q, k, v, 32 ** -0.5)[1])
    else:
        assert handed["stats"] == stats.data_ptr()
    seen = []
    monkeypatch.setattr(tfa, "flash_attention_backward",
                        lambda *a: seen.append(a[4]) or (None, None, None))
    out.grad_fn.apply(torch.ones_like(out))
    assert seen[0] is stats


@pytest.mark.parametrize("path", ["plain", "kernel"])
def test_flash_backward_refuses_lse_for_the_statistics(monkeypatch, path):
    """The backward takes the rows' statistics (b, h, n, 2) and nothing in
    their place: a caller that hands it lse (b, h, n), the JAX kernel's
    saved row, is refused on both paths before anything runs (on the CPU,
    lse would broadcast against the scores and rebuild a wrong P)."""
    if path == "kernel":
        monkeypatch.setattr(tfa, "_plain", lambda t: False)
        monkeypatch.setattr(tfa._build, "library", lambda: pytest.fail("reached the kernel"))
    q, k, v = (_t(a) for a in _qkv(1, 2, 7, 9, seed=33))
    out, lse = tfa.flash_attention_reference(q, k, v, 0.25)
    with pytest.raises(ValueError, match=r"stats \(b, h, n, 2\)"):
        tfa.flash_attention_backward(q, k, v, out, lse, q, 0.25)


# --------------------------------------------------------------------- #
# dispatch                                                              #
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("impl", ["auto", "xla", "pallas"])
def test_dispatch_matches_jax(impl):
    """Each impl against the JAX dispatch with the same impl (on the CPU
    "auto" is the plain version in both packages)."""
    q, k, v = _qkv(2, 3, 16, 16, seed=11)
    ref = jax_dot_product_attention(_j(q), _j(k), _j(v), impl=impl)
    out = tad.dot_product_attention(_t(q), _t(k), _t(v), impl=impl)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_dispatch_selects_implementation(monkeypatch):
    calls = []
    real = tfa.flash_attention
    monkeypatch.setattr(tfa, "flash_attention", lambda *a: calls.append(1) or real(*a))
    q, k, v = (_t(a) for a in _qkv(1, 2, 16, 16, seed=12))
    for impl, expect in (("pallas", 1), ("xla", 0), ("auto", 0)):
        calls.clear()
        tad.dot_product_attention(q, k, v, impl=impl)
        assert len(calls) == expect, impl
    calls.clear()
    out = tad.dot_product_attention(q, k, v, impl="pallas", kernels=False)
    assert not calls  # the plain version of the flash op
    np.testing.assert_allclose(out.numpy(), real(q, k, v).detach().numpy(), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="Unknown attention impl"):
        tad.dot_product_attention(q, k, v, impl="nope")


@pytest.mark.parametrize("dtype,d,extra,expect", [
    ("bfloat16", 32, 0, True), ("bfloat16", 32, -1, False), ("float32", 32, 300, False),
    ("bfloat16", 64, 300, False), ("float32", 64, 0, False),
])
def test_auto_takes_the_kernel_only_where_the_sweep_measured_it(dtype, d, extra, expect):
    """``"auto"`` sends to K7a only bf16 at head dimension 32 from
    FLASH_MIN_SEQ rows up (``extra`` rows past it): float32 (K7a's
    CUDA-core body) and other head dimensions (which the kernels refuse)
    take the plain version."""
    q = torch.zeros((1, 2, (tad.FLASH_MIN_SEQ or 34) + extra, d), dtype=getattr(torch, dtype))
    assert tad.flash_suits(q, q) == (expect and tad.FLASH_MIN_SEQ is not None)
    assert tad.flash_suits(q, q[..., :1, :]) is False  # the shorter sequence decides


def _small_config(simple, attn_impl):
    from dquartic_tpu_torch.utils.config import load_train_config

    cfg = load_train_config("dquartic_train_config.json")
    cfg["model"]["UNet1d"].update(dim_mults=[1, 2], downsample_dim=64, simple=simple)
    cfg["tpu"]["attn_impl"] = attn_impl
    return json.loads(json.dumps(cfg))


@pytest.mark.parametrize("simple,attn_impl,expect", [
    (True, "pallas", 1), (False, "pallas", 8), (True, "auto", 0), (False, "xla", 0),
])
def test_config_attn_impl_reaches_the_attention(monkeypatch, simple, attn_impl, expect):
    """``tpu.attn_impl = "pallas"`` sends every softmax attention of the
    built model through the flash op: one per forward for simple=True, 8
    for simple=False at tfer_depth 4 (2 in the MS1 tower, 2 self and 2
    hybrid layers of 2 in the bottleneck)."""
    from dquartic_tpu_torch.utils.builder import build_model

    calls = []
    real = tfa.flash_attention
    monkeypatch.setattr(tfa, "flash_attention", lambda *a: calls.append(1) or real(*a))
    model = build_model(_small_config(simple, attn_impl), device="cpu", seed=0)
    rng = np.random.default_rng(0)
    x = _t(rng.normal(size=(1, 4, 64)).astype(np.float32))
    with torch.no_grad():
        out = model(x, torch.tensor([10]), x, _t(rng.uniform(size=(1, 4)).astype(np.float32)))
    assert out.shape == (1, 4, 64) and bool(torch.isfinite(out).all())
    assert len(calls) == expect


def test_attn_impl_in_model_section_is_an_error():
    from dquartic_tpu_torch.utils.builder import build_model

    cfg = _small_config(True, "auto")
    cfg["model"]["UNet1d"]["attn_impl"] = "pallas"
    with pytest.raises(ValueError, match="tpu section"):
        build_model(cfg, device="cpu")


# --------------------------------------------------------------------- #
# the CUDA kernels (run on the card only)                               #
# --------------------------------------------------------------------- #

# float32 on the card: the kernel sums the scores and products in another
# order than cuBLAS and uses exp2f; values O(1): 1e-5. bf16: both take the
# same bf16 values and compute in float32; the kernel output rounds once.
CARD_TOL = {"float32": 1e-5, "bfloat16": 1e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,n,m", [(1, 4, 34, 34), (2, 3, 130, 257)])
def test_flash_forward_kernel_on_card(cuda, dtype, b, h, n, m):
    q, k, v = (_t(a, dtype, cuda) for a in _qkv(b, h, n, m, seed=20))
    before = tfa.flash_attention.launches
    out = tfa.flash_attention(q, k, v)
    out2, out32, stats = tfa._launch_forward(q, k, v, 32 ** -0.5)
    torch.cuda.synchronize()
    ref, ref_lse = tfa.flash_attention_reference(q, k, v, 32 ** -0.5)
    ref32, _ = tfa.flash_attention_reference(q.float(), k.float(), v.float(), 32 ** -0.5)
    assert tfa.flash_attention.launches == before + 2
    assert torch.equal(out, out2)
    assert out32.dtype == torch.float32 and torch.equal(out32.to(q.dtype), out)
    tol = CARD_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(out32, ref32, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(tfa.lse_of(stats), ref_lse, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,n,m", [(1, 4, 34, 34), (2, 3, 130, 257)])
def test_flash_backward_kernel_on_card(cuda, dtype, b, h, n, m):
    """K7b against autograd of the plain version run in float32 on the same
    values, max |error| over the largest entry; deterministic."""
    q, k, v = (_t(a, dtype, cuda) for a in _qkv(b, h, n, m, seed=21))
    do = _t(np.random.default_rng(22).normal(size=q.shape).astype(np.float32), dtype, cuda)
    _, out32, stats = tfa._launch_forward(q, k, v, 32 ** -0.5)
    got = tfa.flash_attention_backward(q, k, v, out32, stats, do, 32 ** -0.5)
    again = tfa.flash_attention_backward(q, k, v, out32, stats, do, 32 ** -0.5)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ts = [t.float().requires_grad_(True) for t in (q, k, v)]
    ref = torch.autograd.grad(tfa.flash_attention_plain(*ts), ts, do.float())
    for g, r in zip(got, ref):
        assert g.dtype == q.dtype
        err = float((g.float() - r).abs().max() / r.abs().max())
        assert err < (1e-5 if dtype == "float32" else 1e-2), err


_EDGES = (1, 15, 17, 63, 65)  # around the 16-row warp block and the 64-row kv tile
# chip_smoke.py's FLASH_SHAPES: the RT axis at 34 and 340, batch 8, ragged
FLASH_SHAPES = ((1, 4, 34, 34), (1, 4, 340, 340), (8, 4, 34, 34), (1, 4, 130, 257))
# both sides of K7b's one-launch limit (512 rows of q and of k)
_LIMIT = ((1, 2, 512, 512), (1, 2, 513, 512), (1, 2, 512, 513), (1, 2, 700, 100),
          (1, 2, 100, 700), (1, 2, 1000, 1300))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,n,m", FLASH_SHAPES + _LIMIT
                         + tuple((2, 3, n, m) for n in _EDGES for m in _EDGES))
def test_flash_backward_kernel_every_edge_on_card(cuda, dtype, b, h, n, m):
    """K7b (bf16 on tensor cores) at the UNet's shapes, around its tile and
    warp edges and on both sides of the one-launch limit, against autograd
    of the plain version run in float32 on the same values: max |error|
    over the largest entry of the three gradients (at m = 1 dq and dk are
    zero: P = 1 and dS = dP - D = 0); two identical calls bitwise equal."""
    q, k, v = (_t(a, dtype, cuda) for a in _qkv(b, h, n, m, seed=n * 1000 + m))
    do = _t(np.random.default_rng(n + m).normal(size=q.shape).astype(np.float32), dtype, cuda)
    _, out32, stats = tfa._launch_forward(q, k, v, 32 ** -0.5)
    before = tfa.flash_attention_backward.launches
    got = tfa.flash_attention_backward(q, k, v, out32, stats, do, 32 ** -0.5)
    again = tfa.flash_attention_backward(q, k, v, out32, stats, do, 32 ** -0.5)
    torch.cuda.synchronize()
    assert tfa.flash_attention_backward.launches == before + 2
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    ts = [t.float().requires_grad_(True) for t in (q, k, v)]
    ref = torch.autograd.grad(tfa.flash_attention_plain(*ts), ts, do.float())
    scale = max(float(r.abs().max()) for r in ref)
    for g, r in zip(got, ref):
        assert g.dtype == q.dtype and g.shape == r.shape
        err = float((g.float() - r).abs().max()) / scale
        assert err < (1e-5 if dtype == "float32" else 1e-2), err


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,n,m", [(1, 4, 34, 34), (1, 4, 340, 340), (8, 4, 34, 34),
                                     (1, 4, 130, 257)]
                         + [(2, 3, n, m) for n in _EDGES for m in _EDGES])
def test_flash_forward_bf16_tensor_cores_on_card(cuda, b, h, n, m):
    """The bf16 K7a (mma.sync) at the UNet's shapes and at n, m around its
    tile edges: the output within the bf16 tolerance of the plain version,
    the float32 output and lse (from the rows' statistics) within 1e-5 of
    the plain version in float32 on the same values; an untracked call (the
    serving path) gives the same output without writing the statistics or
    the float32 output."""
    q, k, v = (_t(a, "bfloat16", cuda) for a in _qkv(b, h, n, m, seed=n * 100 + m))
    out, out32, stats = tfa._launch_forward(q, k, v, 32 ** -0.5)
    with torch.no_grad():
        served = tfa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    ref, _ = tfa.flash_attention_reference(q, k, v, 32 ** -0.5)
    ref32, ref_lse = tfa.flash_attention_reference(q.float(), k.float(), v.float(), 32 ** -0.5)
    assert torch.equal(served, out) and torch.equal(out32.to(torch.bfloat16), out)
    torch.testing.assert_close(out.float(), ref.float(), rtol=CARD_TOL["bfloat16"],
                               atol=CARD_TOL["bfloat16"])
    torch.testing.assert_close(out32, ref32, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(tfa.lse_of(stats), ref_lse, rtol=1e-5, atol=1e-5)


# shapes of the backward at large logits: the canonical model's (batch 1 and
# 8), production's RT axis, and one past the one-launch limit
LARGE_SHAPES = ((1, 4, 34, 34), (8, 4, 34, 34), (1, 4, 340, 340), (1, 2, 600, 600))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("target", LOGIT_SCALES)
@pytest.mark.parametrize("b,h,n,m", LARGE_SHAPES)
def test_flash_backward_kernel_at_large_logits_on_card(cuda, b, h, n, m, target, dtype):
    """K7a then K7b through the autograd Function (as the model runs them)
    at |logits| from 1e2 to 1.4e8, against a float64 softmax backward
    computed from q, k, v and dO alone (not from the kernel's statistics);
    each gradient's error over the norm it would have were its terms of one
    sign, which stays clear of 0 where rows are one-hot.
    float32: 1e-4 (the scaled scores round once, 2^-24 of |s|, which moves a
    P that is not one-hot by ~1e-5 at 1e2). bf16: 1e-2 (the gradients
    round once to bf16, 2^-9, and dS enters its products as (hi, lo)
    halves, ~2^-17)."""
    q, k, v, do = _logit_inputs(b, h, n, m, target, seed=n + int(np.log10(target)))
    ts = [_t(a, dtype, cuda).requires_grad_(True) for a in (q, k, v)]
    got = torch.autograd.grad(tfa.flash_attention(*ts), ts, _t(do, dtype, cuda))
    torch.cuda.synchronize()
    ref, norms = _softmax_backward64(*(t.detach().double().cpu() for t in ts), do, 32 ** -0.5)
    for name, g, r, norm in zip("qkv", got, ref, norms):
        assert g.dtype == getattr(torch, dtype) and bool(torch.isfinite(g).all())
        err = _gap(g, r, norm)
        assert err < (1e-4 if dtype == "float32" else 1e-2), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("target", LOGIT_SCALES)
@pytest.mark.parametrize("m", [34, 600])
def test_flash_backward_rebuilds_p_exactly_on_card(cuda, m, target, dtype):
    """The P that K7b rebuilds, read out through dv = Pᵀ dO with dO's row
    i the unit vector of feature i (n = 32 rows: dv[j, i] = P[i, j]), on
    the one cluster launch (m = 34) and the two launches (m = 600). On
    every row: no entry above 1 by more than float32's rounding, the row's
    sum 1 within 1e-5, and P within 2e-5 of a float64 softmax of the same
    scores (exact in both: integer multiples; the scale's product rounds
    once, 2^-24 of |s|). bf16 writes dv in bf16: P to 2^-8 there, the sums
    within 32 of its spacings."""
    q, k, v, _ = _logit_inputs(1, 4, 32, m, target, seed=m + int(np.log10(target)))
    qt, kt, vt = (_t(a, dtype, cuda) for a in (q, k, v))
    do = torch.eye(32, dtype=qt.dtype, device=cuda).expand(1, 4, 32, 32).contiguous()
    _, out32, stats = tfa._launch_forward(qt, kt, vt, 32 ** -0.5)
    dv = tfa.flash_attention_backward(qt, kt, vt, out32, stats, do, 32 ** -0.5)[2]
    torch.cuda.synchronize()
    p = dv.double().cpu().transpose(-1, -2)  # (b, h, n, m)
    s = torch.as_tensor(q @ np.swapaxes(k, -1, -2) * 32 ** -0.5)
    p64 = torch.softmax(s, dim=-1)
    one = 2 ** -23 if dtype == "float32" else 0.0
    assert float(p.max()) <= 1 + one
    sums = (p.sum(-1) - 1).abs().max()
    assert float(sums) <= (1e-5 if dtype == "float32" else 32 * 2 ** -9), float(sums)
    tol = 2e-5 if dtype == "float32" else 2 ** -8
    assert float((p - p64).abs().max()) <= tol
