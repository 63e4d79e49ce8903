"""Sequence parallelism of the port: the K6 op (``linear_attention_sp``),
the halo and gather collectives, ``UNet1d(activation_sharding)``, the
Trainer and the sampler on a mesh, against the JAX package.

The ranks are processes of one gloo group on the CPU (one pool of four for
the module; the sp = 2 cases run on a group of ranks 0 and 1), where the
port's kernel wrappers run their plain versions and the collectives are
the real ``all_reduce``. Inputs and weights are made with numpy from a
seed in this process, which also runs the JAX side, on one device or on a
virtual CPU mesh with the Pallas sp kernels in interpret mode, as
``tests/test_parallel.py`` does. The CUDA kernels K6a-c are held against
their plain versions, and a hand split of N against K1/K4, by the tests
marked ``cuda``, which skip without a card; on a CUDA machine without JAX:

    python -m pytest tests/test_torch_sp.py -m cuda --noconftest -q
"""

import multiprocessing as mp
import os
import queue
import socket
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist

import dquartic_tpu_torch.ops.linear_attention as tla
from dquartic_tpu_torch.core import DDIMProcess, make_schedule
from dquartic_tpu_torch.infer import DDIMSampler
from dquartic_tpu_torch.models import UNet1d
from dquartic_tpu_torch.parallel import (
    halo_exchange, initialize_runtime, make_mesh, mesh_axis_sizes, sharded_levels, sp_gather,
    sp_slice,
)
from dquartic_tpu_torch.train import Trainer
from dquartic_tpu_torch.utils.builder import build_mesh, build_model, build_trainer
from dquartic_tpu_torch.utils.config import load_train_config
from chip_smoke import _hand_split
from test_torch_ops import _AtenLog
from test_torch_train_ops import _ALLOCATIONS

try:  # the JAX reference; a CUDA machine without JAX runs only `-m cuda`
    import jax
    import jax.numpy as jnp

    from dquartic_tpu.compat.torch_ckpt import convert_unet1d_state_dict
    from dquartic_tpu.core import DDIMProcess as JaxDDIMProcess
    from dquartic_tpu.core import make_schedule as jax_make_schedule
    from dquartic_tpu.models import UNet1d as JaxUNet1d
    from dquartic_tpu.ops import linear_attention as jla
    from dquartic_tpu.parallel import make_mesh as jax_make_mesh
    from dquartic_tpu.train import Trainer as JaxTrainer
    from dquartic_tpu_torch.compat.jax_params import jax_params_to_torch
    from test_torch_model import random_params
    from test_torch_trainer import _flat, _jax_draws
except ImportError:
    jax = None

WORLD = 4
CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "dquartic_train_config.json")
# JAX's own tolerances for the sp kernels (tests/test_parallel.py): the
# forward at rtol 3e-4 / atol 3e-5, the six gradients at 2e-3 / 2e-3. Here
# both sides sum the same float32 terms in another order, and the
# tolerances hold an order of magnitude tighter.
OP_TOL = dict(rtol=3e-5, atol=3e-6)
OP_GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
# Whole models: the sharded forward against the unsharded JAX forward at
# JAX's own rtol 1e-4 / atol 1e-5 (test_parallel.py:321-323).
MODEL_TOL = dict(rtol=1e-4, atol=1e-5)
TINY = dict(dim=4, channels=1, conditional=True, init_cond_channels=1, attn_cond_channels=1,
            simple=True)
RT = 4


# --------------------------------------------------------------------- #
# the pool of ranks                                                     #
# --------------------------------------------------------------------- #


def _rank_main(rank, init_method, inq, outq):
    torch.set_num_threads(1)
    initialize_runtime("gloo", rank, WORLD, init_method, timeout_s=120)
    # every process makes both meshes' groups, in one order
    meshes = {sp: make_mesh(sp=sp, ranks=range(sp)) for sp in (WORLD, 2)}
    while True:
        task = inq.get()
        if task is None:
            break
        name, sp, args = task
        try:
            res = globals()[name](meshes[sp], *args) if rank < sp else None
            outq.put((rank, True, res))
        except Exception:  # reported to the test, which fails with it
            outq.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class _Ranks:
    """WORLD processes in one gloo group; ``run(name, sp, *args)`` calls
    ``name(mesh, *args)`` on ranks 0 .. sp-1 and returns their results."""

    def __init__(self):
        ctx = mp.get_context("spawn")
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        self.inqs = [ctx.Queue() for _ in range(WORLD)]
        self.outq = ctx.Queue()
        self.procs = [ctx.Process(target=_rank_main, daemon=True,
                                  args=(r, f"tcp://127.0.0.1:{port}", self.inqs[r], self.outq))
                      for r in range(WORLD)]
        for p in self.procs:
            p.start()

    def run(self, name, sp, *args):
        for q in self.inqs:
            q.put((name, sp, args))
        got = {}
        for _ in range(WORLD):
            try:
                rank, ok, res = self.outq.get(timeout=300)
            except queue.Empty:
                pytest.fail(f"{name}: a rank did not answer")
            if not ok:
                pytest.fail(f"{name} failed on rank {rank}:\n{res}")
            got[rank] = res
        return [got[r] for r in range(sp)]

    def close(self):
        for q in self.inqs:
            q.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()


@pytest.fixture(scope="module")
def ranks():
    pool = _Ranks()
    yield pool
    pool.close()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------------- #
# the plan and the collectives                                          #
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("mz,levels,sp,k", [
    (40000, 7, 2, 6), (40000, 7, 4, 5), (40000, 7, 1, 7), (16, 2, 2, 2), (20, 3, 2, 2),
    (24, 3, 4, 2), (30016, 7, 2, 6), (64, 3, 4, 3),
])
def test_level_plan(mz, levels, sp, k):
    """The canonical window at sp = 2 shards levels 40000 .. 1250 (12 of
    the 14 mixers on K6) and runs 625 in full on every rank."""
    assert sharded_levels(mz, levels, sp) == k


def test_level_plan_rejects_an_unsplittable_window():
    with pytest.raises(ValueError, match="does not split"):
        sharded_levels(40001, 1, 2)


def _collectives(mesh, x, r_halo, r_gather):
    """Each rank's slice through halo_exchange (1 left, 2 right) and
    sp_gather, with a loss weighted by per-rank random arrays; returns the
    outputs and the input cotangent."""
    rank = mesh.sp_rank
    leaf = sp_slice(_t(x), mesh.sp_group).requires_grad_(True)
    h = halo_exchange(leaf, 1, 2, mesh.sp_group)
    g = sp_gather(leaf * 2.0, mesh.sp_group)
    loss = (h * _t(r_halo[rank])).sum() + (g * _t(r_gather[rank])).sum()
    loss.backward()
    return h.detach().numpy(), g.detach().numpy(), leaf.grad.numpy()


@pytest.mark.parametrize("sp", [2, 4])
def test_halo_and_gather_are_adjoint(ranks, sp):
    """halo_exchange is the window of the zero-padded global sequence, the
    gather the whole sequence; their backwards give every rank the
    cotangent of its slice under the sum of the ranks' losses."""
    rng = np.random.default_rng(sp)
    x = rng.normal(size=(2, 3, 8 * sp)).astype(np.float32)
    n = 8
    r_halo = rng.normal(size=(sp, 2, 3, n + 3)).astype(np.float32)
    r_gather = rng.normal(size=(sp, 2, 3, 8 * sp)).astype(np.float32)
    out = ranks.run("_collectives", sp, x, r_halo, r_gather)
    xt = _t(x).requires_grad_(True)
    padded = torch.nn.functional.pad(xt, (1, 2))
    loss = sum((padded[..., r * n:r * n + n + 3] * _t(r_halo[r])).sum()
               + (2.0 * xt * _t(r_gather[r])).sum() for r in range(sp))
    loss.backward()
    for r, (h, g, dx) in enumerate(out):
        np.testing.assert_array_equal(h, padded[..., r * n:r * n + n + 3].detach().numpy())
        np.testing.assert_array_equal(g, 2.0 * x)
        np.testing.assert_allclose(dx, xt.grad[..., r * n:(r + 1) * n].numpy(), rtol=1e-6,
                                   atol=1e-6)


# --------------------------------------------------------------------- #
# the K6 op against the JAX sp kernels                                  #
# --------------------------------------------------------------------- #


def _op_weights(C, seed, heads=4):
    rng = np.random.default_rng(seed)
    H = heads * 32
    return [(rng.normal(size=s) * sc).astype(np.float32) for s, sc in
            (((C, 3 * H), 0.1), ((H, C), 0.1), ((C,), 0.1), ((C,), 1.0), ((C,), 1.0))]


def _sp_op(mesh, x, w, dy):
    """linear_attention_sp on this rank's slice of x (B, C, N): y, dx of
    the loss Σ y·dy over the ranks, the rank's weight partials, and the
    shapes of the tensors the op summed over the ranks in its forward and
    in its backward."""
    rank, size = mesh.sp_rank, mesh.sp
    n = x.shape[2] // size
    xs = _t(x[:, :, rank * n:(rank + 1) * n]).requires_grad_(True)
    ws = [_t(a).requires_grad_(True) for a in w]
    summed, real = [], tla.sp_all_reduce
    tla.sp_all_reduce = lambda t, group: summed.append(tuple(t.shape)) or real(t, group)
    try:
        y = tla.linear_attention_sp(xs, *ws, group=mesh.sp_group)
        forward = list(summed)
        (y * _t(dy[:, :, rank * n:(rank + 1) * n])).sum().backward()
    finally:
        tla.sp_all_reduce = real
    return (y.detach().numpy(), xs.grad.numpy(), [t.grad.numpy() for t in ws],
            (forward, summed[len(forward):]))


def _sp_op_inputs(C, N, seed):
    w = _op_weights(C, seed=seed)
    rng = np.random.default_rng(seed + 1)
    return (w, rng.normal(size=(2, C, N)).astype(np.float32),
            rng.normal(size=(2, C, N)).astype(np.float32))


def _jax_op(x, w, dy, sp=None):
    """JAX ``fused_linear_attention_t`` (pre-norm, residual) on (B, C, N)
    and its vjp for ``dy``: on one device, or with ``sp_axis="sp"`` on an
    ``sp``-device mesh; returns y and the six gradients as numpy arrays in
    the port's layouts."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    jw = [jnp.asarray(a) for a in w]

    def f(xx, wq, wo, bo, gg, gp):
        return jla.fused_linear_attention_t(xx, wq, wo, bo, gg, 4, 32, g_pre=gp, residual=True,
                                            sp_axis="sp" if sp else None)

    xj, dyj = jnp.asarray(x.transpose(0, 2, 1)), jnp.asarray(dy.transpose(0, 2, 1))
    if sp:
        mesh = jax_make_mesh(dp=1, sp=sp, tp=1, devices=jax.devices()[:sp])
        with jax.set_mesh(mesh):
            xs = jax.device_put(xj, NamedSharding(mesh, P(None, "sp", None)))
            yj, vjp = jax.vjp(jax.jit(f), xs, *jw)
            grads = vjp(dyj)
    else:
        yj, vjp = jax.vjp(jax.jit(f), xj, *jw)
        grads = vjp(dyj)
    return (np.asarray(yj).transpose(0, 2, 1), np.asarray(grads[0]).transpose(0, 2, 1),
            [np.asarray(gr) for gr in grads[1:]])


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("N", [256, 600])
def test_sp_op_matches_jax(ranks, N, sp):
    """``linear_attention_sp`` at sp = 2 and 4 (f32; N = 600 leaves 300 or
    150 columns a rank, ragged against the JAX kernel's 512-column block)
    against JAX ``fused_linear_attention_t(..., sp_axis="sp")`` on an
    sp-device mesh: the output and all six gradients (the weights' as the
    sum of the ranks' partials)."""
    w, x, dy = _sp_op_inputs(4, N, seed=N)
    out = ranks.run("_sp_op", sp, x, w, dy)
    y = np.concatenate([o[0] for o in out], axis=2)
    dx = np.concatenate([o[1] for o in out], axis=2)
    dws = [sum(o[2][i] for o in out) for i in range(5)]
    yj, dxj, grads = _jax_op(x, w, dy, sp=sp)
    np.testing.assert_allclose(y, yj, **OP_TOL)
    np.testing.assert_allclose(dx, dxj, **OP_GRAD_TOL)
    for got, ref in zip(dws, grads):
        np.testing.assert_allclose(got, ref, **OP_GRAD_TOL)


@pytest.mark.parametrize("sp", [2, 4])
def test_sp_op_sums_the_stats_once_and_z_once_in_the_backward(ranks, sp):
    """The forward sums (A, s) over the ranks; the backward sums the
    recomputed (A, s) and then Z, and nothing else: two collectives a
    backward (T follows from Z and the summed (A, s))."""
    C, N = 4, 64
    w, x, dy = _sp_op_inputs(C, N, seed=7)
    for *_, (forward, backward) in ranks.run("_sp_op", sp, x, w, dy):
        assert forward == [(2, 128, C + 1)]
        assert backward == [(2, 128, C + 1), (2, 128, C)]


@pytest.mark.parametrize("sp", [2, 4])
def test_sp_weight_partials_follow_the_rule(ranks, sp):
    """Each rank's dW_out and dW_v are those of its own bmat (its A over the
    summed s) against the summed Z, Z here from autograd of the plain
    forward with respect to the folded context M (Z = (∂L/∂M)ᵀ); summed over
    the ranks they are JAX's gradients on one device."""
    C, N, H = 4, 128, 128
    w, x, dy = _sp_op_inputs(C, N, seed=11)
    out = ranks.run("_sp_op", sp, x, w, dy)
    w_qkv, w_out, b_out, g, g_pre = map(_t, w)
    xt = _t(x)
    stats = tla.sp_stats_reference(xt, w_qkv, g_pre, round_operands=False)
    _, inv_s, m = tla.sp_context(stats, w_qkv, w_out)
    m.requires_grad_(True)
    (tla.sp_apply_reference(xt, m, w_qkv, b_out, g, g_pre) * _t(dy)).sum().backward()
    z = m.grad.transpose(1, 2).reshape(2, 4, 32, C)  # (B, heads, 32, C)
    wv = w_qkv[:, 2 * H:].t().reshape(4, 32, C)
    wo = w_out.reshape(4, 32, C)
    n = N // sp
    for r, o in enumerate(out):
        local = tla.sp_stats_reference(xt[:, :, r * n:(r + 1) * n], w_qkv, g_pre,
                                       round_operands=False)
        bmat = (local[..., :C] * inv_s[..., None]).reshape(2, 4, 32, C)
        ctx = torch.einsum("bhic,hjc->bhij", bmat, wv)
        dctx = torch.einsum("bhic,hjc->bhij", z, wo)
        dwo = torch.einsum("bhij,bhic->hjc", ctx, z).reshape(H, C)
        dwv = torch.einsum("bhij,bhic->hjc", dctx, bmat).reshape(H, C)
        np.testing.assert_allclose(o[2][1], dwo.numpy(), **OP_GRAD_TOL)
        np.testing.assert_allclose(o[2][0][:, 2 * H:], dwv.t().numpy(), **OP_GRAD_TOL)
    _, _, grads = _jax_op(x, w, dy)
    np.testing.assert_allclose(sum(o[2][1] for o in out), grads[1], **OP_GRAD_TOL)
    np.testing.assert_allclose(sum(o[2][0] for o in out)[:, 2 * H:], grads[0][:, 2 * H:],
                               **OP_GRAD_TOL)


def _recording_sp_library(monkeypatch, *entries):
    """Route ``entries`` of the kernel library to one recorder; returns the
    list of (entry, arguments) in call order."""
    calls = []

    class FakeLibrary:
        pass

    for entry in entries:
        setattr(FakeLibrary, entry,
                lambda self, *args, entry=entry: calls.append((entry, args)) or 0)
    monkeypatch.setattr(tla._build, "library", FakeLibrary)
    monkeypatch.setattr(tla._build, "stream_of", lambda t: 0)
    return calls


def _module_weights(C, dt, seed):
    """The weights as LinearAttention hands them over: transposed views of
    the conv weights in the compute dtype, float32 gains, g_pre as (1, C, 1)."""
    w_qkv, w_out, b_out, g, g_pre = map(_t, _op_weights(C, seed))
    conv_qkv, conv_out = w_qkv.t().contiguous().to(dt), w_out.t().contiguous().to(dt)
    return [conv_qkv.t(), conv_out.t(), b_out.to(dt), g, g_pre.reshape(1, C, 1)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("round_operands", [True, False])
def test_sp_stats_wrapper_hands_the_weights_over_as_they_are(monkeypatch, dtype,
                                                             round_operands):
    """K6a's wrapper runs no aten op but the stats' allocation: one launch,
    which gets w_qkv's and g_pre's own memory, strides and dtypes (no
    static shifts, casts or transposes on the host), and the counter
    advances by one."""
    calls = _recording_sp_library(monkeypatch, "dq_linear_attention_sp_stats")
    dt = getattr(torch, dtype)
    B, C, N = 2, 4, 10
    x = _t(np.random.default_rng(3).normal(size=(B, C, N)).astype(np.float32)).to(dt)
    w = _module_weights(C, dt, seed=3)
    before = tla.linear_attention_sp_stats.launches
    with _AtenLog() as log:
        stats = tla._sp_stats_kernel(x, w[0], w[4], 4, 32, round_operands)
    assert set(log.ops) <= _ALLOCATIONS, log.ops
    assert tla.linear_attention_sp_stats.launches == before + 1
    ((entry, args),) = calls
    assert args[:7] == (x.data_ptr(), w[0].data_ptr(), 1, C, w[4].data_ptr(), 1,
                        stats.data_ptr())
    bits = 1 if dtype == "bfloat16" else 0  # w_qkv in the compute dtype, g_pre float32
    # B, C, N, heads, weight dtype bits, round, bf16 x, device
    assert args[7:15] == (B, C, N, 4, bits, int(round_operands), int(dtype == "bfloat16"), 0)
    assert stats.shape == (B, 128, C + 1) and stats.dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sp_apply_wrapper_hands_the_weights_over_as_they_are(monkeypatch, dtype):
    """K6b's wrapper runs no aten op but y's allocation: one launch, which
    gets the summed stats as they are and the five weights' own memory,
    strides and dtypes (no context, no static shifts, no casts on the host),
    and the counter advances by one."""
    calls = _recording_sp_library(monkeypatch, "dq_linear_attention_sp_apply")
    dt = getattr(torch, dtype)
    B, C, N, H = 2, 4, 10, 128
    x = _t(np.random.default_rng(5).normal(size=(B, C, N)).astype(np.float32)).to(dt)
    w = _module_weights(C, dt, seed=5)
    stats = torch.rand(B, H, C + 1)
    before = tla.linear_attention_sp_apply.launches
    with _AtenLog() as log:
        y = tla._sp_apply_kernel(x, stats, *w, 4, 32)
    assert set(log.ops) <= _ALLOCATIONS, log.ops
    assert tla.linear_attention_sp_apply.launches == before + 1
    ((entry, args),) = calls
    assert args[:3] == (x.data_ptr(), y.data_ptr(), stats.data_ptr())
    assert args[3:15] == (w[0].data_ptr(), 1, C, w[1].data_ptr(), 1, H, w[2].data_ptr(), 1,
                          w[3].data_ptr(), 1, w[4].data_ptr(), 1)
    bits = 0b00111 if dtype == "bfloat16" else 0  # w_qkv, w_out, b_out in the compute dtype
    # B, C, N, heads, weight dtype bits, bf16 x, device
    assert args[15:22] == (B, C, N, 4, bits, int(dtype == "bfloat16"), 0)
    assert y.shape == x.shape and y.dtype == dt
    with pytest.raises(ValueError, match="stats must be"):
        tla._sp_apply_kernel(x, stats[:, :, :C], *w, 4, 32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sp_apply_plain_version_folds_the_stats(dtype):
    """On CPU tensors K6b's op is the plain apply on the context that
    ``sp_context`` folds from the summed stats, M rounded to bf16 for bf16
    x as K1 rounds it: the call the kernel is held against on the card."""
    dt = getattr(torch, dtype)
    B, C, N = 2, 8, 33
    w_qkv, w_out, b_out, g, g_pre = map(_t, _op_weights(C, seed=6))
    x = _t(np.random.default_rng(6).normal(size=(B, C, N)).astype(np.float32)).to(dt)
    stats = tla.sp_stats_reference(x, w_qkv, g_pre)
    y = tla.linear_attention_sp_apply(x, stats, w_qkv, w_out, b_out, g, g_pre)
    _, _, m = tla.sp_context(stats, w_qkv, w_out, round_m=dtype == "bfloat16")
    assert torch.equal(y, tla.sp_apply_reference(x, m, w_qkv, b_out, g, g_pre))
    # one slice holding the whole sequence: the op without sequence parallelism
    ref = tla.linear_attention_nr_reference(x.float(), w_qkv, w_out, b_out, g, g_pre, 4, 32)
    tol = 1e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(y.float().numpy(), ref.numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sp_backward_wrapper_hands_the_weights_over_as_they_are(monkeypatch, dtype):
    """K6c's wrapper runs no aten op but allocations: launch 1 (Z), one
    ``reduce`` of Z, launches 2 and 3 in one entry point, each given the
    weights' own memory, strides and dtypes and the summed and the rank's
    own stats as they are; the gradients come back in each parameter's
    shape, dtype and (for the two matrices) strides; no (B, C, N) float32
    buffer is allocated; the counter advances by one."""
    calls = _recording_sp_library(monkeypatch, "dq_linear_attention_sp_bwd_z",
                                  "dq_linear_attention_sp_bwd_x")
    dt = getattr(torch, dtype)
    B, C, N, H = 2, 4, 10, 128
    rng = np.random.default_rng(4)
    x, dy = (_t(rng.normal(size=(B, C, N)).astype(np.float32)).to(dt) for _ in "12")
    w = _module_weights(C, dt, seed=4)
    stats, local = (torch.rand(B, H, C + 1) for _ in "12")
    reduce = lambda t: calls.append(("reduce", t))  # noqa: E731
    before = tla.linear_attention_sp_backward.launches
    with _AtenLog() as log:
        grads = tla._sp_backward_kernel(dy, x, *w, stats, local, reduce, 4, 32)
    assert set(log.ops) <= _ALLOCATIONS, log.ops
    assert tla.linear_attention_sp_backward.launches == before + 1
    assert [c[0] for c in calls] == ["dq_linear_attention_sp_bwd_z", "reduce",
                                     "dq_linear_attention_sp_bwd_x"]
    (_, za), (_, z), (_, xa) = calls
    assert z.shape == (B, H, C) and z.dtype == torch.float32
    dx, dw_qkv, dw_out, db_out, dg, dg_pre = grads
    weights = (w[0].data_ptr(), 1, C, w[1].data_ptr(), 1, H, w[2].data_ptr(), 1,
               w[3].data_ptr(), 1, w[4].data_ptr(), 1)
    bits = 0b00111 if dtype == "bfloat16" else 0  # w_qkv, w_out, b_out in the compute dtype
    assert za[:2] == (x.data_ptr(), dy.data_ptr()) and za[2:14] == weights
    assert za[14:16] == (stats.data_ptr(), z.data_ptr())
    assert za[17:24] == (B, C, N, 4, bits, int(dtype == "bfloat16"), 0)
    assert xa[:3] == (x.data_ptr(), dy.data_ptr(), dx.data_ptr()) and xa[3:15] == weights
    assert xa[15:27] == (dw_qkv.data_ptr(), *dw_qkv.stride(), dw_out.data_ptr(),
                         *dw_out.stride(), db_out.data_ptr(), 1, dg.data_ptr(), 1,
                         dg_pre.data_ptr(), 1)
    assert xa[27:30] == (stats.data_ptr(), local.data_ptr(), z.data_ptr())
    assert xa[30] == za[16]  # launch 1's row partials (db, dg) reach launch 2
    assert xa[32:40] == (B, C, N, 4, bits, bits, int(dtype == "bfloat16"), 0)
    assert dx.shape == x.shape and dx.dtype == dt
    for gr, p in zip(grads[1:], w):
        assert gr.shape == p.shape and gr.dtype == p.dtype
    assert dw_qkv.stride() == w[0].stride() and dw_out.stride() == w[1].stride()


# --------------------------------------------------------------------- #
# UNet1d(activation_sharding)                                           #
# --------------------------------------------------------------------- #


def _jax_unet(kw, seed):
    model = JaxUNet1d(**TINY, **kw)
    mz = kw["downsample_dim"]
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), np.zeros((1, RT, mz), np.float32),
                            np.zeros((1,), np.int32), np.zeros((1, RT, mz), np.float32),
                            np.zeros((1, RT), np.float32))
    return model, random_params(shapes, seed)


def _inputs(b, mz, seed):
    rng = np.random.default_rng(seed)
    return dict(x=rng.normal(size=(b, RT, mz)).astype(np.float32),
                t=rng.integers(0, 1000, size=(b,)).astype(np.int32),
                ic=rng.uniform(-1, 1, size=(b, RT, mz)).astype(np.float32),
                ac=rng.uniform(-1, 1, size=(b, RT)).astype(np.float32))


def _port_unet(mesh, kw, sd, impl):
    model = UNet1d(**TINY, **kw, linear_attn_impl=impl, activation_sharding=("dp", "sp"))
    model.load_state_dict({k: _t(v) for k, v in sd.items()})
    model.mesh = mesh
    return model.eval()


def _sp_forward(mesh, kw, sd, impl, i):
    """The sharded forward and how many mixers ran the K6 op."""
    model = _port_unet(mesh, kw, sd, impl)
    calls = []
    real = tla.linear_attention_sp_stats
    tla.linear_attention_sp_stats = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        with torch.no_grad():
            out = model(_t(i["x"]), _t(i["t"]).long(), _t(i["ic"]), _t(i["ac"]))
    finally:
        tla.linear_attention_sp_stats = real
    return out.numpy(), len(calls)


@pytest.mark.parametrize("sp,dim_mults,mz,impl,k6", [
    (2, (1, 2), 16, "pallas_t", 4),     # every level sharded: the bottleneck gathers
    (4, (1, 2), 16, "pallas_t", 4),
    (2, (1, 2, 2), 20, "pallas_t", 4),  # level 2 (N = 5) runs in full on every rank
    (4, (1, 2, 2), 24, "pallas_t", 4),  # level 2 (N = 6) in full
    (2, (1, 2, 2), 20, "xla", 0),       # the "xla" mixers on the gathered sequence
    (2, (1, 2, 2), 20, "pallas", 0),    # the "pallas" (K8) mixers gathered likewise
])
def test_sp_unet_forward_matches_jax(ranks, sp, dim_mults, mz, impl, k6):
    """UNet1d(activation_sharding) at sp ranks against JAX UNet1d.apply on
    one device with the same weights; every rank returns the whole output.
    Under "pallas_t" the mixers of sharded levels run K6 (``k6`` of them),
    the others the "xla" path, as the JAX dispatch picks."""
    kw = dict(dim_mults=dim_mults, downsample_dim=mz)
    jmodel, params = _jax_unet(kw, seed=mz)
    i = _inputs(2, mz, seed=mz + sp)
    ref = np.asarray(jax.jit(jmodel.apply)(params, i["x"], i["t"], i["ic"], i["ac"]))
    sd = jax_params_to_torch(params, dim_mults)
    out = ranks.run("_sp_forward", sp, kw, sd, impl, i)
    for got, n_k6 in out:
        assert n_k6 == k6
        np.testing.assert_allclose(got, ref, **MODEL_TOL)


def test_sp_unet_needs_a_mesh():
    """activation_sharding without a mesh raises, as a JAX sharding
    constraint does outside a mesh: the model never runs unsharded in
    silence. fused_resnet and kernel_dp_axis are refused beside it, as in
    JAX."""
    kw = dict(TINY, dim_mults=(1, 2), downsample_dim=16)
    model = UNet1d(**kw, activation_sharding=("dp", "sp"))
    i = _inputs(1, 16, seed=0)
    with pytest.raises(ValueError, match="runs on a mesh"):
        model(_t(i["x"]), _t(i["t"]).long(), _t(i["ic"]), _t(i["ac"]))
    with pytest.raises(ValueError, match="fused_resnet"):
        UNet1d(**kw, activation_sharding=("dp", "sp"), fused_resnet=True)
    with pytest.raises(ValueError, match="kernel_dp_axis"):
        UNet1d(**kw, activation_sharding=("dp", "sp"), kernel_dp_axis="dp")


# --------------------------------------------------------------------- #
# Trainer and sampler on the mesh                                       #
# --------------------------------------------------------------------- #


def _sp_train_step(mesh, kw, sd, batch, t, eps, lr):
    model = _port_unet(mesh, kw, sd, "pallas_t").train()
    tr = Trainer(model, DDIMProcess(schedule=make_schedule(1000, "cosine", "eps")), mesh=mesh)
    m = tr.train_step(batch, lr, t=_t(t), eps=_t(eps))
    return (float(m["loss"]), float(m["grad_norm"]),
            {k: v.detach().numpy() for k, v in model.state_dict().items()},
            {k: v.numpy() for k, v in tr.ema_state_dict().items()})


def test_sp_trainer_step_matches_jax(ranks):
    """One Trainer step at sp = 2 (K6 mixers, halo convs, gradients summed
    over the group) against the single-device JAX step from the same
    weights, batch and draws: loss and gradient norm to 1e-5; parameters
    within 2·lr (Adam's first update is about lr·sign(g)) + 1e-5
    relative, the EMA within 2·lr·1e-3 (tests/test_torch_trainer.py),
    well inside JAX's own 5e-3 for its sp step; both ranks hold the same
    state."""
    lr = 1e-3
    kw = dict(dim_mults=(1, 2), downsample_dim=64)
    rng = np.random.default_rng(11)
    batch = {"ms2_1": rng.uniform(0, 1, (2, RT, 64)).astype(np.float32),
             "ms1_1": rng.uniform(0, 1, (2, RT)).astype(np.float32),
             "ms2_2": rng.uniform(0, 1, (2, RT, 64)).astype(np.float32)}
    jmodel = JaxUNet1d(**TINY, **kw)
    jtr = JaxTrainer(jmodel, JaxDDIMProcess(schedule=jax_make_schedule(1000, "cosine", "eps")),
                     seed=0)
    params = random_params(jax.eval_shape(lambda: jtr.init_params(batch)), seed=12)
    key = jax.random.PRNGKey(13)
    t, eps = _jax_draws(key, 2, batch["ms2_1"].shape)
    jstate, jm = jtr.train_step(jtr._fresh_state(params),
                                {k: jnp.asarray(v) for k, v in batch.items()}, jnp.float32(lr), key)
    sd = jax_params_to_torch(params, kw["dim_mults"])
    out = ranks.run("_sp_train_step", 2, kw, sd, batch, np.asarray(t), np.asarray(eps), lr)
    for loss, gn, got_sd, ema_sd in out:
        np.testing.assert_allclose(loss, float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(gn, float(jm["grad_norm"]), rtol=1e-5)
        got = _flat(convert_unet1d_state_dict(got_sd, kw["dim_mults"]))
        ema = _flat(convert_unet1d_state_dict(ema_sd, kw["dim_mults"]))
        ref, ref_ema = _flat(jstate.params), _flat(jstate.ema_params)
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=2 * lr, err_msg=k)
            np.testing.assert_allclose(ema[k], ref_ema[k], rtol=1e-5, atol=2 * lr * 1e-3,
                                       err_msg=k)
    for k in out[0][2]:
        np.testing.assert_array_equal(out[0][2][k], out[1][2][k], err_msg=k)


def _small_config(sp):
    config = load_train_config(CONFIG)
    config["model"]["UNet1d"].update(dim_mults=[1, 2, 2], downsample_dim=64)
    config["tpu"].update(linear_attn_impl="pallas_t", mesh={"dp": 1, "sp": sp, "tp": 1})
    return config


def _batch(seed, mz=64):
    rng = np.random.default_rng(seed)
    return {"ms2_1": rng.uniform(0, 1, (1, RT, mz)).astype(np.float32),
            "ms1_1": rng.uniform(0, 1, (1, RT)).astype(np.float32),
            "ms2_2": rng.uniform(0, 1, (1, RT, mz)).astype(np.float32)}


def _sp_predict(mesh, batch):
    """build_model from tpu.mesh (the running group of WORLD ranks) ->
    DDIMSampler.predict, 3 steps."""
    config = _small_config(mesh.sp)
    model = build_model(config, device="cpu", seed=5)
    assert model.activation_sharding == ("dp", "sp")
    assert mesh_axis_sizes(model.mesh) == {"dp": 1, "sp": mesh.sp, "tp": 1}
    sampler = DDIMSampler(model, DDIMProcess(schedule=make_schedule(1000, "cosine", "eps")),
                          mesh=model.mesh)
    return sampler.predict([batch], num_steps=3, seed=7, device="cpu")[0]["pred"]


def test_sp_predict_matches_sp1(ranks):
    """predict at sp = 4 (the model built from ``tpu.mesh``) against the
    single-process model of the same seed: the same noise, the same
    prediction on every rank (float32 summation order only)."""
    batch = _batch(3)
    out = ranks.run("_sp_predict", WORLD, batch)
    model = build_model(_small_config(1), device="cpu", seed=5)
    ref = DDIMSampler(model, DDIMProcess(schedule=make_schedule(1000, "cosine", "eps"))).predict(
        [batch], num_steps=3, seed=7, device="cpu")[0]["pred"]
    for pred in out:
        np.testing.assert_allclose(pred, ref, rtol=1e-5, atol=1e-5)


def _sp_build_trainer(mesh, batch):
    config = _small_config(mesh.sp)
    tr = build_trainer(config, device="cpu", seed=5)
    gen = torch.Generator().manual_seed(3)
    m = tr.train_step(batch, 1e-3, generator=gen)
    return float(m["loss"]), float(m["grad_norm"])


def test_build_trainer_on_the_mesh_matches_sp1(ranks):
    """build_trainer from ``tpu.mesh`` with sp = 4 draws t and eps alike on
    every rank and takes the single-process step's loss and gradient
    norm."""
    batch = _batch(4)
    out = ranks.run("_sp_build_trainer", WORLD, batch)
    tr = build_trainer(_small_config(1), device="cpu", seed=5)
    m = tr.train_step(batch, 1e-3, generator=torch.Generator().manual_seed(3))
    for loss, gn in out:
        np.testing.assert_allclose(loss, float(m["loss"]), rtol=1e-5)
        np.testing.assert_allclose(gn, float(m["grad_norm"]), rtol=1e-5)


# --------------------------------------------------------------------- #
# tpu.mesh and activation_sharding reach the model, or raise            #
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("mesh,match", [
    ({"dp": 1, "sp": 2, "tp": 1}, "needs a running torch.distributed"),
    ({"dp": 2, "sp": 1, "tp": 1}, "torch.distributed.run --nproc-per-node 2"),
    ({"dp": 1, "sp": 1, "tp": 2}, "torch.distributed.run --nproc-per-node 2"),
])
def test_config_mesh_reaches_the_model(mesh, match):
    """A mesh of more than one rank in one process raises, naming the
    launcher; it is never dropped (the model with sp = 2 is built on the
    ranks by test_sp_predict_matches_sp1, which checks its
    activation_sharding; dp and tp by tests/test_torch_parallel.py)."""
    config = _small_config(1)
    config["tpu"]["mesh"] = mesh
    with pytest.raises(ValueError, match=match):
        build_model(config, device="cpu")
    with pytest.raises(ValueError, match=match):
        build_trainer(config, device="cpu")


def test_config_unet_mesh_keys_reach_the_model():
    """``activation_sharding`` in the UNet1d block reaches UNet1d (which then
    needs a mesh to run); so does ``kernel_dp_axis``, which excludes it; one
    process builds no mesh from the default ``tpu.mesh``."""
    config = _small_config(1)
    assert build_mesh(config) is None
    config["model"]["UNet1d"]["activation_sharding"] = ["dp", "sp"]
    model = build_model(config, device="cpu")
    assert model.activation_sharding == ("dp", "sp") and model.mesh is None
    config["tpu"]["fused_resnet"] = True
    with pytest.raises(ValueError, match="fused_resnet"):
        build_model(config, device="cpu")  # serving: JAX predict raises too
    assert not build_model(config, device="cpu", trainable=True).fused_resnet
    config["model"]["UNet1d"]["kernel_dp_axis"] = "dp"
    with pytest.raises(ValueError, match="kernel_dp_axis"):
        build_model(config, device="cpu", trainable=True)
    del config["model"]["UNet1d"]["activation_sharding"]
    assert build_model(config, device="cpu").kernel_dp_axis == "dp"


def test_trainer_and_sampler_refuse_an_unsharded_model():
    """A mesh with sp > 1 around a model that would compute the whole
    window on every rank raises (its gradients would count sp times)."""
    from dquartic_tpu_torch.parallel import Mesh

    mesh = Mesh(sp=2)
    model = UNet1d(**TINY, dim_mults=(1, 2), downsample_dim=16)
    process = DDIMProcess(schedule=make_schedule(1000, "cosine", "eps"))
    with pytest.raises(ValueError, match="activation_sharding"):
        Trainer(model, process, mesh=mesh)
    with pytest.raises(ValueError, match="activation_sharding"):
        DDIMSampler(model, process, mesh=mesh)


# --------------------------------------------------------------------- #
# on the card: K6a-c against their plain versions, the hand split       #
# --------------------------------------------------------------------- #


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels only run on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cuda_inputs(B, C, N, dev, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    H = 128
    x = torch.randn((B, C, N), generator=g, device=dev).to(dtype)
    dy = torch.randn((B, C, N), generator=g, device=dev).to(dtype)
    w = [torch.randn(s, generator=g, device=dev) * sc for s, sc in
         (((C, 3 * H), 0.3), ((H, C), 0.1), ((C,), 0.1), ((C,), 1.0))]
    w.append(1.0 + 0.2 * torch.randn((C,), generator=g, device=dev))
    return x, dy, w


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C,N", [(4, 20000), (16, 313), (8, 700), (8, 1), (16, 100000)])
def test_k6_kernels_match_plain(cuda, dtype, C, N):
    """K6a (both operand modes), K6b and K6c on one slice against their
    plain versions (bf16: on the same bf16 values), at the level-0 slice,
    ragged N, one column and a slice too long to stage. float32 sums in
    another order; bf16 outputs round once."""
    dt = getattr(torch, dtype)
    x, dy, w = _cuda_inputs(34, C, N, cuda, dt, seed=C * N)
    w_qkv, w_out, b_out, g, g_pre = w
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == "float32" else dict(rtol=3e-2, atol=3e-2)
    for rnd in (True, False):
        st = tla.linear_attention_sp_stats(x, w_qkv, g_pre, round_operands=rnd)
        ref = tla.sp_stats_reference(x, w_qkv, g_pre, round_operands=rnd)
        torch.testing.assert_close(st, ref, rtol=1e-4, atol=1e-3 * float(ref.abs().max()))
    _, _, m = tla.sp_context(st, w_qkv, w_out, round_m=dt == torch.bfloat16)
    y = tla.linear_attention_sp_apply(x, st, w_qkv, w_out, b_out, g, g_pre)
    torch.testing.assert_close(y.float(), tla.sp_apply_reference(x, m, w_qkv, b_out, g, g_pre)
                               .float(), **tol)
    # one slice: its own stats are the sums
    got = tla.linear_attention_sp_backward(dy, x, *w, st, st, lambda t: None)
    ref = tla.sp_backward_reference(dy, x, *w, st, st, lambda t: None)
    # max |error| over the largest entry (chip_smoke's GRAD_TOL): float32
    # sums in another order; in bf16 dx rounds once, one ulp is 2^-8 of it
    grad_tol = 1e-3 if dtype == "float32" else 1e-2
    for a, b in zip(got, ref):
        scale = float(b.float().abs().max()) + 1e-12
        assert float((a.float() - b.float()).abs().max()) / scale < grad_tol


@pytest.mark.cuda
@pytest.mark.parametrize("size", [2, 4])
def test_k6_hand_split_matches_k1_k4(cuda, size):
    """N cut into ``size`` slices, K6a partials summed in a fixed order, K6b
    per slice, concatenated: K1 on the whole N; the backward (K6c, one
    thread a slice, Z and T summed over the slices) against K4."""
    x, dy, w = _cuda_inputs(34, 4, 40000, cuda, torch.float32, seed=size)
    ref_y = tla.linear_attention(x, *w)
    ref_g = tla.linear_attention_backward(dy, x, *w)
    y, got = _hand_split(x, dy, w, size)
    torch.testing.assert_close(y, ref_y, rtol=1e-4, atol=1e-4)
    for a, b in zip(got, ref_g):
        assert float((a - b).abs().max()) / float(b.abs().max()) < 1e-3
