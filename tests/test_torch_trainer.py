"""The port's training path against the JAX package: the diffusion loss,
UNet1d gradients, the optimizer, one full Trainer step, and the loop's
checkpoints. Weights and inputs are numpy arrays from seeds handed to both
packages; the random draws of a step (t, eps) are the ones the JAX rng
makes, injected into the port. Everything runs on the CPU in float32, where
the port's kernel ops run their plain versions.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dquartic_tpu.compat.torch_ckpt import convert_unet1d_state_dict
from dquartic_tpu.core import DDIMProcess as JaxDDIMProcess
from dquartic_tpu.core import make_schedule as jax_make_schedule
from dquartic_tpu.models import UNet1d as JaxUNet1d
from dquartic_tpu.train import Trainer as JaxTrainer
from dquartic_tpu.train import WarmupCosineSchedule as JaxSchedule
from dquartic_tpu.train import make_optimizer as jax_make_optimizer
from dquartic_tpu_torch.compat.jax_params import grads_state_dict, jax_params_to_torch
from dquartic_tpu_torch.core import DDIMProcess, make_schedule
from dquartic_tpu_torch.infer import DDIMSampler
from dquartic_tpu_torch.models import UNet1d
from dquartic_tpu_torch.train import (
    CallbackHandler, Trainer, WarmupCosineSchedule, latest_path_for, load_checkpoint,
    make_optimizer,
)
from dquartic_tpu_torch.utils.builder import build_model, build_trainer
from dquartic_tpu_torch.utils.config import load_train_config
from test_torch_model import SMALL, random_params

RT, MZ = 4, 256


def _t(a):
    return torch.from_numpy(np.array(a))


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _scaled_err(a, b):
    return np.max(np.abs(np.asarray(a, np.float64) - b)) / (np.max(np.abs(b)) + 1e-12)


def _port_model(params, **kw):
    cfg = {**SMALL, "fused_resnet": True, **kw}
    model = UNet1d(**cfg)
    sd = jax_params_to_torch(params, cfg["dim_mults"])
    model.load_state_dict({k: _t(v) for k, v in sd.items()})
    return model


def _jax_draws(rng_key, batch, shape, num_timesteps=1000):
    """The (t, eps) that the JAX train_loss draws from ``rng_key``."""
    t_rng, noise_rng = jax.random.split(rng_key)
    t = jax.random.randint(t_rng, (batch,), 0, num_timesteps)
    eps = jax.random.normal(noise_rng, shape, dtype=jnp.float32)
    return np.asarray(t), np.asarray(eps)


# --------------------------------------------------------------------- #
# diffusion loss                                                        #
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("pred_type", ["eps", "x0"])
@pytest.mark.parametrize("ms1_weight", [0.0, 0.3])
@pytest.mark.parametrize("explicit_noise", [False, True])
def test_train_loss_matches_jax(pred_type, ms1_weight, explicit_noise):
    """Same denoiser, data and draws: float32 on both sides, the same
    formulas, so 1e-6 relative (summation order of the means)."""
    rng = np.random.default_rng(0)
    b = 3
    x0 = rng.uniform(0, 1, (b, RT, 64)).astype(np.float32)
    ms2 = rng.uniform(0, 1, (b, RT, 64)).astype(np.float32)
    ms1 = rng.uniform(0, 1, (b, RT)).astype(np.float32)
    noise = rng.uniform(0, 1, (b, RT, 64)).astype(np.float32) if explicit_noise else None
    key = jax.random.PRNGKey(7)
    t, eps = _jax_draws(key, b, x0.shape)

    jp = JaxDDIMProcess(schedule=jax_make_schedule(1000, "cosine", pred_type),
                        ms1_loss_weight=ms1_weight)
    jloss, jaux = jp.train_loss(
        lambda x, tt, ic, ac: jnp.tanh(x) * 0.9 + 0.1 * ic, key, jnp.asarray(x0),
        jnp.asarray(ms2), jnp.asarray(ms1),
        noise=None if noise is None else jnp.asarray(noise))
    tp = DDIMProcess(schedule=make_schedule(1000, "cosine", pred_type),
                     ms1_loss_weight=ms1_weight)
    loss, aux = tp.train_loss(
        lambda x, tt, ic, ac: torch.tanh(x) * 0.9 + 0.1 * ic, _t(x0), _t(ms2), _t(ms1),
        noise=None if noise is None else _t(noise), t=_t(t), eps=_t(eps))
    np.testing.assert_array_equal(aux["t"].numpy(), np.asarray(jaux["t"]))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    np.testing.assert_allclose(aux["per_sample_loss"].numpy(),
                               np.asarray(jaux["per_sample_loss"]), rtol=1e-6)


def test_train_loss_draws_from_generator():
    """Without injected draws the loss draws t and eps from the generator:
    the same seed gives the same loss, another seed another."""
    tp = DDIMProcess(schedule=make_schedule(1000, "cosine", "eps"))
    x0 = torch.rand(2, RT, 32)

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return tp.train_loss(lambda x, t, ic, ac: torch.tanh(x), x0, generator=g)[0]

    assert float(run(1)) == float(run(1)) != float(run(2))


# --------------------------------------------------------------------- #
# UNet1d gradients                                                      #
# --------------------------------------------------------------------- #


def _grad_inputs(b, rt, mz, seed):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.uniform(0, 1, (b, rt, mz)).astype(np.float32),
        t=np.array([5, 900][:b], np.int32),
        ms1=rng.uniform(0, 1, (b, rt)).astype(np.float32),
        target=rng.normal(size=(b, rt, mz)).astype(np.float32),
    )


def _grads_both(jmodel, params, port, i, dim_mults):
    def loss(p):
        out = jmodel.apply(p, i["x"], i["t"], i["x"], i["ms1"])
        return jnp.mean((out - i["target"]) ** 2)

    ref = _flat(jax.jit(jax.grad(loss))(params))
    out = port(_t(i["x"]), _t(i["t"]).long(), _t(i["x"]), _t(i["ms1"]))
    torch.mean((out - _t(i["target"])) ** 2).backward()
    got = _flat(convert_unet1d_state_dict(grads_state_dict(port), dim_mults))
    assert got.keys() == ref.keys()
    return got, ref


# float32 through the net's RMSNorms and residual stream on both sides,
# summation order only: the forward agrees to ~1e-6 relative
# (test_torch_model.py), and each gradient to 1e-4 of its largest entry.
UNET_GRAD_TOL = 1e-4


def test_unet_grads_match_jax_xla_config():
    model = JaxUNet1d(**SMALL)
    i = _grad_inputs(2, RT, MZ, 1)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), i["x"], i["t"], i["x"], i["ms1"])
    params = random_params(shapes, seed=2)
    got, ref = _grads_both(model, params, _port_model(params), i, SMALL["dim_mults"])
    for k in ref:
        assert _scaled_err(got[k], ref[k]) < UNET_GRAD_TOL, k


def test_remat_blocks_gives_identical_gradients():
    i = _grad_inputs(1, RT, MZ, 5)
    model = JaxUNet1d(**SMALL)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), i["x"], i["t"], i["x"], i["ms1"])
    params = random_params(shapes, seed=6)
    grads = []
    for remat in (False, True):
        port = _port_model(params, remat_blocks=remat)
        out = port(_t(i["x"]), _t(i["t"]).long(), _t(i["x"]), _t(i["ms1"]))
        torch.mean((out - _t(i["target"])) ** 2).backward()
        grads.append(grads_state_dict(port))
    for k in grads[0]:
        np.testing.assert_array_equal(grads[0][k], grads[1][k], err_msg=k)


# --------------------------------------------------------------------- #
# optimizer                                                             #
# --------------------------------------------------------------------- #


def test_schedule_matches_jax():
    for args in ((1e-4, 5, 20), (3e-4, 30, 10), (1e-5, 0, 7)):
        a, b = WarmupCosineSchedule.clamped(*args), JaxSchedule.clamped(*args)
        assert [a(e) for e in range(args[2] + 2)] == [b(e) for e in range(args[2] + 2)]


def test_optimizer_matches_optax_chain():
    """clip(10) -> Adam -> decoupled weight decay, -lr: 3 steps on the same
    gradients, the second above the clip threshold. float32 Adam on both
    sides, bias corrections rounded in another order: 1e-5 relative."""
    rng = np.random.default_rng(9)
    shapes = [(7, 5), (5,), (3, 4, 2)]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) * scale for s in shapes]
             for scale in (0.5, 40.0, 1.0)]
    lrs = [1e-3, 2e-3, 5e-4]

    tx = jax_make_optimizer()
    jp = [jnp.asarray(p) for p in p0]
    state = tx.init(jp)
    params = [torch.nn.Parameter(_t(p)) for p in p0]
    opt = make_optimizer(params)
    for g, lr in zip(grads, lrs):
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = [p - jnp.float32(lr) * u for p, u in zip(jp, updates)]
        for p, x in zip(params, g):
            p.grad = _t(x)
        norm = opt.step(lr)
        np.testing.assert_allclose(float(norm), float(np.sqrt(sum((x**2).sum() for x in g))),
                                   rtol=1e-6)
        for p, q in zip(params, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(q), rtol=1e-5, atol=1e-7)


def test_factored_optimizer_not_ported():
    """clip(10) -> scale_by_factored_rms() at optax's defaults (the JAX
    make_optimizer(kind="factored")), -lr: 3 steps on the same gradients,
    the second above the clip threshold, on parameters that factor (both
    of their two largest axes >= 128, one of them a tie) and ones that do
    not. float32 on both sides, sums in another order: 1e-5 relative."""
    rng = np.random.default_rng(9)
    shapes = [(130, 200), (7,), (3, 4, 2), (128, 128, 3), (3, 150, 129)]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) * scale for s in shapes]
             for scale in (0.5, 40.0, 1.0)]
    lrs = [1e-3, 2e-3, 5e-4]
    tx = jax_make_optimizer(kind="factored")
    jp = [jnp.asarray(p) for p in p0]
    state = tx.init(jp)
    params = [torch.nn.Parameter(_t(p)) for p in p0]
    opt = make_optimizer(params, kind="factored")
    assert [d is not None for d in opt.dims] == [True, False, False, True, True]
    for g, lr in zip(grads, lrs):
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = [p - jnp.float32(lr) * u for p, u in zip(jp, updates)]
        for p, x in zip(params, g):
            p.grad = _t(x)
        norm = opt.step(lr)
        np.testing.assert_allclose(float(norm), float(np.sqrt(sum((x**2).sum() for x in g))),
                                   rtol=1e-6)
        for p, q in zip(params, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(q), rtol=1e-5, atol=1e-7)
    sd = opt.state_dict()
    again = make_optimizer([torch.nn.Parameter(_t(p)) for p in p0], kind="factored")
    again.load_state_dict(sd)
    assert again.count == 3 and all(
        (a is None and b is None) or torch.equal(a, b)
        for k in ("v_row", "v_col", "v") for a, b in zip(again.state_dict()[k], sd[k]))


# --------------------------------------------------------------------- #
# one Trainer step                                                      #
# --------------------------------------------------------------------- #


def _batch(seed, b=1, mz=MZ):
    rng = np.random.default_rng(seed)
    return {"ms2_1": rng.uniform(0, 1, (b, RT, mz)).astype(np.float32),
            "ms1_1": rng.uniform(0, 1, (b, RT)).astype(np.float32),
            "ms2_2": rng.uniform(0, 1, (b, RT, mz)).astype(np.float32)}


def test_trainer_step_matches_jax():
    """One full step (mixing, loss, backward, clip, AdamW, EMA) from the
    same weights and batch with the draws of the JAX rng. Loss and grad
    norm are float32 sums in another order (1e-5). Adam's first update is
    about lr·sign(g), so a gradient entry near 0 may take the other sign:
    parameters agree within 2·lr (+1e-5 relative), and the EMA, which
    moves them by (1 - 0.999), within 2·lr·1e-3."""
    lr = 1e-3
    kw = dict(dim_mults=(1, 2), downsample_dim=64)
    batch = _batch(11, b=2, mz=64)
    jmodel = JaxUNet1d(**{**SMALL, **kw})
    jproc = JaxDDIMProcess(schedule=jax_make_schedule(1000, "cosine", "eps"))
    jtr = JaxTrainer(jmodel, jproc, seed=0)
    shapes = jax.eval_shape(lambda: jtr.init_params(batch))
    params = random_params(shapes, seed=12)
    key = jax.random.PRNGKey(13)
    t, eps = _jax_draws(key, 2, batch["ms2_1"].shape)
    jstate, jmetrics = jtr.train_step(
        jtr._fresh_state(params), {k: jnp.asarray(v) for k, v in batch.items()},
        jnp.float32(lr), key)

    port = _port_model(params, **kw)
    tr = Trainer(port, DDIMProcess(schedule=make_schedule(1000, "cosine", "eps")))
    metrics = tr.train_step(batch, lr, t=_t(t), eps=_t(eps))
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(jmetrics["grad_norm"]),
                               rtol=1e-5)
    dim_mults = kw["dim_mults"]
    got = _flat(convert_unet1d_state_dict(
        {k: v.detach().numpy() for k, v in port.state_dict().items()}, dim_mults))
    ema = _flat(convert_unet1d_state_dict(
        {k: v.numpy() for k, v in tr.ema_state_dict().items()}, dim_mults))
    ref, ref_ema = _flat(jstate.params), _flat(jstate.ema_params)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=2 * lr, err_msg=k)
        np.testing.assert_allclose(ema[k], ref_ema[k], rtol=1e-5, atol=2 * lr * 1e-3, err_msg=k)
    assert tr.step == 1 and int(jstate.step) == 1


# --------------------------------------------------------------------- #
# the loop: checkpoints, resume, EMA -> sampler                         #
# --------------------------------------------------------------------- #


class _Epochs(CallbackHandler):
    def __init__(self, best_path):
        self.seen, self.best_path = [], best_path

    def epoch_callback(self, epoch, epoch_loss):
        self.seen.append((epoch, os.path.exists(self.best_path)))
        return True


def _small_trainer(callbacks=None):
    torch.manual_seed(0)
    model = UNet1d(**{**SMALL, "downsample_dim": 64}, fused_resnet=True)
    return Trainer(model, DDIMProcess(schedule=make_schedule(1000, "cosine", "eps")),
                   callback_handler=callbacks, seed=3)


def test_checkpoints_resume_after_stored_epoch(tmp_path):
    data = [_batch(20, mz=64), _batch(21, mz=64)]
    best = str(tmp_path / "ckpt" / "best_model.ckpt")
    cb = _Epochs(best)
    tr = _small_trainer(cb).train(data, epochs=3, warmup_epochs=1, learning_rate=1e-3,
                                  checkpoint_path=best, best_every_n_epochs=2)
    latest = latest_path_for(best)
    assert os.path.basename(latest) == "dquartic_latest_checkpoint.ckpt"
    # epoch 0 improves on inf, but the best file waits for the 2-epoch gap
    assert cb.seen[0] == (0, False) and cb.seen[1] == (1, True)
    ck = load_checkpoint(latest)
    assert ck["epoch"] == 2 and ck["step"] == 6 and tr.step == 6
    assert not any(f.endswith(".tmp") for f in os.listdir(tmp_path / "ckpt"))

    # resume: a 4-epoch run starts after the stored epoch 2 and runs one
    cb2 = _Epochs(best)
    tr2 = _small_trainer(cb2)
    tr2.train(data, epochs=4, warmup_epochs=1, learning_rate=1e-3, checkpoint_path=best)
    assert [e for e, _ in cb2.seen] == [3] and tr2.step == 8
    assert load_checkpoint(latest)["epoch"] == 3

    # the EMA weights load into a model that DDIMSampler runs
    model = UNet1d(**{**SMALL, "downsample_dim": 64}, fused_resnet=True)
    model.load_state_dict(tr2.ema_state_dict())
    recs = DDIMSampler(model.eval(), tr2.process).predict([data[0]], num_steps=3, device="cpu")
    assert np.isfinite(recs[0]["pred"]).all() and recs[0]["pred"].shape == (1, RT, 64)


def test_callback_stops_training(tmp_path):
    class Stop(CallbackHandler):
        def epoch_callback(self, epoch, epoch_loss):
            return False

    tr = _small_trainer(Stop())
    tr.train([_batch(22, mz=64)], epochs=5, warmup_epochs=0,
             checkpoint_path=str(tmp_path / "b.ckpt"))
    assert tr.step == 1


# --------------------------------------------------------------------- #
# builder: trainable models and the serving path                        #
# --------------------------------------------------------------------- #


def _cut_config(**tpu):
    cfg = load_train_config("dquartic_train_config.json")
    cfg["model"]["UNet1d"].update(dim_mults=[1, 2, 2], downsample_dim=128)
    cfg["tpu"].update(fused_resnet=True, **tpu)
    return cfg


def test_trainable_model_serves_the_same_numbers():
    """float32 master weights cast to bf16 at use compute what the serving
    model with bf16-stored weights computes, bit for bit."""
    cfg = _cut_config(compute_dtype="bfloat16")
    serve = build_model(cfg, device="cpu", seed=3)
    train = build_model(cfg, device="cpu", seed=3, trainable=True)
    assert serve.init_conv.weight.dtype == torch.bfloat16 and not serve.init_conv.weight.requires_grad
    assert all(p.dtype == torch.float32 and p.requires_grad for p in train.parameters())
    rng = np.random.default_rng(4)
    x, ic = (_t(rng.uniform(-1, 1, (1, RT, 128)).astype(np.float32)) for _ in range(2))
    ac, t = _t(rng.uniform(-1, 1, (1, RT)).astype(np.float32)), torch.tensor([321])
    with torch.no_grad():
        a, b = serve(x, t, ic, ac), train(x, t, ic, ac)
    assert a.dtype == b.dtype == torch.bfloat16
    assert torch.equal(a, b)


def test_build_trainer_step_and_rejections():
    tr = build_trainer(_cut_config(compute_dtype="bfloat16", ema_decay=0.99), device="cpu",
                       seed=1)
    assert tr.ema_decay == 0.99 and tr.model.compute_dtype == torch.bfloat16
    batch = {k: v[..., :128] if v.ndim == 3 else v for k, v in _batch(30).items()}
    before = [p.detach().clone() for p in tr.optimizer.params]
    m = tr.train_step(batch, 1e-3, generator=torch.Generator().manual_seed(0))
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    assert all(p.grad.dtype == torch.float32 for p in tr.optimizer.params)
    assert any(not torch.equal(a, p) for a, p in zip(before, tr.optimizer.params))
    with pytest.raises(ValueError, match="inference-only"):
        build_trainer(_cut_config(quantize_mid=True), device="cpu")
    factored = build_trainer(_cut_config(optimizer="factored"), device="cpu")
    assert factored.optimizer.kind == "factored"
    factored.train_step(batch, 1e-3, generator=torch.Generator().manual_seed(0))
    assert factored.optimizer.count == 1
