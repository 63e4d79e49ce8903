"""The port's schedules, DDIM step and sampler against the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dquartic_tpu.core import DDIMProcess as JaxDDIMProcess
from dquartic_tpu.core import make_schedule as jax_make_schedule
from dquartic_tpu.infer import DDIMSampler as JaxDDIMSampler
from dquartic_tpu.models import UNet1d as JaxUNet1d
from dquartic_tpu_torch.compat.jax_params import jax_params_to_torch
from dquartic_tpu_torch.core import DDIMProcess, make_schedule, sample_timesteps
from dquartic_tpu_torch.infer import DDIMSampler
from dquartic_tpu_torch.models import UNet1d
from dquartic_tpu_torch.utils.builder import build_model, build_process
from dquartic_tpu_torch.utils.config import load_train_config


@pytest.mark.parametrize("schedule_type", ["linear", "cosine"])
@pytest.mark.parametrize("pred_type", ["eps", "x0"])
@pytest.mark.parametrize("weighting", ["reference", "uniform", "min_snr:5"])
def test_schedules_array_equal(schedule_type, pred_type, weighting):
    a = make_schedule(1000, schedule_type, pred_type, weighting)
    b = jax_make_schedule(1000, schedule_type, pred_type, weighting)
    for name in ("betas", "alphas", "alpha_bars", "loss_weight"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


def _denoiser_pair(pred_scale):
    """The same analytic denoiser for both packages: pred = tanh(x)·s + c."""

    def jax_fn(x, t, ic, ac):
        return jnp.tanh(x) * pred_scale + 0.01 * ic

    def torch_fn(x, t, ic, ac):
        return torch.tanh(x) * pred_scale + 0.01 * ic

    return jax_fn, torch_fn


@pytest.mark.parametrize("pred_type", ["eps", "x0"])
@pytest.mark.parametrize("t,t_prev", [(999, 979), (500, 480), (0, -1)])
@pytest.mark.parametrize("parity", [True, False])
def test_ddim_step_matches_jax(pred_type, t, t_prev, parity):
    """float32 DDIM algebra on the same float32 schedule constants: the
    only difference is tanh's last-ulp rounding, amplified at t=999 by
    1/sqrt(alpha_bar) ~ 1e2 before the [-1, 1] clip."""
    sched = make_schedule(1000, "cosine", pred_type)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 4, 64)).astype(np.float32)
    ic = rng.uniform(-1, 1, size=(2, 4, 64)).astype(np.float32)
    jfn, tfn = _denoiser_pair(0.9)
    jp = JaxDDIMProcess(schedule=jax_make_schedule(1000, "cosine", pred_type),
                        parity_neighbor_stepping=parity)
    tp = DDIMProcess(schedule=sched, parity_neighbor_stepping=parity)
    jx, jeps = jp.ddim_step(jfn, jnp.asarray(x), jnp.int32(t), jnp.int32(t_prev),
                            jnp.asarray(ic), None)
    tx, teps = tp.ddim_step(tfn, torch.from_numpy(x), t, t_prev, torch.from_numpy(ic), None)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(teps.numpy(), np.asarray(jeps), rtol=1e-5, atol=2e-5)


def test_q_sample_matches_jax():
    rng = np.random.default_rng(1)
    x0 = rng.uniform(-1, 1, size=(3, 4, 32)).astype(np.float32)
    noise = rng.normal(size=(3, 4, 32)).astype(np.float32)
    t = np.array([0, 500, 999], np.int32)
    ref = JaxDDIMProcess(schedule=jax_make_schedule(1000, "cosine", "eps")).q_sample(
        jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise)
    )
    out = DDIMProcess(schedule=make_schedule(1000, "cosine", "eps")).q_sample(
        torch.from_numpy(x0), torch.from_numpy(t), torch.from_numpy(noise)
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_sample_timesteps_truncate():
    np.testing.assert_array_equal(sample_timesteps(1000, 50)[:3], [999, 978, 958])
    assert sample_timesteps(1000, 50)[-1] == 0


SMALL = dict(
    dim=4, channels=1, dim_mults=(1, 2, 2), conditional=True, init_cond_channels=1,
    attn_cond_channels=1, downsample_dim=128, simple=True,
)


def test_five_step_sample_matches_jax():
    """Same weights, x_t and conditions through 5 DDIM steps of the small
    UNet1d. The per-forward float32 difference (~1e-5) is amplified by
    1/sqrt(alpha_bar) ~ 1e2 at the first step, before the clip; 1e-3 holds
    with margin on the [0, 1] data scale."""
    from test_torch_model import random_params

    rng = np.random.default_rng(0)
    b, rt, mz = 1, 4, 128
    x_t = rng.normal(size=(b, rt, mz)).astype(np.float32)
    ms2 = rng.uniform(0, 1, size=(b, rt, mz)).astype(np.float32)
    ms1 = rng.uniform(0, 1, size=(b, rt)).astype(np.float32)

    jmodel = JaxUNet1d(**SMALL)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x_t, np.zeros((b,), np.int32),
                            ms2, ms1)
    params = random_params(shapes, seed=3)
    jproc = JaxDDIMProcess(schedule=jax_make_schedule(1000, "cosine", "eps"))
    jx0, jnoise = JaxDDIMSampler(jmodel, jproc).sample(params, x_t, ms2, ms1, num_steps=5)

    model = UNet1d(**SMALL, fused_resnet=True)
    model.load_state_dict(
        {k: torch.from_numpy(np.array(v)) for k, v in jax_params_to_torch(params, SMALL["dim_mults"]).items()}
    )
    proc = DDIMProcess(schedule=make_schedule(1000, "cosine", "eps"))
    x0, noise = DDIMSampler(model.eval(), proc).sample(
        torch.from_numpy(x_t), torch.from_numpy(ms2), torch.from_numpy(ms1), num_steps=5
    )
    np.testing.assert_allclose(x0.numpy(), np.asarray(jx0), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(noise.numpy(), np.asarray(jnoise), rtol=1e-3, atol=1e-3)


def test_predict_through_config_entry_points():
    """build_model/build_process from the canonical config (cut to 3
    levels at m/z 128), quantize_mid on, then DDIMSampler.predict."""
    cfg = load_train_config("dquartic_train_config.json")
    cfg["model"]["UNet1d"].update(dim_mults=[1, 2, 2], downsample_dim=128)
    cfg["tpu"].update(quantize_mid=True, fused_resnet=True)
    model = build_model(cfg, device="cpu", seed=0)
    assert model.mid_block1.block1.proj.weight_q.dtype == torch.int8
    rng = np.random.default_rng(1)
    batch = {k: rng.uniform(0, 1, size=s).astype(np.float32)
             for k, s in (("ms2_1", (1, 4, 128)), ("ms1_1", (1, 4)), ("ms2_2", (1, 4, 128)))}
    recs = DDIMSampler(model, build_process(cfg)).predict([batch], num_steps=3, seed=0,
                                                          device="cpu")
    assert recs[0]["pred"].shape == (1, 4, 128)
    assert np.isfinite(recs[0]["pred"]).all()
    np.testing.assert_allclose(recs[0]["mixture"], 0.5 * batch["ms2_1"] + 0.5 * batch["ms2_2"])
    again = DDIMSampler(model, build_process(cfg)).predict([batch], num_steps=3, seed=0,
                                                           device="cpu")
    np.testing.assert_array_equal(again[0]["pred"], recs[0]["pred"])
