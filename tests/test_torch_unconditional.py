"""The port's unconditional UNet1d (``conditional=False``) against the JAX
package on the same weights: the forward for ``simple`` true and false,
fused and unfused, the shipping kernel route (fused, int8 mid convs, the
K1 op) against JAX's Pallas kernels in interpret mode, bf16, the gradients,
a 5-step sample, the reference converter, a JAX Trainer checkpoint resumed,
the builder and the CLI. Weights are numpy arrays from seeds in the JAX
tree's shapes; everything runs on the CPU.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from click.testing import CliRunner

from dquartic_tpu.compat.torch_ckpt import convert_unet1d_state_dict as jax_convert_unet
from dquartic_tpu.core import DDIMProcess as JaxDDIMProcess
from dquartic_tpu.core import make_schedule as jax_make_schedule
from dquartic_tpu.infer import DDIMSampler as JaxDDIMSampler
from dquartic_tpu.models import UNet1d as JaxUNet1d
from dquartic_tpu.ops.quantization import quantize_mid_block_params as jax_quantize_mid
from dquartic_tpu.train import Trainer as JaxTrainer
from dquartic_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from dquartic_tpu_torch.cli import cli
from dquartic_tpu_torch.compat.jax_params import (
    grads_state_dict, jax_params_to_torch, torch_to_jax_params,
)
from dquartic_tpu_torch.compat.torch_ckpt import convert_unet1d_state_dict
from dquartic_tpu_torch.core import DDIMProcess, make_schedule
from dquartic_tpu_torch.infer import DDIMSampler
from dquartic_tpu_torch.models import UNet1d
from dquartic_tpu_torch.models.attention import Attention, Transformer1d
from dquartic_tpu_torch.models.fused_blocks import ResnetBlockT
from dquartic_tpu_torch.models.layers import Int8Conv1d
from dquartic_tpu_torch.ops.quantization import quantize_mid_block_params
from dquartic_tpu_torch.train import Trainer, latest_path_for, load_checkpoint
from dquartic_tpu_torch.train.checkpoint import restore_or_init
from dquartic_tpu_torch.utils.builder import build_model, build_process, build_trainer
from dquartic_tpu_torch.utils.config import load_train_config
from test_torch_model import random_params

UNCOND = dict(dim=4, channels=1, dim_mults=(1, 2, 2), conditional=False, downsample_dim=256,
              tfer_depth=2)
RT, MZ = 4, 256
# float32 on both sides, summation order only (tests/test_torch_model.py)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
# each gradient to 1e-4 of its largest entry (tests/test_torch_trainer.py)
GRAD_TOL = 1e-4
# 5 DDIM steps: the per-forward float32 difference amplified by
# 1/sqrt(alpha_bar) at the first step (tests/test_torch_sampler.py)
SAMPLE_TOL = dict(rtol=1e-3, atol=1e-3)
# bf16 compute on both sides: the two round at different points through the
# 3-level net (and the 4-channel RMSNorms amplify roundings where a norm
# cancels), so each is held against the float32 model: the port's relative
# L2 error at most BF16_REL_RATIO times JAX's (eager; jitted at the tests'
# XLA optimization level 0, JAX's bf16 is 5-37 % off float32). Measured over
# three seeds for simple and tfer: JAX 1.2e-2 to 4.3e-2, the port 0.80 to
# 0.99 times that.
BF16_REL_RATIO = 1.5


def _t(a):
    return torch.from_numpy(np.array(a))


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _inputs(b=1, seed=0):
    rng = np.random.default_rng(seed)
    return dict(x=rng.normal(size=(b, RT, MZ)).astype(np.float32),
                t=rng.integers(0, 1000, size=(b,)).astype(np.int32),
                ic=rng.uniform(-1, 1, size=(b, RT, MZ)).astype(np.float32),
                ac=rng.uniform(-1, 1, size=(b, RT)).astype(np.float32))


def _jax(simple, seed=1, **kw):
    model = JaxUNet1d(**{**UNCOND, **kw}, simple=simple)
    mz = model.downsample_dim
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), np.zeros((1, RT, mz), np.float32),
                            np.zeros((1,), np.int32))
    return model, random_params(shapes, seed=seed)


@pytest.fixture(scope="module", params=[True, False], ids=["simple", "tfer"])
def jax_model(request):
    return (request.param,) + _jax(request.param)


def _port(params, simple, quantized=False, **kw):
    model = UNet1d(**UNCOND, simple=simple, **kw)
    if quantized:
        quantize_mid_block_params(model)
    model.load_state_dict({k: _t(v) for k, v in jax_params_to_torch(params).items()})
    return model.eval()


@pytest.mark.parametrize("fused", [True, False])
def test_unconditional_unet_matches_jax(jax_model, fused):
    """No init condition, no MS1 tower, self attention at the bottleneck
    (a Transformer1d of self-attention layers with simple=False); the
    conditions a caller passes are ignored, as in JAX."""
    simple, model, params = jax_model
    port = _port(params, simple, fused_resnet=fused)
    assert not hasattr(port, "init_cond_proj") and not hasattr(port, "attn_cond_proj")
    mixer = port.mid_attn.fn.fn
    if simple:
        assert isinstance(mixer, Attention) and hasattr(mixer, "to_qkv")
    else:
        assert isinstance(mixer, Transformer1d)
        assert all(isinstance(a, Attention) for a, _ in mixer.layers)
    i = _inputs(b=2, seed=2)
    ref = np.asarray(jax.jit(model.apply)(params, i["x"], i["t"]))
    with torch.no_grad():
        out = port(_t(i["x"]), _t(i["t"]).long()).numpy()
        conditioned = port(_t(i["x"]), _t(i["t"]).long(), _t(i["ic"]), _t(i["ac"])).numpy()
    assert out.shape == (2, RT, MZ)
    np.testing.assert_allclose(out, ref, **MODEL_TOL)
    np.testing.assert_array_equal(conditioned, out)


def test_unconditional_kernel_route_matches_jax_kernels():
    """The shipping inference route (fused ResnetBlocks, the pallas_t mixer,
    int8 mid convs) against JAX's, whose Pallas kernels run in interpret
    mode, on the same int8 weights; the port's kernel modules are the ones
    the conditional model runs."""
    model, params = _jax(True, seed=3)
    kmodel = model.clone(fused_resnet=True, linear_attn_impl="pallas_t", quantize_mid=True)
    qparams = jax_quantize_mid(params)
    i = _inputs(seed=4)
    ref = np.asarray(jax.jit(kmodel.apply)(qparams, i["x"], i["t"]))
    port = _port(qparams, True, quantized=True, fused_resnet=True, linear_attn_impl="pallas_t")
    assert isinstance(port.downs[0][0], ResnetBlockT)
    assert isinstance(port.mid_block1.block1.proj, Int8Conv1d)
    with torch.no_grad():
        out = port(_t(i["x"]), _t(i["t"]).long()).numpy()
    np.testing.assert_allclose(out, ref, **MODEL_TOL)


def test_unconditional_bf16_matches_jax():
    model, params = _jax(True, seed=5)
    i = _inputs(seed=6)
    f32 = np.asarray(jax.jit(model.apply)(params, i["x"], i["t"]))
    ref = np.asarray(model.clone(dtype=jnp.bfloat16).apply(params, i["x"], i["t"]), np.float32)
    port = UNet1d(**UNCOND, simple=True, fused_resnet=True, dtype=torch.bfloat16)
    port.load_state_dict({k: _t(v) for k, v in jax_params_to_torch(params).items()})
    with torch.no_grad():
        out = port(_t(i["x"]), _t(i["t"]).long())
    assert out.dtype == torch.bfloat16

    def rel(a):
        return np.linalg.norm(a - f32) / np.linalg.norm(f32)

    assert rel(out.float().numpy()) <= BF16_REL_RATIO * rel(ref), (rel(out.float().numpy()),
                                                                   rel(ref))


def test_unconditional_gradients_match_jax(jax_model):
    simple, model, params = jax_model
    rng = np.random.default_rng(7)
    x = rng.uniform(0, 1, (2, RT, MZ)).astype(np.float32)
    t = np.array([5, 900], np.int32)
    target = rng.normal(size=(2, RT, MZ)).astype(np.float32)

    def loss(p):
        return jnp.mean((model.apply(p, x, t) - target) ** 2)

    ref = _flat(jax.jit(jax.grad(loss))(params))
    port = _port(params, simple, fused_resnet=True)
    torch.mean((port(_t(x), _t(t).long()) - _t(target)) ** 2).backward()
    got = _flat(torch_to_jax_params(grads_state_dict(port)))
    assert got.keys() == ref.keys()
    for k in ref:
        err = np.abs(got[k] - ref[k]).max() / (np.abs(ref[k]).max() + 1e-12)
        assert err < GRAD_TOL, (k, err)


def test_unconditional_five_step_sample_matches_jax():
    model, params = _jax(True, seed=8)
    rng = np.random.default_rng(9)
    x_t = rng.normal(size=(1, RT, MZ)).astype(np.float32)
    ms2 = rng.uniform(0, 1, size=(1, RT, MZ)).astype(np.float32)
    ms1 = rng.uniform(0, 1, size=(1, RT)).astype(np.float32)
    jproc = JaxDDIMProcess(schedule=jax_make_schedule(1000, "cosine", "eps"))
    jx0, jnoise = JaxDDIMSampler(model, jproc).sample(params, x_t, ms2, ms1, num_steps=5)
    proc = DDIMProcess(schedule=make_schedule(1000, "cosine", "eps"))
    x0, noise = DDIMSampler(_port(params, True, fused_resnet=True), proc).sample(
        _t(x_t), _t(ms2), _t(ms1), num_steps=5)
    np.testing.assert_allclose(x0.numpy(), np.asarray(jx0), **SAMPLE_TOL)
    np.testing.assert_allclose(noise.numpy(), np.asarray(jnoise), **SAMPLE_TOL)


def test_reference_converter_matches_jax():
    """A reference-named unconditional state_dict (the port's names are the
    reference's) through the port's copy of the converter: JAX's tree leaf
    for leaf, with the mid attention's to_qkv and no condition."""
    torch.manual_seed(10)
    sd = UNet1d(**UNCOND, simple=True).state_dict()
    ref = jax_convert_unet({k: v.numpy() for k, v in sd.items()}, UNCOND["dim_mults"],
                           conditional=False, simple=True)
    got = convert_unet1d_state_dict(sd, UNCOND["dim_mults"], conditional=False, simple=True)
    fr, fg = _flat(ref), _flat(got)
    assert fr.keys() == fg.keys() and all(np.array_equal(fr[k], fg[k]) for k in fr)
    assert "['params']['mid_attn_fn']['to_qkv']['kernel']" in fr
    back = jax_params_to_torch(got)
    assert back.keys() == sd.keys() and all(np.array_equal(back[k], sd[k].numpy()) for k in sd)


def _batch(seed, mz=MZ):
    rng = np.random.default_rng(seed)
    return {"ms2_1": rng.uniform(0, 1, (1, RT, mz)).astype(np.float32),
            "ms1_1": rng.uniform(0, 1, (1, RT)).astype(np.float32),
            "ms2_2": rng.uniform(0, 1, (1, RT, mz)).astype(np.float32)}


# the resumed runs: two levels at m/z 64, as tests/test_torch_trainer.py's
# one-step test
SMALLER = dict(dim_mults=(1, 2), downsample_dim=64)


def test_trainer_resumes_a_jax_unconditional_run(tmp_path):
    """A JAX Trainer of the unconditional UNet1d takes one step and writes
    its latest file; the port resumes from it (its Adam state mapped by the
    walk of the unconditional tree; the factored state's mapping is the
    conditional model's, tested in test_torch_checkpoint.py) and takes the
    next step against JAX's with the JAX rng's draws: loss 1e-5 relative,
    parameters within 2·lr (+1e-5 relative), the EMA within 2·lr·1e-3
    (tests/test_torch_trainer.py's one-step tolerances)."""
    from test_torch_trainer import _jax_draws

    model, params = _jax(True, seed=11, **SMALLER)
    lr = 1e-3
    jtr = JaxTrainer(model, JaxDDIMProcess(schedule=jax_make_schedule(1000, "cosine", "eps")),
                     seed=0)
    b0, b1 = ({k: jnp.asarray(v) for k, v in _batch(s, mz=64).items()} for s in (12, 13))
    state, _ = jtr.train_step(jtr._fresh_state(params), b0, jnp.float32(lr),
                              jax.random.PRNGKey(0))
    best = tmp_path / "ckpt" / "best_model.ckpt"
    jax_save_checkpoint(latest_path_for(str(best)), {
        "epoch": np.int64(0), "best_loss": np.float64(0.75), "state": state})
    key = jax.random.PRNGKey(14)
    t, eps = _jax_draws(key, 1, b1["ms2_1"].shape)
    jstate, jm = jtr.train_step(state, b1, jnp.float32(lr), key)

    port = UNet1d(**{**UNCOND, **SMALLER}, simple=True, fused_resnet=True)
    tr = Trainer(port, DDIMProcess(schedule=make_schedule(1000, "cosine", "eps")))
    ckpt, epoch, best_loss, resumed = restore_or_init(str(best))
    assert resumed and (epoch, best_loss) == (0, 0.75) and ckpt["opt_state"]["kind"] == "adamw"
    tr._load(ckpt)
    m = tr.train_step(_batch(13, mz=64), lr, t=_t(t), eps=_t(eps))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    got, ema = tr.model.state_dict(), tr.ema_state_dict()
    ref, ref_ema = jax_params_to_torch(jstate.params), jax_params_to_torch(jstate.ema_params)
    assert got.keys() == ref.keys() and tr.step == 2
    for k in ref:
        np.testing.assert_allclose(got[k].detach().numpy(), ref[k], rtol=1e-5, atol=2 * lr,
                                   err_msg=k)
        np.testing.assert_allclose(ema[k].numpy(), ref_ema[k], rtol=1e-5, atol=2 * lr * 1e-3,
                                   err_msg=k)


def _config(**tpu):
    cfg = load_train_config("dquartic_train_config.json")
    cfg["model"]["UNet1d"].update(dim_mults=[1, 2, 2], downsample_dim=MZ, conditional=False)
    cfg["tpu"].update(**tpu)
    cfg["wandb"]["use_wandb"] = False
    return cfg


def test_builder_routes_the_unconditional_model_like_the_conditional_one():
    """quantize_mid, fused_resnet and linear_attn_impl reach the
    unconditional model as they reach the conditional one; it serves and
    trains through the entry points."""
    cfg = _config(compute_dtype="bfloat16", quantize_mid=True, fused_resnet=True,
                  linear_attn_impl="pallas")
    serve = build_model(cfg, device="cpu", seed=0)
    assert not serve.conditional and isinstance(serve.mid_block1.block1.proj, Int8Conv1d)
    assert isinstance(serve.final_res_block, ResnetBlockT)
    assert {m.impl for m in serve.modules() if hasattr(m, "impl")} == {"pallas"}
    assert serve.init_conv.weight.shape[1] == 1
    recs = DDIMSampler(serve, build_process(cfg)).predict([_batch(15)], num_steps=3,
                                                         device="cpu")
    assert recs[0]["pred"].shape == (1, RT, MZ) and np.isfinite(recs[0]["pred"]).all()
    tr = build_trainer(_config(fused_resnet=True), device="cpu", seed=1)
    m = tr.train_step(_batch(16), 1e-3, generator=torch.Generator().manual_seed(0))
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0


def test_cli_train_and_predict_unconditional(tmp_path):
    rng = np.random.default_rng(17)
    np.save(tmp_path / "ms2.npy", rng.uniform(0, 100, (3, RT, MZ)).astype(np.float32))
    np.save(tmp_path / "ms1.npy", rng.uniform(0, 50, (3, RT)).astype(np.float32))
    cfg = _config(fused_resnet=True)
    cfg["data"].update(parquet_directory=None, ms2_data_path=str(tmp_path / "ms2.npy"),
                       ms1_data_path=str(tmp_path / "ms1.npy"))
    best = tmp_path / "ckpt" / "best_model.ckpt"
    cfg["model"].update(checkpoint_path=str(best), num_epochs=1, warmup_epochs=0)
    (tmp_path / "c.json").write_text(json.dumps(cfg))
    runner = CliRunner()
    r = runner.invoke(cli, ["train", "--device", "cpu", str(tmp_path / "c.json")])
    assert r.exit_code == 0, r.output
    latest = latest_path_for(str(best))
    assert load_checkpoint(latest)["step"] == 3
    out = tmp_path / "pred.npz"
    r = runner.invoke(cli, ["predict", "--device", "cpu", "--quantize-mid", "--num-steps", "3",
                            "--num-batches", "1", str(tmp_path / "c.json"), latest, str(out)])
    assert r.exit_code == 0, r.output
    pred = np.load(out)["pred_0"]
    assert pred.shape == (1, RT, MZ) and np.isfinite(pred).all()
