"""The port's CustomTransformer against the JAX package on the same weights:
its layers, the model in float32 and bf16, the train_loss gradients, a
JAX Trainer checkpoint resumed by the port (Adam and factored state), the
reference converter, the builder and the CLI. Weights are numpy arrays from
seeds in the JAX tree's shapes, carried across by
:mod:`dquartic_tpu_torch.compat.jax_params`; everything runs on the CPU.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from click.testing import CliRunner

from dquartic_tpu.compat.torch_ckpt import (
    convert_custom_transformer_state_dict as jax_convert_ct,
)
from dquartic_tpu.core import DDIMProcess as JaxDDIMProcess
from dquartic_tpu.core import make_schedule as jax_make_schedule
from dquartic_tpu.models import CustomTransformer as JaxCT
from dquartic_tpu.models import transformer as jtf
from dquartic_tpu.train import Trainer as JaxTrainer
from dquartic_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from dquartic_tpu_torch.cli import cli
from dquartic_tpu_torch.compat.jax_params import (
    grads_state_dict, jax_params_to_torch, torch_to_jax_params,
)
from dquartic_tpu_torch.compat.torch_ckpt import convert_custom_transformer_state_dict
from dquartic_tpu_torch.core import DDIMProcess, make_schedule
from dquartic_tpu_torch.infer import DDIMSampler
from dquartic_tpu_torch.models import CustomTransformer
from dquartic_tpu_torch.models import transformer as ttf
from dquartic_tpu_torch.train import ClippedFactoredRMS, Trainer, latest_path_for, load_checkpoint
from dquartic_tpu_torch.train.checkpoint import restore_or_init
from dquartic_tpu_torch.utils.builder import build_model, build_trainer
from dquartic_tpu_torch.utils.config import load_train_config

CT = dict(input_dim=64, hidden_dim=32, num_heads=2, num_layers=2)
B, RT = 2, 8
# float32 on both sides: each layer differs in summation order only; the
# model to 1e-4 (tests/test_torch_model.py's tolerances).
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
# bf16 compute on both sides (float32 parameters cast at use, float32
# logits, softmax and norm statistics): the two round the products, GELU
# and residual sums to bf16 at different points. Each is ~9e-3 (relative
# L2) from the float32 model and ~1e-2 from the other, max |diff| 0.03-0.05
# on outputs up to ~4, over three seeds; held at 2e-2 and 0.1.
BF16_REL_L2 = 2e-2
BF16_ATOL = 0.1
# each gradient to 1e-4 of its largest entry, as tests/test_torch_trainer.py
GRAD_TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def random_ct_params(shapes, seed):
    """Numpy weights in the flax tree's shapes: LayerNorm scales ~1, small
    biases, kernels N(0, 1/fan_in)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path[-1:])
        if "scale" in name:
            return (1.0 + 0.1 * rng.normal(size=s.shape)).astype(np.float32)
        if "bias" in name:
            return (0.1 * rng.normal(size=s.shape)).astype(np.float32)
        return (rng.normal(size=s.shape) / np.sqrt(s.shape[0])).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _inputs(seed=0, b=B):
    rng = np.random.default_rng(seed)
    return dict(x=rng.normal(size=(b, RT, CT["input_dim"])).astype(np.float32),
                t=rng.integers(0, 1000, size=(b,)).astype(np.int32),
                ac=rng.uniform(-1, 1, size=(b, RT)).astype(np.float32))


@pytest.fixture(scope="module")
def jax_ct():
    model = JaxCT(**CT)
    i = _inputs()
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), i["x"], i["t"], None, i["ac"])
    return model, random_ct_params(shapes, seed=1)


def _port(params, dtype=torch.float32):
    model = CustomTransformer(**CT, dtype=dtype)
    model.load_state_dict({k: _t(v) for k, v in jax_params_to_torch(params).items()})
    return model


# --------------------------------------------------------------------- #
# layers                                                                #
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_pairwise_matches_jax(dtype):
    """sin and cos cast to x's dtype before the products, as in JAX: in
    bf16 to one bf16 rounding of the result (2^-8 relative)."""
    x = np.random.default_rng(2).normal(size=(2, 8, 32)).astype(np.float32)
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    ref = np.asarray(jtf.apply_rope_pairwise(jnp.asarray(x, jd)), np.float32)
    got = ttf.apply_rope_pairwise(_t(x).to(td)).float().numpy()
    tol = LAYER_TOL if dtype == "float32" else dict(rtol=2 ** -7, atol=2 ** -7)
    np.testing.assert_allclose(got, ref, **tol)


def test_time_embedding_and_layernorm_match_flax():
    rng = np.random.default_rng(3)
    t = np.array([0, 7, 999], np.int32)
    m = jtf.TimeEmbedding(32)
    p = random_ct_params(jax.eval_shape(m.init, jax.random.PRNGKey(0), t), 4)
    port = ttf.TimeEmbedding(32)
    port.load_state_dict({f"{k}.{w}": _t(v) for k in ("linear1", "linear2") for w, v in (
        ("weight", np.asarray(p["params"][k]["kernel"]).T), ("bias", p["params"][k]["bias"]))})
    np.testing.assert_allclose(port(_t(t), torch.float32).detach().numpy(),
                               np.asarray(m.apply(p, jnp.asarray(t))), **LAYER_TOL)

    import flax.linen as fnn

    x = (rng.normal(size=(4, 6, 32)) * 3 + 1).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=32)).astype(np.float32)
    bias = (0.1 * rng.normal(size=32)).astype(np.float32)
    ref = fnn.LayerNorm().apply({"params": {"scale": scale, "bias": bias}}, jnp.asarray(x))
    ln = ttf.LayerNorm(32)
    ln.load_state_dict({"weight": _t(scale), "bias": _t(bias)})
    assert ln.eps == 1e-6
    np.testing.assert_allclose(ln(_t(x)).detach().numpy(), np.asarray(ref), **LAYER_TOL)


def test_transformer_layer_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, RT, 32)).astype(np.float32)
    cond = rng.normal(size=(2, RT, 32)).astype(np.float32)
    m = jtf.TransformerLayer(32, 2)
    p = random_ct_params(jax.eval_shape(m.init, jax.random.PRNGKey(0), x, cond), 6)
    port = ttf.TransformerLayer(32, 2)
    sd = _wrap_layer(p["params"])
    port.load_state_dict({k[len("layers.0."):]: _t(v) for k, v in sd.items()})
    np.testing.assert_allclose(port(_t(x), _t(cond)).detach().numpy(),
                               np.asarray(m.apply(p, jnp.asarray(x), jnp.asarray(cond))),
                               **LAYER_TOL)


def _wrap_layer(layer):
    """One layer's flax tree inside a CustomTransformer tree of one layer,
    the other leaves empty, for the port's map."""
    dense = {"kernel": np.zeros((1, 1), np.float32), "bias": np.zeros(1, np.float32)}
    tree = {k: dense for k in ("input_projection", "conditional_projection",
                               "output_projection")}
    tree["time_embedding"] = {"linear1": dense, "linear2": dense}
    tree["layers_0"] = layer
    return {k: v for k, v in jax_params_to_torch(tree).items() if k.startswith("layers.0.")}


# --------------------------------------------------------------------- #
# the model                                                             #
# --------------------------------------------------------------------- #


def test_custom_transformer_matches_jax(jax_ct):
    model, params = jax_ct
    i = _inputs()
    ref = np.asarray(model.apply(params, i["x"], i["t"], None, i["ac"]))
    port = _port(params)
    with torch.no_grad():
        got = port(_t(i["x"]), _t(i["t"]).long(), None, _t(i["ac"])).numpy()
        # the MS2 condition is unused; a missing MS1 condition is zeros
        ic = port(_t(i["x"]), _t(i["t"]).long(), _t(i["x"]) * 5, _t(i["ac"])).numpy()
        no_ac = port(_t(i["x"]), _t(i["t"]).long()).numpy()
    np.testing.assert_allclose(got, ref, **MODEL_TOL)
    assert np.array_equal(got, ic)
    np.testing.assert_allclose(
        no_ac, np.asarray(model.apply(params, i["x"], i["t"], None, None)), **MODEL_TOL)


def test_custom_transformer_bf16_matches_jax(jax_ct):
    _, params = jax_ct
    i = _inputs()
    ref = np.asarray(JaxCT(**CT, dtype=jnp.bfloat16).apply(params, i["x"], i["t"], None, i["ac"]),
                     np.float32)
    with torch.no_grad():
        out = _port(params, torch.bfloat16)(_t(i["x"]), _t(i["t"]).long(), None, _t(i["ac"]))
    assert out.dtype == torch.bfloat16
    got = out.float().numpy()
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel < BF16_REL_L2 and np.abs(got - ref).max() < BF16_ATOL, (rel, np.abs(got - ref).max())


def test_ms1_map_condition_raises_in_both_packages(jax_ct):
    """A 3-D MS1 condition (b, rt, mz_c), what sqMass slices give, raises in
    JAX's apply_rope_pairwise unpack; the port raises too."""
    model, params = jax_ct
    i = _inputs()
    ac3 = np.ones((B, RT, 10), np.float32)
    with pytest.raises(ValueError):
        model.apply(params, i["x"], i["t"], None, ac3)
    with pytest.raises(ValueError, match="2-D MS1 chromatogram"):
        _port(params)(_t(i["x"]), _t(i["t"]).long(), None, _t(ac3))


def _jax_draws(key, batch, shape):
    t_rng, noise_rng = jax.random.split(key)
    return (np.asarray(jax.random.randint(t_rng, (batch,), 0, 1000)),
            np.asarray(jax.random.normal(noise_rng, shape, dtype=jnp.float32)))


def test_train_loss_gradients_match_jax_grad(jax_ct):
    """train_loss on the same weights, data and draws; the port's gradients
    mapped to the flax tree by torch_to_jax_params against jax.grad."""
    model, params = jax_ct
    rng = np.random.default_rng(7)
    x0, ms2 = (rng.uniform(0, 1, (B, RT, CT["input_dim"])).astype(np.float32) for _ in "ab")
    ms1 = rng.uniform(0, 1, (B, RT)).astype(np.float32)
    key = jax.random.PRNGKey(8)
    t, eps = _jax_draws(key, B, x0.shape)
    jp = JaxDDIMProcess(schedule=jax_make_schedule(1000, "cosine", "eps"))

    def loss(p):
        return jp.train_loss(lambda *a: model.apply(p, *a), key, jnp.asarray(x0),
                             jnp.asarray(ms2), jnp.asarray(ms1))[0]

    jloss, jgrad = jax.value_and_grad(loss)(params)
    port = _port(params)
    tp = DDIMProcess(schedule=make_schedule(1000, "cosine", "eps"))
    tloss, _ = tp.train_loss(port, _t(x0), _t(ms2), _t(ms1), t=_t(t), eps=_t(eps))
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-5)
    got, ref = _flat(torch_to_jax_params(grads_state_dict(port))), _flat(jgrad)
    assert got.keys() == ref.keys()
    for k in ref:
        if "['k_proj']['bias']" in k:
            # zero in exact arithmetic (a key bias adds one constant to each
            # query's logits, which the softmax cancels): rounding noise on
            # both sides, of the order of float32's epsilon times the
            # gradients around it
            assert max(np.abs(got[k]).max(), np.abs(ref[k]).max()) < 1e-6, k
            continue
        err = np.abs(got[k] - ref[k]).max() / (np.abs(ref[k]).max() + 1e-12)
        assert err < GRAD_TOL, (k, err)


# --------------------------------------------------------------------- #
# a JAX Trainer checkpoint, resumed                                     #
# --------------------------------------------------------------------- #


def _batch(seed, b=1):
    rng = np.random.default_rng(seed)
    return {"ms2_1": rng.uniform(0, 1, (b, RT, CT["input_dim"])).astype(np.float32),
            "ms1_1": rng.uniform(0, 1, (b, RT)).astype(np.float32),
            "ms2_2": rng.uniform(0, 1, (b, RT, CT["input_dim"])).astype(np.float32)}


@pytest.mark.parametrize("kind", ["adamw", "factored"])
def test_trainer_resumes_a_jax_custom_transformer_run(tmp_path, jax_ct, kind):
    """A JAX Trainer of the CustomTransformer takes two steps and writes its
    latest file; the port resumes from it (epoch, best loss, step, EMA and
    the optax Adam or factored state in torch layouts) and takes the third
    step against JAX's from the same state with the JAX rng's draws, at the
    tolerances of tests/test_torch_trainer.py's one-step test: loss 1e-5
    relative, parameters within 2·lr (+1e-5 relative; Adam's first updates
    are ~lr·sign(g)), the EMA within 2·lr·1e-3. The factored runs factor at
    5, as the factored checkpoint test of test_torch_checkpoint.py, so the
    tiny model's kernels carry row and column statistics."""
    _, params = jax_ct
    lr = 1e-3
    jproc = JaxDDIMProcess(schedule=jax_make_schedule(1000, "cosine", "eps"))
    tx = None if kind == "adamw" else optax.chain(
        optax.clip_by_global_norm(10.0), optax.scale_by_factored_rms(min_dim_size_to_factor=5))
    jtr = JaxTrainer(JaxCT(**CT), jproc, optimizer=tx, seed=0)
    state = jtr._fresh_state(params)
    batches = [{k: jnp.asarray(v) for k, v in _batch(s).items()} for s in (10, 11, 12)]
    for s in range(2):
        state, _ = jtr.train_step(state, batches[s], jnp.float32(lr), jax.random.PRNGKey(s))
    best = tmp_path / "ckpt" / "best_model.ckpt"
    jax_save_checkpoint(latest_path_for(str(best)), {
        "epoch": np.int64(1), "best_loss": np.float64(0.5), "state": state})
    key = jax.random.PRNGKey(9)
    t, eps = _jax_draws(key, 1, batches[2]["ms2_1"].shape)
    jstate, jm = jtr.train_step(state, batches[2], jnp.float32(lr), key)

    model = CustomTransformer(**CT)
    opt = None if kind == "adamw" else ClippedFactoredRMS(model.parameters(),
                                                          min_dim_size_to_factor=5)
    tr = Trainer(model, DDIMProcess(schedule=make_schedule(1000, "cosine", "eps")), optimizer=opt)
    ckpt, epoch, best_loss, resumed = restore_or_init(str(best))
    assert resumed and (epoch, best_loss) == (1, 0.5) and ckpt["opt_state"]["kind"] == kind
    tr._load(ckpt)
    assert tr.step == 2
    m = tr.train_step(_batch(12), lr, t=_t(t), eps=_t(eps))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    got, ema = tr.model.state_dict(), tr.ema_state_dict()
    ref, ref_ema = jax_params_to_torch(jstate.params), jax_params_to_torch(jstate.ema_params)
    assert got.keys() == ref.keys()
    for k in ref:
        if k.endswith("k_proj.bias"):  # its gradient is rounding noise on both sides: see
            continue  # test_train_loss_gradients_match_jax_grad
        np.testing.assert_allclose(got[k].detach().numpy(), ref[k], rtol=1e-5, atol=2 * lr,
                                   err_msg=k)
        np.testing.assert_allclose(ema[k].numpy(), ref_ema[k], rtol=1e-5, atol=2 * lr * 1e-3,
                                   err_msg=k)

    # Trainer.train resumes after the stored epoch
    model2 = CustomTransformer(**CT)
    opt2 = None if kind == "adamw" else ClippedFactoredRMS(model2.parameters(),
                                                           min_dim_size_to_factor=5)
    tr2 = Trainer(model2, DDIMProcess(schedule=make_schedule(1000, "cosine", "eps")),
                  optimizer=opt2)
    tr2.train([_batch(10), _batch(11)], epochs=3, warmup_epochs=0, checkpoint_path=str(best))
    assert tr2.step == 2 + 2 and load_checkpoint(latest_path_for(str(best)))["epoch"] == 2


# --------------------------------------------------------------------- #
# the reference converter                                               #
# --------------------------------------------------------------------- #


def _reference_state_dict(seed, h=32, layers=2, in_dim=64):
    """A state_dict in the reference CustomTransformer's names (packed
    nn.MultiheadAttention in_proj, ``ff.0``/``ff.2``)."""
    rng = np.random.default_rng(seed)

    def w(*s):
        return _t(rng.normal(size=s).astype(np.float32) * 0.1)

    sd = {"input_projection.weight": w(h, in_dim), "input_projection.bias": w(h),
          "conditional_projection.weight": w(h, 1), "conditional_projection.bias": w(h),
          "output_projection.weight": w(in_dim, h), "output_projection.bias": w(in_dim),
          "time_embedding.linear1.weight": w(4 * h, h), "time_embedding.linear1.bias": w(4 * h),
          "time_embedding.linear2.weight": w(h, 4 * h), "time_embedding.linear2.bias": w(h)}
    for i in range(layers):
        p = f"layers.{i}"
        sd.update({f"{p}.attention.in_proj_weight": w(3 * h, h),
                   f"{p}.attention.in_proj_bias": w(3 * h),
                   f"{p}.attention.out_proj.weight": w(h, h), f"{p}.attention.out_proj.bias": w(h),
                   f"{p}.norm1.weight": 1 + w(h), f"{p}.norm1.bias": w(h),
                   f"{p}.norm2.weight": 1 + w(h), f"{p}.norm2.bias": w(h),
                   f"{p}.ff.0.weight": w(4 * h, h), f"{p}.ff.0.bias": w(4 * h),
                   f"{p}.ff.2.weight": w(h, 4 * h), f"{p}.ff.2.bias": w(h)})
    return sd


def test_reference_converter_matches_jax():
    """The port's copy of convert_custom_transformer_state_dict gives JAX's
    tree leaf for leaf, and through the port's map the port model computes
    what the JAX model computes on the JAX converter's tree."""
    sd = _reference_state_dict(13)
    ref = jax_convert_ct({k: v.numpy() for k, v in sd.items()}, num_layers=2, hidden_dim=32)
    got = convert_custom_transformer_state_dict(sd, num_layers=2, hidden_dim=32)
    fr, fg = _flat(ref), _flat(got)
    assert fr.keys() == fg.keys() and all(np.array_equal(fr[k], fg[k]) for k in fr)
    i = _inputs(14)
    out = np.asarray(JaxCT(**CT).apply(ref, i["x"], i["t"], None, i["ac"]))
    with torch.no_grad():
        port = _port(got)(_t(i["x"]), _t(i["t"]).long(), None, _t(i["ac"])).numpy()
    np.testing.assert_allclose(port, out, **MODEL_TOL)


# --------------------------------------------------------------------- #
# builder and CLI                                                       #
# --------------------------------------------------------------------- #


def _config(**tpu):
    cfg = load_train_config("dquartic_train_config.json")
    cfg["model"]["use_model"] = "CustomTransformer"
    cfg["model"]["CustomTransformer"] = dict(CT)
    cfg["tpu"].update(**tpu)
    cfg["wandb"]["use_wandb"] = False
    return cfg


def test_build_model_serves_in_the_compute_dtype_with_float32_layernorms():
    cfg = _config(compute_dtype="bfloat16", quantize_mid=True, fused_resnet=True)
    serve = build_model(cfg, device="cpu", seed=3)  # the UNet1d's tpu keys are not read
    train = build_model(cfg, device="cpu", seed=3, trainable=True)
    assert isinstance(serve, CustomTransformer) and not serve.training
    for name, p in serve.named_parameters():
        norm = ".norm1." in name or ".norm2." in name
        assert p.dtype == (torch.float32 if norm else torch.bfloat16) and not p.requires_grad, name
    assert all(p.dtype == torch.float32 and p.requires_grad for p in train.parameters())
    i = _inputs(4, b=1)
    with torch.no_grad():
        a = serve(_t(i["x"]), _t(i["t"]).long(), None, _t(i["ac"]))
        b = train(_t(i["x"]), _t(i["t"]).long(), None, _t(i["ac"]))
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    again = build_model(cfg, device="cpu", state_dict=train.state_dict())
    assert all(torch.equal(x, y) for x, y in zip(again.state_dict().values(),
                                                 serve.state_dict().values()))


def test_seeded_weights_follow_flax_initialization():
    """lecun_normal kernels: truncated at two standard deviations with a
    standard deviation of sqrt(1/fan_in); zero biases, unit LayerNorm
    scales; another seed, other weights."""
    cfg = _config()
    cfg["model"]["CustomTransformer"].update(input_dim=512, hidden_dim=256)
    m = build_model(cfg, device="cpu", seed=0, trainable=True)
    w = m.input_projection.weight.detach()
    std = 512 ** -0.5
    assert abs(float(w.std()) / std - 1) < 0.02
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    assert float(m.input_projection.bias.detach().abs().max()) == 0
    assert torch.equal(m.layers[0].norm1.weight.detach(), torch.ones(256))
    other = build_model(cfg, device="cpu", seed=1, trainable=True)
    assert not torch.equal(other.input_projection.weight, m.input_projection.weight)


def test_builder_refuses_what_jax_refuses():
    for key in ("attn_impl", "dim_mults"):
        cfg = _config()
        cfg["model"]["CustomTransformer"][key] = "pallas"
        with pytest.raises(ValueError, match="Unknown CustomTransformer config keys"):
            build_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="inference-only"):
        build_trainer(_config(quantize_mid=True), device="cpu")
    cfg = _config()
    cfg["tpu"]["mesh"]["sp"] = 2
    with pytest.raises(ValueError, match="Queue 1 item 7"):
        build_model(cfg, device="cpu")
    cfg = _config()
    cfg["model"]["use_model"] = "UNet2d"
    with pytest.raises(ValueError, match="Invalid model class"):
        build_model(cfg, device="cpu")
    if not torch.cuda.is_available():  # the entry points need the card unless told
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(_config())


def test_build_trainer_steps_and_samples():
    tr = build_trainer(_config(compute_dtype="bfloat16", fused_resnet=True), device="cpu", seed=2)
    before = [p.detach().clone() for p in tr.optimizer.params]
    m = tr.train_step(_batch(20), 1e-3, generator=torch.Generator().manual_seed(0))
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    assert any(not torch.equal(a, p) for a, p in zip(before, tr.optimizer.params))
    model = build_model(_config(compute_dtype="bfloat16"), device="cpu",
                        state_dict=tr.ema_state_dict())
    recs = DDIMSampler(model, tr.process).predict([_batch(21)], num_steps=3, device="cpu")
    assert recs[0]["pred"].shape == (1, RT, CT["input_dim"]) and np.isfinite(recs[0]["pred"]).all()


def test_cli_train_convert_and_predict(tmp_path):
    """``train`` with --device cpu (and a resume), ``predict`` from its
    checkpoint, ``convert-checkpoint`` of a reference file and ``predict``
    from the converted one; ``--quantize-mid`` and ``--fused-resnet``
    refuse this model, as in JAX."""
    rng = np.random.default_rng(30)
    np.save(tmp_path / "ms2.npy", rng.uniform(0, 100, (3, RT, CT["input_dim"])).astype(np.float32))
    np.save(tmp_path / "ms1.npy", rng.uniform(0, 50, (3, RT)).astype(np.float32))
    cfg = _config()
    cfg["data"].update(parquet_directory=None, ms2_data_path=str(tmp_path / "ms2.npy"),
                       ms1_data_path=str(tmp_path / "ms1.npy"))
    best = tmp_path / "ckpt" / "best_model.ckpt"
    cfg["model"].update(checkpoint_path=str(best), num_epochs=2, warmup_epochs=1)
    (tmp_path / "c.json").write_text(json.dumps(cfg))
    runner = CliRunner()
    r = runner.invoke(cli, ["train", "--device", "cpu", str(tmp_path / "c.json")])
    assert r.exit_code == 0, r.output
    latest = latest_path_for(str(best))
    assert load_checkpoint(latest)["step"] == 6
    cfg["model"]["num_epochs"] = 3
    (tmp_path / "c3.json").write_text(json.dumps(cfg))
    r = runner.invoke(cli, ["train", "--device", "cpu", str(tmp_path / "c3.json")])
    assert r.exit_code == 0, r.output
    assert load_checkpoint(latest)["epoch"] == 2 and load_checkpoint(latest)["step"] == 9

    out = tmp_path / "pred.npz"
    r = runner.invoke(cli, ["predict", "--device", "cpu", "--num-steps", "3", "--num-batches", "1",
                            str(tmp_path / "c3.json"), latest, str(out)])
    assert r.exit_code == 0, r.output
    pred = np.load(out)["pred_0"]
    assert pred.shape == (1, RT, CT["input_dim"]) and np.isfinite(pred).all()
    for flag in ("--quantize-mid", "--fused-resnet"):
        r = runner.invoke(cli, ["predict", "--device", "cpu", flag, str(tmp_path / "c3.json"),
                                latest, str(out)])
        assert r.exit_code != 0 and "only applies to UNet1d" in r.output

    torch.save({"model_state_dict": _reference_state_dict(31), "epoch": 5, "best_loss": 0.5},
               tmp_path / "ref.ckpt")
    conv = tmp_path / "converted.ckpt"
    r = runner.invoke(cli, ["convert-checkpoint", str(tmp_path / "ref.ckpt"), str(conv),
                            str(tmp_path / "c3.json")])
    assert r.exit_code == 0, r.output
    ck = load_checkpoint(str(conv))
    assert (ck["epoch"], ck["step"], ck["opt_state"]) == (5, 0, None)
    r = runner.invoke(cli, ["predict", "--device", "cpu", "--num-steps", "3", "--num-batches", "1",
                            str(tmp_path / "c3.json"), str(conv), str(out)])
    assert r.exit_code == 0, r.output
    assert np.isfinite(np.load(out)["pred_0"]).all()
