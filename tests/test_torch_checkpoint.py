"""The port reads the JAX package's checkpoints: its msgpack decoder against
flax's, sampling from params and EMA loaded that way against the JAX
sampler on the same tree (also through the int8 mid convs), resuming a JAX
training run, the factored optimizer, and the reference-checkpoint
converter. The JAX files are written at test time by
``dquartic_tpu.train.checkpoint.save_checkpoint`` from a JAX ``TrainState``
of the tiny UNet1d of ``tests/test_cli_viz.py``; everything runs in float32
on the CPU, where the port's kernel wrappers run their plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from dquartic_tpu.compat.torch_ckpt import convert_checkpoint_file as jax_convert_file
from dquartic_tpu.core import DDIMProcess as JaxDDIMProcess
from dquartic_tpu.core import make_schedule as jax_make_schedule
from dquartic_tpu.infer import DDIMSampler as JaxDDIMSampler
from dquartic_tpu.models import UNet1d as JaxUNet1d
from dquartic_tpu.ops.quantization import quantize_mid_block_params as jax_quantize_mid
from dquartic_tpu.train import Trainer as JaxTrainer
from dquartic_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from dquartic_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from dquartic_tpu_torch.compat.jax_params import jax_params_to_torch
from dquartic_tpu_torch.compat.torch_ckpt import convert_checkpoint_file
from dquartic_tpu_torch.core import DDIMProcess, make_schedule
from dquartic_tpu_torch.infer import DDIMSampler
from dquartic_tpu_torch.models import UNet1d
from dquartic_tpu_torch.train import (
    ClippedFactoredRMS, Trainer, checkpoint_params, latest_path_for, load_checkpoint,
)
from dquartic_tpu_torch.train.checkpoint import read_jax_checkpoint, read_msgpack
from dquartic_tpu_torch.train.checkpoint import restore_or_init
from dquartic_tpu_torch.utils.builder import build_model
from dquartic_tpu_torch.utils.config import load_train_config
from test_torch_model import random_params

RT, MZ = 4, 16
TINY = dict(dim=4, channels=1, dim_mults=(1, 2), conditional=True, init_cond_channels=1,
            attn_cond_channels=1, downsample_dim=MZ, simple=True)
# the sampler's tolerance (tests/test_torch_sampler.py): float32 on both
# sides, the per-forward summation-order difference amplified by
# 1/sqrt(alpha_bar) at the first step
SAMPLE_TOL = dict(rtol=1e-3, atol=1e-3)


def _t(a):
    return torch.from_numpy(np.array(a))


def _batch(seed, b=1):
    rng = np.random.default_rng(seed)
    return {"ms2_1": rng.uniform(0, 1, (b, RT, MZ)).astype(np.float32),
            "ms1_1": rng.uniform(0, 1, (b, RT)).astype(np.float32),
            "ms2_2": rng.uniform(0, 1, (b, RT, MZ)).astype(np.float32)}


def _jax_trainer(optimizer=None):
    return JaxTrainer(JaxUNet1d(**TINY), JaxDDIMProcess(schedule=jax_make_schedule(
        1000, "cosine", "eps")), optimizer=optimizer, seed=0)


def _random_like(tree, seed, positive=False):
    rng = np.random.default_rng(seed)
    leaf = lambda x: rng.normal(size=np.shape(x)).astype(np.float32)  # noqa: E731
    return jax.tree_util.tree_map(
        (lambda x: np.abs(leaf(x)) + 0.1) if positive else leaf, tree)


@pytest.fixture(scope="module")
def jax_state():
    """A JAX TrainState of the tiny UNet1d (Trainer.init_state, no step)
    with random weights, an EMA apart from them and Adam moments from 3
    steps' worth of history."""
    tr = _jax_trainer()
    state = tr.init_state(_batch(0))
    params = random_params(jax.eval_shape(lambda: state.params), seed=1)
    ema = random_params(jax.eval_shape(lambda: state.params), seed=2)
    clip, adam, decay = state.opt_state
    adam = adam._replace(count=jnp.int32(3), mu=_random_like(params, 3),
                         nu=_random_like(params, 4, positive=True))
    return state.replace(step=jnp.int32(3), params=params, ema_params=ema,
                         opt_state=(clip, adam, decay))


def _save_jax(path, state, epoch=4, best_loss=0.25):
    jax_save_checkpoint(str(path), {"epoch": np.int64(epoch), "best_loss": np.float64(best_loss),
                                    "state": state})


def _tiny_config(**tpu):
    cfg = load_train_config("dquartic_train_config.json")
    cfg["model"]["UNet1d"].update(dim_mults=list(TINY["dim_mults"]), downsample_dim=MZ)
    cfg["tpu"].update(fused_resnet=True, **tpu)
    return cfg


# --------------------------------------------------------------------- #
# the msgpack decoder                                                   #
# --------------------------------------------------------------------- #


def _leaves(tree):
    if isinstance(tree, dict):
        return {(k,) + p: v for key, sub in tree.items() for k in [key]
                for p, v in _leaves(sub).items()}
    if isinstance(tree, list):
        return {(i,) + p: v for i, sub in enumerate(tree) for p, v in _leaves(sub).items()}
    return {(): tree}


def _assert_same_leaves(got, ref):
    got, ref = _leaves(got), _leaves(ref)
    assert got.keys() == ref.keys()
    for k, r in ref.items():
        g = got[k]
        if torch.is_tensor(g):  # bfloat16: the same bits
            assert g.dtype == torch.bfloat16 and np.asarray(r).dtype.name == "bfloat16", k
            np.testing.assert_array_equal(g.view(torch.int16).numpy().view(np.uint16),
                                          np.asarray(r).view(np.uint16), err_msg=str(k))
        elif isinstance(r, (np.ndarray, np.generic)):
            assert type(g) is type(r) and g.dtype == r.dtype and g.shape == r.shape, k
            assert np.asarray(g).tobytes() == np.asarray(r).tobytes(), k
        else:
            assert type(g) is type(r) and g == r, k


@pytest.mark.parametrize("chunk_bytes", [None, 1000])
def test_reader_matches_msgpack_restore(tmp_path, jax_state, monkeypatch, chunk_bytes):
    """A JAX train checkpoint, then a tree of every leaf kind flax writes
    (bfloat16 arrays, numpy scalars, Python numbers, str, bool, None, an
    array of each width): the port's decoder gives flax's tree leaf for
    leaf, bitwise. With flax's chunk size cut to 1000 bytes the larger
    arrays are written chunked and read back whole."""
    if chunk_bytes is not None:
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", chunk_bytes)
    path = tmp_path / "latest.ckpt"
    _save_jax(path, jax_state)
    ref = serialization.msgpack_restore(path.read_bytes())
    got = read_jax_checkpoint(str(path))
    _assert_same_leaves(got, ref)

    rng = np.random.default_rng(5)
    tree = {
        "bf16": jnp.asarray(rng.normal(size=(3, 700)), jnp.bfloat16),
        "bf16_scalar": jnp.bfloat16(1.25),
        "scalars": {"f32": np.float32(1.5), "i32": np.int32(-7), "f64": np.float64(2.5e-300),
                    "u8": np.uint8(200), "bool_": np.bool_(True)},
        "py": {"int": 3, "neg": -40000, "big": 2**40, "float": 0.1, "none": None, "t": True,
               "f": False, "s": "slice", "long_s": "x" * 300, "list": [1, 2.0, "a"]},
        "arrays": {str(dt): rng.normal(size=(2, 600)).astype(dt)
                   for dt in (np.float16, np.float32, np.float64, np.int8, np.int64)},
        "empty": {}, "zero_d": np.asarray(4.0, np.float32),
    }
    data = serialization.msgpack_serialize(tree)
    _assert_same_leaves(read_msgpack(bytearray(data)),
                        serialization.msgpack_restore(data))
    assert (b"__msgpack_chunked_array__" in data) == (chunk_bytes is not None)


def test_reader_rejects_complex_and_truncation():
    data = serialization.msgpack_serialize({"c": 1 + 2j})
    with pytest.raises(ValueError, match="extension"):
        read_msgpack(bytearray(data))
    data = serialization.msgpack_serialize({"a": np.ones(8, np.float32)})
    with pytest.raises(ValueError, match="truncated"):
        read_msgpack(bytearray(data[:-3]))


# --------------------------------------------------------------------- #
# serving from a JAX checkpoint                                         #
# --------------------------------------------------------------------- #


def _sample_inputs(seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(1, RT, MZ)).astype(np.float32),
            rng.uniform(0, 1, (1, RT, MZ)).astype(np.float32),
            rng.uniform(0, 1, (1, RT)).astype(np.float32))


@pytest.mark.parametrize("use_ema", [False, True])
@pytest.mark.parametrize("quantize", [False, True])
def test_sample_from_jax_checkpoint_matches_jax(tmp_path, jax_state, use_ema, quantize):
    """The params (or the EMA) of a JAX file through load_checkpoint,
    checkpoint_params and build_model(state_dict=...) sample what JAX's
    DDIMSampler samples from the same tree; with quantize_mid both
    packages quantize those float weights (the JAX predict path)."""
    path = tmp_path / "best.ckpt"
    _save_jax(path, jax_state)
    tree = jax_state.ema_params if use_ema else jax_state.params
    jmodel = JaxUNet1d(**TINY)
    if quantize:
        jmodel, tree = jmodel.clone(quantize_mid=True), jax_quantize_mid(tree)
    x_t, ms2, ms1 = _sample_inputs(7)
    jproc = JaxDDIMProcess(schedule=jax_make_schedule(1000, "cosine", "eps"))
    jx0, jnoise = JaxDDIMSampler(jmodel, jproc).sample(tree, x_t, ms2, ms1, num_steps=5)

    ckpt = load_checkpoint(str(path))
    assert (ckpt["epoch"], ckpt["best_loss"], ckpt["step"]) == (4, 0.25, 3)
    model = build_model(_tiny_config(quantize_mid=quantize), device="cpu",
                        state_dict=checkpoint_params(ckpt, use_ema))
    if quantize:
        assert model.mid_block1.block1.proj.weight_q.dtype == torch.int8
    proc = DDIMProcess(schedule=make_schedule(1000, "cosine", "eps"))
    x0, noise = DDIMSampler(model, proc).sample(_t(x_t), _t(ms2), _t(ms1), num_steps=5)
    np.testing.assert_allclose(x0.numpy(), np.asarray(jx0), **SAMPLE_TOL)
    np.testing.assert_allclose(noise.numpy(), np.asarray(jnoise), **SAMPLE_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_from_state_dict_is_the_seeded_model(dtype):
    """build_model from a state_dict quantizes the float weights, then
    casts: bitwise what build_model makes from the seed of those weights."""
    cfg = _tiny_config(quantize_mid=True, compute_dtype=dtype)
    seeded = build_model(cfg, device="cpu", seed=11)
    weights = build_model(_tiny_config(compute_dtype=dtype), device="cpu", seed=11,
                          trainable=True).state_dict()
    loaded = build_model(cfg, device="cpu", state_dict=weights)
    a, b = seeded.state_dict(), loaded.state_dict()
    assert a.keys() == b.keys() and any(v.dtype == torch.int8 for v in a.values())
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


# --------------------------------------------------------------------- #
# resuming a JAX training run                                           #
# --------------------------------------------------------------------- #


def test_trainer_resumes_a_jax_run(tmp_path, jax_state):
    """One port step from a JAX latest file against the JAX step from the
    same state, with the JAX rng's draws injected, at the tolerance of
    test_trainer_step_matches_jax (loss 1e-5 relative; parameters within
    2·lr + 1e-5 relative, the EMA within 2·lr·1e-3). Then Trainer.train
    resumes after the stored epoch with the stored step count and best
    loss."""
    from test_torch_trainer import _jax_draws

    lr = 1e-3
    best = tmp_path / "ckpt" / "best_model.ckpt"
    _save_jax(latest_path_for(str(best)), jax_state, epoch=4, best_loss=0.25)
    batch = _batch(8)
    key = jax.random.PRNGKey(9)
    t, eps = _jax_draws(key, 1, batch["ms2_1"].shape)
    jtr = _jax_trainer()
    donated = jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), jax_state)
    jstate, jm = jtr.train_step(donated, {k: jnp.asarray(v) for k, v in batch.items()},
                                jnp.float32(lr), key)

    tr = Trainer(UNet1d(**TINY, fused_resnet=True),
                 DDIMProcess(schedule=make_schedule(1000, "cosine", "eps")))
    ckpt, epoch, best_loss, resumed = restore_or_init(str(best))
    assert resumed and (epoch, best_loss) == (4, 0.25)
    tr._load(ckpt)
    assert tr.step == 3
    m = tr.train_step(batch, lr, t=_t(t), eps=_t(eps))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    got = tr.model.state_dict()
    ref = jax_params_to_torch(jstate.params)
    ref_ema = jax_params_to_torch(jstate.ema_params)
    ema = tr.ema_state_dict()
    for k in ref:
        np.testing.assert_allclose(got[k].detach().numpy(), ref[k], rtol=1e-5, atol=2 * lr,
                                   err_msg=k)
        np.testing.assert_allclose(ema[k].numpy(), ref_ema[k], rtol=1e-5, atol=2 * lr * 1e-3,
                                   err_msg=k)

    tr2 = Trainer(UNet1d(**TINY, fused_resnet=True),
                  DDIMProcess(schedule=make_schedule(1000, "cosine", "eps")))
    tr2.train([batch, _batch(10)], epochs=6, warmup_epochs=0, checkpoint_path=str(best))
    assert tr2.step == 3 + 2 and load_checkpoint(latest_path_for(str(best)))["epoch"] == 5


def test_factored_state_from_a_jax_checkpoint(tmp_path, jax_state):
    """optax's factored state in flax layouts, written in a JAX checkpoint,
    drives the port's factored optimizer in torch layouts: after two optax
    steps on random gradients (statistics with history), the port loads the
    file and takes the third step on the same gradients. The factoring
    threshold is 5 on both sides (the tiny model has no axis of 128), so
    its (3, 8, 8) conv kernels factor with row and column on swapped axes
    in the two layouts (a tie of C_in and C_out), and the (1, 8, 384)
    ones without a tie. float32, sums in another order: 1e-5 relative."""
    tx = optax.chain(optax.clip_by_global_norm(10.0),
                     optax.scale_by_factored_rms(min_dim_size_to_factor=5))
    params = jax.tree_util.tree_map(jnp.asarray, jax_state.params)
    opt = tx.init(params)
    grads = [_random_like(params, 20 + i) for i in range(3)]
    lr = 1e-2
    for g in grads[:2]:
        u, opt = tx.update(g, opt, params)
        params = jax.tree_util.tree_map(lambda p, x: p - lr * x, params, u)
    path = tmp_path / "latest.ckpt"
    _save_jax(path, jax_state.replace(params=params, opt_state=opt))
    n_factored = sum(np.size(v) == 1 and np.ndim(p) > 1 for v, p in zip(
        jax.tree_util.tree_leaves(opt[1].v), jax.tree_util.tree_leaves(params)))
    assert n_factored >= 8

    model = UNet1d(**TINY, fused_resnet=True)
    ckpt = load_checkpoint(str(path))
    model.load_state_dict(ckpt["params"])
    names = [n for n, _ in model.named_parameters()]
    optim = ClippedFactoredRMS(model.parameters(), min_dim_size_to_factor=5)
    optim.load_state_dict(ckpt["opt_state"], names)
    assert optim.count == 2
    u, _ = tx.update(grads[2], opt, params)
    ref = jax_params_to_torch(jax.tree_util.tree_map(lambda p, x: p - lr * x, params, u))
    g_port = jax_params_to_torch(grads[2])
    for n, p in model.named_parameters():
        p.grad = _t(g_port[n])
    optim.step(lr)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[n], rtol=1e-5, atol=1e-7, err_msg=n)


# --------------------------------------------------------------------- #
# EMA keyed by name; the reference converter                            #
# --------------------------------------------------------------------- #


def test_ema_by_name_and_the_old_positional_form(tmp_path):
    """The port's checkpoints key the EMA by parameter name, so
    checkpoint_params picks it without a Trainer; a file of the earlier
    form (a positional list) gives the same weights."""
    torch.manual_seed(0)
    tr = Trainer(UNet1d(**TINY, fused_resnet=True),
                 DDIMProcess(schedule=make_schedule(1000, "cosine", "eps")), ema_decay=0.5)
    best = str(tmp_path / "best.ckpt")
    tr.train([_batch(3)], epochs=1, warmup_epochs=0, checkpoint_path=best)
    ckpt = load_checkpoint(best)
    assert isinstance(ckpt["ema_params"], dict) and list(ckpt["ema_params"]) == tr.param_names
    new = checkpoint_params(ckpt, use_ema=True)
    assert all(torch.equal(new[k], v) for k, v in tr.ema_state_dict().items())
    trained = checkpoint_params(ckpt, use_ema=False)
    assert all(torch.equal(trained[k], v) for k, v in tr.model.state_dict().items())
    assert any(not torch.equal(new[k], trained[k]) for k in trained)

    old = dict(ckpt, ema_params=[ckpt["ema_params"][n] for n in tr.param_names])
    assert all(torch.equal(checkpoint_params(old)[k], v) for k, v in new.items())
    torch.save(old, latest_path_for(best))
    resumed = Trainer(UNet1d(**TINY, fused_resnet=True),
                      DDIMProcess(schedule=make_schedule(1000, "cosine", "eps")), ema_decay=0.5)
    resumed._load(load_checkpoint(latest_path_for(best)))
    assert all(torch.equal(a, b) for a, b in zip(resumed.ema_params, tr.ema_params))


def test_convert_checkpoint_matches_jax(tmp_path):
    """One reference-named state_dict (for simple=True the port's names
    and layouts are the reference's) through the JAX converter and the
    port's: the two files sample alike, and the port's file holds the
    weights unchanged, as params and EMA, with no optimizer state."""
    cfg = _tiny_config()
    cfg["model"]["UNet1d"]["dim_mults"] = list(TINY["dim_mults"])
    cfg_path = tmp_path / "config.json"
    import json

    cfg_path.write_text(json.dumps(cfg))
    torch.manual_seed(4)
    ref_model = UNet1d(**TINY)
    with torch.no_grad():
        for p in ref_model.parameters():
            p.add_(0.05 * torch.randn_like(p))
    sd = ref_model.state_dict()
    ref_path = tmp_path / "reference.ckpt"
    torch.save({"model_state_dict": sd, "epoch": 7, "best_loss": 0.125}, ref_path)

    jax_convert_file(str(ref_path), str(tmp_path / "jax.ckpt"), str(cfg_path))
    convert_checkpoint_file(str(ref_path), str(tmp_path / "port.ckpt"), str(cfg_path))
    jck = jax_load_checkpoint(str(tmp_path / "jax.ckpt"))
    ck = load_checkpoint(str(tmp_path / "port.ckpt"))
    assert (ck["epoch"], ck["best_loss"], ck["step"], ck["opt_state"]) == (7, 0.125, 0, None)
    assert ck["params"].keys() == sd.keys()
    assert all(torch.equal(ck["params"][k], sd[k]) for k in sd)
    assert all(torch.equal(ck["ema_params"][k], sd[k]) for k in sd)

    x_t, ms2, ms1 = _sample_inputs(12)
    jproc = JaxDDIMProcess(schedule=jax_make_schedule(1000, "cosine", "eps"))
    jx0, _ = JaxDDIMSampler(JaxUNet1d(**TINY), jproc).sample(
        jck["state"]["params"], x_t, ms2, ms1, num_steps=5)
    model = build_model(cfg, device="cpu", state_dict=checkpoint_params(ck))
    x0, _ = DDIMSampler(model, DDIMProcess(schedule=make_schedule(1000, "cosine", "eps"))).sample(
        _t(x_t), _t(ms2), _t(ms1), num_steps=5)
    np.testing.assert_allclose(x0.numpy(), np.asarray(jx0), **SAMPLE_TOL)


def test_convert_checkpoint_refuses_custom_transformer(tmp_path):
    """Named for when the port refused the reference CustomTransformer: it
    now converts it. A reference-named state_dict through the JAX
    converter and the port's: the port's file holds the JAX file's tree
    through the port's map, bit for bit, as params and EMA, with the
    epoch and best loss and no optimizer state."""
    import json

    from test_torch_custom_transformer import CT, _reference_state_dict

    cfg = _tiny_config()
    cfg["model"]["use_model"] = "CustomTransformer"
    cfg["model"]["CustomTransformer"] = dict(CT)
    (tmp_path / "c.json").write_text(json.dumps(cfg))
    torch.save({"model_state_dict": _reference_state_dict(40), "epoch": 3, "best_loss": 0.5},
               tmp_path / "r.ckpt")
    args = str(tmp_path / "r.ckpt"), str(tmp_path / "c.json")
    jax_convert_file(args[0], str(tmp_path / "jax.ckpt"), args[1])
    convert_checkpoint_file(args[0], str(tmp_path / "o.ckpt"), args[1])
    ref = jax_params_to_torch(jax_load_checkpoint(str(tmp_path / "jax.ckpt"))["state"]["params"])
    ck = load_checkpoint(str(tmp_path / "o.ckpt"))
    assert (ck["epoch"], ck["best_loss"], ck["step"], ck["opt_state"]) == (3, 0.5, 0, None)
    for key in ("params", "ema_params"):
        assert ck[key].keys() == ref.keys()
        assert all(np.array_equal(ck[key][k].numpy(), ref[k]) for k in ref)
