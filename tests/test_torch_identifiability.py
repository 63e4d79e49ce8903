"""The port's identifiability experiment (scripts/run_identifiability_torch.py)
against the JAX script and package, on the CPU at small size.

* ``make_window`` is bitwise the JAX script's (that module imports only
  numpy at its top level).
* The on-device window generator's assembly from given draws against a
  numpy restatement of the JAX ``make_windows_jax`` (fragments
  scatter-added with ``np.add.at``): rtol 1e-6, atol 1e-7, since numpy's
  and torch's ``exp`` may differ in the last bit; the MS1 trace is exactly
  the sum of the amplitude-scaled profiles; one seed, bitwise the same
  windows.
* ``pair_batch`` on a drawn pair is bitwise the port's ``DIAMSDataset``
  min-max of that pair (itself bitwise JAX's, tests/test_torch_data.py).
* ``separation`` and ``cosine`` on hand-built maps.
* Three steps of the recipe (x0, uniform weighting, factored optimizer,
  EMA 0.999, remat_blocks; float32, as the CPU runs JAX's jitted bf16 5-37 %
  off float32, ROADMAP Queue 3) against three JAX ``Trainer.train_step`` calls
  on the same weights, batches, t and eps at a 3-level, m/z 256 model
  (:func:`_check_recipe_step`). The optimizer's decay rate is 0 at the
  first step, so each step is held, not only the first: loss and gradient
  norm rtol 1e-5; parameters rtol 1e-5 with atol 2·lr and the EMA within
  2·lr·1e-3 (a first factored update is about lr·sign(g) where g is near 0,
  and the summation order flips that sign); then what those cannot see,
  each within 1e-4 of its leaf's largest magnitude: the factored
  statistics against JAX's, and the update (p1 - p0)/lr and the statistics
  against optax's ``scale_by_factored_rms`` fed the port's own clipped
  gradients from its first step on (the JAX optimizer's second link), the
  update with a slack of two float32 spacings of p1 over lr; the step
  count; the EMA within two float32 spacings of the larger of the terms of
  JAX's ``e·d + p·(1 - d)`` on the
  port's values. A skipped update or statistics that do not decay fail
  these checks.
* 2N steps equal N steps, a save, a resume in a new trainer and N more,
  bitwise.
* A tiny ``main()`` writes ``metrics.jsonl`` with the JAX script's record
  keys, and ``viz_identifiability_torch.py`` its figure from that run.
"""

import importlib.util
import json
import os
import sys

import flax
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
from dquartic_tpu.train import make_optimizer as jax_make_optimizer
from dquartic_tpu_torch.compat.jax_params import (
    _opt_state_to_port,
    jax_params_to_torch,
    torch_to_jax_params,
)
from dquartic_tpu_torch.core import DDIMProcess, make_schedule
from dquartic_tpu_torch.data import DIAMSDataset
from dquartic_tpu_torch.models import UNet1d
from dquartic_tpu_torch.train import Trainer, make_optimizer
from dquartic_tpu_torch.utils.builder import build_trainer
from test_torch_model import SMALL, random_params
from test_torch_parallel import _scaled
from test_torch_trainer import _jax_draws

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import run_identifiability_torch as idf  # noqa: E402
import viz_identifiability_torch as idf_viz  # noqa: E402


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_run_identifiability", os.path.join(REPO, "scripts", "run_identifiability.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_make_window_matches_the_jax_script():
    jax_script = _jax_script()
    assert (jax_script.RT, jax_script.MZ) == (idf.RT, idf.MZ)
    a, b = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(3):
        (w, m), (jw, jm) = idf.make_window(a), jax_script.make_window(b)
        assert w.dtype == jw.dtype == np.float32
        np.testing.assert_array_equal(w, jw)
        np.testing.assert_array_equal(m, jm)


def _numpy_windows(d, mz):
    """The JAX script's make_windows_jax (run_identifiability.py:197-223) in
    numpy float32 from given draws; repeated bins summed by np.add.at."""
    c, s, nf, pos = (d[k].numpy() for k in ("c", "s", "nf", "pos"))
    n, n_pep = c.shape
    t = np.arange(idf.RT, dtype=np.float32)
    prof = np.exp(np.float32(-0.5) * ((t[None, None, :] - c[..., None]) / s[..., None]) ** 2)
    inten = np.exp(np.float32(0.8) * d["z_int"].numpy())
    inten = inten * (np.arange(idf.MAX_FRAGMENTS)[None, None, :] < nf[..., None])
    rows = np.arange(n * n_pep)[:, None]
    posf = pos.reshape(n * n_pep, idf.MAX_FRAGMENTS)
    intf = inten.reshape(n * n_pep, idf.MAX_FRAGMENTS).astype(np.float32)
    spec = np.zeros((n * n_pep, mz), np.float32)
    for off, w in zip(range(-2, 3), (0.1, 0.5, 1.0, 0.5, 0.1)):
        np.add.at(spec, (np.broadcast_to(rows, posf.shape), posf + off), np.float32(w) * intf)
    spec = spec.reshape(n, n_pep, mz)
    amp = np.exp(np.float32(0.4) * d["z_amp"].numpy())
    aprof = amp[..., None] * prof
    return np.einsum("npr,npm->nrm", aprof, spec), aprof.sum(axis=1), aprof


def test_window_generator_assembly_matches_numpy():
    mz = 256
    draws = idf.draw_windows(torch.Generator().manual_seed(3), 6, mz)
    # fragments that share bins: the case a scatter with repeated indices orders
    draws["pos"][0, 0, :4] = torch.tensor([100, 101, 103, 100])
    W, M, aprof = idf.assemble_windows(draws, mz)
    rW, rM, raprof = _numpy_windows(draws, mz)
    assert W.shape == (6, idf.RT, mz) and M.shape == (6, idf.RT)
    np.testing.assert_allclose(aprof.numpy(), raprof, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(W.numpy(), rW, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(M.numpy(), rM, rtol=1e-6, atol=1e-7)
    # the MS1 trace is exactly the sum of the amplitude-scaled profiles
    assert torch.equal(M, aprof[:, 0] + aprof[:, 1] + aprof[:, 2] + aprof[:, 3])
    nf = draws["nf"]
    assert int(nf.min()) >= 5 and int(nf.max()) <= 11
    assert int(draws["pos"].min()) >= 20 and int(draws["pos"].max()) < mz - 20


def test_window_generator_repeats_bitwise():
    one = idf.make_windows(torch.Generator().manual_seed(11), 4, 256)
    two = idf.make_windows(torch.Generator().manual_seed(11), 4, 256)
    other = idf.make_windows(torch.Generator().manual_seed(12), 4, 256)
    assert all(torch.equal(a, b) for a, b in zip(one, two))
    assert not torch.equal(one[0], other[0])
    batch = idf.make_batch_inf(torch.Generator().manual_seed(11), 2, 256)
    for k in ("ms2_1", "ms2_2"):  # pairwise min-max: the pair spans [0, 1]
        lo = torch.minimum(batch["ms2_1"].amin((1, 2)), batch["ms2_2"].amin((1, 2)))
        hi = torch.maximum(batch["ms2_1"].amax((1, 2)), batch["ms2_2"].amax((1, 2)))
        assert torch.equal(lo, torch.zeros(2)) and torch.allclose(hi, torch.ones(2))
        assert batch[k].shape == (2, idf.RT, 256)


def test_pair_batch_is_the_datasets_min_max(tmp_path):
    ms2, ms1 = idf.window_set(6, 128)
    np.save(tmp_path / "ms2.npy", ms2)
    np.save(tmp_path / "ms1.npy", ms1)
    ds = DIAMSDataset(ms2_file=str(tmp_path / "ms2.npy"), ms1_file=str(tmp_path / "ms1.npy"),
                      normalize="minmax", seed=4)
    dm2, dm1 = torch.from_numpy(ms2), torch.from_numpy(ms1)
    for _ in range(4):
        ref = ds.sample_pair()
        i, j = ds.last_indices
        got = idf.pair_batch(dm2[[i]], dm2[[j]], dm1[[i]], dm1[[j]])
        for k, r in zip(("ms2_1", "ms1_1", "ms2_2", "ms1_2"), ref):
            np.testing.assert_array_equal(got[k][0].numpy(), r, err_msg=k)
    i, j = idf.pair_indices(torch.Generator().manual_seed(0), 5, 2, overfit=True)
    assert i.tolist() == [0, 1, 0, 1, 0] and j.tolist() == [1, 0, 1, 0, 1]
    i, j = idf.pair_indices(torch.Generator().manual_seed(0), 64, 4, overfit=False)
    assert bool((i != j).all()) and int(i.max()) < 4 and int(j.max()) < 4


def test_separation_and_cosine_on_hand_built_maps():
    target = np.zeros((4, 10))
    other = np.zeros((4, 10))
    target[1, 2], target[2, 5] = 3.0, 1.0
    other[0, 7], other[3, 1] = 1.0, 3.0
    mix = 0.5 * target + 0.5 * other
    assert idf.separation(mix, target, other) == pytest.approx(0.5)
    assert idf.separation(target, target, other) == pytest.approx(1.0)
    assert idf.separation(other, target, other) == pytest.approx(0.0)
    assert idf.separation(-target, target, other) == pytest.approx(0.0)  # clipped at 0
    assert idf.cosine(target, target) == pytest.approx(1.0)
    assert idf.cosine(target, other) == pytest.approx(0.0)
    assert idf.cosine(mix, target) == pytest.approx(
        float((mix * target).sum() / np.linalg.norm(mix) / np.linalg.norm(target)))


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


RECIPE_MZ, RECIPE_STEPS = 256, 3
_RECIPE = {}


def _recipe_kw():
    return {**SMALL, "downsample_dim": RECIPE_MZ, "remat_blocks": True}


def _process():
    return DDIMProcess(schedule=make_schedule(1000, "cosine", "x0", weighting="uniform"))


def _jax_named_stats(opt_state, params):
    """optax's factored statistics as the port names and lays them out."""
    named = _opt_state_to_port(flax.serialization.to_state_dict(opt_state), params)
    return {k: {n: None if v is None else v.numpy() for n, v in named[k].items()}
            for k in ("v_row", "v_col", "v")}


def _jax_recipe():
    """The JAX Trainer's recipe steps from random weights: each step's
    batch, draws, learning rate and the state after it (once a module)."""
    if _RECIPE:
        return _RECIPE
    kw = _recipe_kw()
    jproc = JaxDDIMProcess(schedule=jax_make_schedule(1000, "cosine", "x0", weighting="uniform"))
    jtr = JaxTrainer(JaxUNet1d(**kw), jproc, optimizer=jax_make_optimizer(kind="factored"),
                     ema_decay=0.999, seed=0)
    batches = [{k: v.numpy() for k, v in idf.make_batch_inf(
        torch.Generator().manual_seed(5 + s), 2, RECIPE_MZ).items()} for s in range(RECIPE_STEPS)]
    params = random_params(jax.eval_shape(lambda: jtr.init_params(batches[0])), seed=21)
    state = jtr._fresh_state(params)
    steps = []
    for s, batch in enumerate(batches, start=1):
        key = jax.random.PRNGKey(22 + s)
        t, eps = _jax_draws(key, 2, batch["ms2_1"].shape)
        lr = idf.learning_rate(s, idf.BASE_LR, 24000)
        state, m = jtr.train_step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                                  jnp.float32(lr), key)
        steps.append(dict(batch=batch, t=t, eps=eps, lr=lr, loss=float(m["loss"]),
                          grad_norm=float(m["grad_norm"]), params=_flat(state.params),
                          ema=_flat(state.ema_params),
                          stats=_jax_named_stats(state.opt_state, state.params)))
    _RECIPE.update(params=params, steps=steps)
    return _RECIPE


def _port_flat(named):
    """A port state_dict (tensors by name) as the JAX tree's flat leaves, a
    copy of the live values."""
    return _flat(convert_unet1d_state_dict(
        {k: v.detach().numpy().copy() for k, v in named.items()}, _recipe_kw()["dim_mults"]))


def _port_recipe(ref, fault=None):
    """The port's Trainer through the reference's steps. After each: its
    metrics, weights, EMA, statistics and count, its update (p1 - p0)/lr,
    and what optax's ``scale_by_factored_rms`` makes of the port's clipped
    gradients (update and statistics). ``fault`` patches a fault into the
    optimizer: ``"update_skipped"`` (the statistics move, the weights not)
    or ``"no_decay"`` (decay rate 0 at every step: the statistics are the
    newest g² alone)."""
    import optax

    kw = _recipe_kw()
    model = UNet1d(**kw, fused_resnet=True)
    sd = jax_params_to_torch(ref["params"], kw["dim_mults"])
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    tr = Trainer(model, _process(), optimizer=make_optimizer(model.parameters(), kind="factored"),
                 ema_decay=0.999)
    opt = tr.optimizer
    if fault == "no_decay":
        opt.decay_rate = 0.0
    elif fault == "update_skipped":
        step = opt.step

        def skipped(lr):
            before = [p.detach().clone() for p in opt.params]
            norm = step(lr)
            with torch.no_grad():
                for p, b in zip(opt.params, before):
                    p.copy_(b)
            return norm

        opt.step = skipped
    elif fault is not None:
        raise ValueError(fault)
    shadow = optax.scale_by_factored_rms()
    sstate = shadow.init(ref["params"])
    out = []
    for r in ref["steps"]:
        p0 = _port_flat(dict(zip(tr.param_names, opt.params)))
        e0 = _port_flat(tr.ema_state_dict())
        m = tr.train_step(r["batch"], r["lr"], t=torch.tensor(r["t"]),
                          eps=torch.tensor(r["eps"]))
        grads = torch_to_jax_params({n: p.grad for n, p in zip(tr.param_names, opt.params)},
                                    kw["dim_mults"])
        u, sstate = shadow.update(grads, sstate, grads)  # params unused
        p1 = _port_flat(dict(zip(tr.param_names, opt.params)))
        whole = opt.state_dict(whole="cpu")
        out.append(dict(
            loss=float(m["loss"]), grad_norm=float(m["grad_norm"]), params=p1,
            ema0=e0, ema=_port_flat(tr.ema_state_dict()), count=(opt.count, tr.step),
            update={k: (p1[k].astype(np.float64) - p0[k]) / r["lr"] for k in p1},
            stats={k: {n: None if v is None else v.numpy().copy()
                       for n, v in zip(tr.param_names, whole[k])}
                   for k in ("v_row", "v_col", "v")},
            optax_update={k: -np.asarray(v, np.float64) for k, v in _flat(u).items()},
            optax_stats=_jax_named_stats({"1": sstate}, ref["params"])))
    return out


def _check_optimizer_step(got, r, k):
    """The statistics against JAX's and optax's, the update against
    optax's, the count (see the module docstring)."""
    for mk, want in r["stats"].items():
        for n, v in want.items():
            assert (got["stats"][mk][n] is None) == (v is None), (mk, n)
            if v is not None:
                _scaled(got["stats"][mk][n], v, 1e-4, f"step {k} {mk} {n} against JAX")
                _scaled(got["stats"][mk][n], got["optax_stats"][mk][n], 1e-4,
                        f"step {k} {mk} {n} against optax")
    for n, u in got["optax_update"].items():
        slack = 2 * np.spacing(np.abs(got["params"][n])).astype(np.float64) / r["lr"]
        _scaled(got["update"][n], u, 1e-4, f"step {k} update {n}", slack)
    assert got["count"] == (k, k)


def _check_recipe_step(got, r, k):
    np.testing.assert_allclose(got["loss"], r["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], r["grad_norm"], rtol=1e-5)
    assert got["params"].keys() == r["params"].keys()
    for n in r["params"]:
        np.testing.assert_allclose(got["params"][n], r["params"][n], rtol=1e-5,
                                   atol=2 * r["lr"], err_msg=f"step {k} {n}")
        np.testing.assert_allclose(got["ema"][n], r["ema"][n], rtol=1e-5,
                                   atol=2 * r["lr"] * 1e-3, err_msg=f"step {k} ema {n}")
        # JAX's e·d + p·(1 - d), 1 - d formed in double; its two products
        # and its sum are rounded on each side
        kept, new = got["ema0"][n] * np.float32(0.999), got["params"][n] * np.float32(1 - 0.999)
        ulp = np.spacing(np.maximum(np.abs(kept), np.abs(new)))
        assert np.all(np.abs(got["ema"][n] - (kept + new)) <= 2 * ulp), (k, n)
    _check_optimizer_step(got, r, k)


def test_recipe_step_matches_jax():
    """x0, uniform, factored, EMA 0.999, remat_blocks: three steps, each
    held against JAX's, float32."""
    ref = _jax_recipe()
    for k, (got, r) in enumerate(zip(_port_recipe(ref), ref["steps"]), start=1):
        _check_recipe_step(got, r, k)


@pytest.mark.parametrize("fault", ["update_skipped", "no_decay"])
def test_recipe_step_checks_catch_optimizer_faults(fault):
    """A skipped update, or statistics that do not decay, fail the
    optimizer's check of some step on their own."""
    ref = _jax_recipe()
    out = _port_recipe(ref, fault)
    with pytest.raises(AssertionError, match="of the leaf's largest magnitude"):
        for k, (got, r) in enumerate(zip(out, ref["steps"]), start=1):
            _check_optimizer_step(got, r, k)


def _tiny(config):
    """Two levels in float32: the CPU's scale for the loop's tests."""
    config["model"]["UNet1d"]["dim_mults"] = [1, 2]
    config["tpu"]["compute_dtype"] = "float32"


def _knobs(root, **kw):
    return idf.Knobs(**{**dict(root=str(root), steps=2, total=8, batch=2, eval_every=1000,
                               windows=4, mz=64, device="cpu", pred="x0",
                               weighting="uniform", ema="0.999", save_every=1000,
                               infinite=True, overfit=False, resume=False), **kw})


def _state(exp):
    tr = exp.trainer
    opt = tr.optimizer.state_dict()
    return ([p.detach().clone() for p in tr.optimizer.params],
            [e.clone() for e in tr.ema_params],
            [v.clone() for k in ("v_row", "v_col", "v") for v in opt[k] if v is not None],
            (tr.step, opt["count"]))


@pytest.mark.parametrize("infinite", [True, False])
def test_resume_retraces_the_uninterrupted_run(tmp_path, infinite):
    """2N steps, against N steps, save, a resumed trainer and N more."""
    n = 2
    whole = idf.setup(_knobs(tmp_path / "whole", infinite=infinite), _tiny)
    for step in range(1, 2 * n + 1):
        idf.train_step(whole, step)
    first = idf.setup(_knobs(tmp_path / "legs", infinite=infinite), _tiny)
    for step in range(1, n + 1):
        idf.train_step(first, step)
    idf.save(first, n)
    second = idf.setup(_knobs(tmp_path / "legs", infinite=infinite), _tiny)
    assert idf.resume(second) == n
    for step in range(n + 1, 2 * n + 1):
        idf.train_step(second, step)
    a, b = _state(whole), _state(second)
    assert a[3] == b[3] == (2 * n, 2 * n)
    for x, y in zip(a[:3], b[:3]):
        assert len(x) == len(y) > 0 and all(torch.equal(u, v) for u, v in zip(x, y))


@pytest.mark.parametrize("dtype,plain", [("bfloat16", False), ("float32", True)])
def test_numerics_knobs_reach_the_trainer(tmp_path, dtype, plain):
    """IDF_COMPUTE_DTYPE reaches the config and the model; IDF_PLAIN turns
    every kernel module of the model to its plain version."""
    exp = idf.setup(_knobs(tmp_path, compute_dtype=dtype, plain=plain),
                    lambda c: c["model"]["UNet1d"].update(dim_mults=[1, 2]))
    assert exp.config["tpu"]["compute_dtype"] == dtype
    assert exp.trainer.model.compute_dtype == getattr(torch, dtype)
    flags = [m.kernels for m in exp.trainer.model.modules() if hasattr(m, "kernels")]
    assert flags and all(f is not plain for f in flags)


def test_seed_knob_seeds_the_trainers_initial_weights(tmp_path):
    """IDF_SEED: the trainer's initial weights, the build_trainer seed (0 by
    default, as the JAX script's); the windows and the eval noise stay."""
    runs = {seed: idf.setup(_knobs(tmp_path / str(seed), seed=seed), _tiny) for seed in (0, 1)}
    assert idf.Knobs().seed == 0
    ref = build_trainer(runs[0].config, device="cpu", seed=0)
    p0, p1 = (list(runs[s].trainer.optimizer.params) for s in (0, 1))
    assert all(torch.equal(a, b) for a, b in zip(p0, ref.optimizer.params))
    assert not all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert torch.equal(runs[0].eval_noise, runs[1].eval_noise)


def test_main_writes_the_jax_scripts_records_and_the_figure(tmp_path):
    """A tiny overfit run through main(): the eval records at the start and
    the end and a loss record, with the JAX script's keys; both checkpoints;
    then the acceptance figure from its state.ckpt."""
    knobs = _knobs(tmp_path, overfit=True, infinite=False, ema="", steps=2, total=2)
    assert idf.main(knobs, _tiny, loss_every=2) == 2
    records = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert [sorted(r) for r in records] == [["evals", "step"], ["loss_mean500", "step", "wall_s"],
                                            ["evals", "step"]]
    assert [r["step"] for r in records] == [0, 2, 2]
    for rec in (records[0], records[2]):
        assert [e["pair"] for e in rec["evals"]] == ["train", "train_rev"]
        for e in rec["evals"]:
            assert sorted(e) == sorted(["pair", "cos50", "mix_baseline", "sep50", "sep50_swap",
                                        "sep_mix_baseline", "ms1_swap_rel"])
            assert all(np.isfinite(v) for k, v in e.items() if k != "pair")
    assert (tmp_path / "state.ckpt").exists() and (tmp_path / "state_best.ckpt").exists()

    out = tmp_path / "fig" / "idf.png"
    stats = idf_viz.main(str(out), _knobs(tmp_path, windows=4))
    assert out.exists() and out.stat().st_size > 0
    assert json.loads((tmp_path / "fig" / "idf.json").read_text()) == stats
    assert stats["step"] == 2 and 0.0 <= stats["sep50"] <= 1.0
