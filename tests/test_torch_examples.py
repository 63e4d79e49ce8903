"""The port's examples (``examples/*_torch.py``) against the JAX package's
scripts beside them, at a tiny size on the CPU.

The weights are the JAX model's random initialization, written by the JAX
package's ``save_checkpoint`` (flax msgpack) and read by both sides (the
port through ``compat/jax_params.py``). Each JAX script runs as its own
``main`` with ``sys.argv`` set; each port example through its ``main``
with ``--device cpu`` and through its functions:

* ``quantize_checkpoint``: the quantized sizes equal, the drift within the
  printed digits of JAX's;
* ``predict_and_plot``: given JAX's noise, the prediction at the sampler
  tests' tolerance (1e-3, tests/test_torch_sampler.py), the same
  ``metrics.json`` keys and PNG names;
* ``multichip_deconvolution``: the records of two gloo ranks under
  ``torch.distributed.run`` against a one-process ``predict``;
* ``explore_dataset`` (NPY and parquet) and ``inspect_sqmass``: the same
  printed summaries;
* without a card, every example refuses to run unless given ``--device``.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from dquartic_tpu.core import DDIMProcess as JaxDDIMProcess
from dquartic_tpu.core import make_schedule as jax_make_schedule
from dquartic_tpu.infer import DDIMSampler as JaxDDIMSampler
from dquartic_tpu.models import UNet1d as JaxUNet1d
from dquartic_tpu.train import Trainer as JaxTrainer
from dquartic_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from dquartic_tpu_torch.utils.config import load_train_config
from test_sqmass_slices import sqmass_file  # noqa: F401  (fixture)
from test_torch_model import random_params

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "examples"
# m/z 256 over two levels: the mid convs (64 x 64 x 3) are large enough to quantize
RT, MZ, N = 4, 256, 6
UNET = dict(dim=4, channels=1, dim_mults=[1, 2], conditional=True, init_cond_channels=1,
            attn_cond_channels=1, tfer_dim_mult=620, downsample_dim=MZ, simple=True)
STEPS = 3
SAMPLER_TOL = 1e-3



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The tiny models run fastest on one thread, which leaves the other
    cores to the other test modules."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _example(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax(name, argv, monkeypatch, capsys):
    """The JAX script ``name`` run as ``python examples/<name>.py argv``;
    its standard output."""
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    capsys.readouterr()
    _example(name).main()
    return capsys.readouterr().out


def _run_port(name, argv, capsys):
    capsys.readouterr()
    _example(f"{name}_torch").main([*argv])
    return capsys.readouterr().out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """NPY windows, the tiny config (float32, 10 timesteps) and a JAX
    checkpoint of random weights with an EMA."""
    tmp = tmp_path_factory.mktemp("examples")
    rng = np.random.default_rng(0)
    np.save(tmp / "ms2.npy", rng.uniform(0, 10, (N, RT, MZ)).astype(np.float32))
    np.save(tmp / "ms1.npy", rng.uniform(0, 5, (N, RT)).astype(np.float32))
    cfg = {
        "data": {"parquet_directory": None, "ms2_data_path": str(tmp / "ms2.npy"),
                 "ms1_data_path": str(tmp / "ms1.npy"), "normalize": "minmax"},
        "model": {"checkpoint_path": str(tmp / "ckpt" / "best_model.ckpt"),
                  "num_epochs": 1, "warmup_epochs": 1, "batch_size": 2, "learning_rate": 1e-3,
                  "num_timesteps": 10, "beta_schedule_type": "cosine", "pred_type": "eps",
                  "auto_normalize": True, "ms1_loss_weight": 0.0, "use_model": "UNet1d",
                  "UNet1d": dict(UNET)},
        "wandb": {"use_wandb": False},
        "threads": 1,
        "tpu": {"log_every_n_epochs": 1000},
    }
    config = tmp / "config.json"
    config.write_text(json.dumps(cfg))
    jtr = JaxTrainer(JaxUNet1d(**{**UNET, "dim_mults": tuple(UNET["dim_mults"])}),
                     JaxDDIMProcess(schedule=jax_make_schedule(10, "cosine", "eps")))
    state = jtr.init_state({"ms2_1": np.zeros((1, RT, MZ), np.float32),
                            "ms1_1": np.zeros((1, RT), np.float32)})
    shapes = jax.eval_shape(lambda: state.params)
    state = state.replace(params=random_params(shapes, seed=3),
                          ema_params=random_params(shapes, seed=4))
    ckpt = tmp / "jax.ckpt"
    jax_save_checkpoint(str(ckpt), {"epoch": np.int64(0), "best_loss": np.float64(1.0),
                                    "state": state})
    return tmp, str(config), str(ckpt), state


def test_quantize_checkpoint_matches_jax(run, monkeypatch, capsys):
    tmp, config, ckpt, _ = run
    jax_out = _run_jax("quantize_checkpoint", [config, ckpt, str(tmp / "q_jax.ckpt")],
                       monkeypatch, capsys).splitlines()
    port_out = _run_port("quantize_checkpoint", [config, ckpt, str(tmp / "q_port.ckpt"),
                                                 "--device", "cpu"], capsys).splitlines()
    assert jax_out[-3].startswith("params: ") and " -> " in jax_out[-3]
    assert port_out[-3] == jax_out[-3]  # the weights' MB before and after
    assert port_out[-2].split(" -> ")[0] == jax_out[-2].split(" -> ")[0]  # the same input file
    drift = [float(out[-1].rsplit(" ", 1)[1].rstrip("%")) for out in (jax_out, port_out)]
    assert drift[0] > 0.01, "nothing was quantized"
    assert abs(drift[1] - drift[0]) <= 2e-3, drift  # printed to 3 decimals, in %
    from dquartic_tpu_torch.train.checkpoint import load_checkpoint

    q = load_checkpoint(str(tmp / "q_port.ckpt"))["qparams"]
    assert any(k.endswith("::q_values") and v.dtype == torch.int8 for k, v in q.items())


def test_predict_and_plot_matches_jax(run, monkeypatch, capsys):
    """The same metrics keys and panel files as the JAX script; window 0's
    pair and, given JAX's noise, its prediction as the JAX sampler's."""
    tmp, config, ckpt, state = run
    _run_jax("predict_and_plot", [config, ckpt, str(tmp / "pp_jax"), "--num-steps",
                                  str(STEPS)], monkeypatch, capsys)
    out = _run_port("predict_and_plot", [config, ckpt, str(tmp / "pp_port"), "--num-steps",
                                         str(STEPS), "--device", "cpu"], capsys)
    assert "window 1: reconstruction cosine vs target" in out
    assert sorted(os.listdir(tmp / "pp_port")) == sorted(os.listdir(tmp / "pp_jax"))
    jm, pm = (json.loads((tmp / d / "metrics.json").read_text()) for d in ("pp_jax", "pp_port"))
    assert [sorted(r) for r in pm] == [sorted(r) for r in jm]
    assert [r["window"] for r in pm] == [0, 1]

    from dquartic_tpu.data import DIAMSDataset as JaxDataset
    from dquartic_tpu_torch.data import DIAMSDataset

    ex = _example("predict_and_plot_torch")
    cfg = load_train_config(config)
    jpair = JaxDataset(ms2_file=cfg["data"]["ms2_data_path"],
                       ms1_file=cfg["data"]["ms1_data_path"]).sample_pair()
    pair = DIAMSDataset(ms2_file=cfg["data"]["ms2_data_path"],
                        ms1_file=cfg["data"]["ms1_data_path"]).sample_pair()
    for a, b in zip(pair, jpair):
        np.testing.assert_array_equal(a, b)
    ms2_1, ms1_1, ms2_2, _ = jpair
    noise = np.array(jax.random.normal(jax.random.PRNGKey(0), (1, *ms2_1.shape)))
    mixture = 0.5 * ms2_1 + 0.5 * ms2_2
    jmodel = JaxUNet1d(**{**UNET, "dim_mults": tuple(UNET["dim_mults"])})
    jproc = JaxDDIMProcess(schedule=jax_make_schedule(10, "cosine", "eps"))
    jpred, jnoise = JaxDDIMSampler(jmodel, jproc).sample(
        state.ema_params, noise, mixture[None], ms1_1[None], num_steps=STEPS)
    sampler = ex.build_sampler(cfg, ckpt, torch.device("cpu"))
    got_mix, pred, pred_noise = ex.deconvolve(sampler, ms2_1, ms1_1, ms2_2,
                                              torch.from_numpy(noise), STEPS)
    np.testing.assert_array_equal(got_mix, mixture)
    np.testing.assert_allclose(pred, np.asarray(jpred[0]), rtol=SAMPLER_TOL, atol=SAMPLER_TOL)
    np.testing.assert_allclose(pred_noise, np.asarray(jnoise[0]), rtol=SAMPLER_TOL,
                               atol=SAMPLER_TOL)


def test_multichip_two_ranks_match_one_process(run):
    """Two gloo ranks under ``torch.distributed.run``, one window each, in
    the shipping config: rank 0's npz holds the records of a one-process
    ``predict`` of the same global batches."""
    from dquartic_tpu_torch.infer import DDIMSampler
    from dquartic_tpu_torch.utils.builder import build_dataset, build_model, build_process

    tmp, config, ckpt, _ = run
    out = tmp / "mc.npz"
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         str(EXAMPLES / "multichip_deconvolution_torch.py"),
         "--device", "cpu", "--num-steps", str(STEPS), "--num-batches", "2", config, ckpt,
         str(out)], capture_output=True, text=True, env=env, timeout=240, cwd=str(tmp))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "deconvolved on 2 card(s)" in proc.stdout

    ex = _example("multichip_deconvolution_torch")
    cfg = ex.shipping_config(load_train_config(config), 2)
    cfg["tpu"]["mesh"] = {"dp": 1, "sp": 1, "tp": 1}  # one process, the global batch of 2
    params = _example("predict_and_plot_torch").load_params(ckpt)
    model = build_model(cfg, device="cpu", state_dict=params)
    dataset = build_dataset(cfg, seed=0, device="cpu")
    sampler = DDIMSampler(model, build_process(cfg))
    ref = []
    for i, batch in enumerate(dataset):
        if i == 2:
            break
        ref.extend(sampler.predict([batch], num_steps=STEPS, seed=0, device="cpu"))
    got = np.load(out)
    assert sorted(got.files) == sorted(f"{k}_{i}" for i in range(2) for k in ref[0])
    for i, rec in enumerate(ref):
        for k, v in rec.items():
            assert got[f"{k}_{i}"].shape == v.shape == ((2, RT, MZ) if k != "ms1_1" else (2, RT))
            if k in ("ms2_1", "ms1_1", "mixture"):
                np.testing.assert_array_equal(got[f"{k}_{i}"], v)
            else:
                # a row alone against it in a batch of two: float32 roundings, amplified
                # by 1/sqrt(alpha_bar) at the first of 3 steps of a 10-step schedule
                np.testing.assert_allclose(got[f"{k}_{i}"], v, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("backend", ["npy", "parquet"])
def test_explore_dataset_matches_jax(run, tmp_path, monkeypatch, capsys, backend):
    tmp, config, _, _ = run
    if backend == "npy":
        source = ["--npy", str(tmp / "ms2.npy"), str(tmp / "ms1.npy")]
    else:
        from test_dataset import _write_parquet

        (tmp_path / "pq").mkdir()
        _write_parquet(tmp_path / "pq", n=9)
        source = ["--parquet", str(tmp_path / "pq")]
    jax_out = _run_jax("explore_dataset", [*source, "--plots", str(tmp_path / "jax"),
                                           "--pairs", "2"], monkeypatch, capsys)
    port_out = _run_port("explore_dataset", [*source, "--plots", str(tmp_path / "port"),
                                             "--pairs", "2", "--device", "cpu"], capsys)
    jl, pl = jax_out.splitlines(), port_out.splitlines()
    assert pl[:-1] == jl[:-1] and len(pl) == len(jl) >= 6
    assert f"dataset: {9 if backend == 'parquet' else N} samples ({backend} backend)" in pl
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) == [
        "mixture_0.png", "mixture_1.png"]


def test_inspect_sqmass_matches_jax(sqmass_file, monkeypatch, capsys):  # noqa: F811
    jax_out = _run_jax("inspect_sqmass", [sqmass_file], monkeypatch, capsys)
    port_out = _run_port("inspect_sqmass", [sqmass_file, "--device", "cpu"], capsys)
    assert port_out == jax_out
    assert "isolation windows: 1" in port_out and "MS2: 6 spectra, 300 points" in port_out


@pytest.mark.parametrize("name", ["predict_and_plot", "quantize_checkpoint",
                                  "multichip_deconvolution", "explore_dataset",
                                  "inspect_sqmass"])
def test_examples_refuse_without_a_card(run, tmp_path, monkeypatch, capsys, name):
    """Without a card and without ``--device`` each example exits with
    ``resolve_device``'s message and writes nothing."""
    tmp, config, ckpt, _ = run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out"
    argv = {"predict_and_plot": [config, ckpt, str(out)],
            "quantize_checkpoint": [config, ckpt, str(out)],
            "multichip_deconvolution": [config, ckpt, str(out)],
            "explore_dataset": ["--npy", str(tmp / "ms2.npy"), str(tmp / "ms1.npy"),
                                "--plots", str(out)],
            "inspect_sqmass": [str(tmp / "none.sqMass")]}[name]
    with pytest.raises(SystemExit) as exit_:
        _example(f"{name}_torch").main(argv)
    assert f"{name}_torch: no CUDA device" in str(exit_.value.code)
    assert not out.exists() and not (tmp / "none.sqMass").exists()
