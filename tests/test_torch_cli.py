"""The port's command line (click runner, ``--device cpu``) against the
JAX package's: ``generate-config``, ``train`` with its checkpoints, metrics
and resume, ``predict`` to npz and parquet (read back by the JAX package),
``predict`` from a checkpoint the JAX package wrote, ``convert-checkpoint``,
the prediction panels of ``tpu.log_predictions``, and the refusal to run
without a card unless ``--device`` names one."""

import json
import os

import jax
import numpy as np
import pytest
import torch
from click.testing import CliRunner

from dquartic_tpu.cli import cli as jax_cli
from dquartic_tpu.core import DDIMProcess as JaxDDIMProcess
from dquartic_tpu.core import make_schedule as jax_make_schedule
from dquartic_tpu.infer.sampler import load_predictions_parquet as jax_load_predictions
from dquartic_tpu.models import UNet1d as JaxUNet1d
from dquartic_tpu.train import Trainer as JaxTrainer
from dquartic_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from dquartic_tpu_torch.cli import cli
from dquartic_tpu_torch.infer import load_predictions_parquet
from dquartic_tpu_torch.models import UNet1d
from dquartic_tpu_torch.train import latest_path_for, load_checkpoint
from dquartic_tpu_torch.utils.config import load_train_config
from test_torch_model import random_params

RT, MZ, N = 4, 16, 6
UNET = dict(dim=4, channels=1, dim_mults=[1, 2], conditional=True, init_cond_channels=1,
            attn_cond_channels=1, tfer_dim_mult=620, downsample_dim=MZ, simple=True)


def _write_config(tmp_path, **tpu):
    cfg = {
        "data": {"parquet_directory": None, "ms2_data_path": str(tmp_path / "ms2.npy"),
                 "ms1_data_path": str(tmp_path / "ms1.npy"), "normalize": "minmax"},
        "model": {"checkpoint_path": str(tmp_path / "ckpt" / "best_model.ckpt"),
                  "num_epochs": 2, "warmup_epochs": 1, "batch_size": 2, "learning_rate": 1e-3,
                  "num_timesteps": 10, "beta_schedule_type": "cosine", "pred_type": "eps",
                  "auto_normalize": True, "ms1_loss_weight": 0.0, "use_model": "UNet1d",
                  "UNet1d": dict(UNET)},
        "wandb": {"use_wandb": False},
        "threads": 1,
        "tpu": {"log_every_n_epochs": 1000, "fused_resnet": True, **tpu},
    }
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    return str(path)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """An NPY dataset of 6 windows and the tiny config (3 batches of 2)."""
    tmp_path = tmp_path_factory.mktemp("torch_cli")
    rng = np.random.default_rng(0)
    np.save(tmp_path / "ms2.npy", rng.uniform(0, 10, (N, RT, MZ)).astype(np.float32))
    np.save(tmp_path / "ms1.npy", rng.uniform(0, 5, (N, RT)).astype(np.float32))
    return tmp_path, _write_config(tmp_path)


def _invoke(args):
    res = CliRunner().invoke(cli, args)
    assert res.exit_code == 0, (res.output, res.exception)
    return res


def test_generate_config_writes_what_jax_writes(tmp_path):
    _invoke(["generate-config", str(tmp_path / "port.json")])
    assert CliRunner().invoke(jax_cli, ["generate-config", str(tmp_path / "jax.json")]).exit_code == 0
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    assert load_train_config(str(tmp_path / "port.json"))["model"]["use_model"] == "UNet1d"


def test_train_checkpoints_metrics_and_resume(run):
    tmp_path, config = run
    _invoke(["train", "--device", "cpu", config])
    best = tmp_path / "ckpt" / "best_model.ckpt"
    latest = latest_path_for(str(best))
    assert best.exists()
    ck = load_checkpoint(latest)
    assert (ck["epoch"], ck["step"]) == (1, 2 * (N // 2))
    records = [json.loads(line) for line in (tmp_path / "ckpt" / "metrics.jsonl").open()]
    assert [r["epoch"] for r in records] == [0, 1]

    cfg = json.loads(open(config).read())
    cfg["model"]["num_epochs"] = 3
    longer = tmp_path / "config3.json"
    longer.write_text(json.dumps(cfg))
    res = _invoke(["train", "--device", "cpu", str(longer)])
    assert "Resumed from" in res.output
    ck = load_checkpoint(latest)
    assert (ck["epoch"], ck["step"]) == (2, 3 * (N // 2))
    records = [json.loads(line) for line in (tmp_path / "ckpt" / "metrics.jsonl").open()]
    assert [r["epoch"] for r in records] == [0, 1, 2]


def test_predict_npz_and_parquet(run):
    """From the run's checkpoint (trained by the test above, else by this
    one): npz and parquet of two batches, the same seed, the same arrays;
    the parquet reads back through the JAX package's reader."""
    tmp_path, config = run
    latest = latest_path_for(str(tmp_path / "ckpt" / "best_model.ckpt"))
    if load_checkpoint(latest) is None:
        _invoke(["train", "--device", "cpu", config])
    common = ["predict", "--num-steps", "3", "--num-batches", "2", "--device", "cpu",
              "--quantize-mid", "--use-ema"]
    _invoke(common + [config, latest, str(tmp_path / "p.npz")])
    _invoke(common + [config, latest, str(tmp_path / "p.parquet")])
    npz = np.load(tmp_path / "p.npz")
    assert sorted(npz.files) == sorted(f"{k}_{i}" for i in range(2) for k in
                                       ("ms2_1", "ms1_1", "mixture", "pred", "pred_noise"))
    jax_recs = jax_load_predictions(str(tmp_path / "p.parquet"))
    port_recs = load_predictions_parquet(str(tmp_path / "p.parquet"))
    assert len(jax_recs) == len(port_recs) == 2
    for i, (a, b) in enumerate(zip(jax_recs, port_recs)):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            np.testing.assert_array_equal(a[k], npz[f"{k}_{i}"])
    assert npz["pred_0"].shape == (2, RT, MZ) and np.isfinite(npz["pred_0"]).all()


def test_predict_from_a_jax_checkpoint(run, tmp_path):
    """A checkpoint the JAX package wrote (its Trainer's state, random
    weights) serves through the port's predict."""
    _, config = run
    jtr = JaxTrainer(JaxUNet1d(**{**UNET, "dim_mults": tuple(UNET["dim_mults"])}),
                     JaxDDIMProcess(schedule=jax_make_schedule(10, "cosine", "eps")))
    batch = {"ms2_1": np.zeros((1, RT, MZ), np.float32), "ms1_1": np.zeros((1, RT), np.float32)}
    state = jtr.init_state(batch)
    state = state.replace(params=random_params(jax.eval_shape(lambda: state.params), seed=3))
    path = tmp_path / "jax.ckpt"
    jax_save_checkpoint(str(path), {"epoch": np.int64(0), "best_loss": np.float64(1.0),
                                    "state": state})
    _invoke(["predict", "--num-steps", "2", "--num-batches", "1", "--device", "cpu",
             "--no-use-ema", config, str(path), str(tmp_path / "p.npz")])
    pred = np.load(tmp_path / "p.npz")["pred_0"]
    assert pred.shape == (2, RT, MZ) and np.isfinite(pred).all()


def test_convert_checkpoint_command(run, tmp_path):
    _, config = run
    torch.manual_seed(0)
    sd = UNet1d(**{**UNET, "dim_mults": tuple(UNET["dim_mults"])}).state_dict()
    torch.save({"model_state_dict": sd, "epoch": 2, "best_loss": 0.5}, tmp_path / "ref.ckpt")
    _invoke(["convert-checkpoint", str(tmp_path / "ref.ckpt"), str(tmp_path / "out.ckpt"),
             config])
    ck = load_checkpoint(str(tmp_path / "out.ckpt"))
    assert (ck["epoch"], ck["best_loss"], ck["step"]) == (2, 0.5, 0)
    assert all(torch.equal(ck["params"][k], sd[k]) for k in sd)


@pytest.mark.parametrize("command", ["train", "predict"])
def test_no_card_without_device(run, monkeypatch, command):
    """train and predict run on the card: without one, and without
    --device, they fail with resolve_device's message."""
    tmp_path, config = run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [command, config]
    if command == "predict":
        ref = tmp_path / "ref_for_device.ckpt"
        torch.save({"params": {}}, ref)
        args = [command, config, str(ref), str(tmp_path / "never.npz")]
    res = CliRunner().invoke(cli, args)
    assert res.exit_code != 0
    assert f"{command}: no CUDA device" in res.output
    assert not (tmp_path / "never.npz").exists()


def test_log_predictions_writes_panels(tmp_path):
    """``tpu.log_predictions``: after each logged epoch (every one at
    ``log_every_n_epochs`` 1) ``train`` writes the six panels of each step
    count of ``prediction_num_steps`` beside the checkpoints and logs the
    cosines and the ``predictions_table`` to ``metrics.jsonl``, as the JAX
    ``train`` does."""
    rng = np.random.default_rng(2)
    np.save(tmp_path / "ms2.npy", rng.uniform(0, 10, (N, RT, MZ)).astype(np.float32))
    np.save(tmp_path / "ms1.npy", rng.uniform(0, 5, (N, RT)).astype(np.float32))
    config = _write_config(tmp_path, log_predictions=True, log_every_n_epochs=1,
                           prediction_num_steps=[2, 3])
    _invoke(["train", "--device", "cpu", config])
    records = [json.loads(line) for line in (tmp_path / "ckpt" / "metrics.jsonl").open()]
    tables = [r for r in records if r.get("_table") == "predictions_table"]
    assert len(tables) == 2
    paths = set()
    for table in tables:
        assert table["columns"][:4] == ["Num Steps", "Epoch", "Loss", "Reconstruction Cosine"]
        assert [row[0] for row in table["rows"]] == [2, 3]
        for row in table["rows"]:
            assert len(row) == 10 and -1.0 <= row[3] <= 1.0
            assert all(p.endswith(".png") and os.path.dirname(p) == str(tmp_path / "ckpt")
                       for p in row[4:])
            paths.update(row[4:])
    assert paths == {str(p) for p in (tmp_path / "ckpt").glob("*.png")}
    assert len(paths) == 6 * 2 * len({row[1] for t in tables for row in t["rows"]})
    cosines = [k for r in records for k in r if k.startswith("predictions/cosine_")]
    assert cosines == ["predictions/cosine_2steps", "predictions/cosine_3steps"] * 2
