"""``build_trainer``'s handling of the config's checkpoint backend and metrics
log, against the JAX package's builder and logger.

The JAX ``Trainer`` takes ``tpu.checkpoint_backend`` ``"msgpack"`` or
``"orbax"`` and raises for any other value; the port takes the same two
names (``"orbax"`` selects its async sharded backend, the port's own
format) and raises alike. The JAX ``build_trainer`` always builds a
logger (``make_logger``): wandb where configured and installed, else
``<checkpoint dir>/metrics.jsonl``; the port builds the same one from
its own copy of the logging module.
"""

import json

import numpy as np
import pytest
import torch

from dquartic_tpu.utils import logging as jax_logging
from dquartic_tpu_torch.utils import logging as port_logging
from dquartic_tpu_torch.utils.builder import build_logger, build_trainer
from dquartic_tpu_torch.utils.config import load_train_config

# the keys of the epoch record the JAX Trainer logs (trainer.py, Trainer.train)
EPOCH_KEYS = {"epoch", "train/loss", "learning_rate", "epoch_seconds", "steps_per_second"}
RT, MZ = 34, 64


def _config(tmp_path=None, **tpu):
    cfg = load_train_config("dquartic_train_config.json")
    cfg["model"]["UNet1d"].update(dim_mults=[1, 2], downsample_dim=MZ)
    cfg["tpu"].update(fused_resnet=True, **tpu)
    cfg["wandb"]["use_wandb"] = False
    if tmp_path is not None:
        cfg["model"]["checkpoint_path"] = str(tmp_path / "run" / "best_model.ckpt")
    return cfg


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"ms2_1": rng.uniform(0, 1, (1, RT, MZ)).astype(np.float32),
            "ms1_1": rng.uniform(0, 1, (1, RT)).astype(np.float32),
            "ms2_2": rng.uniform(0, 1, (1, RT, MZ)).astype(np.float32)}


@pytest.mark.parametrize("backend,match", [
    ("Orbax", "Unknown checkpoint_backend"), ("msgpak", "Unknown checkpoint_backend"),
])
def test_config_checkpoint_backend_other_than_msgpack_raises(backend, match):
    """An unknown name raises, as in the JAX ``Trainer`` (which compares
    the exact string: ``"Orbax"`` is unknown there too)."""
    with pytest.raises(ValueError, match=match):
        build_trainer(_config(checkpoint_backend=backend), device="cpu")


def test_config_checkpoint_backend_orbax_builds_the_async_backend():
    from dquartic_tpu_torch.train.async_ckpt import AsyncCheckpointBackend

    tr = build_trainer(_config(checkpoint_backend="orbax"), device="cpu", seed=1)
    assert tr.checkpoint_backend == "orbax"
    assert isinstance(tr._async, AsyncCheckpointBackend)


def test_config_checkpoint_backend_msgpack_builds():
    tr = build_trainer(_config(checkpoint_backend="msgpack"), device="cpu", seed=1)
    assert tr.num_parameters() > 0


def test_build_trainer_writes_the_metrics_log(tmp_path):
    """Without a logger, build_trainer logs to ``<dirname(checkpoint_path)>/
    metrics.jsonl`` (wandb off in the config), one record per epoch with
    the JAX Trainer's keys."""
    cfg = _config(tmp_path)
    tr = build_trainer(cfg, device="cpu", seed=2)
    assert isinstance(tr.logger, port_logging.JsonlLogger)
    tr.train([_batch(3), _batch(4)], epochs=1, warmup_epochs=0, learning_rate=1e-3,
             checkpoint_path=cfg["model"]["checkpoint_path"])
    tr.logger.finish()
    lines = (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()
    (rec,) = [json.loads(line) for line in lines]
    assert set(rec) == EPOCH_KEYS | {"_time"}
    assert rec["epoch"] == 0 and np.isfinite(rec["train/loss"]) and rec["steps_per_second"] > 0


def test_build_logger_logs_on_sp_rank_zero_only(tmp_path):
    """Only mesh rank 0 logs: sp rank 1, and dp or tp rank 1 of sp rank 0,
    get a no-op logger."""
    from dquartic_tpu_torch.parallel import Mesh

    cfg = _config(tmp_path)
    assert isinstance(build_logger(cfg, Mesh(sp=2, rank=0)), port_logging.JsonlLogger)
    assert isinstance(build_logger(cfg, Mesh(sp=2, rank=1)), port_logging.NoOpLogger)
    assert not build_logger(cfg, Mesh(sp=2, rank=1)).enabled
    for mesh in (Mesh(dp=2, rank=1), Mesh(tp=2, rank=1), Mesh(dp=2, sp=2, tp=2, rank=4)):
        assert mesh.sp_rank == 0
        assert isinstance(build_logger(cfg, mesh), port_logging.NoOpLogger)


@pytest.mark.parametrize("run_name", [None, "run-a"])
def test_jsonl_logger_writes_what_the_jax_logger_writes(tmp_path, run_name):
    """The same dict gives the same record from both packages' loggers,
    apart from ``_time`` (seconds since the logger was made)."""
    metrics = {"epoch": 3, "train/loss": np.float32(0.25), "learning_rate": 1e-4,
               "steps_per_second": torch.tensor(2.5), "note": "text", "shape": [1, 2]}
    recs = []
    for mod, d in ((port_logging, "port"), (jax_logging, "jax")):
        lg = mod.make_logger(use_wandb=False, log_dir=str(tmp_path / d), run_name=run_name)
        lg.log(metrics)
        lg.log_table("t", ["a"], [[1]])
        lg.finish()
        lines = [json.loads(s) for s in (tmp_path / d / "metrics.jsonl").read_text().splitlines()]
        lines[0].pop("_time")
        recs.append(lines)
    assert recs[0] == recs[1]
    assert recs[0][0]["train/loss"] == 0.25 and recs[0][0]["note"] == "text"


@pytest.mark.parametrize("sp,tp", [(1, 1), (2, 1), (4, 1), (1, 2), (2, 2)])
@pytest.mark.parametrize("batch_size", [None, 1, 2, 3, 6, 8])
def test_build_mesh_dp_rule_matches_jax(monkeypatch, sp, tp, batch_size):
    """A None ``tpu.mesh.dp`` takes the largest degree, up to the processes
    that sp·tp leave, that divides the batch (all of them without a batch
    size), as the JAX ``build_mesh`` does over its devices. Both packages
    see 8: the JAX tests' virtual CPU devices, and 8 processes here (the
    port's world size, patched; ``make_mesh`` patched to return the axes
    it is given, which needs no process group)."""
    import dquartic_tpu_torch.utils.builder as port_builder
    from dquartic_tpu.utils.builder import build_mesh as jax_build_mesh

    cfg = _config()
    cfg["tpu"]["mesh"] = {"dp": None, "sp": sp, "tp": tp}
    monkeypatch.setattr(port_builder.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(port_builder.dist, "get_world_size", lambda group=None: 8)
    monkeypatch.setattr(port_builder, "make_mesh", lambda dp, sp, tp: (dp, sp, tp))
    ref = jax_build_mesh(cfg, batch_size=batch_size)
    got = port_builder.build_mesh(cfg, batch_size=batch_size)
    want = None if ref is None else (ref.shape["dp"], dict(ref.shape).get("sp", 1), ref.shape["tp"])
    assert got == want


def test_build_mesh_leaves_idle_processes_out(monkeypatch):
    """Two processes at sp 1 and batch 1: dp 1, one device, no mesh (the
    rule before took dp 2); at batch 2 both processes take a dp of 2
    (``make_mesh`` patched to return the axes it is given)."""
    import dquartic_tpu_torch.utils.builder as port_builder

    monkeypatch.setattr(port_builder.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(port_builder.dist, "get_world_size", lambda group=None: 2)
    assert port_builder.build_mesh(_config(), batch_size=1) is None
    monkeypatch.setattr(port_builder, "make_mesh", lambda dp, sp, tp: (dp, sp, tp))
    assert port_builder.build_mesh(_config(), batch_size=2) == (2, 1, 1)


@pytest.mark.parametrize("simple", [True, False])
def test_seeded_unet_weights_are_drawn_as_jax_draws_them(simple):
    """``build_model``'s seeded UNet1d draws each kernel as the JAX
    UNet1d's ``init`` does, from flax's ``lecun_normal``: a normal
    truncated at two standard deviations, its standard deviation
    sqrt(1 / fan_in); gains 1 and biases 0. Per kernel, |w|·sqrt(fan_in)
    stays within 2 / 0.8796 = 2.2737 on both sides (an untruncated normal
    reaches 3-5 at these sizes), and the standard deviation of a kernel of
    4096 or more weights is within 5 % of JAX's."""
    import jax

    from dquartic_tpu.utils.builder import build_model as jax_build_model
    from dquartic_tpu_torch.compat.jax_params import jax_params_to_torch
    from dquartic_tpu_torch.utils.builder import build_model

    cfg = _config()
    cfg["model"]["UNet1d"].update(downsample_dim=256, simple=simple, tfer_depth=1)
    cfg["tpu"]["fused_resnet"] = simple
    rt, mz = 4, 256
    x = np.zeros((1, rt, mz), np.float32)
    jparams = jax_build_model(cfg).init(jax.random.PRNGKey(0), x, np.zeros((1,), np.int32), x,
                                        np.zeros((1, rt), np.float32))
    ref = jax_params_to_torch(jparams, cfg["model"]["UNet1d"]["dim_mults"])
    port = build_model(cfg, device="cpu", seed=0, trainable=True).state_dict()
    assert set(port) == set(ref)
    bound = 2 / 0.87962566103423978 + 1e-4
    kernels = 0
    for name, t in port.items():
        w, r = t.double().numpy(), np.asarray(ref[name], np.float64)
        if name.endswith(".g"):
            assert (w == 1).all() and (r == 1).all(), name
        elif name.endswith(("bias", ".b")):
            assert (w == 0).all() and (r == 0).all(), name
        else:
            fan_in = w[0].size
            assert np.abs(w).max() * fan_in ** 0.5 <= bound, name
            assert np.abs(r).max() * fan_in ** 0.5 <= bound, name
            if w.size >= 4096:
                kernels += 1
                assert abs(w.std() / r.std() - 1) < 0.05, name
    assert kernels >= 4
