"""Data and tensor parallelism of the port on its paths: every model family
through DDP and tp, the sampler (float and int8), checkpoints moved across
tp sizes through the training loop, and per-process feeding, each against
one process. The ranks, helpers and tolerances are those of
tests/test_torch_parallel.py (a pool of its own here, four gloo ranks on
the CPU; the rank processes import no JAX), and build_trainer on each
mesh of up to four ranks."""

import os

import numpy as np
import pytest
import torch

from dquartic_tpu_torch.infer import DDIMSampler
from dquartic_tpu_torch.models import UNet1d
from dquartic_tpu_torch.models.transformer import CustomTransformer
from dquartic_tpu_torch.parallel import Mesh, full_state_dict, local_rows
from dquartic_tpu_torch.train import Trainer, make_optimizer
from dquartic_tpu_torch.train.optim import WarmupCosineSchedule
from dquartic_tpu_torch.utils.builder import build_dataset, build_model, build_trainer, init_weights
from test_torch_parallel import (
    CT, LR, MIN, MZ, RT, TINY, _batch, _np, _process, _Ranks, _scaled, _small_config, _t,
)


# the meshes of this module's ranks (at most four)
BUILT = [(2, 1, 1), (1, 1, 2), (2, 1, 2), (2, 2, 1)]


@pytest.fixture(scope="module")
def ranks():
    pool = _Ranks(__name__, BUILT)
    yield pool
    pool.close()


# --------------------------------------------------------------------- #
# every family under DDP and tp: two steps against one process          #
# --------------------------------------------------------------------- #


FAMILIES = {
    "unet_fused": dict(),
    "unet_tfer": dict(simple=False, tfer_depth=2),
    "unet_uncond": dict(conditional=False),
    "ct": None,
}


def _family_model(family, seed):
    torch.manual_seed(0)
    if family == "ct":
        model = CustomTransformer(**CT)
        model.init_weights(torch.Generator().manual_seed(seed))
    else:
        model = UNet1d(**{**TINY, **FAMILIES[family]}, fused_resnet=True)
        init_weights(model, torch.Generator().manual_seed(seed))
    return model


# Adam's first update is about lr·sign(g), so a gradient near zero whose
# sign the summation order flips moves its parameter by 2·lr; at this lr
# the second step's loss and norm move by far less than rtol 1e-5 for it.
FAMILY_LR = 1e-6


def _two_steps(mesh, family, batches):
    model = _family_model(family, 3)
    tr = Trainer(model, _process(), mesh=mesh, tp_min_features=MIN)
    gen = torch.Generator().manual_seed(9)
    out = []
    for b in batches:
        m = tr.train_step(local_rows({k: _t(v) for k, v in b.items()}, mesh), FAMILY_LR,
                          generator=gen)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out, _np(full_state_dict(model)), _opt_flat(tr.optimizer.state_dict(whole="cpu"))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_every_family_takes_two_steps_on_dp_and_tp(ranks, family):
    """Two steps at (dp, tp) = (2, 2), the draws from one seeded generator,
    against one process: DDP's reducer sees a gradient for every parameter
    (a parameter without one raises at the second step), and the losses,
    norms, parameters and Adam's moments (gathered whole; within 1e-4 of
    each one's largest magnitude, which atol 2·lr cannot see) agree."""
    batches = [_batch(2, 21), _batch(2, 22)]
    out = ranks.run("_two_steps", (2, 1, 2), family, batches)
    ref, ref_sd, ref_opt = _two_steps(None, family, batches)
    for metrics, sd, opt in out:
        np.testing.assert_allclose(metrics, ref, rtol=1e-5)
        for k, v in ref_sd.items():
            np.testing.assert_allclose(sd[k], v, rtol=1e-5, atol=2 * FAMILY_LR, err_msg=k)
        _moments_agree(opt, ref_opt, family)


def _built_step(mesh, batch):
    config = _small_config()
    if mesh is not None:
        config["tpu"]["mesh"] = mesh.shape
    tr = build_trainer(config, device="cpu", seed=5, mesh=mesh)
    m = tr.train_step(local_rows({k: _t(v) for k, v in batch.items()}, mesh), LR,
                      generator=torch.Generator().manual_seed(3))
    return float(m["loss"]), float(m["grad_norm"]), tr.model.kernel_dp_axis, \
        tr.model.activation_sharding


@pytest.mark.parametrize("shape", BUILT)
def test_build_trainer_takes_every_mesh(ranks, shape):
    """build_trainer on each mesh (the builder's flags: kernel_dp_axis on a
    dp mesh without sp, activation_sharding with sp) takes the
    one-process step's loss and gradient norm from the same seed and
    generator."""
    batch = _batch(2, 51)
    ref = _built_step(None, batch)
    dp, sp, _ = shape
    for loss, norm, dp_axis, sharding in ranks.run("_built_step", shape, batch):
        np.testing.assert_allclose((loss, norm), ref[:2], rtol=1e-5)
        assert dp_axis == ("dp" if dp > 1 and sp == 1 else None)
        assert sharding == (("dp", "sp") if sp > 1 else None)


# --------------------------------------------------------------------- #
# the sampler                                                           #
# --------------------------------------------------------------------- #


def _predict(mesh, quantize, batch):
    config = _small_config()
    config["tpu"]["quantize_mid"] = quantize
    model = build_model(config, device="cpu", seed=5, mesh=mesh, tp_min_features=MIN)
    sampler = DDIMSampler(model, _process(), mesh=mesh)
    rec = sampler.predict([local_rows(batch, mesh)], num_steps=3, seed=7, device="cpu")[0]
    g = torch.Generator().manual_seed(2)
    x_t = torch.randn((2, RT, MZ), generator=g)
    ms2 = _t(batch["ms2_1"]) * 0.5 + _t(batch["ms2_2"]) * 0.5
    x0, _ = sampler.sample(*local_rows((x_t, ms2, _t(batch["ms1_1"])), mesh), num_steps=3)
    return rec, x0.numpy()


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("shape", [(2, 1, 1), (1, 1, 2)])
def test_predict_and_sample_match_one_process(ranks, shape, quantize):
    """predict over dp = 2 (each rank fed its row) and tp = 2 (the wide
    leaves split, the int8 mid convs on their column shards) returns on
    every rank the records of one process on the global batch; ``sample``
    returns the rank's rows of it."""
    batch = _batch(2, 31)
    out = ranks.run("_predict", shape, quantize, batch)
    ref, ref_x0 = _predict(None, quantize, batch)
    for r, (rec, x0) in enumerate(out):
        for k, v in ref.items():
            np.testing.assert_allclose(rec[k], v, rtol=1e-5, atol=1e-6, err_msg=k)
        rows = local_rows(ref_x0, Mesh(dp=shape[0], rank=r * (shape[0] > 1)))
        np.testing.assert_allclose(x0, rows, rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------- #
# checkpoints across tp sizes                                           #
# --------------------------------------------------------------------- #


class _Epochs:
    """A dataset of one batch an epoch, the same every epoch."""

    def __init__(self, batch):
        self.batch = batch

    def __len__(self):
        return 1

    def __iter__(self):
        yield {k: _t(v) for k, v in self.batch.items()}


def _train(mesh, kind, path, epochs, batch):
    model = _family_model("unet_fused", 4)
    tr = Trainer(model, _process(), optimizer=make_optimizer(model.parameters(), kind=kind),
                 mesh=mesh, tp_min_features=MIN)
    tr.train(_Epochs(batch), epochs=epochs, warmup_epochs=1, learning_rate=LR,
             checkpoint_path=path)
    return _np(full_state_dict(model)), tr.step


def _step_from(ckpt, kind, batch):
    """The reference of a one-process resume of ``ckpt`` (a latest file of
    epoch 0) to epoch 1: the state loaded by hand into a model of another
    seed, then the step with the learning rate and draws ``train`` gives
    epoch 1 of 2. Its parameters and optimizer state by position."""
    model = _family_model("unet_fused", 5)
    tr = Trainer(model, _process(), optimizer=make_optimizer(model.parameters(), kind=kind),
                 tp_min_features=MIN)
    model.load_state_dict(ckpt["params"])
    tr.optimizer.load_state_dict(ckpt["opt_state"], tr.param_names)
    tr.step = int(ckpt["step"])
    lr = float(np.float32(WarmupCosineSchedule.clamped(LR, 1, 2)(1)))
    tr.train_step({k: _t(v) for k, v in batch.items()}, lr,
                  generator=torch.Generator().manual_seed(tr.seed * 1_000_003 + 1))
    return _np(full_state_dict(model)), _opt_flat(tr.optimizer.state_dict())


def _latest(directory):
    return torch.load(os.path.join(directory, "dquartic_latest_checkpoint.ckpt"),
                      weights_only=True)


@pytest.mark.parametrize("kind", ["adamw", "factored"])
def test_checkpoints_move_between_tp_sizes(ranks, tmp_path, kind):
    """A run checkpointed at tp = 2 resumes at tp = 1, and one checkpointed
    at tp = 1 resumes at tp = 2; the file holds whole leaves and optimizer
    state (the one a single process writes). Both resumes take the
    parameters of an uninterrupted run's second step, and the tp = 2 one
    its optimizer moments. Adam's and the factored optimizer's first update
    is about lr·sign(g), so the gradients near 0 whose sign the tp = 2
    summation order flips move their parameters by 2·lr at the first step,
    which moves every gradient of the second: the tp = 1 resume of the
    tp = 2 file is therefore held, bitwise, against that file's state
    loaded by hand and stepped (``_step_from``), and the file against the
    one-process file of the same epoch."""
    batch = _batch(1, 41)
    full, steps = _train(None, kind, str(tmp_path / "whole" / "best.ckpt"), 2, batch)
    assert steps == 2
    a, b = str(tmp_path / "a" / "best.ckpt"), str(tmp_path / "b" / "best.ckpt")
    ranks.run("_train", (1, 1, 2), kind, a, 1, batch)
    _train(None, kind, b, 1, batch)
    a1, b1 = _latest(tmp_path / "a"), _latest(tmp_path / "b")
    whole_shapes = {k: tuple(v.shape) for k, v in _family_model("unet_fused", 4).state_dict().items()}
    assert {k: tuple(v.shape) for k, v in a1["params"].items()} == whole_shapes
    assert a1["step"] == b1["step"] == 1
    for k, v in b1["params"].items():
        np.testing.assert_allclose(a1["params"][k], v, rtol=1e-5, atol=2 * LR, err_msg=k)
    _moments_agree(_opt_flat(a1["opt_state"]), _opt_flat(b1["opt_state"]), "tp = 2 file")

    resumed_1, _ = _train(None, kind, a, 2, batch)
    resumed_2 = ranks.run("_train", (1, 1, 2), kind, b, 2, batch)
    for got in [resumed_1] + [r[0] for r in resumed_2]:
        for k, v in full.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=2 * LR, err_msg=k)
    # the optimizer state the resumed runs write, which atol 2·lr cannot see
    ref_params, ref_opt = _step_from(a1, kind, batch)
    for k, v in ref_params.items():
        np.testing.assert_array_equal(resumed_1[k], v, err_msg=k)
    got = _opt_arrays(tmp_path / "a")
    assert got.keys() == ref_opt.keys()
    for k, v in ref_opt.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    _moments_agree(_opt_arrays(tmp_path / "b"), _opt_arrays(tmp_path / "whole"), b)


def _moments_agree(got, want, what):
    """Each optimizer moment within 1e-4 of its largest magnitude; one that
    is zero up to rounding (below 1e-6 of the largest moment of its kind:
    the CustomTransformer's key biases, whose gradient softmax cancels) is
    held below that on both sides."""
    assert got.keys() == want.keys()
    top = {}
    for k, v in want.items():
        kind = k.split()[1]
        top[kind] = max(top.get(kind, 0.0), float(np.abs(v).max()))
    for k, v in want.items():
        floor = 1e-6 * top[k.split()[1]]
        if np.abs(v).max() < floor:
            assert np.abs(got[k]).max() < floor, f"{what} {k}"
        else:
            _scaled(got[k], v, 1e-4, f"{what} {k}")


def _opt_arrays(directory):
    """The optimizer state of a directory's latest checkpoint, by position
    and moment."""
    return _opt_flat(_latest(directory)["opt_state"])


def _opt_flat(st):
    """An optimizer's state_dict by position and moment."""
    if "state" in st:
        return {f"{i} {k}": v.numpy() for i, m in st["state"].items()
                for k, v in m.items() if k != "step"}
    return {f"{i} {k}": v.numpy() for k in ("v_row", "v_col", "v")
            for i, v in enumerate(st[k]) if v is not None}


# --------------------------------------------------------------------- #
# per-process feeding                                                   #
# --------------------------------------------------------------------- #


def test_each_dp_rank_feeds_only_its_rows(tmp_path, monkeypatch):
    """build_dataset on a dp = 2 mesh: each rank's batches are its rows of
    the one-process batches (same RNG, same pairs), and it fetches those
    rows alone; a global batch dp does not divide raises."""
    from dquartic_tpu_torch.data import dataset as pdataset

    rng = np.random.default_rng(0)
    np.save(tmp_path / "ms2.npy", rng.uniform(0, 9, (8, RT, MZ)).astype(np.float32))
    np.save(tmp_path / "ms1.npy", rng.uniform(0, 9, (8, RT)).astype(np.float32))
    config = _small_config()
    config["data"].update(ms2_data_path=str(tmp_path / "ms2.npy"),
                          ms1_data_path=str(tmp_path / "ms1.npy"), parquet_directory=None)
    config["model"]["batch_size"] = 4
    ref = [{k: v.numpy() for k, v in b.items()}
           for b in build_dataset(config, seed=3, device="cpu")]
    fetched = []
    real = pdataset.DIAMSDataset._fetch
    monkeypatch.setattr(pdataset.DIAMSDataset, "_fetch",
                        lambda self, i: fetched.append(i) or real(self, i))
    for d in range(2):
        fetched.clear()
        got = list(build_dataset(config, seed=3, device="cpu", mesh=Mesh(dp=2, tp=2, rank=2 * d)))
        assert len(got) == len(ref) == 2 and len(fetched) == 2 * 2 * 2  # 2 rows x 2 pairs
        for g, r in zip(got, ref):
            for k in r:
                np.testing.assert_array_equal(g[k].numpy(), r[k][2 * d:2 * d + 2], err_msg=k)
    config["model"]["batch_size"] = 3
    with pytest.raises(ValueError, match="global batch rows 3 not divisible by process count 2"):
        build_dataset(config, device="cpu", mesh=Mesh(dp=2))
