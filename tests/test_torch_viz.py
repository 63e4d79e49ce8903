"""The port's prediction panels and prediction-logging hook against the
JAX package's (``dquartic_tpu.utils.viz``), on the CPU.

The renderers are host numpy code shared in substance: the same arrays
give the same files and the same decoded pixels, for every backend (the
plotly ones fall back to matplotlib here, where plotly is not installed),
index and physical axes, 1-D and 2-D MS1. The hook draws the pair the
JAX hook draws from a dataset of the same seed and logs the same keys and
table columns; its noise is torch's (the JAX hook's is JAX's), so its
prediction is held against the port's own sampler on a model loaded from
the trainer's EMA, and the trainer's state against a snapshot, both
bitwise. The CPU's convolution takes another backend (and rounds
otherwise, ~1e-6) for weights that require grad, so the reference model's
parameters require grad where the tensors the hook samples with do: the
trained weights do, the EMA does not.
"""

import json
import os

import jax
import matplotlib.image as mpimg
import matplotlib.pyplot as plt
import numpy as np
import pytest
import torch

import dquartic_tpu.utils.viz as jax_viz
import dquartic_tpu_torch.utils.viz as viz
from dquartic_tpu.core import DDIMProcess as JaxDDIMProcess
from dquartic_tpu.core import make_schedule as jax_make_schedule
from dquartic_tpu.data import DIAMSDataset as JaxDIAMSDataset
from dquartic_tpu.infer import DDIMSampler as JaxDDIMSampler
from dquartic_tpu.models import UNet1d as JaxUNet1d
from dquartic_tpu.train import Trainer as JaxTrainer
from dquartic_tpu.utils.logging import JsonlLogger as JaxJsonlLogger
from dquartic_tpu_torch.compat.jax_params import jax_params_to_torch
from dquartic_tpu_torch.core import DDIMProcess, make_schedule
from dquartic_tpu_torch.data import DIAMSDataset
from dquartic_tpu_torch.infer import DDIMSampler
from dquartic_tpu_torch.models import UNet1d
from dquartic_tpu_torch.train import Trainer
from dquartic_tpu_torch.utils.logging import JsonlLogger
from test_torch_model import random_params

RT, MZ = 4, 16
UNET = dict(dim=4, channels=1, dim_mults=(1, 2), conditional=True, init_cond_channels=1,
            attn_cond_channels=1, downsample_dim=MZ)
STEPS = (2, 3)


def _panels(rng, ms1_2d):
    mesh = [rng.uniform(0, 10, size=(6, 12)).astype(np.float32) for _ in range(5)]
    ms1 = rng.uniform(0, 5, size=(6, 3) if ms1_2d else (6,)).astype(np.float32)
    return mesh[0], mesh[1], mesh[2], ms1, mesh[3], mesh[4]


@pytest.mark.parametrize("backend,physical,ms1_2d", [
    ("matplotlib", False, False), ("matplotlib", True, False), ("matplotlib", True, True),
    ("ms_matplotlib", False, False), ("ms_matplotlib", True, False),
    ("ms_matplotlib", False, True),
    ("plotly", True, False), ("plotly", False, True),
    ("ms_plotly", False, False), ("ms_plotly", True, True),
])
def test_plot_single_prediction_matches_jax(tmp_path, backend, physical, ms1_2d):
    """The same six files, pixel for pixel (matplotlib draws both)."""
    arrays = _panels(np.random.default_rng(1), ms1_2d)
    axes = dict(rt_axis=np.linspace(100.0, 105.0, 6), mz_axis=np.linspace(400.0, 411.0, 12)) \
        if physical else {}
    got = viz.plot_single_prediction(*arrays, out_dir=str(tmp_path / "port"), prefix="p_",
                                     backend=backend, **axes)
    ref = jax_viz.plot_single_prediction(*arrays, out_dir=str(tmp_path / "jax"), prefix="p_",
                                         backend=backend, **axes)
    assert [os.path.relpath(p, tmp_path / "port") for p in got] == \
        [os.path.relpath(p, tmp_path / "jax") for p in ref]
    assert len(got) == 6
    for a, b in zip(got, ref):
        assert a.endswith(".png")  # no plotly here: the matplotlib panels
        np.testing.assert_array_equal(mpimg.imread(a), mpimg.imread(b), err_msg=a)


@pytest.mark.parametrize("plot_3d", [True, False])
def test_peakmap_ms_keeps_the_points_jax_keeps(tmp_path, monkeypatch, plot_3d):
    """The top ``max_points`` cells of the melted mesh, in the same order,
    at the same coordinates and intensities (the figure's collection read
    back before it is closed)."""
    arr = np.random.default_rng(2).uniform(0, 10, size=(6, 40)).astype(np.float32)
    rt, mz = np.linspace(100.0, 105.0, 6), np.linspace(400.0, 420.0, 40)
    figs = []
    close = plt.close
    monkeypatch.setattr(plt, "close", lambda fig=None: (figs.append(fig), close(fig)))

    def points(fig):
        coll = fig.axes[0].collections[0]
        where = np.asarray(coll._segments3d) if plot_3d else np.asarray(coll.get_offsets())
        return where, np.asarray(coll.get_array())

    for mod, name in ((viz, "port"), (jax_viz, "jax")):
        mod._peakmap_ms(arr, "t", str(tmp_path / f"{name}.png"), rt, mz, plot_3d=plot_3d,
                        max_points=50)
    (got, got_z), (ref, ref_z) = (points(fig) for fig in figs)
    assert got.shape[0] == got_z.shape[0] == 50
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got_z, ref_z)


# --------------------------------------------------------------------- #
# the hook                                                              #
# --------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """NPY windows, the JAX model's random weights and its train state."""
    tmp = tmp_path_factory.mktemp("viz_hook")
    rng = np.random.default_rng(0)
    np.save(tmp / "ms2.npy", rng.uniform(0, 10, size=(5, RT, MZ)).astype(np.float32))
    np.save(tmp / "ms1.npy", rng.uniform(0, 5, size=(5, RT)).astype(np.float32))
    files = dict(ms2_file=str(tmp / "ms2.npy"), ms1_file=str(tmp / "ms1.npy"),
                 normalize="minmax")
    jmodel = JaxUNet1d(**UNET)
    jproc = JaxDDIMProcess(schedule=jax_make_schedule(10, "cosine", "eps"))
    jtr = JaxTrainer(jmodel, jproc, seed=0)
    batch = {"ms2_1": np.zeros((1, RT, MZ), np.float32), "ms1_1": np.zeros((1, RT), np.float32),
             "ms2_2": np.zeros((1, RT, MZ), np.float32), "ms1_2": np.zeros((1, RT), np.float32)}
    params = random_params(jax.eval_shape(lambda: jtr.init_params(batch)), seed=5)
    return tmp, files, jmodel, jproc, jtr._fresh_state(params), params


def _port_trainer(params, ema_decay=0.999):
    model = UNet1d(**UNET)
    sd = jax_params_to_torch(params, UNET["dim_mults"])
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    process = DDIMProcess(schedule=make_schedule(10, "cosine", "eps"))
    tr = Trainer(model, process, ema_decay=ema_decay)
    rng = np.random.default_rng(4)
    for _ in range(2):  # the EMA moves away from the trained weights
        tr.train_step({"ms2_1": rng.uniform(0, 1, (1, RT, MZ)).astype(np.float32),
                       "ms1_1": rng.uniform(0, 1, (1, RT)).astype(np.float32),
                       "ms2_2": rng.uniform(0, 1, (1, RT, MZ)).astype(np.float32)}, 1e-2)
    return tr


def _snapshot(tr):
    opt = tr.optimizer.state_dict()
    return ({k: v.clone() for k, v in tr.model.state_dict().items()},
            [e.clone() for e in tr.ema_params] if tr.ema_params is not None else None,
            {k: v.clone() if torch.is_tensor(v) else json.dumps(v, default=str)
             for k, v in _flat_state(opt).items()},
            tr.model.training, tr.step)


def _flat_state(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat_state(v, f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flat_state(v, f"{prefix}/{i}"))
    else:
        out[prefix] = tree
    return out


def _assert_unchanged(tr, snap):
    params, ema, opt, training, step = snap
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, params[k]), k
    if ema is not None:
        assert all(torch.equal(a, b) for a, b in zip(tr.ema_params, ema))
    now = _flat_state(tr.optimizer.state_dict())
    assert now.keys() == opt.keys()
    for k, v in now.items():
        if torch.is_tensor(v):
            assert torch.equal(v, opt[k]), k
        else:
            assert json.dumps(v, default=str) == opt[k], k
    assert tr.model.training == training and tr.step == step


def _records(log_dir):
    return [json.loads(line) for line in open(os.path.join(log_dir, "metrics.jsonl"))]


def _recording(monkeypatch):
    """Record the arrays the port's hook hands to the renderer."""
    seen = []
    draw = viz.plot_single_prediction

    def record(*arrays, **kw):
        seen.append([np.array(a) for a in arrays])
        return draw(*arrays, **kw)

    monkeypatch.setattr(viz, "plot_single_prediction", record)
    return seen


def _reference_pred(tr, state_dict, cond, ms1, epoch, ns, grad=False):
    """DDIMSampler.sample on a second model loaded from ``state_dict``
    (its parameters requiring grad when ``grad``), from the noise the hook
    draws."""
    model = UNet1d(**UNET)
    model.load_state_dict(state_dict)
    model.requires_grad_(grad)
    g = torch.Generator().manual_seed(viz.noise_seed(0, epoch, ns))
    noise = torch.randn((1, RT, MZ), generator=g)
    pred, noise_pred = DDIMSampler(model.eval(), tr.process).sample(
        noise, torch.from_numpy(cond)[None], torch.from_numpy(ms1)[None], num_steps=ns)
    return pred[0].numpy(), noise_pred[0].numpy()


def test_hook_matches_the_jax_hook(setup, monkeypatch):
    """Same pair, same logged keys and table columns, rows of the same
    shape and panel names as the JAX hook's; the prediction is the port's
    sampler on a model loaded from ``ema_state_dict()``, bitwise; the
    trainer's parameters, EMA, optimizer state, mode and step unchanged."""
    tmp, files, jmodel, jproc, jstate, params = setup
    jds, ds = JaxDIAMSDataset(**files), DIAMSDataset(**files)
    jlog, log = JaxJsonlLogger(str(tmp / "jax_logs")), JsonlLogger(str(tmp / "port_logs"))
    jax_viz.PredictionLoggingHook(JaxDDIMSampler(jmodel, jproc), jds, jlog,
                                  out_dir=str(tmp / "jax_plots"), num_steps=STEPS)(1, 0.5, jstate)
    jlog.finish()

    tr = _port_trainer(params)
    snap = _snapshot(tr)
    seen = _recording(monkeypatch)
    viz.PredictionLoggingHook(DDIMSampler(tr.model, tr.process), ds, log,
                              out_dir=str(tmp / "port_plots"), num_steps=STEPS)(1, 0.5, tr)
    log.finish()
    _assert_unchanged(tr, snap)
    assert ds.last_indices == jds.last_indices

    jrec, rec = _records(tmp / "jax_logs"), _records(tmp / "port_logs")
    assert [sorted(k for k in r if not k.startswith("_")) for r in rec] == \
        [sorted(k for k in r if not k.startswith("_")) for r in jrec]
    assert rec[-1]["_table"] == jrec[-1]["_table"] == "predictions_table"
    assert rec[-1]["columns"] == jrec[-1]["columns"] and len(rec[-1]["columns"]) == 10
    for row, jrow in zip(rec[-1]["rows"], jrec[-1]["rows"]):
        assert row[:3] == jrow[:3] and len(row) == len(jrow) == 10
        assert [os.path.basename(p) for p in row[4:]] == [os.path.basename(p) for p in jrow[4:]]
        assert all(os.path.exists(p) for p in row[4:])
    assert len(list((tmp / "port_plots").glob("*.png"))) == 6 * len(STEPS)

    ms2_1, ms2_2, cond, ms1 = seen[0][0], seen[0][1], seen[0][2], seen[0][3]
    np.testing.assert_array_equal(cond, 0.5 * ms2_1 + 0.5 * ms2_2)
    ema_sd = tr.ema_state_dict()
    for (ns, row), arrays in zip(zip(STEPS, rec[-1]["rows"]), seen):
        pred, pred_noise = _reference_pred(tr, ema_sd, cond, ms1, 1, ns)
        np.testing.assert_array_equal(arrays[4], pred)
        np.testing.assert_array_equal(arrays[5], pred_noise)
        p, t = arrays[4].astype(np.float64).ravel(), ms2_1.astype(np.float64).ravel()
        assert row[3] == pytest.approx(p @ t / (np.linalg.norm(p) * np.linalg.norm(t) + 1e-12),
                                       rel=1e-12)
    # the EMA, not the trained weights
    trained, _ = _reference_pred(tr, tr.model.state_dict(), cond, ms1, 1, STEPS[0], grad=True)
    assert np.abs(trained - seen[0][4]).max() > 1e-4


def test_hook_without_ema_samples_the_trained_weights(setup, monkeypatch, tmp_path):
    """A trainer that keeps no EMA (or ``use_ema=False``) samples with the
    trained weights; the trainer in eval mode stays in eval mode."""
    _, files, _, _, _, params = setup
    for ema_decay, use_ema in ((None, True), (0.999, False)):
        tr = _port_trainer(params, ema_decay=ema_decay)
        tr.model.eval()
        snap = _snapshot(tr)
        seen = _recording(monkeypatch)
        viz.PredictionLoggingHook(DDIMSampler(tr.model, tr.process), DIAMSDataset(**files),
                                  JsonlLogger(str(tmp_path / "logs")), out_dir=str(tmp_path),
                                  num_steps=(2,), use_ema=use_ema)(0, 1.0, tr)
        _assert_unchanged(tr, snap)
        pred, _ = _reference_pred(tr, tr.model.state_dict(), seen[0][2], seen[0][3], 0, 2,
                                  grad=True)
        np.testing.assert_array_equal(seen[0][4], pred)
