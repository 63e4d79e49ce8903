"""The port's command line on a mesh, under the standard launcher
(``python -m torch.distributed.run``, which ships with torch): ``train``
and ``predict`` with ``tpu.mesh.dp: 2`` on two CPU processes (gloo) write
the checkpoint and the predictions a one-process run writes; one process
asked for a mesh of two ranks raises, naming the launcher; at tp = 2 the
prediction panels of ``tpu.log_predictions`` come from the lead alone.

Tolerances: the parameters of a dp = 2 run differ from one process's only
in the order of the gradient sums, rtol 1e-5 with atol 2·lr (Adam's first
update is about lr·sign(g)), as tests/test_torch_parallel.py; the
predictions, from the same weights, rtol 1e-5.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from dquartic_tpu_torch.cli import cli
from dquartic_tpu_torch.train import latest_path_for
from test_torch_cli import _write_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RT, MZ, N = 4, 16, 8
LR = 1e-3


def _launch(args, cwd, script=None, env=None):
    """``args`` of the CLI on two processes under the launcher (or of
    ``script``, which runs the CLI, with ``env`` added)."""
    target = ["-m", "dquartic_tpu_torch.cli"] if script is None else [script]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "2", *target, *args]
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1", **(env or {}))
    res = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
    return res


def _invoke(args):
    res = CliRunner().invoke(cli, args)
    assert res.exit_code == 0, (res.output, res.exception)
    return res


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_cli")
    rng = np.random.default_rng(1)
    np.save(tmp / "ms2.npy", rng.uniform(0, 10, (N, RT, MZ)).astype(np.float32))
    np.save(tmp / "ms1.npy", rng.uniform(0, 5, (N, RT)).astype(np.float32))
    return tmp


def _run_dir(data, name, dp):
    d = data / name
    d.mkdir()
    for f in ("ms2.npy", "ms1.npy"):
        os.symlink(data / f, d / f)
    return d, _write_config(d, mesh={"dp": dp, "sp": 1, "tp": 1})


def test_train_and_predict_under_the_launcher_match_one_process(data):
    """``train`` at dp = 2 (each process fed its row of every batch of 2,
    DDP over the rows) writes the checkpoints of the one-process run, rank 0
    alone; ``predict`` at dp = 2 from it writes the one-process npz."""
    one, one_cfg = _run_dir(data, "one", 1)
    two, two_cfg = _run_dir(data, "two", 2)
    _invoke(["train", "--device", "cpu", one_cfg])
    res = _launch(["train", "--device", "cpu", two_cfg], cwd=two)
    assert res.stdout.count("[Training] Epoch=2") == 1  # mesh rank 0 alone reports
    for name in ("best_model.ckpt", "dquartic_latest_checkpoint.ckpt"):
        ref = torch.load(one / "ckpt" / name, weights_only=True)
        got = torch.load(two / "ckpt" / name, weights_only=True)
        assert (got["epoch"], got["step"]) == (ref["epoch"], ref["step"]) == (1, 8)
        np.testing.assert_allclose(got["best_loss"], ref["best_loss"], rtol=1e-5)
        for part, atol in (("params", 2 * LR), ("ema_params", 2 * LR)):
            for k, v in ref[part].items():
                np.testing.assert_allclose(got[part][k].numpy(), v.numpy(), rtol=1e-5,
                                           atol=atol, err_msg=f"{name} {part} {k}")
    assert len((two / "ckpt" / "metrics.jsonl").read_text().splitlines()) == 2

    ckpt = latest_path_for(str(one / "ckpt" / "best_model.ckpt"))
    args = ["predict", "--device", "cpu", "--num-steps", "3", "--num-batches", "2"]
    _invoke(args + [one_cfg, ckpt, str(one / "preds.npz")])
    _launch(args + [two_cfg, ckpt, str(two / "preds.npz")], cwd=two)
    ref, got = np.load(one / "preds.npz"), np.load(two / "preds.npz")
    assert sorted(got.files) == sorted(ref.files) and len(ref.files) == 10
    for k in ref.files:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-6, err_msg=k)


def _predictions(run_dir):
    """The cosines and table rows of ``metrics.jsonl``."""
    records = [json.loads(line) for line in (run_dir / "ckpt" / "metrics.jsonl").open()]
    cosines = {k: r[k] for r in records for k in r if k.startswith("predictions/cosine_")}
    tables = [r["rows"] for r in records if r.get("_table") == "predictions_table"]
    return cosines, tables


def test_prediction_panels_at_tp2_come_from_the_lead(data):
    """``tpu.log_predictions`` at tp = 2 under the launcher: both ranks
    sample (the model's collectives need them), the lead alone renders the
    panels and logs, and its cosines are the one-process run's."""
    runs = {}
    for name, tp in (("viz_one", 1), ("viz_tp2", 2)):
        d = data / name
        d.mkdir()
        for f in ("ms2.npy", "ms1.npy"):
            os.symlink(data / f, d / f)
        cfg = _write_config(d, mesh={"dp": 1, "sp": 1, "tp": tp}, log_predictions=True,
                            prediction_num_steps=[2, 3])
        with open(cfg) as f:
            c = json.load(f)
        c["model"]["num_epochs"] = 1
        with open(cfg, "w") as f:
            json.dump(c, f)
        runs[name] = (d, cfg)
    one, one_cfg = runs["viz_one"]
    _invoke(["train", "--device", "cpu", one_cfg])
    two, two_cfg = runs["viz_tp2"]
    record = two / "renders"
    _launch(["train", "--device", "cpu", two_cfg], cwd=two,
            script=os.path.join(REPO, "tests", "_viz_rank.py"), env={"VIZ_RECORD": str(record)})
    renders = [json.loads(line) for line in open(f"{record}.rank0")]
    assert [r["prefix"] for r in renders] == ["e1_s2_", "e1_s3_"]
    assert not os.path.exists(f"{record}.rank1")
    assert len(list((two / "ckpt").glob("*.png"))) == 12
    (cos1, rows1), (cos2, rows2) = _predictions(one), _predictions(two)
    assert sorted(cos2) == sorted(cos1) == ["predictions/cosine_2steps",
                                            "predictions/cosine_3steps"]
    for k in cos1:
        np.testing.assert_allclose(cos2[k], cos1[k], rtol=1e-5, err_msg=k)
    assert len(rows1) == len(rows2) == 1
    assert [r[:2] for r in rows2[0]] == [r[:2] for r in rows1[0]]


def test_one_process_refuses_a_mesh_of_two(data):
    _, cfg = _run_dir(data, "refused", 2)
    res = CliRunner().invoke(cli, ["train", "--device", "cpu", cfg])
    assert res.exit_code != 0
    assert "torch.distributed.run --nproc-per-node 2" in res.output
