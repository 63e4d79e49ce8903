"""The port's async sharded checkpoint backend (``tpu.checkpoint_backend:
"orbax"``, :mod:`dquartic_tpu_torch.train.async_ckpt`) against the JAX
Orbax backend's protocol (tests/test_train.py ``test_orbax_checkpoint_backend``)
and against the port's msgpack backend.

On one process: latest and best are written and a second ``train``
continues the step counter, its state bitwise the msgpack path's; a save is
a snapshot (a step taken while it is written does not reach it); a writer's
error surfaces at the next ``wait`` or ``save`` and leaves the previous
latest loadable; a JAX Orbax tree at the latest or the best path raises
and is left as it was; ``cli.py train`` resumes through it. On two gloo
ranks of the CPU (tp = 2 and dp = 2): each rank writes only its own shards
(the replicated leaves once), no rank gathers a split leaf while it saves,
and the resume on the ranks equals a one-process resume of the same files
(which reshards the tp = 2 leaves).
"""

import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

import dquartic_tpu_torch.parallel.tensor as ptensor
import dquartic_tpu_torch.train.optim as poptim
import dquartic_tpu_torch.train.trainer as ptrainer
from dquartic_tpu_torch.models import UNet1d
from dquartic_tpu_torch.parallel import full_state_dict, local_rows
from dquartic_tpu_torch.train import Trainer, make_optimizer
from dquartic_tpu_torch.train import async_ckpt
from test_torch_parallel import MIN, TINY, _batch, _named_state, _np, _process, _Ranks

LR = 1e-3
BATCHES = 2  # an epoch
SHAPES = [(1, 1, 2), (2, 1, 1)]



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The tiny models run fastest on one thread, which leaves the other
    cores to the other test modules."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trainer(mesh=None, kind="adamw", backend="orbax", ema=0.999, device="cpu"):
    """The tiny UNet1d (fused ResnetBlocks) from one seed on every process,
    its wide leaves split over tp by the Trainer at the test threshold."""
    torch.manual_seed(0)
    model = UNet1d(**TINY, fused_resnet=True).to(device)
    return Trainer(model, _process(), optimizer=make_optimizer(model.parameters(), kind=kind),
                   ema_decay=ema, mesh=mesh, tp_min_features=MIN, checkpoint_backend=backend)


def _batches(mesh=None, device="cpu"):
    """Two pair batches of two rows; under dp each rank keeps its rows."""
    out = []
    for seed in range(BATCHES):
        b = {k: torch.from_numpy(v).to(device) for k, v in _batch(2, seed).items()}
        out.append(b if mesh is None else local_rows(b, mesh))
    return out


def _train(tr, path, epochs, mesh=None):
    tr.train(_batches(mesh), epochs=epochs, warmup_epochs=0, learning_rate=LR,
             checkpoint_path=path)
    return tr


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    return None if tree is None else np.array(tree, copy=True)


def _state(tr):
    """A copy of the whole train state (gathered over tp): parameters, EMA,
    the optimizer's state keyed by name, and the step."""
    ema = {}
    for (n, e), s in zip(zip(tr.param_names, tr.ema_params or []), tr._splits):
        ema[n] = (e if s is None else ptensor.gather(e, s[0].group, s[1])).cpu().numpy()
    return dict(params=_copy(_np(full_state_dict(tr.model))), ema=_copy(ema),
                opt=_copy(_named_state(tr, tr.optimizer.kind)), step=tr.step,
                count=tr.optimizer.named_state(tr.param_names)[0]["count"])


def _assert_equal(a, b):
    assert a["step"] == b["step"] and a["count"] == b["count"]
    for part in ("params", "ema"):
        assert a[part].keys() == b[part].keys()
        for k in a[part]:
            np.testing.assert_array_equal(a[part][k], b[part][k], err_msg=f"{part} {k}")
    for moment, leaves in a["opt"].items():
        for k, v in leaves.items():
            w = b["opt"][moment][k]
            assert (v is None) == (w is None)
            if v is not None:
                np.testing.assert_array_equal(v, w, err_msg=f"{moment} {k}")


def _resume(tr, path):
    """Restore ``tr`` from the latest save beside ``path`` as ``train``
    does, without training."""
    meta, tensors, _, _, resumed = tr._async.restore_or_init(
        path, tr._shard_layout(), optional=("ema/",))
    assert resumed
    tr._load_shards(meta, tensors)
    return tr


# --------------------------------------------------------------------- #
# one process                                                           #
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("kind", ["adamw", "factored"])
def test_latest_best_and_resume_match_the_msgpack_path(tmp_path, kind):
    """The JAX test's protocol: after one epoch the latest and the best
    exist; a second ``train`` for two epochs resumes after the first and
    ends at step 2·len(batches). Every state on the way is bitwise the
    msgpack backend's."""
    states = {}
    for backend in ("orbax", "msgpack"):
        path = str(tmp_path / backend / "best_model.ckpt")
        tr = _train(_trainer(kind=kind, backend=backend), path, 1)
        if backend == "orbax":
            latest = tr._async.latest_path_for(path)
            assert os.path.basename(latest) == async_ckpt.LATEST_NAME
            for d in (path, latest):
                meta = json.loads(open(os.path.join(d, "meta.json")).read())
                assert meta["files"] == [async_ckpt.shard_name(0, 1)]
                assert (meta["epoch"], meta["step"], meta["optimizer"]) == (0, BATCHES, kind)
            assert not [n for n in os.listdir(tmp_path / backend) if ".tmp-" in n]
        tr2 = _trainer(kind=kind, backend=backend)
        if backend == "orbax":
            resumed = _state(_resume(_trainer(kind=kind), path))
            _assert_equal(resumed, _state(tr))
        _train(tr2, path, 2)
        assert tr2.step == 2 * BATCHES
        states[backend] = (_state(tr), _state(tr2))
    for a, b in zip(states["orbax"], states["msgpack"]):
        _assert_equal(a, b)


def _save_then_step(tmp_path, device):
    """Saved before a step and loaded after it: the pre-step state."""
    tr = _trainer(device=device)
    batch = _batches(device=device)[0]
    gen = torch.Generator(device=device).manual_seed(1)
    tr.train_step(batch, LR, generator=gen)
    before = _state(tr)
    path = str(tmp_path / "best_model.ckpt")
    tr._save(tr._async.latest_path_for(path), 0, 1.0)
    tr.train_step(batch, LR, generator=gen)
    tr._async.wait()
    assert tr.step == 2
    assert any((a != b).any() for a, b in zip(before["params"].values(),
                                              _state(tr)["params"].values()))
    _assert_equal(_state(_resume(_trainer(device=device), path)), before)


def test_a_save_is_a_snapshot(tmp_path):
    """Saved before a step and loaded after it: the pre-step state."""
    _save_then_step(tmp_path, "cpu")


@pytest.mark.cuda
def test_a_save_is_a_snapshot_on_the_card(tmp_path):
    """The same on the card, where the staging copies into pinned memory
    do not block: the step taken at once after the save runs after them
    on the stream and does not reach the files."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the staging copies are asynchronous only there")
    _save_then_step(tmp_path, "cuda")


@pytest.mark.parametrize("surfaces_at", ["wait", "save"])
def test_a_failed_write_surfaces_and_keeps_the_previous_latest(tmp_path, monkeypatch,
                                                               surfaces_at):
    """A writer that fails half-way through its file: the error is raised
    at the next ``wait`` (or ``save``), and the latest save before it
    still loads, whole."""
    tr = _trainer()
    path = str(tmp_path / "best_model.ckpt")
    latest = tr._async.latest_path_for(path)
    tr.train_step(_batches()[0], LR, generator=torch.Generator().manual_seed(1))
    tr._save(latest, 0, 1.0)
    tr._async.wait()
    saved = _state(tr)
    tr.train_step(_batches()[1], LR, generator=torch.Generator().manual_seed(2))

    real_save = torch.save

    def half_then_fail(obj, f, *a, **k):
        f.write(b"PK\x03\x04 half a file")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", half_then_fail)
    tr._save(latest, 1, 0.5)
    with pytest.raises(RuntimeError, match="async checkpoint save") as err:
        if surfaces_at == "wait":
            tr._async.wait()
        else:
            tr._async._jobs[-1].thread.join()
            monkeypatch.setattr(torch, "save", real_save)
            tr._save(latest, 1, 0.5)
    assert "disk full" in repr(err.value.__cause__)
    monkeypatch.setattr(torch, "save", real_save)
    assert [n for n in os.listdir(tmp_path) if ".tmp-" in n]  # the failed save's, kept
    _assert_equal(_state(_resume(_trainer(), path)), saved)
    assert not [n for n in os.listdir(tmp_path) if ".tmp-" in n]  # removed at the resume


@pytest.mark.parametrize("where", ["latest", "best"])
def test_a_jax_orbax_tree_raises_and_is_left_untouched(tmp_path, where):
    """A tree the JAX package's Orbax backend wrote (here by orbax itself, at
    a tiny size) at the JAX latest path or at the best path: ``train``
    raises, names the format and the way out, and writes nothing there."""
    ocp = pytest.importorskip("orbax.checkpoint")
    path = tmp_path / "best_model.ckpt"
    tree = tmp_path / async_ckpt.JAX_LATEST_NAME if where == "latest" else path
    ocp.PyTreeCheckpointer().save(str(tree), {"epoch": np.asarray(3),
                                              "w": np.arange(6, dtype=np.float32)})
    assert async_ckpt.is_orbax_tree(str(tree))
    before = {p: (p.stat().st_mtime_ns, p.read_bytes()) for p in tree.rglob("*") if p.is_file()}
    with pytest.raises(ValueError, match="JAX Orbax checkpoint.*msgpack"):
        _train(_trainer(), str(path), 1)
    after = {p: (p.stat().st_mtime_ns, p.read_bytes()) for p in tree.rglob("*") if p.is_file()}
    assert after == before
    assert not (tmp_path / async_ckpt.LATEST_NAME).exists()


def test_cli_train_resumes_through_the_async_backend(tmp_path):
    """``cli.py train`` with ``tpu.checkpoint_backend: "orbax"``: the latest
    and best directories, then a longer run resumes after epoch 1."""
    from test_torch_cli import N, RT, MZ, _invoke, _write_config

    rng = np.random.default_rng(0)
    np.save(tmp_path / "ms2.npy", rng.uniform(0, 10, (N, RT, MZ)).astype(np.float32))
    np.save(tmp_path / "ms1.npy", rng.uniform(0, 5, (N, RT)).astype(np.float32))
    config = _write_config(tmp_path, checkpoint_backend="orbax")
    _invoke(["train", "--device", "cpu", config])
    latest = tmp_path / "ckpt" / async_ckpt.LATEST_NAME
    meta = json.loads((latest / "meta.json").read_text())
    assert (meta["epoch"], meta["step"]) == (1, 2 * (N // 2))
    assert (tmp_path / "ckpt" / "best_model.ckpt" / "meta.json").exists()
    cfg = json.loads(open(config).read())
    cfg["model"]["num_epochs"] = 3
    (tmp_path / "config3.json").write_text(json.dumps(cfg))
    res = _invoke(["train", "--device", "cpu", str(tmp_path / "config3.json")])
    assert "Resumed from" in res.output
    meta = json.loads((latest / "meta.json").read_text())
    assert (meta["epoch"], meta["step"]) == (2, 3 * (N // 2))


# --------------------------------------------------------------------- #
# two gloo ranks                                                        #
# --------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def ranks():
    pool = _Ranks(__name__, SHAPES)
    yield pool
    pool.close()


def _refuse_gathers():
    """Patches under which any gather of a split leaf raises."""
    def refuse(*a, **k):
        raise AssertionError("a split leaf was gathered while saving")

    targets = [(ptensor, "gather"), (poptim, "gather"), (ptrainer, "gather"),
               (ptrainer, "full_state_dict"), (dist, "all_gather")]
    return [(m, name, getattr(m, name), refuse) for m, name in targets]


def _ranks_save_and_resume(mesh, root, kind):
    """On each rank: one epoch on the mesh with the async backend, its
    saves made with every gather refused, and a fresh trainer resumed from
    the files; then a run to epoch 2 resumed after epoch 1, and a resume
    of its files. Returns what the rank keeps and writes, and the states
    whole."""
    tr = _trainer(mesh, kind)
    real = tr._save
    patches = _refuse_gathers()

    def save(*a, **k):
        for m, name, _, fake in patches:
            setattr(m, name, fake)
        try:
            return real(*a, **k)
        finally:
            for m, name, orig, _ in patches:
                setattr(m, name, orig)

    tr._save = save
    path = os.path.join(root, "best_model.ckpt")
    _train(tr, path, 1, mesh)
    _assert_equal(_state(_resume(_trainer(mesh, kind), path)), _state(tr))
    tr2 = _train(_trainer(mesh, kind), path, 2, mesh)
    return dict(writes=tr._async.writes, state2=_state(tr2),
                resumed2=_state(_resume(_trainer(mesh, kind), path)),
                step=tr2.step,
                leaves={k: (tuple(t.shape), a) for k, (t, a) in tr._shard_leaves().items()})


@pytest.mark.parametrize("shape,kind", [((1, 1, 2), "adamw"), ((1, 1, 2), "factored"),
                                        ((2, 1, 1), "adamw")])
def test_ranks_write_their_own_shards_and_resume_as_one_process(ranks, tmp_path, shape, kind):
    got = ranks.run("_ranks_save_and_resume", shape, str(tmp_path), kind)
    dp, _, tp = shape
    assert [g["writes"] for g in got] == ([True, True] if tp == 2 else [True, False])
    for g in got:
        assert g["step"] == 2 * BATCHES
        _assert_equal(g["resumed2"], got[0]["state2"])
    latest = tmp_path / async_ckpt.LATEST_NAME
    meta = json.loads((latest / "meta.json").read_text())
    assert meta["mesh"] == {"dp": dp, "sp": 1, "tp": tp}
    assert meta["files"] == [async_ckpt.shard_name(i, tp) for i in range(tp)]
    leaves = got[0]["leaves"]
    split = {k for k, (_, a) in leaves.items() if a is not None}
    assert bool(split) == (tp == 2)
    if tp == 2:
        assert any(k.startswith("opt/") for k in split) and any(k.startswith("ema/") for k in split)
    for i in range(tp):  # each file: its rank's shards, the replicated leaves in file 0 only
        shard = torch.load(latest / meta["files"][i], weights_only=True)
        assert set(shard) == (set(leaves) if i == 0 else split)
        for k, t in shard.items():
            assert tuple(t.shape) == got[i]["leaves"][k][0], k
    # one process resumes the same files, resharding the tp = 2 leaves
    _assert_equal(_state(_resume(_trainer(kind=kind), str(tmp_path / "best_model.ckpt"))),
                  got[0]["state2"])


@pytest.mark.parametrize("kind", ["adamw", "factored"])
def test_the_buffers_are_made_before_the_loop(tmp_path, kind):
    """``train`` makes the host buffer of every leaf a save will write
    before its first step, AdamW's moments among them (which its first
    step makes), so no save of the loop allocates one."""
    tr = _train(_trainer(kind=kind), str(tmp_path / "best_model.ckpt"), 0)
    assert tr.step == 0
    layout = tr._shard_layout()
    assert {k: (tuple(b.shape), b.dtype) for k, b in tr._async._buffers.items()} == \
        {k: (shape, torch.float32) for k, (shape, _) in layout.items()}
    assert any(k.startswith("opt/exp_avg") for k in layout) == (kind == "adamw")
