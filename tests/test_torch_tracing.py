"""The port's spans (``utils/profiling.py``) on the CPU: off, a span site
enters no ``record_function`` and adds no autograd node; on, ``predict``
and ``train_step`` give their span trees under one request id, children
inside their parents; the numbers are bitwise the same on and off; under
``profiling.trace`` every span is a ``user_annotation`` of the chrome trace
on its own clock; and each request takes the next id of one counter.
"""

import json
import os

import numpy as np
import pytest
import torch

from dquartic_tpu_torch.core import DDIMProcess, make_schedule
from dquartic_tpu_torch.infer import DDIMSampler
from dquartic_tpu_torch.models import UNet1d
from dquartic_tpu_torch.train import Trainer
from dquartic_tpu_torch.utils import profiling

TINY = dict(dim=4, channels=1, dim_mults=(1, 2), conditional=True, init_cond_channels=1,
            attn_cond_channels=1, downsample_dim=64, simple=True, fused_resnet=True)
RT, MZ, STEPS = 4, 64, 3
MARKER = "_BackwardMarkBackward"
UNET = ["unet.forward", "unet.cond", "unet.mid", "unet.mid.attn"]
PREDICT = ["predict", "predict.to_device"] + ["ddim.step"] * STEPS + UNET * STEPS \
    + ["predict.to_host"]
TRAIN = ["train_step", "train_step.batch", "train_step.forward"] + UNET \
    + ["train_step.backward", "unet.mid.backward", "unet.mid.attn.backward",
       "unet.cond.backward", "train_step.optimizer", "train_step.ema"]
PARENT = {"predict.to_device": "predict", "ddim.step": "predict", "predict.to_host": "predict",
          "train_step.batch": "train_step", "train_step.forward": "train_step",
          "train_step.backward": "train_step", "train_step.optimizer": "train_step",
          "train_step.ema": "train_step", "unet.mid": "unet.forward",
          "unet.cond": "unet.forward", "unet.mid.attn": "unet.mid",
          "unet.mid.backward": "train_step.backward",
          "unet.mid.attn.backward": "unet.mid.backward",
          "unet.cond.backward": "train_step.backward"}
MARKERS = 6  # two identity nodes for each of the three backward spans


@pytest.fixture(autouse=True)
def fresh_store():
    profiling.clear()
    yield
    profiling.clear()


def _batch(seed, b=2):
    rng = np.random.default_rng(seed)
    return {"ms2_1": rng.uniform(0, 1, (b, RT, MZ)).astype(np.float32),
            "ms1_1": rng.uniform(0, 1, (b, RT)).astype(np.float32),
            "ms2_2": rng.uniform(0, 1, (b, RT, MZ)).astype(np.float32)}


def _process():
    return DDIMProcess(schedule=make_schedule(1000, "cosine", "eps"))


def _model(**kw):
    torch.manual_seed(0)
    return UNet1d(**dict(TINY, **kw))


def _draws(seed, b=2):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 1000, (b,), generator=g), torch.randn((b, RT, MZ), generator=g)


def _predict(batches=1):
    sampler = DDIMSampler(_model(), _process())
    data = [_batch(i) for i in range(batches)]
    return [r["pred"] for r in sampler.predict(data, num_steps=STEPS, seed=5, device="cpu")]


def _train(**kw):
    """One step of a fresh trainer: its loss, gradients, parameters and EMA."""
    tr = Trainer(_model(**kw), _process(), seed=3)
    t, eps = _draws(7)
    loss = tr.train_step(_batch(1), 1e-3, t=t, eps=eps)["loss"]
    return [loss] + [p.grad for p in tr.optimizer.params] + list(tr.optimizer.params) \
        + tr.ema_params


RUN = {"predict": _predict, "train_step": _train}


def _graph(loss):
    """The names of the autograd nodes behind ``loss``, with repeats."""
    names, seen, todo = [], set(), [loss.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.append(type(node).__name__)
        todo.extend(n for n, _ in node.next_functions)
    return sorted(names)


def _loss():
    b = {k: torch.as_tensor(v) for k, v in _batch(1).items()}
    t, eps = _draws(7)
    loss, _ = _process().train_loss(_model(), b["ms2_1"], 0.5 * (b["ms2_1"] + b["ms2_2"]),
                                    b["ms1_1"], t=t, eps=eps)
    return loss


@pytest.mark.parametrize("what", ["predict", "train_step", "graph"])
def test_off_enters_nothing(what, monkeypatch):
    """With spans off no ``record_function`` is entered (it raises here),
    no span is kept, and the forward adds no marker to the graph."""
    def refuse(*a, **k):
        raise AssertionError("record_function entered with spans off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    if what == "graph":
        off = _graph(_loss())
        assert MARKER not in off and profiling.spans() == []
        with profiling.recording():
            on = _graph(_loss())
        assert sorted(on) == sorted(off + [MARKER] * MARKERS)
    else:
        RUN[what]()
        assert profiling.spans() == []


@pytest.mark.parametrize("what", ["predict", "train_step"])
def test_on_gives_the_span_tree(what):
    with profiling.recording():
        RUN[what]()
    got = profiling.spans()
    by_id = {s.id: s for s in got}
    assert sorted(s.name for s in got) == sorted(PREDICT if what == "predict" else TRAIN)
    assert len({s.request for s in got}) == 1 and got[0].request is not None
    for s in got:
        parent = by_id.get(s.parent)
        want = PARENT.get(s.name, {"unet.forward": "ddim.step" if what == "predict"
                                   else "train_step.forward"}.get(s.name))
        assert (parent.name if parent else None) == want, s
        if parent:  # inside its parent
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
            assert parent.device_ms >= s.device_ms
        assert s.device_ms >= 0 and s.self_ms <= s.device_ms
    root = next(s for s in got if s.parent is None)
    assert root.name == what
    kids = [s for s in got if s.parent == root.id]
    assert root.self_ms == pytest.approx(root.device_ms - sum(k.device_ms for k in kids))


@pytest.mark.parametrize("what", ["predict", "train_step"])
def test_numbers_bitwise_on_and_off(what):
    off = RUN[what]()
    with profiling.recording():
        on = RUN[what]()
    assert len(on) == len(off)
    for a, b in zip(off, on):
        a, b = torch.as_tensor(a), torch.as_tensor(b)
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("what", ["predict", "train_step"])
def test_spans_share_the_trace_clock(what, tmp_path):
    """Each span is a ``user_annotation`` whose ``ts`` (plus the trace's
    base) lies within 1 ms of the span's recorded start."""
    with profiling.trace(str(tmp_path)):
        RUN[what]()
    with open(os.path.join(tmp_path, "trace.json")) as f:
        trace = json.load(f)
    base_us = trace["baseTimeNanoseconds"] / 1e3
    notes = [(e["name"], float(e["ts"]) + base_us) for e in trace["traceEvents"]
             if e.get("cat") == "user_annotation"]
    got = profiling.spans()
    assert len(got) == len(PREDICT if what == "predict" else TRAIN)
    for s in got:
        near = min(abs(ts - s.start_ns / 1e3) for name, ts in notes if name == s.name)
        assert near < 1000.0, (s, near)


@pytest.mark.parametrize("session", ["profiler", "recording"])
def test_requests_take_the_next_id(session, tmp_path):
    """Two sessions give two request ids, the first session's the lowest;
    requests made with spans off between them still take an id."""
    def record():
        if session == "profiler":
            return profiling.trace(str(tmp_path))
        return profiling.recording()

    with record():
        _predict()
    _predict(batches=2)  # off: two ids, no spans
    with record():
        _predict()
    ids = sorted({s.request for s in profiling.spans()})
    assert len(ids) == 2 and ids[1] == ids[0] + 3
    first = [s for s in profiling.spans() if s.request == ids[0]]
    assert len(first) == len(PREDICT) and max(s.id for s in first) < min(
        s.id for s in profiling.spans() if s.request == ids[1])


@pytest.mark.parametrize("keep", [1, 4])
def test_store_keeps_the_newest(keep, monkeypatch):
    """The store is bounded: it keeps the newest spans, and ``clear``
    empties it."""
    import collections

    monkeypatch.setattr(profiling, "_store", collections.deque(maxlen=keep))
    with profiling.recording():
        for i in range(6):
            with profiling.span(f"s{i}"):
                pass
    assert [s.name for s in profiling.spans()] == [f"s{i}" for i in range(6 - keep, 6)]
    profiling.clear()
    assert profiling.spans() == []


@pytest.mark.parametrize("simple", [True, False])
def test_train_step_spans_the_mid_attention_and_the_condition(simple):
    """One train step of the small model (``simple: true``: a cross
    attention and two convs over the trace; ``simple: false``: the 4-layer
    transformer and the MS1 tower) records ``unet.mid.attn`` inside
    ``unet.mid``, ``unet.cond`` inside ``unet.forward``, and their
    backward spans inside ``unet.mid.backward`` and
    ``train_step.backward``, all of the step's request; with spans off,
    nothing records and the numbers are bitwise the same."""
    off = _train(simple=simple)
    assert profiling.spans() == []
    with profiling.recording():
        on = _train(simple=simple)
    assert all(torch.equal(torch.as_tensor(a), torch.as_tensor(b)) for a, b in zip(off, on))
    got = profiling.spans()
    by_id = {s.id: s for s in got}
    (root,) = [s for s in got if s.name == "train_step"]
    for name in ("unet.mid.attn", "unet.mid.attn.backward", "unet.cond", "unet.cond.backward"):
        (s,) = [x for x in got if x.name == name]
        parent = by_id[s.parent]
        assert parent.name == PARENT[name] and s.request == root.request
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
        assert 0 <= s.device_ms <= parent.device_ms
    (fwd,) = [s for s in got if s.name == "unet.forward"]
    for name in ("unet.cond", "unet.mid", "unet.mid.attn"):
        (s,) = [x for x in got if x.name == name]
        assert fwd.start_ns <= s.start_ns <= s.end_ns <= fwd.end_ns
