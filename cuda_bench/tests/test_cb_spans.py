"""The readers of the program's spans (``metrics/*.py`` of source
``program_span`` that read ``profiling.spans()``): None without a traced
slice or without spans; from a run recorded on the CPU at a small size,
the mean of their span over the lowest request only."""

import collections
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from cb_helpers import ROOT, SAMPLE, TRAIN, small_cell
from dquartic_tpu_torch.utils import profiling

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
# metric: (cell, [(span, field)] whose means it sums)
SPANS = {
    "unet_forward_ms.sample": (SAMPLE, [("unet.forward", "device_ms")]),
    "ddim_self_ms.sample": (SAMPLE, [("ddim.step", "self_ms")]),
    "to_host_ms.sample": (SAMPLE, [("predict.to_host", "device_ms")]),
    "batch_ms.train": (TRAIN, [("train_step.batch", "device_ms")]),
    "fwd_ms.train": (TRAIN, [("train_step.forward", "device_ms")]),
    "bwd_ms.train": (TRAIN, [("train_step.backward", "device_ms")]),
    "mid_ms.train": (TRAIN, [("unet.mid", "device_ms"), ("unet.mid.backward", "device_ms")]),
    "optimizer_step_ms.train": (TRAIN, [("train_step.optimizer", "device_ms")]),
    "ema_ms.train": (TRAIN, [("train_step.ema", "device_ms")]),
}
RT, LATER_MS = 4, 1e6


def _reader(metric):
    path = os.path.join(ROOT, "cuda_bench", "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"reader_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _batches(n, mz):
    rng = np.random.default_rng(3)
    return [{"ms2_1": rng.uniform(0, 1, (2, RT, mz)).astype(np.float32),
             "ms1_1": rng.uniform(0, 1, (2, RT)).astype(np.float32),
             "ms2_2": rng.uniform(0, 1, (2, RT, mz)).astype(np.float32)} for _ in range(n)]


def _record(cell_name):
    """The spans of two requests of the cell's program at the small size,
    recorded; the later request's read far off, so a reader that takes
    them shows it."""
    from dquartic_tpu_torch.utils.builder import build_model, build_process, build_trainer

    cell = small_cell(cell_name)
    config, mz = cell.program_config(), cell.unet["downsample_dim"]
    profiling.clear()
    with profiling.recording():
        if cell.workload["mode"] == "sample":
            from dquartic_tpu_torch.infer.sampler import DDIMSampler

            sampler = DDIMSampler(build_model(config, device="cpu", seed=1),
                                  build_process(config))
            sampler.predict(_batches(2, mz), num_steps=3, seed=2, device="cpu")
        else:
            trainer = build_trainer(config, device="cpu", seed=1)
            for batch in _batches(2, mz):
                trainer.train_step(batch, 1e-5, generator=torch.Generator().manual_seed(4))
    got = profiling.spans()
    profiling.clear()
    first = min(s.request for s in got)
    assert len({s.request for s in got}) == 2
    for s in got:
        if s.request != first:
            s.device_ms = LATER_MS
    return first, got


@pytest.fixture(scope="module")
def recorded():
    return {name: _record(name) for name in (SAMPLE, TRAIN)}


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_reader_needs_a_slice(metric):
    read = _reader(metric)
    assert read({"slice": None, "window": None}) is None and read({}) is None
    profiling.clear()
    assert read({"slice": {"busy_s": 1.0}}) is None  # no spans recorded
    entry = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    assert entry["source"] == "program_span" and SPANS[metric][0] in entry["workloads"]


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_reader_takes_the_first_request(metric, recorded, monkeypatch):
    cell, parts = SPANS[metric]
    first, got = recorded[cell]
    monkeypatch.setattr(profiling, "_store", collections.deque(got))
    profiling.spans()  # self ms from the device ms as they now read
    want = 0.0
    for name, field in parts:
        values = [getattr(s, field) for s in got if s.request == first and s.name == name]
        assert values, name
        want += sum(values) / len(values)
    assert want < LATER_MS
    assert _reader(metric)({"slice": {"busy_s": 1.0}}) == pytest.approx(want)
