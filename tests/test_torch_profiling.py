"""The port's profiling utilities against the JAX package's: ``StepTimer``'s
summary on the same step times, ``trace`` writing a Chrome trace,
``device_memory_stats`` under JAX's keys (empty without a card), and
``host_rss_mb``. Runs on the CPU; the CUDA paths are driven through a
stand-in ``torch.cuda``.
"""

import json
import os

import numpy as np
import pytest
import torch

from dquartic_tpu.utils import profiling as jprof
from dquartic_tpu_torch.utils import profiling as tprof


@pytest.mark.parametrize("times", [[0.5], [0.9, 0.010, 0.012, 0.011, 0.030], []])
def test_step_timer_summary_matches_jax(times):
    """The same keys and values as JAX's summary: the first step (the
    warm-up) left out where there are others."""
    port, ref = tprof.StepTimer(), jprof.StepTimer()
    port.times, ref.times = list(times), list(times)
    assert port.summary() == ref.summary()


def test_step_timer_steps_and_sync(monkeypatch):
    """Each step appends its wall time; with ``sync`` a step that observed
    a CUDA tensor waits on that tensor's card, and nothing else does."""
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: synced.append(device))
    timer = tprof.StepTimer(sync=True)
    for _ in range(3):
        with timer.step():
            timer.observe(torch.ones(4) * 2)
    assert len(timer.times) == 3 and all(t >= 0 for t in timer.times) and synced == []
    s = timer.summary()
    assert set(s) == {"steps", "mean_ms", "p50_ms", "p95_ms", "max_ms"} and s["steps"] == 3

    class OnCard:  # a tensor on the second card, as the timer sees it
        is_cuda, device = True, torch.device("cuda", 1)

    with timer.step():
        timer.observe(OnCard())
    assert synced == [torch.device("cuda", 1)]


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with tprof.trace(str(log_dir)) as d:
        torch.randn(64, 64) @ torch.randn(64, 64)
    assert d == str(log_dir)
    with open(os.path.join(d, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)


def test_device_memory_stats(monkeypatch):
    """Empty without CUDA (JAX's "when unsupported"); with a card, one
    entry a device in MB under JAX's keys."""
    if not torch.cuda.is_available():
        assert tprof.device_memory_stats() == []

    class Props:
        total_memory = 80e9

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: {
        "allocated_bytes.all.current": 1e6 * (i + 1), "allocated_bytes.all.peak": 5e6})
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda i: Props())
    stats = tprof.device_memory_stats()
    assert [set(s) for s in stats] == [{"device", "bytes_in_use_mb", "peak_bytes_mb",
                                        "bytes_limit_mb"}] * 2
    assert [s["bytes_in_use_mb"] for s in stats] == [1.0, 2.0]
    assert stats[1] == {"device": "cuda:1", "bytes_in_use_mb": 2.0, "peak_bytes_mb": 5.0,
                        "bytes_limit_mb": 80000.0}


def test_host_rss_matches_jax():
    a, b = tprof.host_rss_mb(), jprof.host_rss_mb()
    assert a is not None and b is not None
    np.testing.assert_allclose(a, b, rtol=0.05)
