"""The slice's reading (busy union, idle gaps by host activity, the top
device operations) on a hand-made chrome trace, and the result line's keys."""

import os
import sys

from cb_helpers import ROOT, SAMPLE
from cuda_bench import harness, trace


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_read_takes_the_union_between_the_spins():
    events = [
        _x("spin_kernel", "kernel", 0, 100), _x("spin_kernel", "kernel", 1000, 100),
        _x("void (anonymous namespace)::linattn_cluster<bf16, 4>(float*)", "kernel", 100, 200),
        _x("resnet_fwd<float, 4, 4, 1>", "kernel", 250, 150),  # overlaps the first
        _x("Memcpy DtoH", "gpu_memcpy", 700, 100),
        _x("bench.forward", "user_annotation", 0, 1100),
        _x("aten::cat", "cpu_op", 450, 100), _x("aten::copy_", "cpu_op", 850, 100),
        _x("late", "kernel", 1200, 50),  # after the closing spin: outside
    ]
    r = trace.read({"traceEvents": events})
    assert r["window_s"] == 900e-6 and abs(r["busy_s"] - 400e-6) < 1e-12
    assert [k[0].split("<")[0][-15:] for k in r["kernels"]][:1] == ["linattn_cluster"]
    assert dict(r["device_ops"])["linattn_cluster"] == 200e-6
    gaps = dict(r["idle_gaps"])
    assert abs(gaps["bench.forward:aten::cat"] - 300e-6) < 1e-12
    assert abs(gaps["bench.forward:aten::copy_"] - 200e-6) < 1e-12


def test_result_line_keys():
    sys.path.insert(0, os.path.join(ROOT, "cuda_bench"))
    import json

    import run

    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    sl = {"busy_s": 0.3, "window_s": 0.4, "device_ops": [["k", 0.1]], "idle_gaps": [["g", 0.1]],
          "kernels": []}
    res = {"numbers": {"pred_gap": 1e-4}, "failed": 0, "attempted": 8, "memory_peak_bytes": 1,
           "e2e": {"setup_s": 1.0, "windows_per_s": 5.0, "peak_mem_gib": 2.0},
           "rec": {"slice": sl, "forward_ms": 29.0, "window": None, "b": 8, "rt": 34,
                   "train": False, "forwards": 8, "backwards": 0}}
    res["rec"]["unet"] = harness.Cell.load(SAMPLE, seed=1, seconds=1, trace=False).unet
    orig = harness.device_info
    harness.device_info = lambda n: {"platform": "gpu", "kind": "x", "count": n}
    try:
        for traced in (False, True):
            cell = harness.Cell.load(SAMPLE, seed=1, seconds=1, trace=traced, device="cpu")
            out = run.result(cell, bench, res, 1)
            keys = ["correct", "attempted", "failed", "metrics", "device"]
            assert list(out) == keys + (["breakdown"] if traced else []) + ["checks"]
            assert out["correct"] is True
            names = set(out["metrics"])
            assert names == ({"forward_ms.sample", "idle_share.sample"} if traced
                             else {"setup_s", "windows_per_s", "peak_mem_gib"})
    finally:
        harness.device_info = orig


def test_measure_reads_the_device_from_the_cuda_only_slice(monkeypatch):
    made = []

    class FakeSlice:
        def __init__(self, path, host=False):
            self.path, self.host, self.started = path, host, False
            made.append(self)

        def start(self):
            self.started = True

        def stop(self):
            assert self.started
            busy = 0.5 if self.host else 0.9  # the host's records slow the host
            return {"busy_s": busy, "window_s": 1.0, "kernels": [("k", 0.0, 1.0)],
                    "device_ops": [["k", busy]], "idle_gaps": [[f"host={self.host}", 0.1]],
                    "trace_bytes": 1}

    runs = []
    monkeypatch.setattr(trace, "Slice", FakeSlice)
    out = trace.measure(lambda sl, i: (runs.append((sl.host, i)), sl.start()), "base", 7)
    assert runs == [(False, 7), (True, 8)]
    assert [s.path for s in made] == ["base.trace.json", "base.host.trace.json"]
    assert out["busy_s"] == 0.9 and out["device_ops"] == [["k", 0.9]]
    assert out["idle_gaps"] == [["host=True", 0.1]]
