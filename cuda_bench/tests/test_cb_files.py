"""Every file of the benchmark loads and names what exists: each cell its
configuration, traffic and mode; each per-layer metric its reader, its
cells and the end-to-end metric it moves; and BENCHMARK.json keeps to the
contract's shapes."""

import importlib.util
import json
import math
import os
import re

import pytest

from cb_helpers import ROOT
from cuda_bench import harness
from cuda_bench.reference import unet1d as R

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"]: m for m in BENCH["end_to_end"]}
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["cuda_bench"] and BENCH["command"][1] == "cuda_bench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert "setup_s" in E2E and E2E["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in E2E.values())


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    c = harness.Cell.load(cell, seed=1, seconds=1, trace=False, device="cpu")
    assert c.workload["config"] == entry["config"] and c.workload["traffic"] == entry["traffic"]
    assert c.workload["why"] == entry["why"] and len(entry["why"]) <= 200
    assert entry["chips"] == 1
    mode = harness.mode(c.workload["mode"])
    assert callable(mode.run)
    assert c.traffic["rt"] == 34 and c.traffic["batch"] >= 1
    assert c.unet["downsample_dim"] == 40000
    assert c.workload["check"]["limits"], "every cell compares its numbers against limits"
    reported = [m for m in BENCH["end_to_end"] if cell in m.get("workloads", [cell])]
    assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
    assert any(cell in m.get("workloads", [cell]) for m in BENCH["per_layer"])


def _unet_full():
    """The full UNet1d as its configuration file would state it: the
    canonical block with ``simple: false`` and the constructor's
    ``tfer_depth``, outside ``BENCHMARK.json``."""
    entry = dict(next(c for c in BENCH["configs"] if c["name"] == "unet-simple"),
                 name="unet-full", file="cuda_bench/configs/unet-full.json")
    data = json.load(open(os.path.join(ROOT, "cuda_bench", "configs", "unet-simple.json")))
    data["model"]["UNet1d"]["simple"] = False
    data.update(assumed={"tfer_depth": 4}, parameters=2_829_323_087)
    return entry, data


def _check_config(entry, data):
    """A configuration's entry and its file agree, and the file states the
    parameters its block has."""
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["file"] == f"cuda_bench/configs/{entry['name']}.json"
    assert data["source"] == entry["source"] and data["reduced"] == entry["reduced"]
    assert all(NAME.match(k) for k in entry["reduced"]) and len(entry["reduced"]) <= 16
    shapes = R.param_shapes(data["model"]["UNet1d"])
    assert sum(math.prod(s) for s in shapes.values()) == data["parameters"]


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_files(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    _check_config(entry, json.load(open(os.path.join(ROOT, entry["file"]))))
    assert any(w["config"] == config for w in BENCH["workloads"])


def test_config_check_takes_the_full_unet():
    _check_config(*_unet_full())


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_per_layer_readers(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    assert m["moves"] in E2E and UNIT.match(m["unit"]) and NAME.match(metric)
    for cell in m["workloads"]:
        assert cell in CELLS
        assert cell in E2E[m["moves"]].get("workloads", [cell])
    path = os.path.join(ROOT, "cuda_bench", "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location("reader", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.read({"slice": None, "window": None}) is None  # nothing to read: no number


def test_names_and_units():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for m in BENCH["end_to_end"] + BENCH["per_layer"])
    layers = {m["layer"] for m in BENCH["per_layer"]}
    perf = open(os.path.join(ROOT, "PERF.md")).read()
    assert all(f"`{layer}`" in perf for layer in layers)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
