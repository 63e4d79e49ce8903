"""The harness end to end on the CPU at a small size, its look for a card
skipped: a sound run of every cell is correct and shows a number for each
of its limits, and each fault the cells can have comes out not correct (a
fault that starts after the first training steps by the numbers read at
the end of the window alone). The control (the reference in the
program's place, its products in fp8) comes out not correct at the cells'
own size on the card (``-m cuda``), and so do the late faults; at the
CPU's small size the sampling control's gap stays under the limit set at
the cell's size, so only the training control is held here."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from cb_helpers import ROOT, SAMPLE, TRAIN, planted, run_small, small_cell
from cuda_bench import harness

CELLS = [w["name"] for w in json.load(open(os.path.join(ROOT, "BENCHMARK.json")))["workloads"]]
FIRST = ("grad_vs_bf16", "change_vs_bf16", "ema_gap")
LATE = ("late_grad_vs_bf16", "late_norm_vs_bf16")


def _correct(name, res):
    limits = small_cell(name).workload["check"]["limits"]
    return harness.correct_of(harness.judge(res["numbers"], limits), res["failed"])


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res = run_small(name)
    assert res["attempted"] >= 1 and res["failed"] == 0
    cell = small_cell(name)
    limits = cell.workload["check"]["limits"]
    checks = harness.judge(res["numbers"], limits)
    assert harness.correct_of(checks, res["failed"]), checks
    assert set(limits) <= set(checks)
    if cell.workload["mode"] == "train":
        assert set(FIRST + LATE) <= set(limits)


@pytest.mark.parametrize("name,fault", [(SAMPLE, "half_batch"), (SAMPLE, "answer_altered"),
                                        (TRAIN, "state_unchanged")])
def test_faults_are_not_correct(name, fault):
    res = run_small(name, fault=fault)
    assert not _correct(name, res), res["numbers"]


def _late_alone(res, limits):
    """Not correct by a number read at the end of the window alone."""
    checks = harness.judge(res["numbers"], limits)
    assert res["failed"] == 0
    assert all(checks[n]["value"] <= checks[n]["limit"] for n in FIRST), checks
    assert any(checks[n]["value"] > checks[n]["limit"] for n in LATE), checks
    assert not harness.correct_of(checks, res["failed"])


@pytest.mark.parametrize("fault", ["late_drift", "late_double"])
def test_late_fault_reads_late_alone(fault):
    _late_alone(run_small(TRAIN, fault=fault), small_cell(TRAIN).workload["check"]["limits"])


def test_control_is_not_correct_small():
    res = run_small(TRAIN, program="control")
    assert not _correct(TRAIN, res), res["numbers"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's own size on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("name", [SAMPLE, TRAIN])
def test_control_is_not_correct_on_card(card, name):
    out = subprocess.run([sys.executable, "cuda_bench/run.py", "--workload", name, "--seed",
                          str(2 ** 32 + 17), "--seconds", "1", "--trace", "0", "--program",
                          "control"], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is False, result["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["late_drift", "late_double"])
def test_late_fault_is_not_correct_on_card(card, fault):
    cell = harness.Cell.load(TRAIN, seed=2 ** 32 + 29, seconds=2, trace=False)
    with planted(fault):
        res = harness.mode("train").run(cell, time.perf_counter())
    _late_alone(res, cell.workload["check"]["limits"])


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "cuda_bench/run.py", "--workload", SAMPLE, "--seed",
                          str(2 ** 33 + 1), "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 3 and out.stdout == "", (out.returncode, out.stdout)
    assert "CUDA device" in out.stderr
