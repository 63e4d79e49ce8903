"""Shared set-up of the benchmark's CPU tests: the cells at a small size,
and the faults planted under the harness for its own tests."""

import contextlib
import copy
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from cuda_bench import harness  # noqa: E402

SMALL = dict(dim_mults=[1, 2, 2], downsample_dim=256)
SAMPLE, TRAIN = "unet-simple.sample-b8", "unet-simple.train-b1"


def small_cell(name: str, seed: int = 12_345_678_901, **kw) -> harness.Cell:
    """``name`` on the CPU at m/z 256 over three levels (10 DDIM steps)."""
    cell = harness.Cell.load(name, seed=seed, seconds=0.2, trace=False, device="cpu", **kw)
    cell.config = copy.deepcopy(cell.config)
    cell.config["model"]["UNet1d"].update(SMALL)
    if cell.workload["mode"] == "sample":
        cell.workload = dict(cell.workload, num_steps=10)
    return cell


class Faulty:
    """A sampler with a planted fault: ``half_batch`` computes the first
    half of each batch and hands its answers out for the other half too;
    ``answer_altered`` leaves one RT row of every window as the mixture."""

    def __init__(self, sampler, fault: str):
        self.sampler, self.fault = sampler, fault

    def __getattr__(self, name):
        return getattr(self.sampler, name)

    def predict(self, dataset, mixture_weights, num_steps, seed, device):
        import numpy as np

        (batch,) = dataset
        if self.fault == "half_batch":
            h = len(batch["ms2_1"]) // 2
            half = {k: v[:h] for k, v in batch.items()}
            pred = self.sampler.predict([half], mixture_weights, num_steps, seed, device)[0]["pred"]
            return [{"pred": np.concatenate([pred, pred])}]
        rec = self.sampler.predict(dataset, mixture_weights, num_steps, seed, device)[0]
        pred = rec["pred"].copy()
        r = pred.shape[1] // 2
        pred[:, r] = mixture_weights[0] * batch["ms2_1"][:, r] + \
            mixture_weights[1] * batch["ms2_2"][:, r]
        return [{"pred": pred}]


LATE_DRIFT = 1e4  # the factor on the mid attention's gradients of the planted late_drift


@contextlib.contextmanager
def planted(fault):
    """The harness's modes with ``fault`` planted in the program they build:
    a sampling fault of :class:`Faulty`; ``state_unchanged`` (a training
    step that leaves the parameters and moments as they were); and two
    faults that start after the first ``check.steps`` steps, as a backward
    does that goes wrong only once its values have grown: ``late_drift``
    (the gradients of the mid attention's leaves come out ``LATE_DRIFT``
    times too large) and ``late_double`` (every leaf's gradient counted
    twice)."""
    from cuda_bench.modes import sample, train

    if fault is None:
        yield
        return
    base = train.PortTrainer
    if fault == "state_unchanged":
        class Unchanged(base):
            def __init__(self, cell, P):
                super().__init__(cell, P)
                self.trainer.optimizer.adamw.step = lambda *a, **k: None

        mod, attr, value = train, "PortTrainer", Unchanged
    elif fault in ("late_drift", "late_double"):
        prefix, factor = ("mid_attn.fn.fn.", LATE_DRIFT) if fault == "late_drift" else ("", 2.0)

        class Late(base):
            def __init__(self, cell, P):
                super().__init__(cell, P)
                self.steps, n = 0, cell.workload["check"]["steps"]
                for name, (p, _) in self.leaves.items():
                    if name.startswith(prefix):
                        p.register_hook(lambda g: g * factor if self.steps > n else g)

            def step(self, *a):
                self.steps += 1
                return super().step(*a)

        mod, attr, value = train, "PortTrainer", Late
    else:
        build = sample.build
        mod, attr, value = sample, "build", lambda cell, P: Faulty(build(cell, P), fault)
    orig = getattr(mod, attr)
    setattr(mod, attr, value)
    try:
        yield
    finally:
        setattr(mod, attr, orig)


def run_small(name: str, fault=None, **kw) -> dict:
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        cell = small_cell(name, **kw)
        with planted(fault):
            return harness.mode(cell.workload["mode"]).run(cell, time.perf_counter())
    finally:
        torch.set_num_threads(threads)
