"""Serving: ``DDIMSampler.predict`` in a closed loop with one caller.

Set-up makes the float32 weights on the device from the seed, builds the
serving model from them with ``build_model`` (the cell's ``tpu`` block:
precision, int8 mid convs, kernel path), draws the traffic's pool of host
pair batches, and warms up with one call. The window then calls
``predict`` on one pair batch after another, cycling the pool, each call
with its own noise seed; the next call goes when the previous one
returns, and the window ends with the last call that started inside it.

``correct``: once the program is freed, the plain float32 reference
(:mod:`cuda_bench.reference`) runs the 50-step reverse pass over a sample
of the windows the calls returned, drawn from the seed (one RT-row window
from each quarter of the batch, from calls drawn among those completed),
from the same weights (int8 mid convs derived again from them), windows
and noise; ``pred_gap`` is the worst window's relative L2 gap between the
program's ``pred`` and the reference's.
"""

from __future__ import annotations

import math
import os
import random
import time

import numpy as np
import torch

from .. import harness, trace
from ..clock import Timed
from ..reference import ddim, unet1d as R
from ..reference.precision import Precision
from ..roofline import model as M
from ..traffic import generator
from ..weights import Weights, derive


SLICE_FORWARDS = 8


def call_seed(seed: int, i: int) -> int:
    return derive(seed, "call", i)


def noise(seed: int, shape, device) -> torch.Tensor:
    """x_T of a call, drawn as ``DDIMSampler.predict_batch`` draws it."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, dtype=torch.float32, device=device)


class ControlSampler:
    """The reference in the program's place, its products in fp8."""

    def __init__(self, P, cell):
        self.P = R.int8_params(P) if cell.workload["tpu"].get("quantize_mid") else P
        self.u, self.device = cell.unet, cell.device
        self.pc = Precision("fp8")

    @torch.inference_mode()
    def predict(self, dataset, mixture_weights, num_steps, seed, device):
        (batch,) = dataset
        t = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        mix = mixture_weights[0] * t["ms2_1"] + mixture_weights[1] * t["ms2_2"]
        x = noise(seed, mix.shape, device)
        fwd = lambda *a: R.forward(self.P, self.u, *a, pc=self.pc)  # noqa: E731
        pred = ddim.sample(fwd, x, mix, t["ms1_1"], num_steps)
        return [{"pred": pred.cpu().numpy()}]


def build(cell, P):
    if cell.program == "control":
        return ControlSampler(P, cell)
    from dquartic_tpu_torch.infer.sampler import DDIMSampler
    from dquartic_tpu_torch.utils.builder import build_model, build_process

    config = cell.program_config()
    return DDIMSampler(build_model(config, device=cell.device, state_dict=P),
                       build_process(config))


def run(cell, t_process: float) -> dict:
    dev, u, tr = cell.device, cell.unet, cell.traffic
    cuda = torch.device(dev).type == "cuda"
    steps, b, rt, mz = cell.workload["num_steps"], tr["batch"], tr["rt"], u["downsample_dim"]
    weights = tr["mixture_weights"]
    shapes = R.param_shapes(u)

    # ---- set-up ----------------------------------------------------------
    P = Weights(shapes, cell.seed, dev).make()
    harness.mark(t_process, "weights", dev)
    sampler = build(cell, P)
    if cell.program != "control":
        del P
    harness.free(dev)
    harness.mark(t_process, "model", dev)
    pool = generator.pool(tr, mz, derive(cell.seed, "traffic"), dev)
    harness.mark(t_process, "traffic", dev)

    def call(i, batch):
        return sampler.predict([batch], mixture_weights=weights, num_steps=steps,
                               seed=call_seed(cell.seed, i), device=dev)[0]["pred"]

    call(-1, pool[-1])  # warm-up: every shape of the window, every kernel built
    harness.sync(dev)
    setup_s = time.perf_counter() - t_process
    harness.mark(t_process, "warm-up")
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    timed = None
    if cell.trace and cell.program == "port":
        timed = sampler.model = Timed(sampler.model, "bench.forward", dev)

    # ---- the window --------------------------------------------------------
    preds, ends = [], []
    t0 = time.perf_counter()
    while not preds or time.perf_counter() - t0 < cell.seconds:
        preds.append(call(len(preds), pool[len(preds) % len(pool)]))
        ends.append(time.perf_counter())
    window_s = ends[-1] - t0
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    n = len(preds)
    secs = sorted(b_ - a for a, b_ in zip([t0] + ends, ends))
    harness.log(f"window: {n} calls of {b} windows in {window_s:.4f} s; a call's s: min "
                f"{secs[0]:.4f}, median {secs[len(secs) // 2]:.4f}, max {secs[-1]:.4f}")

    rec = None
    if cell.trace:
        forward_ms = timed.mean_ms() if timed else None
        # each slice: the last SLICE_FORWARDS forwards of one more call, and
        # the call's end (the DDIM steps between them, the copies to the host)
        model = timed.fn if timed else sampler.model

        def one_call(sl, i):
            seen = []

            def opening(*args):
                if len(seen) == steps - SLICE_FORWARDS:
                    sl.start()
                seen.append(1)
                return model(*args)

            sampler.model = opening
            call(i, pool[i % len(pool)])
            sampler.model = model

        sl = trace.measure(one_call, os.path.join(harness.OUT_DIR, f"{cell.name}.{cell.seed}"), n)
        rec = dict(unet=u, b=b, rt=rt, train=False, forwards=SLICE_FORWARDS, backwards=0, slice=sl,
                   forward_ms=forward_ms,
                   window=dict(flops=n * steps * M.forward_flops(u, b, rt), seconds=window_s))
    del sampler, timed
    harness.free(dev)

    failed = sum(int(not np.isfinite(p[i]).all()) for p in preds for i in range(len(p)))
    numbers = check(cell, preds, pool, shapes)
    return dict(
        e2e={"setup_s": setup_s, "windows_per_s": n * b / window_s,
             "peak_mem_gib": window_peak / 2 ** 30},
        memory_peak_bytes=window_peak, attempted=n * b, failed=failed,
        numbers=numbers, rec=rec)


def picks(cell, n_calls: int, b: int):
    """(call, row) of the windows compared: one row from each of
    ``windows`` equal parts of the batch, each from a call drawn among the
    ``n_calls`` completed."""
    k = cell.workload["check"]["windows"]
    rng = random.Random(derive(cell.seed, "check"))
    part = b // k
    return [(rng.randrange(n_calls), j * part + rng.randrange(part)) for j in range(k)]


def check(cell, preds, pool, shapes) -> dict:
    """The reference over the sampled windows; ``pred_gap``."""
    dev, u, tr = cell.device, cell.unet, cell.traffic
    t_start = time.perf_counter()
    b, rt, mz = tr["batch"], tr["rt"], u["downsample_dim"]
    chosen = picks(cell, len(preds), b)
    P = Weights(shapes, cell.seed, dev).make()
    if cell.workload["tpu"].get("quantize_mid"):
        P = R.int8_params(P)
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        def rows(key):
            return torch.stack([torch.as_tensor(pool[c % len(pool)][key][r], device=dev)
                                for c, r in chosen])

        x = torch.stack([noise(call_seed(cell.seed, c), (b, rt, mz), dev)[r] for c, r in chosen])
        w = tr["mixture_weights"]
        mix = w[0] * rows("ms2_1") + w[1] * rows("ms2_2")
        with torch.inference_mode():
            ref = ddim.sample(lambda *a: R.forward(P, u, *a), x, mix, rows("ms1_1"),
                              cell.workload["num_steps"]).cpu().numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    gaps = []
    for (c, r), y in zip(chosen, ref):
        p = preds[c][r].astype(np.float64)
        gaps.append(float(np.linalg.norm(p - y) / max(np.linalg.norm(y), 1e-30)))
    harness.log(f"check: windows {chosen}, gaps {gaps}, max abs "
                f"{max(float(np.abs(preds[c][r] - y).max()) for (c, r), y in zip(chosen, ref))}, "
                f"reference {time.perf_counter() - t_start:.2f} s")
    return {"pred_gap": max(gaps) if all(map(math.isfinite, gaps)) else math.inf}
