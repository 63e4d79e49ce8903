"""Training: ``Trainer.train_step`` on host pair batches, one step after
another.

Set-up builds the trainer with ``build_trainer`` (the cell's ``tpu``
block: bf16 on float32 masters, fused kernels, clip + AdamW + EMA), loads
the float32 weights the benchmark makes on the device from the seed, and
starts its state afresh (EMA = the weights). It then drives that trainer
through its first ``check.steps`` steps, on pair batches that all differ
and with timesteps and noise drawn from the seed, through the window's own
call; these steps are the warm-up. Before the next step it reads what the
comparison needs: each step's loss, each leaf's norm of the first clipped
gradient (AdamW's first moment after one step over 1 - beta1), and each
leaf's norm of its change and of its EMA's change since the start (the
start made again from the seed, chunk by chunk).

The window goes on stepping that same trainer; a CUDA event after each
step (no synchronize) times the steps on the device's timeline.

``correct``: once the trainer is freed, the plain float32 reference
follows the first steps from the same weights, batches and draws, and so
does the same reference with its products' operands rounded to bf16 (the
yardstick: how far bf16 alone moves this seed's numbers; at a small
timestep bf16 cannot resolve x_t's noise around -1, and a seed's first loss
moves by up to 10 % in bf16 itself). Compared
(:func:`~cuda_bench.harness.leaf_gaps`): ``grad_vs_bf16``, the median
leaf's gap of the first clipped gradient's norm over the yardstick's;
``change_vs_bf16``, the median leaf's gap of the change after the first
steps over the yardstick's (the worst leaf's, logged, swings with the
seed's timesteps in bf16 itself: at t = 60 the yardstick's read 0.31);
``ema_gap``, the median leaf's gap of the EMA's change (an EMA step moves
an O(1) leaf by under one float32 ulp, so its worst leaf is round-off).
Leaves whose reference gradient is under a thousandth of the median
leaf's move by round-off alone under Adam and are left out of the two
changes. The losses are logged, not compared (see ``PERF.md``).
"""

from __future__ import annotations

import math
import os
import time
from typing import Dict, List

import numpy as np
import torch

from .. import harness, trace
from ..clock import Stamp, Timed
from ..reference import ddim, unet1d as R
from ..reference.precision import Precision
from ..roofline import model as M
from ..traffic import generator
from ..weights import Weights, derive

B1 = 0.9  # the optimizer's first-moment decay (tpu.optimizer adamw, optax's b1)


def to_device(batch, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


class PortTrainer:
    """The program: a trainer from ``build_trainer`` on the benchmark's weights."""

    def __init__(self, cell, P):
        from dquartic_tpu_torch.utils.builder import build_trainer
        from dquartic_tpu_torch.utils.logging import NoOpLogger

        self.trainer = build_trainer(cell.program_config(), device=cell.device,
                                     seed=cell.seed % 2 ** 31, logger=NoOpLogger())
        self.trainer.model.load_state_dict(P)
        self.trainer.init_state()
        by_name = dict(zip(self.trainer.param_names, self.trainer.optimizer.params))
        ema = dict(zip(self.trainer.param_names, self.trainer.ema_params))
        self.leaves = {n: (by_name[n], ema[n]) for n in P}

    def step(self, batch, lr, t, eps):
        return self.trainer.train_step(batch, lr, t=t, eps=eps)["loss"]

    def close(self) -> None:
        """Release the trainer's device memory (parameters, gradients,
        moments, EMA), whatever still refers to it."""
        t = self.trainer
        t.optimizer.adamw.state.clear()
        for p in t.model.parameters():
            p.grad = None
            p.data = torch.empty(0, device=p.device)
        t.ema_params = None
        self.leaves = None

    def first_grads(self) -> List[torch.Tensor]:
        st = self.trainer.optimizer.adamw.state
        nan = torch.tensor(float("nan"))
        return [st[p]["exp_avg"].norm() / (1 - B1) if p in st else nan
                for p, _ in self.leaves.values()]


class ReferenceTrainer:
    """The plain reference: float32 leaves, autograd, clip + AdamW + EMA;
    in the control its products run in fp8."""

    def __init__(self, cell, P, pc: Precision):
        self.u, self.pc, self.device = cell.unet, pc, cell.device
        self.names = list(P)
        self.params = [P[n].detach().requires_grad_(True) for n in self.names]
        self.opt = ddim.AdamW(self.params, ema_decay=cell.workload["tpu"]["ema_decay"])
        self.leaves = {n: (p, e) for n, p, e in zip(self.names, self.params, self.opt.ema)}
        self.first = None

    def step(self, batch, lr, t, eps):
        P = dict(zip(self.names, self.params))
        fwd = lambda *a: R.forward(P, self.u, *a, pc=self.pc)  # noqa: E731
        loss = ddim.train_loss(fwd, to_device(batch, self.device), t, eps)
        grads = torch.autograd.grad(loss, self.params)
        clipped = self.opt.step(list(grads), lr)
        if self.first is None:
            self.first = [g.norm() for g in clipped]
        del grads, clipped
        return loss.detach()

    def first_grads(self) -> List[torch.Tensor]:
        return self.first

    def close(self) -> None:
        for p in self.params:
            p.data = torch.empty(0, device=p.device)
        self.opt.m = self.opt.v = self.opt.ema = self.leaves = None


def read_first(trainer, n_steps, steps_fn) -> dict:
    """Drive ``trainer`` through its first ``n_steps`` steps and read the
    comparison's numbers of each leaf."""
    losses, first = [], None
    for k in range(n_steps):
        losses.append(steps_fn(trainer, k))
        if k == 0:
            first = torch.stack([g.float().reshape(()).cpu() for g in trainer.first_grads()])
    return dict(losses=losses, first=first)


def changes(trainer, weights: Weights):
    """Each leaf's norm of its change and of its EMA's change from the
    start (made again from the seed)."""
    ch, ema = [], []
    with torch.no_grad():
        for name, w0 in weights.leaves():
            p, e = trainer.leaves[name]
            ch.append(float(torch.linalg.vector_norm(p.detach().float() - w0)))
            ema.append(float(torch.linalg.vector_norm(e.float() - w0)))
    return ch, ema


def run(cell, t_process: float) -> dict:
    dev, u, tr = cell.device, cell.unet, cell.traffic
    cuda = torch.device(dev).type == "cuda"
    b, rt, mz = tr["batch"], tr["rt"], u["downsample_dim"]
    shapes = R.param_shapes(u)
    weights = Weights(shapes, cell.seed, dev)
    lr = float(np.float32(cell.config["model"]["learning_rate"]))
    n_check = cell.workload["check"]["steps"]

    # ---- set-up ----------------------------------------------------------
    P = weights.make()
    harness.mark(t_process, "weights", dev)
    if cell.program == "control":
        trainer = ReferenceTrainer(cell, P, Precision("fp8"))
    else:
        trainer = PortTrainer(cell, P)
    del P
    harness.free(dev)
    harness.mark(t_process, "trainer", dev)
    pool = generator.pool(tr, mz, derive(cell.seed, "traffic"), dev)
    harness.mark(t_process, "traffic", dev)
    g = torch.Generator(device=dev).manual_seed(derive(cell.seed, "draws"))
    T = cell.config["model"]["num_timesteps"]

    def draw():
        return (torch.randint(0, T, (b,), generator=g, device=dev),
                torch.randn((b, rt, mz), generator=g, device=dev))

    draws = [draw() for _ in range(n_check)]

    def step(tr_, k, t=None, eps=None):
        with torch.profiler.record_function("bench.step"):
            if t is None:
                t, eps = draw() if k >= n_check else draws[k]
            return tr_.step(pool[k % len(pool)], lr, t, eps)

    first = read_first(trainer, n_check, step)
    harness.mark(t_process, "first steps", dev)
    change, ema_change = changes(trainer, weights)
    harness.sync(dev)
    setup_s = time.perf_counter() - t_process
    harness.mark(t_process, "changes read")
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    timed = None
    if cell.trace and isinstance(trainer, PortTrainer):
        opt = trainer.trainer.optimizer
        timed = opt.step = Timed(opt.step, "bench.optimizer", dev)

    # ---- the window --------------------------------------------------------
    ends, losses = [], []
    k = n_check
    t0 = time.perf_counter()
    while len(ends) < 2 or time.perf_counter() - t0 < cell.seconds:
        losses.append(step(trainer, k))
        ends.append(Stamp(dev))
        k += 1
    harness.sync(dev)
    gaps = [a.ms_to(c) for a, c in zip(ends, ends[1:])]
    device_s = sum(gaps) / 1e3
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    srt = sorted(gaps)
    harness.log(f"window: {len(ends)} steps, {device_s:.4f} s on the device's timeline, "
                f"{time.perf_counter() - t0:.4f} s on the host's; a step's ms: min {srt[0]:.3f}, "
                f"median {srt[len(srt) // 2]:.3f}, max {srt[-1]:.3f}")

    rec = None
    if cell.trace:
        optimizer_ms = timed.mean_ms() if timed else None
        if timed:
            opt.step = timed.fn

        def one_step(sl, i):
            sl.start()
            step(trainer, i)

        sl = trace.measure(one_step, os.path.join(harness.OUT_DIR, f"{cell.name}.{cell.seed}"), k)
        rec = dict(unet=u, b=b, rt=rt, train=True, forwards=1, backwards=1, slice=sl,
                   optimizer_ms=optimizer_ms,
                   window=dict(flops=(len(ends) - 1) * 3 * M.forward_flops(u, b, rt),
                               seconds=device_s))
    losses = torch.stack([x.float().reshape(()) for x in losses]).cpu()
    failed = int((~torch.isfinite(losses)).sum())
    prog = dict(losses=[float(x) for x in first["losses"]], first=first["first"].tolist(),
                change=change, ema=ema_change)
    trainer.close()
    del trainer, timed, first
    harness.free(dev)
    if cuda:
        harness.log(f"before the reference: {torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB "
                    f"allocated")

    numbers = check(cell, prog, pool, draws, lr, weights)
    return dict(
        e2e={"setup_s": setup_s, "train_samples_per_s": (len(ends) - 1) * b / device_s,
             "train_step_ms_p90": harness.quantile(gaps, 90),
             "peak_mem_gib": window_peak / 2 ** 30},
        memory_peak_bytes=window_peak, attempted=len(ends), failed=failed,
        numbers=numbers, rec=rec)


def follow(cell, pool, draws, lr, weights: Weights, precision: str) -> dict:
    """The reference, its products in ``precision``, through the first
    steps: each step's loss and each leaf's first gradient, change and EMA
    change."""
    ref = ReferenceTrainer(cell, weights.make(), Precision(precision))
    r = read_first(ref, len(draws), lambda tr_, k: tr_.step(pool[k % len(pool)], lr, *draws[k]))
    change, ema = changes(ref, weights)
    ref.close()
    del ref
    harness.free(cell.device)
    return dict(losses=[float(x) for x in r["losses"]], first=r["first"].tolist(),
                change=change, ema=ema)


def check(cell, prog, pool, draws, lr, weights: Weights) -> dict:
    """The float32 reference through the same first steps, and the same in
    bf16 (the yardstick of the seed's own bf16 error); the gaps."""
    t_start = time.perf_counter()
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        ref = follow(cell, pool, draws, lr, weights, "float32")
        yard = follow(cell, pool, draws, lr, weights, "bf16")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    r_first = ref["first"]
    gap_of = lambda side: harness.gap_of_norms(side["first"], r_first)  # noqa: E731
    med = float(np.median(r_first))
    moved = [g >= 1e-3 * med for g in r_first]

    def loss_gap(side):
        return max(abs(p - q) / abs(q) if math.isfinite(p) else math.inf
                   for p, q in zip(side["losses"], ref["losses"]))

    out = [n for n, m in zip(weights.shapes, moved) if not m]
    names = list(weights.shapes)
    gp, gy = harness.median_gap(prog["first"], r_first), harness.median_gap(yard["first"], r_first)
    harness.log(f"check: losses {prog['losses']}, the reference's {ref['losses']}, in bf16 "
                f"{yard['losses']}: loss gap {loss_gap(prog)}, in bf16 {loss_gap(yard)}; median "
                f"leaf's first-gradient gap {gp}, in bf16 {gy}; worst leaf's {gap_of(prog)}, in "
                f"bf16 {gap_of(yard)}; {len(out)} leaves left out of the changes {out[:8]}; "
                f"reference {time.perf_counter() - t_start:.2f} s")
    harness.log(f"timesteps {[int(t) for t, _ in draws]}")
    harness.log(f"worst gradient leaves: "
                f"{harness.worst_leaves(prog['first'], r_first, names, yard=yard['first'])}")
    harness.log(f"worst change leaves: "
                f"{harness.worst_leaves(prog['change'], ref['change'], names, moved, yard=yard['change'])}")
    harness.log(f"change gaps: worst leaf {harness.gap_of_norms(prog['change'], ref['change'], moved)}, "
                f"in bf16 {harness.gap_of_norms(yard['change'], ref['change'], moved)}")
    cp, cy = (harness.median_gap(side["change"], ref["change"], moved) for side in (prog, yard))
    return {"grad_vs_bf16": gp / max(gy, 1e-30), "change_vs_bf16": cp / max(cy, 1e-30),
            "ema_gap": harness.median_gap(prog["ema"], ref["ema"], moved)}
