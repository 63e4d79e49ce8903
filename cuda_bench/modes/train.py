"""Training: ``Trainer.train_step`` on host pair batches, one step after
another.

Set-up builds the trainer with ``build_trainer`` (the cell's ``tpu``
block: bf16 on float32 masters, fused kernels, clip + AdamW + EMA), loads
the float32 weights the benchmark makes on the device from the seed, and
starts its state afresh (EMA = the weights). It then drives that trainer
through its first ``check.steps`` steps, on pair batches that all differ
and with timesteps and noise drawn from the seed, through the window's own
call and feed; these steps are the warm-up. Before the next step it reads what the
comparison needs: each step's loss, each leaf's norm of the first clipped
gradient (AdamW's first moment after one step over 1 - beta1), and each
leaf's norm of its change and of its EMA's change since the start (the
start made again from the seed, chunk by chunk).

The feed is the one ``build_dataset`` gives a trainer: the pool's numpy
batches in turn through the program's ``prefetch_iterator``, ``tpu.prefetch``
deep, pinned and copied to the card on a thread of its own, so no step
waits for the card to drain before its batch is copied (a pageable copy
would). The window goes on stepping that same trainer from that same
feed; a CUDA event after each step (no synchronize) times the steps on the
device's timeline. Each step's gradient norm before clipping is logged
after the window.

``correct`` compares the start of the run and its end.

The end of the window: once the window (and a traced run's slice) is
over, the program computes one more gradient at the state the window left,
through its own forward and backward as ``Trainer.train_step`` runs them
(``process.train_loss``, then ``loss.backward()``), and takes no optimizer
step. The batch is one more of the pool; its timesteps and noise come from
their own stream of the seed (``"late"``). The program's gradients,
moments and EMA are then freed, and its float32 masters at that state go to
the plain float32 reference and to the yardstick (the same reference with
its products' operands rounded to bf16), which compute the same gradient
on the same batch and draws. Compared: ``late_grad_vs_bf16``, the median
leaf's gap of the unclipped gradient's norm over the yardstick's, and
``late_norm_vs_bf16``, the gap of the whole gradient's norm over the
yardstick's, the yardstick's taken as the larger of its own whole-norm gap
and its median leaf's gap (a fault confined to a few leaves, such as
attention with large logits, moves the whole norm and not the median
leaf; and one number of the yardstick can land on the reference's by
chance, to 1e-5 of it, where its leaves do not). This part
follows the program from the program's own state: the start is held
apart, below. It runs after the window's peak memory is read, so it moves
no end-to-end metric.

The start: once the trainer is freed, the plain float32 reference
follows the first steps from the same weights, batches and draws, and so
does the yardstick (how far bf16 alone moves this seed's numbers; at a
small timestep bf16 cannot resolve x_t's noise around -1, and a seed's
first loss moves by up to 10 % in bf16 itself). Compared
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

import contextlib
import itertools
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
        self.grad_norms: List[torch.Tensor] = []

    def feed(self, pool, depth: int):
        """The pool's batches in turn through the program's prefetch, as
        ``build_dataset`` hands them to ``Trainer.train``."""
        from dquartic_tpu_torch.data import prefetch_iterator

        return iter(prefetch_iterator(Cycle(pool), self.trainer.device, size=depth))

    def step(self, batch, lr, t, eps):
        out = self.trainer.train_step(batch, lr, t=t, eps=eps)
        self.grad_norms.append(out["grad_norm"])
        return out["loss"]

    def grads(self, batch, t, eps):
        """The loss and each leaf's unclipped gradient at the trainer's
        state, through the forward and backward of ``Trainer.train_step``;
        no optimizer step, no EMA."""
        tr = self.trainer
        b = tr._device_batch(batch)
        w0, w1 = tr.mixture_weights
        tr.optimizer.zero_grad()
        loss, _ = tr.process.train_loss(tr._denoise, b["ms2_1"], w0 * b["ms2_1"] + w1 * b["ms2_2"],
                                        b["ms1_1"], t=t, eps=eps)
        loss.backward()
        return loss.detach(), [p.grad for p, _ in self.leaves.values()]

    def masters(self) -> Dict[str, torch.Tensor]:
        """Free the gradients, moments and EMA; the float32 masters by name."""
        t = self.trainer
        t.optimizer.zero_grad()
        t.optimizer.adamw.state.clear()
        t.ema_params = None
        self.leaves = {n: (p, None) for n, (p, _) in self.leaves.items()}
        return {n: p.detach() for n, (p, _) in self.leaves.items()}

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
        self.grad_norms: List[torch.Tensor] = []

    def feed(self, pool, depth: int):
        return iter(Cycle(pool))

    def grads(self, batch, t, eps):
        return loss_and_grads(self.u, dict(zip(self.names, self.params)), batch, t, eps, self.pc,
                              self.device)

    def step(self, batch, lr, t, eps):
        loss, grads = self.grads(batch, t, eps)
        self.grad_norms.append(whole_norm(grads))
        clipped = self.opt.step(grads, lr)
        if self.first is None:
            self.first = [g.norm() for g in clipped]
        del grads, clipped
        return loss

    def masters(self) -> Dict[str, torch.Tensor]:
        self.opt.m = self.opt.v = self.opt.ema = None
        self.leaves = {n: (p, None) for n, p in zip(self.names, self.params)}
        return {n: p.detach() for n, p in zip(self.names, self.params)}

    def first_grads(self) -> List[torch.Tensor]:
        return self.first

    def close(self) -> None:
        for p in self.params:
            p.data = torch.empty(0, device=p.device)
        self.opt.m = self.opt.v = self.opt.ema = self.leaves = None


class Cycle:
    """The pool's batches in turn, without end: the run's step k takes
    ``pool[k % len(pool)]``."""

    def __init__(self, pool):
        self.pool = pool

    def __iter__(self):
        return (self.pool[k % len(self.pool)] for k in itertools.count())


def loss_and_grads(u, P: Dict[str, torch.Tensor], batch, t, eps, pc: Precision, device):
    """The plain reference's loss and each leaf's gradient at ``P``, its
    products in ``pc``."""
    fwd = lambda *a: R.forward(P, u, *a, pc=pc)  # noqa: E731
    loss = ddim.train_loss(fwd, to_device(batch, device), t, eps)
    return loss.detach(), list(torch.autograd.grad(loss, list(P.values())))


def whole_norm(grads) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))


def leaf_norms(grads) -> List[float]:
    """Each leaf's norm (0 where the leaf has no gradient), on the host."""
    dev = next(g.device for g in grads if g is not None)
    return torch.stack([torch.zeros((), device=dev) if g is None else g.float().norm()
                        for g in grads]).cpu().tolist()


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
    feed = trainer.feed(pool, cell.workload["tpu"]["prefetch"])

    def step(tr_, k, t=None, eps=None):
        with torch.profiler.record_function("bench.step"):
            if t is None:
                t, eps = draw() if k >= n_check else draws[k]
            return tr_.step(next(feed), lr, t, eps)

    try:
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

        # ---- the window ----------------------------------------------------
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
                    f"{time.perf_counter() - t0:.4f} s on the host's; a step's ms: "
                    f"min {srt[0]:.3f}, median {srt[len(srt) // 2]:.3f}, max {srt[-1]:.3f}")

        rec = None
        if cell.trace:
            optimizer_ms = timed.mean_ms() if timed else None
            if timed:
                opt.step = timed.fn

            def one_step(sl, i):
                sl.start()
                step(trainer, i)

            sl = trace.measure(one_step,
                               os.path.join(harness.OUT_DIR, f"{cell.name}.{cell.seed}"), k)
            rec = dict(unet=u, b=b, rt=rt, train=True, forwards=1, backwards=1, slice=sl,
                       optimizer_ms=optimizer_ms,
                       window=dict(flops=(len(ends) - 1) * 3 * M.forward_flops(u, b, rt),
                                   seconds=device_s))
    finally:
        feed.close()  # stops and joins the prefetch thread
    losses = torch.stack([x.float().reshape(()) for x in losses]).cpu()
    failed = int((~torch.isfinite(losses)).sum())
    norms = torch.stack([x.float().reshape(()) for x in trainer.grad_norms]).cpu().tolist()
    harness.log("gradient norms before clipping, step by step from the first: "
                + " ".join(f"{x:.4g}" for x in norms))
    prog = dict(losses=[float(x) for x in first["losses"]], first=first["first"].tolist(),
                change=change, ema=ema_change)

    gl = torch.Generator(device=dev).manual_seed(derive(cell.seed, "late"))
    late_draws = (torch.randint(0, T, (b,), generator=gl, device=dev),
                  torch.randn((b, rt, mz), generator=gl, device=dev))
    late = late_check(cell, trainer, pool[k % len(pool)], *late_draws)
    trainer.close()
    del trainer, timed, first
    harness.free(dev)
    if cuda:
        harness.log(f"before the reference: {torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB "
                    f"allocated")

    numbers = {**check(cell, prog, pool, draws, lr, weights), **late}
    return dict(
        e2e={"setup_s": setup_s, "train_samples_per_s": (len(ends) - 1) * b / device_s,
             "train_step_ms_p90": harness.quantile(gaps, 90),
             "peak_mem_gib": window_peak / 2 ** 30},
        memory_peak_bytes=window_peak, attempted=len(ends), failed=failed,
        numbers=numbers, rec=rec)


@contextlib.contextmanager
def no_tf32():
    """TF32 off for the reference's float32 products, restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def late_check(cell, trainer, batch, t, eps) -> Dict[str, float]:
    """The gradient at the end of the window: the program's, through its
    own forward and backward; then, from the program's float32 masters
    with its gradients, moments and EMA freed, the float32 reference's and
    the yardstick's on the same batch and draws."""
    t_start = time.perf_counter()
    loss, grads = trainer.grads(batch, t, eps)
    prog, losses = leaf_norms(grads), [float(loss)]
    del loss, grads
    P = trainer.masters()
    harness.free(cell.device)
    sides = []
    with no_tf32():
        for precision in ("float32", "bf16"):
            leaves = {n: p.detach().requires_grad_(True) for n, p in P.items()}
            loss, grads = loss_and_grads(cell.unet, leaves, batch, t, eps, Precision(precision),
                                         cell.device)
            sides.append(leaf_norms(grads))
            losses.append(float(loss))
            del leaves, loss, grads
            harness.free(cell.device)
    names = list(P)
    del P
    ref, yard = sides
    whole = [math.sqrt(sum(x * x for x in side)) for side in (prog, ref, yard)]
    norm_gap = [abs(w - whole[1]) / whole[1] for w in whole]
    gp, gy = harness.median_gap(prog, ref), harness.median_gap(yard, ref)
    harness.log(f"late check: timesteps {t.tolist()}; losses {losses[0]}, the reference's "
                f"{losses[1]}, in bf16 {losses[2]}; whole gradient norms {whole[0]}, the "
                f"reference's {whole[1]}, in bf16 {whole[2]}: gaps {norm_gap[0]}, in bf16 "
                f"{norm_gap[2]}; median leaf's gap {gp}, in bf16 {gy}; "
                f"{time.perf_counter() - t_start:.2f} s")
    harness.log(f"late worst gradient leaves: {harness.worst_leaves(prog, ref, names, yard=yard)}")
    return {"late_grad_vs_bf16": gp / max(gy, 1e-30),
            "late_norm_vs_bf16": norm_gap[0] / max(norm_gap[2], gy, 1e-30)}


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
    with no_tf32():
        ref = follow(cell, pool, draws, lr, weights, "float32")
        yard = follow(cell, pool, draws, lr, weights, "bf16")
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
