"""Identifiability experiment on the PyTorch port (port of
scripts/run_identifiability.py): does the port's stack, trained on the card
for thousands of steps, learn to use its MS1 condition?

The same task, stack and readouts as the JAX script (read its docstring for
the design): 34 x ``IDF_MZ`` windows of 4 peptides whose MS1 trace is
exactly the sum of their RT profiles; the canonical 7-level UNet1d
(``generate_train_config``) trained in bf16 with fused ResnetBlocks, remat
and the factored optimizer through ``build_trainer``; every ``IDF_EVAL_EVERY``
steps the 50-step ``DDIMProcess.sample`` (``parity_neighbor_stepping``
off) of each eval pair conditioned on its own MS1 and on the other one's,
scored by ``sep50`` (the sample's peak energy on target-only cells over
target-only plus interferer-only; 0.5 = mixture-like, 1.0 = perfect),
``sep50_swap``, ``sep_mix_baseline``, ``cos50`` and the teacher-forced
``ms1_swap_rel``, with the trained weights and (``IDF_EMA``) the EMA.

The same env knobs, names and defaults as the JAX script (IDF_ROOT,
IDF_STEPS, IDF_TOTAL, IDF_BATCH, IDF_EVAL_EVERY, IDF_LR, IDF_WINDOWS,
IDF_MZ, IDF_RESUME, IDF_SAVE_EVERY, IDF_MS1W, IDF_PRED, IDF_WEIGHTING,
IDF_EMA, IDF_OVERFIT, IDF_INFINITE), and four of its own: ``IDF_DEVICE``:
the script runs on the CUDA card unless it names another device (``cpu``);
without a card and without it, it fails. ``IDF_COMPUTE_DTYPE``
(``bfloat16``, as the JAX script; ``float32``) and ``IDF_PLAIN=1`` (the
model's kernels off, its plain PyTorch versions on the card) run the same
seeds under other numerics, to tell numerics from training dynamics.
``IDF_SEED`` (0, the JAX script's ``build_trainer`` default) seeds the
trainer's initial weights, to tell one draw of them from another.

What differs from the JAX script, and why:

* Random draws come from ``torch.Generator``\\ s, not JAX keys. Step
  ``s`` draws its batch and its (t, eps) from two generators seeded from
  (20260820, s) (:func:`step_generators`), the JAX script's
  ``split(fold_in(PRNGKey(20260820), s))``, so a leg resumed with
  ``IDF_RESUME=1`` draws what the uninterrupted run draws.
* The on-device window generator (:func:`make_windows`) adds each
  fragment's five bins one fragment at a time, where the JAX script
  scatter-adds them all at once: fragments within four bins of each other
  collide, and an accumulating scatter with repeated indices sums in the
  order its atomics land on a CUDA card. One fragment a row per call has
  no repeated index, so the same generator state gives bitwise the same
  windows.
* The checkpoints (``state.ckpt``, ``state_best.ckpt``) are the port's
  ``save_checkpoint`` files: ``global_step`` and the whole train state
  (parameters, the factored optimizer's statistics, EMA, step).
* The losses stay on the device and are read every 500 steps, as in the
  JAX script; nothing else reads the device inside the loop.

Run on the card (the overfit control, then the infinite-data leg)::

    IDF_ROOT=runs/overfit IDF_OVERFIT=1 IDF_PRED=x0 IDF_WEIGHTING=uniform \\
        IDF_STEPS=6000 IDF_EVAL_EVERY=1000 python scripts/run_identifiability_torch.py
    IDF_ROOT=runs/inf IDF_INFINITE=1 IDF_PRED=x0 IDF_WEIGHTING=uniform IDF_EMA=0.999 \\
        IDF_STEPS=12000 IDF_TOTAL=24000 python scripts/run_identifiability_torch.py
    IDF_ROOT=runs/inf ... IDF_RESUME=1 python scripts/run_identifiability_torch.py

and ``IDF_DEVICE=cpu`` with a small ``IDF_MZ`` (a multiple of 64) on the CPU.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ROOT = os.environ.get("IDF_ROOT", os.path.join(tempfile.gettempdir(), "identifiability"))
STEPS = int(os.environ.get("IDF_STEPS", "24000"))
TOTAL = int(os.environ.get("IDF_TOTAL", str(STEPS)))
BATCH = int(os.environ.get("IDF_BATCH", "8"))
EVAL_EVERY = int(os.environ.get("IDF_EVAL_EVERY", "3000"))
BASE_LR = float(os.environ.get("IDF_LR", "1.5e-4"))
N_WINDOWS = int(os.environ.get("IDF_WINDOWS", "18"))
SAVE_EVERY = int(os.environ.get("IDF_SAVE_EVERY", str(EVAL_EVERY)))
MS1W = float(os.environ.get("IDF_MS1W", "0.0"))
PRED = os.environ.get("IDF_PRED", "eps")
WEIGHTING = os.environ.get("IDF_WEIGHTING", "reference")
EMA = os.environ.get("IDF_EMA", "")
OVERFIT = os.environ.get("IDF_OVERFIT") == "1"
INFINITE = os.environ.get("IDF_INFINITE") == "1"
RESUME = os.environ.get("IDF_RESUME") == "1"
DEVICE = os.environ.get("IDF_DEVICE") or None
COMPUTE_DTYPE = os.environ.get("IDF_COMPUTE_DTYPE", "bfloat16")
PLAIN = os.environ.get("IDF_PLAIN") == "1"
SEED = int(os.environ.get("IDF_SEED", "0"))
RT, MZ = 34, int(os.environ.get("IDF_MZ", "2560"))
N_HELD = 2

STEP_KEY = 20260820  # the JAX script's PRNGKey of the loop
EVAL_NOISE_SEED = 99  # and of the eval noise
WINDOW_SEED = 7  # np.random.default_rng of the fixed window set
MAX_FRAGMENTS = 12
PEAK_SHAPE = (0.1, 0.5, 1.0, 0.5, 0.1)  # a fragment's five bins, offsets -2 .. 2
LOSS_EVERY = 500


@dataclasses.dataclass
class Knobs:
    """The run's settings; the defaults are the ``IDF_*`` knobs."""

    root: str = ROOT
    steps: int = STEPS
    total: int = TOTAL
    batch: int = BATCH
    eval_every: int = EVAL_EVERY
    lr: float = BASE_LR
    windows: int = N_WINDOWS
    save_every: int = SAVE_EVERY
    ms1w: float = MS1W
    pred: str = PRED
    weighting: str = WEIGHTING
    ema: str = EMA
    overfit: bool = OVERFIT
    infinite: bool = INFINITE
    resume: bool = RESUME
    mz: int = MZ
    device: Optional[str] = DEVICE
    compute_dtype: str = COMPUTE_DTYPE
    plain: bool = PLAIN
    seed: int = SEED

    @property
    def mode(self) -> str:
        return "overfit" if self.overfit else ("infinite" if self.infinite else "heldout")

    @property
    def n_train(self) -> int:
        return 2 if self.overfit else self.windows - N_HELD


# --------------------------------------------------------------------- #
# data                                                                  #
# --------------------------------------------------------------------- #


def make_window(rng, n_pep=4, mz=MZ, rt=RT):
    """Sparse MS2 window + an MS1 trace that is exactly the summed RT
    profile of its peptides (fully informative conditioning)."""
    W = np.zeros((rt, mz), np.float32)
    ms1 = np.zeros((rt,), np.float32)
    t = np.arange(rt)
    for _ in range(n_pep):
        c = rng.uniform(3, rt - 3)
        s = rng.uniform(1.2, 2.5)
        prof = np.exp(-0.5 * ((t - c) / s) ** 2).astype(np.float32)
        n_frag = int(rng.integers(5, 12))
        pos = rng.integers(20, mz - 20, n_frag)
        inten = rng.lognormal(0.0, 0.8, n_frag).astype(np.float32)
        spec = np.zeros(mz, np.float32)
        shape = np.array([0.1, 0.5, 1.0, 0.5, 0.1], np.float32)
        for p, a in zip(pos, inten):
            spec[p - 2 : p + 3] += a * shape
        amp = float(rng.lognormal(0.0, 0.4))
        W += amp * np.outer(prof, spec)
        ms1 += amp * prof
    return W, ms1


def window_set(n_windows: int, mz: int):
    """The fixed (n_windows, RT, mz) MS2 windows and (n_windows, RT) MS1
    traces of the JAX script (``default_rng(7)``; the last two held out)."""
    rng = np.random.default_rng(WINDOW_SEED)
    ws, m1s = zip(*(make_window(rng, mz=mz) for _ in range(n_windows)))
    return np.stack(ws), np.stack(m1s)


def draw_windows(generator, n: int, mz: int, n_pep: int = 4) -> Dict[str, "torch.Tensor"]:
    """The random draws of :func:`make_windows` for ``n`` windows, on the
    generator's device, in the JAX generator's distributions: RT centres
    U(3, RT-3), widths U(1.2, 2.5), 5-11 fragments at m/z bins in [20,
    mz-20), log-intensities N(0, 0.8²) and log-amplitudes N(0, 0.4²)."""
    import torch

    dev = generator.device
    kw = dict(generator=generator, device=dev)
    return dict(
        c=torch.empty((n, n_pep), device=dev).uniform_(3.0, RT - 3.0, generator=generator),
        s=torch.empty((n, n_pep), device=dev).uniform_(1.2, 2.5, generator=generator),
        nf=torch.randint(5, 12, (n, n_pep), **kw),
        pos=torch.randint(20, mz - 20, (n, n_pep, MAX_FRAGMENTS), **kw),
        z_int=torch.randn((n, n_pep, MAX_FRAGMENTS), **kw),
        z_amp=torch.randn((n, n_pep), **kw),
    )


def assemble_windows(draws: Dict[str, "torch.Tensor"], mz: int):
    """(n, RT, mz) MS2 windows and their (n, RT) MS1 traces from
    :func:`draw_windows`' draws (the JAX script's ``make_windows_jax``,
    run_identifiability.py:197-223). Each fragment's five bins are added
    one fragment at a time (no repeated index in a call, so no sum in an
    order that varies), and the peptides are summed in order: the same
    draws give bitwise the same windows. Returns ``(W, M, aprof)``, M
    exactly the sum over peptides of the amplitude-scaled profiles
    ``aprof`` (n, n_pep, RT)."""
    import torch

    c, s, nf, pos = draws["c"], draws["s"], draws["nf"], draws["pos"]
    n, n_pep = c.shape
    dev = c.device
    t = torch.arange(RT, dtype=torch.float32, device=dev)
    prof = torch.exp(-0.5 * ((t[None, None, :] - c[..., None]) / s[..., None]) ** 2)
    inten = torch.exp(0.8 * draws["z_int"])
    inten = inten * (torch.arange(MAX_FRAGMENTS, device=dev)[None, None, :] < nf[..., None])
    rows = torch.arange(n * n_pep, device=dev)
    posf = pos.reshape(n * n_pep, MAX_FRAGMENTS)
    intf = inten.reshape(n * n_pep, MAX_FRAGMENTS)
    shape = torch.tensor(PEAK_SHAPE, dtype=torch.float32, device=dev)
    spec = torch.zeros((n * n_pep, mz), dtype=torch.float32, device=dev)
    for k, off in enumerate(range(-2, 3)):
        for f in range(MAX_FRAGMENTS):
            spec[rows, posf[:, f] + off] += shape[k] * intf[:, f]
    spec = spec.reshape(n, n_pep, mz)
    amp = torch.exp(0.4 * draws["z_amp"])
    aprof = amp[..., None] * prof
    W = aprof[:, 0, :, None] * spec[:, 0, None, :]
    M = aprof[:, 0]
    for p in range(1, n_pep):
        W = W + aprof[:, p, :, None] * spec[:, p, None, :]
        M = M + aprof[:, p]
    return W, M, aprof


def make_windows(generator, n: int, mz: int, n_pep: int = 4):
    """On-device analogue of :func:`make_window`: fresh (n, RT, mz) MS2
    maps with their exact summed-profile MS1 traces (the IDF_INFINITE data
    stream: no fixed window set to memorize)."""
    W, M, _ = assemble_windows(draw_windows(generator, n, mz, n_pep), mz)
    return W, M


def pair_batch(a2, b2, a1, b1) -> Dict[str, "torch.Tensor"]:
    """A pair batch with the dataset's pairwise min-max semantics
    (data/dataset.py ``sample_pair``): both MS2 maps of a pair scaled by
    their joint range, both MS1 traces by the first one's."""
    import torch

    lo = torch.minimum(a2.amin(dim=(1, 2)), b2.amin(dim=(1, 2)))[:, None, None]
    hi = torch.maximum(a2.amax(dim=(1, 2)), b2.amax(dim=(1, 2)))[:, None, None]
    s = torch.clamp(hi - lo, min=1e-12)
    l1 = a1.amin(dim=1, keepdim=True)
    s1 = torch.clamp(a1.amax(dim=1, keepdim=True) - l1, min=1e-12)
    return {
        "ms2_1": (a2 - lo) / s,
        "ms1_1": (a1 - l1) / s1,
        "ms2_2": (b2 - lo) / s,
        "ms1_2": (b1 - l1) / s1,  # reference scales ms1_2 off split 1
    }


def pair_indices(generator, batch: int, n_train: int, overfit: bool):
    """The (i, j) window indices of a batch: random distinct pairs of the
    training windows, or in overfit mode the one fixed pair in both
    directions."""
    import torch

    dev = generator.device
    if overfit:
        i = torch.arange(2, device=dev).repeat(batch // 2 + 1)[:batch]
        return i, 1 - i
    i = torch.randint(0, n_train, (batch,), generator=generator, device=dev)
    j = torch.randint(0, n_train - 1, (batch,), generator=generator, device=dev)
    return i, torch.where(j >= i, j + 1, j)


def make_batch(dm2, dm1, generator, batch: int, n_train: int, overfit: bool):
    """Pair batch of the fixed window set ``dm2`` (n, RT, mz), ``dm1``
    (n, RT) on the device."""
    i, j = pair_indices(generator, batch, n_train, overfit)
    return pair_batch(dm2[i], dm2[j], dm1[i], dm1[j])


def make_batch_inf(generator, batch: int, mz: int):
    """IDF_INFINITE: a fresh window pair per batch element, same pairwise
    min-max semantics; the generator runs on the device."""
    W, M = make_windows(generator, 2 * batch, mz)
    return pair_batch(W[:batch], W[batch:], M[:batch], M[batch:])


def step_generators(step: int, device) -> Tuple["torch.Generator", "torch.Generator"]:
    """The batch's and the step's (t, eps) generators of global step
    ``step``, seeded from (20260820, step): a resumed leg draws what the
    uninterrupted run draws."""
    import torch

    base = (STEP_KEY << 32) + 2 * step
    return (torch.Generator(device=device).manual_seed(base),
            torch.Generator(device=device).manual_seed(base + 1))


def learning_rate(step: int, base_lr: float, total: int) -> float:
    """Cosine from ``base_lr`` to the 1e-5 floor over ``total`` global
    steps, a float32 value on the host."""
    return float(np.float32(1e-5 + 0.5 * (base_lr - 1e-5) * (1.0 + np.cos(np.pi * step / total))))


# --------------------------------------------------------------------- #
# metrics                                                               #
# --------------------------------------------------------------------- #


def cosine(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


def separation(pred, target, other, tau=0.05):
    """Peak-energy separation: of the sample's energy on cells that
    belong to exactly one component's peaks, the fraction on the
    TARGET's. 0.5 = mixture-like (no separation), 1.0 = perfect."""
    t = np.asarray(target, np.float64).ravel()
    o = np.asarray(other, np.float64).ravel()
    p = np.clip(np.asarray(pred, np.float64).ravel(), 0.0, None)
    t_mask = (t > tau * t.max()) & (o <= tau * o.max())
    o_mask = (o > tau * o.max()) & (t <= tau * t.max())
    et, eo = float(p[t_mask].sum()), float(p[o_mask].sum())
    return et / (et + eo + 1e-12)


def _pair(ms2, ms1, i, j, device):
    """The eval pair (i target, j interferer), each (1, ...) on ``device``:
    target and interferer scaled by their joint range, their 0.5/0.5
    mixture, and both MS1 traces min-max scaled."""
    import torch

    lo = min(ms2[i].min(), ms2[j].min())
    hi = max(ms2[i].max(), ms2[j].max())
    nm = lambda a: (a - lo) / max(hi - lo, 1e-12)  # noqa: E731
    target = torch.from_numpy(nm(ms2[i])).to(device)[None]
    other = torch.from_numpy(nm(ms2[j])).to(device)[None]
    mix = 0.5 * target + 0.5 * other
    m1 = lambda k: torch.from_numpy(  # noqa: E731
        (ms1[k] - ms1[k].min()) / max(ms1[k].max() - ms1[k].min(), 1e-12)
    ).to(device)[None]
    return target, other, mix, m1(i), m1(j)


def eval_pairs(knobs: Knobs):
    """(tag, target, interferer) of the eval: both directions of the one
    pair in overfit mode; else the held-out pair, reversed, and one
    training pair."""
    if knobs.overfit:
        return [("train", 0, 1), ("train_rev", 1, 0)]
    n = knobs.n_train
    return [("held", n, n + 1), ("held_rev", n + 1, n), ("train", 0, 1)]


# --------------------------------------------------------------------- #
# the experiment                                                        #
# --------------------------------------------------------------------- #


@dataclasses.dataclass
class Experiment:
    """What the loop and the eval share: the knobs, the fixed windows (host
    and device), the config, the trainer and the eval process and noise."""

    knobs: Knobs
    device: object
    ms2: np.ndarray
    ms1: np.ndarray
    config: dict
    trainer: object
    process_eval: object
    eval_noise: object
    d_ms2: object = None
    d_ms1: object = None


def write_config(knobs: Knobs, edit: Optional[Callable[[dict], None]] = None) -> dict:
    """``<root>/config.json``: the generated canonical config with the JAX
    script's edits (m/z width, remat, batch, MS1 loss weight, prediction
    type, bf16 unless ``knobs.compute_dtype``, factored optimizer, fused
    ResnetBlocks, EMA, loss weighting), then ``edit`` of the config dict
    (tests cut the depth)."""
    from dquartic_tpu_torch.utils.config import generate_train_config, load_train_config

    os.makedirs(knobs.root, exist_ok=True)
    cfg_path = f"{knobs.root}/config.json"
    generate_train_config(cfg_path)
    with open(cfg_path) as f:
        config = json.load(f)
    unet = config["model"]["UNet1d"]
    unet["downsample_dim"] = knobs.mz
    unet["remat_blocks"] = True
    config["model"]["batch_size"] = knobs.batch
    config["model"]["ms1_loss_weight"] = knobs.ms1w
    config["model"]["pred_type"] = knobs.pred
    config["wandb"]["use_wandb"] = False
    config["tpu"].update(
        compute_dtype=knobs.compute_dtype,
        optimizer="factored",
        fused_resnet=True,
        ema_decay=float(knobs.ema) if knobs.ema else None,
        loss_weighting=knobs.weighting,
    )
    if edit is not None:
        edit(config)
    with open(cfg_path, "w") as f:
        json.dump(config, f, indent=1)
    return load_train_config(cfg_path)


def setup(knobs: Knobs, edit: Optional[Callable[[dict], None]] = None) -> Experiment:
    """Windows, config, trainer and eval inputs of a run; the device is
    ``knobs.device``, or the card (raises without one); ``knobs.plain``
    turns the model's kernels off."""
    import torch

    from dquartic_tpu_torch.utils.builder import build_process, build_trainer
    from dquartic_tpu_torch.utils.device import resolve_device

    device = resolve_device(knobs.device, "run_identifiability_torch")
    ms2, ms1 = window_set(knobs.windows, knobs.mz)
    config = write_config(knobs, edit)
    trainer = build_trainer(config, device=device, seed=knobs.seed)
    if knobs.plain:
        trainer.model.use_kernels(False)
    process_eval = dataclasses.replace(build_process(config), parity_neighbor_stepping=False)
    gen = torch.Generator(device=device).manual_seed(EVAL_NOISE_SEED)
    eval_noise = torch.randn((1, RT, knobs.mz), generator=gen, device=device)
    exp = Experiment(knobs, device, ms2, ms1, config, trainer, process_eval, eval_noise)
    if not knobs.infinite:
        exp.d_ms2 = torch.from_numpy(ms2[: knobs.n_train]).to(device)
        exp.d_ms1 = torch.from_numpy(ms1[: knobs.n_train]).to(device)
    return exp


def batch_for(exp: Experiment, generator):
    k = exp.knobs
    if k.infinite:
        return make_batch_inf(generator, k.batch, k.mz)
    return make_batch(exp.d_ms2, exp.d_ms1, generator, k.batch, k.n_train, k.overfit)


def train_step(exp: Experiment, step: int):
    """Global step ``step``: its batch, (t, eps) and learning rate; returns
    the loss on the device."""
    gb, gr = step_generators(step, exp.device)
    lr = learning_rate(step, exp.knobs.lr, exp.knobs.total)
    return exp.trainer.train_step(batch_for(exp, gb), lr, generator=gr)["loss"]


def sample50(exp: Experiment, params, x_t, mix, m1):
    """The 50-step ``DDIMProcess.sample`` of the eval (no neighbour
    stepping) with ``params`` (None: the model's own)."""
    from dquartic_tpu_torch.infer import DDIMSampler

    return DDIMSampler(exp.trainer.model, exp.process_eval).sample(
        x_t, mix, m1, num_steps=50, params=params)[0]


def x0hat500(exp: Experiment, params, eps, target_n, mix_n, m1_n):
    """The model's teacher-forced clean estimate at t = 500."""
    import torch

    from dquartic_tpu_torch.infer.sampler import with_params

    ab = np.float32(exp.process_eval.schedule.alpha_bars[500])
    sab, s1ab = float(np.sqrt(ab)), float(np.sqrt(np.float32(1.0) - ab))
    tv = torch.full((1,), 500, dtype=torch.long, device=eps.device)
    xt = sab * target_n + s1ab * eps
    pred = with_params(exp.trainer.model, params)(xt, tv, mix_n, m1_n).float()
    if exp.knobs.pred == "x0":
        return pred
    return (xt - s1ab * pred) / sab


def eval_params(exp: Experiment, params=None, suffix: str = "") -> List[dict]:
    """The eval records of ``params`` (None: the trained weights)."""
    import torch

    model = exp.trainer.model
    was_training = model.training
    model.eval()
    recs = []
    norm = exp.process_eval.normalize
    try:
        with torch.inference_mode():
            for tag, i, j in eval_pairs(exp.knobs):
                target, other, mix, m1i, m1j = _pair(exp.ms2, exp.ms1, i, j, exp.device)
                pred = sample50(exp, params, exp.eval_noise, mix, m1i).cpu().numpy()
                pred_swap = sample50(exp, params, exp.eval_noise, mix, m1j).cpu().numpy()
                tn, mn = norm(target), norm(mix)
                x0i = x0hat500(exp, params, exp.eval_noise, tn, mn, norm(m1i))
                x0j = x0hat500(exp, params, exp.eval_noise, tn, mn, norm(m1j))
                swap = float(torch.mean(torch.abs(x0i - x0j))
                             / (torch.mean(torch.abs(x0i)) + 1e-12))
                target, other, mix = (a.cpu().numpy() for a in (target, other, mix))
                recs.append(
                    {
                        "pair": tag + suffix,
                        "cos50": round(cosine(pred, target), 4),
                        "mix_baseline": round(cosine(mix, target), 4),
                        "sep50": round(separation(pred, target, other), 4),
                        "sep50_swap": round(separation(pred_swap, target, other), 4),
                        "sep_mix_baseline": round(separation(mix, target, other), 4),
                        "ms1_swap_rel": round(swap, 4),
                    }
                )
    finally:
        model.train(was_training)
    return recs


def run_eval(exp: Experiment, step: int) -> List[dict]:
    recs = eval_params(exp)
    if exp.trainer.ema_params is not None:
        recs += eval_params(exp, exp.trainer.ema_state_dict(), suffix="_ema")
    print(f"[eval @ step {step}] " + json.dumps(recs), flush=True)
    return recs


def save(exp: Experiment, g_step: int, path: Optional[str] = None) -> None:
    """``global_step`` and the whole train state, with the port's
    ``save_checkpoint``; ``<root>/state.ckpt`` unless ``path``."""
    from dquartic_tpu_torch.train.checkpoint import save_checkpoint

    t0 = time.time()
    path = path or f"{exp.knobs.root}/state.ckpt"
    payload = exp.trainer.checkpoint_payload(epoch=0, loss=float("nan"))
    save_checkpoint(path, {"global_step": int(g_step), **payload})
    print(f"saved {path} @ {g_step} ({time.time()-t0:.0f}s)", flush=True)


def resume(exp: Experiment, path: Optional[str] = None) -> int:
    """Load ``<root>/state.ckpt`` (or ``path``) into the trainer; the global
    step it holds."""
    from dquartic_tpu_torch.train.checkpoint import load_checkpoint

    path = path or f"{exp.knobs.root}/state.ckpt"
    ckpt = load_checkpoint(path, map_location=exp.device)
    exp.trainer._load(ckpt)
    print(f"resumed from {path} at global step {ckpt['global_step']}", flush=True)
    return int(ckpt["global_step"])


def track_best(exp: Experiment, recs: List[dict], step: int, best_split: float) -> float:
    """Keep the best-separating state in ``state_best.ckpt`` (the first
    eval pair's sep50 - sep50_swap); the best split so far."""
    split = recs[0]["sep50"] - recs[0]["sep50_swap"]
    if split > best_split:
        save(exp, step, path=f"{exp.knobs.root}/state_best.ckpt")
        return split
    return best_split


def run(exp: Experiment, g_start: int = 0, loss_every: int = LOSS_EVERY,
        on_step: Optional[Callable[[int], None]] = None) -> int:
    """The loop from global step ``g_start`` for ``knobs.steps`` steps (to
    at most ``knobs.total``): the eval at the start, every ``eval_every``
    steps and at the end (into ``<root>/metrics.jsonl``), the mean loss of
    every ``loss_every`` steps, ``state.ckpt`` every ``save_every`` steps
    and at the end. Returns the last global step."""
    import torch

    k = exp.knobs
    t_start = time.time()
    with open(f"{k.root}/metrics.jsonl", "a") as logf:
        recs0 = run_eval(exp, g_start)
        best_split = track_best(exp, recs0, g_start, -1.0)
        logf.write(json.dumps({"step": g_start, "evals": recs0}) + "\n")
        losses = []
        end = min(g_start + k.steps, k.total)
        for step in range(g_start + 1, end + 1):
            losses.append(train_step(exp, step))
            if on_step is not None:
                on_step(step)
            if step % loss_every == 0:
                vals = torch.stack(losses).tolist()
                losses = []
                rec = {
                    "step": step,
                    "loss_mean500": round(float(np.mean(vals)), 5),
                    "wall_s": round(time.time() - t_start, 1),
                }
                print(json.dumps(rec), flush=True)
                logf.write(json.dumps(rec) + "\n")
                logf.flush()
            if step % k.eval_every == 0 or step == end:
                recs = run_eval(exp, step)
                best_split = track_best(exp, recs, step, best_split)
                logf.write(json.dumps({"step": step, "evals": recs}) + "\n")
                logf.flush()
            if step % k.save_every == 0 or step == end:
                save(exp, step)
    print(f"done: steps {g_start}->{end} in {time.time()-t_start:.0f}s", flush=True)
    return end


def main(knobs: Optional[Knobs] = None, edit: Optional[Callable[[dict], None]] = None,
         loss_every: int = LOSS_EVERY) -> int:
    knobs = knobs or Knobs()
    exp = setup(knobs, edit)
    ckpt = f"{knobs.root}/state.ckpt"
    g_start = resume(exp, ckpt) if knobs.resume and os.path.exists(ckpt) else 0
    print(
        f"params: {exp.trainer.num_parameters()/1e6:.1f}M  mode={knobs.mode} "
        f"windows: {knobs.n_train} train + {0 if knobs.overfit else N_HELD} held "
        f"ms1w={knobs.ms1w} pred={knobs.pred} weighting={knobs.weighting} "
        f"ema={knobs.ema or 'off'} steps {g_start}+{knobs.steps} of {knobs.total} "
        f"on {exp.device} ({knobs.compute_dtype}{', plain' if knobs.plain else ''})",
        flush=True,
    )
    return run(exp, g_start, loss_every=loss_every)


if __name__ == "__main__":
    main()
