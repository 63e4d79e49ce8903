"""Hold the port's identifiability recipe against the JAX Trainer for many
steps on the CPU, from the same weights, batches, t and eps.

Both trainers are built by their own package's ``build_trainer`` from one
config.json (``write_config`` of scripts/run_identifiability_torch.py: x0,
uniform weighting, factored optimizer, EMA 0.999, remat_blocks, fused
ResnetBlocks, on JAX's XLA path; cut to ``--levels`` levels at m/z ``--mz``
and float32). Both
start from the JAX trainer's own initialized state (weights, EMA, factored
statistics), take the port's generator windows (``make_batch_inf`` of each
step's generators) and the (t, eps) that JAX's ``train_step`` draws from
the JAX script's key of that step, at the script's learning rate. A second
JAX run starts from weights one float32 spacing off, in a random direction
each: how far two runs drift apart by rounding alone.

Every ``--every`` steps it prints one JSON line: each run's mean loss over
those steps, and per leaf the distance of the port's weights, and of the
perturbed run's, from the JAX run's, over how far the JAX run's leaf has
moved from its start (the median over the leaves, and the leaves where the
port drifts most against the perturbed run).

    JAX_PLATFORMS=cpu python tests/_idf_trajectory.py --steps 500 --every 50

With ``--save-init DIR`` it writes the JAX trainer's initialized state of the
uncut recipe (bf16, the canonical 7 levels at m/z ``--mz``) into
``DIR/state.ckpt`` as the port's checkpoint at global step 0, and stops: a
run of scripts/run_identifiability_torch.py with ``IDF_ROOT=DIR
IDF_RESUME=1`` then trains the port from JAX's initial weights on its own
seeds.

It imports both packages, so it lives with the tests; it is a diagnosis,
not a test.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "scripts")]


def _flat(tree):
    import jax

    return {jax.tree_util.keystr(k): np.array(v, np.float64) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _drift(a, b, start):
    """Per leaf ||a - b|| over ||b - start||."""
    return {k: float(np.linalg.norm(a[k] - b[k]) / (np.linalg.norm(b[k] - start[k]) + 1e-30))
            for k in b}


def _jax_state(idf, knobs, edit):
    """The port's experiment of ``knobs`` and the JAX trainer, its config
    and initialized state, from one config.json."""
    import flax
    import jax
    import torch

    from dquartic_tpu.utils.builder import build_trainer as jax_build_trainer
    from dquartic_tpu.utils.config import load_train_config as jax_load_train_config
    from dquartic_tpu_torch.compat.jax_params import jax_checkpoint_to_port

    exp = idf.setup(knobs, edit)
    config = jax_load_train_config(os.path.join(knobs.root, "config.json"))
    # the JAX ResnetBlocks on their XLA path: the fused Pallas kernel runs in
    # interpret mode on the CPU (the same function, ~10x slower)
    config["tpu"]["fused_resnet"] = False
    jtr = jax_build_trainer(config)
    example = {k: v.numpy() for k, v in idf.make_batch_inf(
        torch.Generator().manual_seed(0), knobs.batch, knobs.mz).items()}
    state = jtr.init_state(example)
    host = jax.device_get(flax.serialization.to_state_dict(state))
    exp.trainer._load(jax_checkpoint_to_port({"epoch": 0, "best_loss": 0.0, "state": host}))
    return exp, jtr, config, state, host


def save_init(root: str, mz: int, batch: int):
    import run_identifiability_torch as idf

    knobs = idf.Knobs(root=root, steps=0, total=24000, batch=batch, mz=mz, device="cpu",
                      pred="x0", weighting="uniform", ema="0.999", infinite=True,
                      overfit=False, resume=False)
    exp = _jax_state(idf, knobs, None)[0]
    idf.save(exp, 0)


def main(steps: int, every: int, levels: int, mz: int, batch: int, total: int, root: str):
    import jax
    import jax.numpy as jnp
    import torch

    import run_identifiability_torch as idf
    from dquartic_tpu_torch.compat.jax_params import torch_to_jax_params

    def cut(config):
        config["model"]["UNet1d"]["dim_mults"] = config["model"]["UNet1d"]["dim_mults"][:levels]
        config["tpu"]["compute_dtype"] = "float32"

    knobs = idf.Knobs(root=root, steps=steps, total=total, batch=batch, mz=mz, device="cpu",
                      pred="x0", weighting="uniform", ema="0.999", infinite=True,
                      overfit=False, resume=False)
    exp, jtr, config, state, host = _jax_state(idf, knobs, cut)
    rng = np.random.default_rng(1)
    off = jax.tree_util.tree_map(
        lambda p: (p + np.spacing(p) * rng.choice([-1.0, 1.0], p.shape)).astype(np.float32),
        host["params"])
    pstate = jtr._fresh_state(jax.tree_util.tree_map(jnp.asarray, off))
    start = _flat(host["params"])
    key0 = jax.random.PRNGKey(idf.STEP_KEY)
    losses = {"jax": [], "port": [], "jax_off": []}
    seconds = {"jax": 0.0, "port": 0.0, "jax_off": 0.0}
    for step in range(1, steps + 1):
        gb, _ = idf.step_generators(step, "cpu")
        b = idf.make_batch_inf(gb, batch, mz)
        jb = {k: jnp.asarray(v.numpy()) for k, v in b.items()}
        _, kr = jax.random.split(jax.random.fold_in(key0, step))
        t_rng, noise_rng = jax.random.split(kr)
        t = np.asarray(jax.random.randint(t_rng, (batch,), 0, 1000))
        eps = np.asarray(jax.random.normal(noise_rng, b["ms2_1"].shape, dtype=jnp.float32))
        lr = idf.learning_rate(step, knobs.lr, total)
        t0 = time.perf_counter()
        state, m = jtr.train_step(state, jb, jnp.float32(lr), kr)
        losses["jax"].append(float(m["loss"]))
        t1 = time.perf_counter()
        pstate, pm = jtr.train_step(pstate, jb, jnp.float32(lr), kr)
        losses["jax_off"].append(float(pm["loss"]))
        t2 = time.perf_counter()
        pt = exp.trainer.train_step(b, lr, t=torch.tensor(t), eps=torch.tensor(eps))
        losses["port"].append(float(pt["loss"]))
        t3 = time.perf_counter()
        for k, dt in (("jax", t1 - t0), ("jax_off", t2 - t1), ("port", t3 - t2)):
            seconds[k] += dt
        if step % every == 0 or step == steps:
            ref = _flat(state.params)
            port = _flat(torch_to_jax_params(exp.trainer.model.state_dict(),
                                             config["model"]["UNet1d"]["dim_mults"]))
            d_port, d_off = _drift(port, ref, start), _drift(_flat(pstate.params), ref, start)
            ratio = sorted(((d_port[k] / max(d_off[k], 1e-12), k) for k in ref), reverse=True)
            rec = {
                "step": step,
                "loss_mean": {k: float(np.mean(v[-every:])) for k, v in losses.items()},
                "host_s": dict(seconds),
                "drift_median": {"port": float(np.median(list(d_port.values()))),
                                 "jax_off": float(np.median(list(d_off.values())))},
                "drift_max": {"port": max(d_port.values()), "jax_off": max(d_off.values())},
                "port_over_off": [{"leaf": k, "ratio": r, "port": d_port[k], "jax_off": d_off[k]}
                                  for r, k in ratio[:5]],
            }
            print(json.dumps(rec), flush=True)
    return losses


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--every", type=int, default=50)
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--mz", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--total", type=int, default=24000, help="the cosine schedule's length")
    ap.add_argument("--root", default=os.path.join(tempfile.gettempdir(), "idf_trajectory"))
    ap.add_argument("--save-init", metavar="DIR", help="write JAX's initial state, then stop")
    a = ap.parse_args()
    if a.save_init:
        save_init(a.save_init, a.mz, a.batch)
    else:
        main(a.steps, a.every, a.levels, a.mz, a.batch, a.total, a.root)
