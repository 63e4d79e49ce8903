"""Render the deconvolution acceptance figure from an identifiability
checkpoint of the PyTorch port (port of scripts/viz_identifiability.py).

Loads ``IDF_ROOT/state.ckpt`` and ``IDF_ROOT/config.json`` written by
scripts/run_identifiability_torch.py (the same env knobs, which must match
the training leg's), rebuilds the held-out window pair, runs the 50-step
``DDIMProcess.sample`` path (no neighbour stepping, the eval noise)
conditioned on (a) the target's MS1 and (b) the interferer's MS1 (the swap
control) with the EMA weights where the checkpoint holds them, and writes
one composite figure:

    mixture input | sample w/ target MS1 | true target
    MS1 traces    | sample w/ SWAP MS1   | true interferer

Peak maps are max-pooled along m/z for display only (stated on the axis
label); every number in the title is computed on the raw maps by the
training eval's metrics. The numbers also go to ``<figure>.json``.

Run after a training leg (on the card unless IDF_DEVICE names another
device)::

    IDF_ROOT=runs/inf IDF_INFINITE=1 IDF_PRED=x0 IDF_WEIGHTING=uniform IDF_EMA=0.999 \\
        python scripts/viz_identifiability_torch.py img/deconvolution_idf_torch.png
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from run_identifiability_torch import (  # noqa: E402
    EVAL_NOISE_SEED, RT, Knobs, _pair, cosine, separation, window_set,
)


def main(out_path: str = "img/deconvolution_idf_torch.png", knobs: Knobs = None) -> dict:
    import dataclasses

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import torch

    from dquartic_tpu_torch.infer import DDIMSampler
    from dquartic_tpu_torch.train.checkpoint import checkpoint_params, load_checkpoint
    from dquartic_tpu_torch.utils.builder import build_model, build_process
    from dquartic_tpu_torch.utils.config import load_train_config
    from dquartic_tpu_torch.utils.device import resolve_device

    knobs = knobs or Knobs()
    root = knobs.root
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    device = resolve_device(knobs.device, "viz_identifiability_torch")

    # identical window battery to the training script (seed 7; last 2 held out)
    ms2, ms1 = window_set(knobs.windows, knobs.mz)
    i, j = knobs.windows - 2, knobs.windows - 1  # the held-out pair

    config = load_train_config(f"{root}/config.json")
    ckpt = load_checkpoint(f"{root}/state.ckpt", map_location="cpu")
    step = int(ckpt["global_step"])
    model = build_model(config, device=device, trainable=True,
                        state_dict=checkpoint_params(ckpt, use_ema=True)).eval()
    del ckpt
    print(f"loaded {root}/state.ckpt @ step {step}", flush=True)
    process = dataclasses.replace(build_process(config), parity_neighbor_stepping=False)

    # same normalization, noise and sampling as run_identifiability_torch's eval
    target, other, mix, m1i, m1j = _pair(ms2, ms1, i, j, device)
    gen = torch.Generator(device=device).manual_seed(EVAL_NOISE_SEED)
    noise = torch.randn((1, RT, knobs.mz), generator=gen, device=device)
    sampler = DDIMSampler(model, process)
    pred = sampler.sample(noise, mix, m1i, num_steps=50)[0][0].float().cpu().numpy()
    pred_swap = sampler.sample(noise, mix, m1j, num_steps=50)[0][0].float().cpu().numpy()
    target, other, mix = (a[0].cpu().numpy() for a in (target, other, mix))
    n1 = lambda a: a[0].cpu().numpy()  # noqa: E731
    ms1_i, ms1_j = n1(m1i), n1(m1j)

    sep = separation(pred, target, other)
    sep_swap = separation(pred_swap, target, other)
    sep_mix = separation(mix, target, other)
    stats = {
        "step": step, "sep50": round(sep, 3), "sep50_swap": round(sep_swap, 3),
        "sep_mix_baseline": round(sep_mix, 3),
        "cos50": round(cosine(pred, target), 3),
        "cos_mix_baseline": round(cosine(mix, target), 3),
    }
    print(json.dumps(stats), flush=True)

    # display-only max-pool along m/z so 5-bin peaks stay visible
    POOL = 5

    def disp(a):
        return a[:, : (a.shape[1] // POOL) * POOL].reshape(RT, -1, POOL).max(2)

    panels = [
        (disp(mix), "Mixture input (2 co-eluting windows)"),
        (disp(np.clip(pred, 0, None)),
         f"50-step sample, TARGET MS1  (sep50 {sep:.2f})"),
        (disp(target), "True target window"),
        (None, "MS1 conditions"),
        (disp(np.clip(pred_swap, 0, None)),
         f"50-step sample, SWAPPED MS1  (sep50 {sep_swap:.2f})"),
        (disp(other), "True interferer window"),
    ]
    vmax = max(disp(mix).max(), disp(target).max(), disp(other).max())
    fig, axes = plt.subplots(2, 3, figsize=(16, 7))
    fig.suptitle(
        f"MS1-conditioned deconvolution on a held-out window pair — "
        f"step {step} (mixture-baseline sep50 {sep_mix:.2f})",
        fontsize=13,
    )
    for ax, (arr, title) in zip(axes.ravel(), panels):
        ax.set_title(title, fontsize=10)
        if arr is None:
            t = np.arange(RT)
            ax.plot(t, ms1_i, lw=2, color="#4053d3", label="target MS1")
            ax.plot(t, ms1_j, lw=2, color="#b51d14", label="interferer MS1")
            ax.set_xlabel("RT index")
            ax.set_ylabel("normalized intensity")
            ax.legend(frameon=False, fontsize=9)
            continue
        im = ax.imshow(
            arr.T, aspect="auto", origin="lower", interpolation="nearest",
            cmap="viridis",
            norm=matplotlib.colors.PowerNorm(0.45, vmin=0.0, vmax=vmax),
        )
        ax.set_xlabel("RT index")
        ax.set_ylabel(f"m/z bin (max-pooled x{POOL}, display only)")
        fig.colorbar(im, ax=ax, label="intensity (γ=0.45 display)", fraction=0.046)
    fig.tight_layout(rect=(0, 0, 1, 0.95))
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    print(f"wrote {out_path}", flush=True)
    with open(os.path.splitext(out_path)[0] + ".json", "w") as f:
        json.dump(stats, f, indent=1)
    return stats


if __name__ == "__main__":
    main(*sys.argv[1:2])
