"""Deconvolve windows with a trained model and render the panel plots, on
the PyTorch port (the counterpart of examples/predict_and_plot.py).

Load a checkpoint through the port's reader (its own ``torch.save`` files
or the JAX package's msgpack ones), take the EMA weights where the file
holds them, draw pairs from the dataset with ``DIAMSDataset.sample_pair``,
deconvolve each mixture with the DDIM reverse pass from noise drawn from a
``torch.Generator`` seeded by the window's index, and write the six panels
of ``plot_single_prediction`` per window (where matplotlib is installed)
and ``metrics.json`` with the JAX script's keys.

Usage:
  python examples/predict_and_plot_torch.py CONFIG.json CHECKPOINT.ckpt OUT_DIR \\
      [--num-steps 50] [--num-windows 2] [--device cuda]

It runs on the CUDA card unless ``--device`` names another device
(``--device cpu`` runs the kernels' plain PyTorch versions); without a
card and without ``--device`` it fails.
"""

import argparse
import importlib.util
import json
import os
import sys

import numpy as np


def load_params(checkpoint: str, use_ema: bool = True):
    """The float weights of a checkpoint file, the EMA in place of the
    trained weights where it holds one."""
    from dquartic_tpu_torch.train.checkpoint import checkpoint_params, load_checkpoint

    ckpt = load_checkpoint(checkpoint, map_location="cpu")
    if ckpt is None:
        raise FileNotFoundError(checkpoint)
    return checkpoint_params(ckpt, use_ema)


def window_noise(index: int, shape, device):
    """N(0, I) of ``(1, *shape)`` from a generator seeded by the window's
    index (the JAX script's ``PRNGKey(index)``)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(index)
    return torch.randn((1, *shape), generator=gen, device=device)


def deconvolve(sampler, ms2_1, ms1_1, ms2_2, noise, num_steps: int):
    """The mixture ``0.5·ms2_1 + 0.5·ms2_2`` of one pair deconvolved from
    ``noise``: ``(mixture, pred, pred_noise)`` as float32 numpy arrays of
    one window."""
    import torch

    mixture = 0.5 * ms2_1 + 0.5 * ms2_2
    dev = noise.device
    pred, pred_noise = sampler.sample(noise, torch.as_tensor(mixture, device=dev)[None],
                                      torch.as_tensor(ms1_1, device=dev)[None],
                                      num_steps=num_steps)
    return mixture, pred[0].float().cpu().numpy(), pred_noise[0].float().cpu().numpy()


def cosine(pred: np.ndarray, target: np.ndarray) -> float:
    return float(np.dot(pred.ravel(), target.ravel())
                 / (np.linalg.norm(pred) * np.linalg.norm(target) + 1e-12))


def build_sampler(config, checkpoint: str, device):
    """A ``DDIMSampler`` over the config's model on the checkpoint's
    weights (the EMA where it holds one)."""
    from dquartic_tpu_torch.infer import DDIMSampler
    from dquartic_tpu_torch.utils.builder import build_model, build_process

    model = build_model(config, device=device, state_dict=load_params(checkpoint))
    return DDIMSampler(model, build_process(config))


def predict_and_plot(config_path: str, checkpoint: str, out_dir: str, num_steps: int = 50,
                     num_windows: int = 2, device=None, plot=None):
    """Deconvolve ``num_windows`` pairs and write their panels (with
    ``plot``, by default ``plot_single_prediction`` where matplotlib is
    installed, else none) and ``metrics.json``; returns the metrics."""
    from dquartic_tpu_torch.data import DIAMSDataset
    from dquartic_tpu_torch.utils.config import load_train_config
    from dquartic_tpu_torch.utils.device import resolve_device

    device = resolve_device(device, "predict_and_plot_torch")
    if plot is None and importlib.util.find_spec("matplotlib") is not None:
        from dquartic_tpu_torch.utils.viz import plot_single_prediction as plot
    if plot is None:
        print("matplotlib is not installed: no panels are drawn")
    config = load_train_config(config_path)
    sampler = build_sampler(config, checkpoint, device)
    d = config["data"]
    ds = DIAMSDataset(parquet_directory=d["parquet_directory"], ms2_file=d["ms2_data_path"],
                      ms1_file=d["ms1_data_path"], normalize=d["normalize"])

    os.makedirs(out_dir, exist_ok=True)
    metrics = []
    for i in range(num_windows):
        ms2_1, ms1_1, ms2_2, _ = ds.sample_pair()
        noise = window_noise(i, ms2_1.shape, device)
        mixture, pred, pred_noise = deconvolve(sampler, ms2_1, ms1_1, ms2_2, noise, num_steps)
        cos = cosine(pred, ms2_1)
        metrics.append({"window": i, "cosine_vs_target": cos})
        if plot is not None:
            plot(ms2_1, ms2_2, mixture, ms1_1, pred, pred_noise, out_dir=out_dir,
                 prefix=f"w{i}_")
        print(f"window {i}: reconstruction cosine vs target = {cos:.4f}")

    with open(os.path.join(out_dir, "metrics.json"), "w") as f:
        json.dump(metrics, f, indent=2)
    return metrics


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config")
    ap.add_argument("checkpoint")
    ap.add_argument("out_dir")
    ap.add_argument("--num-steps", type=int, default=50)
    ap.add_argument("--num-windows", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="device to run on (default: the CUDA card); 'cpu' runs the plain "
                         "PyTorch versions of the kernels")
    args = ap.parse_args(argv)
    from dquartic_tpu_torch.utils.device import resolve_device

    try:
        device = resolve_device(args.device, "predict_and_plot_torch")
    except RuntimeError as e:  # no card and no --device
        sys.exit(str(e))
    predict_and_plot(args.config, args.checkpoint, args.out_dir, args.num_steps,
                     args.num_windows, device)


if __name__ == "__main__":
    main()
