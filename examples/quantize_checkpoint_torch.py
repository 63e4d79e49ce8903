"""Int8 post-training quantization of a trained checkpoint, on the PyTorch
port (the counterpart of examples/quantize_checkpoint.py).

Per-channel symmetric int8 on every large weight (the port's
``quantize_params``: JAX's rule, in the torch layout) of a checkpoint's
weights, the EMA where it holds one. It writes the quantized weights with
``save_checkpoint`` and prints the JAX script's three lines: the weights'
bytes before and after, the two files' sizes, and the model's output
drift on a synthetic window, the model run on the dequantized weights
(``apply_quantized``) against the float ones.

Usage:
  python examples/quantize_checkpoint_torch.py CONFIG.json IN.ckpt OUT.ckpt [--device cuda]

It runs on the CUDA card unless ``--device`` names another device; without
a card and without ``--device`` it fails.
"""

import argparse
import os
import sys

import numpy as np

# the drift check's window: the JAX script's 8 RT rows of the config's m/z
DRIFT_RT = 8


def quantize(params):
    """``(qparams, raw_mb, q_mb)``: the quantized weights and both sizes."""
    from dquartic_tpu_torch.ops.quantization import quantize_params, quantized_nbytes

    q = quantize_params(params)
    return q, quantized_nbytes(params) / 1e6, quantized_nbytes(q) / 1e6


def output_drift(config, params, qparams, device) -> float:
    """max |out(dequantized) - out(float)| / max |out(float)| of the
    config's model at its compute dtype on the JAX script's synthetic
    window (``default_rng(0)``: x and the MS1 condition uniform in [0, 1),
    t = 0). The model keeps float mid convs (``quantize_mid`` off), as the
    weights it is given are float."""
    import copy

    import torch

    from dquartic_tpu_torch.ops.quantization import apply_quantized
    from dquartic_tpu_torch.utils.builder import build_model

    config = copy.deepcopy(config)
    config["tpu"]["quantize_mid"] = False
    config["model"]["UNet1d"].pop("quantize_mid", None)
    model = build_model(config, device=device, trainable=True).eval()
    rng = np.random.default_rng(0)
    mz = config["model"]["UNet1d"]["downsample_dim"]
    x = torch.from_numpy(rng.uniform(0, 1, (1, DRIFT_RT, mz)).astype(np.float32)).to(device)
    t = torch.zeros((1,), dtype=torch.long, device=device)
    ac = torch.from_numpy(rng.uniform(0, 1, (1, DRIFT_RT)).astype(np.float32)).to(device)
    with torch.no_grad():
        out_ref = torch.func.functional_call(
            model, {k: v.to(device) for k, v in params.items()}, (x, t, x, ac)).float()
        out_q = apply_quantized(model, {k: v.to(device) for k, v in qparams.items()},
                                x, t, x, ac).float()
    return float((out_q - out_ref).abs().max() / (out_ref.abs().max() + 1e-9))


def quantize_checkpoint(config_path: str, input_ckpt: str, output_ckpt: str, device=None):
    """Quantize ``input_ckpt`` into ``output_ckpt`` and print the three
    lines; returns ``{raw_mb, q_mb, in_mb, out_mb, drift}``."""
    from dquartic_tpu_torch.train.checkpoint import checkpoint_params, load_checkpoint, \
        save_checkpoint
    from dquartic_tpu_torch.utils.config import load_train_config
    from dquartic_tpu_torch.utils.device import resolve_device

    device = resolve_device(device, "quantize_checkpoint_torch")
    config = load_train_config(config_path)
    ckpt = load_checkpoint(input_ckpt, map_location="cpu")
    if ckpt is None:
        raise FileNotFoundError(input_ckpt)
    # quantized where the model runs (on the card, a second per billion weights)
    params = {k: v.to(device) for k, v in checkpoint_params(ckpt, use_ema=True).items()}
    q, raw_mb, q_mb = quantize(params)
    print(f"params: {raw_mb:.1f} MB -> {q_mb:.1f} MB ({raw_mb / q_mb:.2f}x)")

    save_checkpoint(output_ckpt, {"epoch": ckpt["epoch"], "best_loss": ckpt["best_loss"],
                                  "qparams": {k: v.cpu() for k, v in q.items()}})
    in_mb, out_mb = os.path.getsize(input_ckpt) / 1e6, os.path.getsize(output_ckpt) / 1e6
    print(f"checkpoint file: {in_mb:.1f} MB -> {out_mb:.1f} MB")
    del ckpt

    drift = output_drift(config, params, q, device)
    print(f"max relative output drift: {drift * 100:.3f}%")
    return dict(raw_mb=raw_mb, q_mb=q_mb, in_mb=in_mb, out_mb=out_mb, drift=drift)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config")
    ap.add_argument("input_ckpt")
    ap.add_argument("output_ckpt")
    ap.add_argument("--device", default=None,
                    help="device to run on (default: the CUDA card); 'cpu' runs the plain "
                         "PyTorch versions of the kernels")
    args = ap.parse_args(argv)
    from dquartic_tpu_torch.utils.device import resolve_device

    try:
        device = resolve_device(args.device, "quantize_checkpoint_torch")
    except RuntimeError as e:  # no card and no --device
        sys.exit(str(e))
    quantize_checkpoint(args.config, args.input_ckpt, args.output_ckpt, device)


if __name__ == "__main__":
    main()
