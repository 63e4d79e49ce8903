"""Multi-card batch deconvolution, one DIA window per card, on the PyTorch
port (the counterpart of examples/multichip_deconvolution.py).

The production data-gen workload is thousands of independent (rt, m/z)
windows pushed through the 50-step DDIM reverse pass: parallel over
windows. This script runs the dp recipe: one process per card under
``torch.distributed.run``, a dp-only mesh over every rank with a batch of
one window a rank, and the shipping inference config (int8 mid convs, the
fused ResnetBlocks, K1 linear attention, as ``build_model`` reads them
from ``tpu.quantize_mid`` and ``tpu.fused_resnet``). Under DDP-style dp
each rank runs its kernels on its own rows; ``DDIMSampler.predict``
gathers the records over dp, and mesh rank 0 writes them.

  python -m torch.distributed.run --nproc-per-node N \\
      examples/multichip_deconvolution_torch.py config.json ckpt.ckpt out.parquet

One process (no launcher) deconvolves one window a batch on one card.
Without a card the ranks need ``--device cpu`` (gloo), as every port entry
point does. The same flow is reachable without code through the CLI: set
``tpu.mesh = {"dp": N}`` and run ``dquartic-torch predict`` under the
launcher.
"""

import argparse
import sys


def shipping_config(config, n: int):
    """``config`` for one window on each of ``n`` ranks: a dp-only mesh of
    ``n``, ``batch_size = n``, int8 mid convs and the fused ResnetBlocks."""
    config["tpu"]["mesh"] = {"dp": n, "sp": 1, "tp": 1}
    config["model"]["batch_size"] = n
    config["tpu"].update(quantize_mid=True, fused_resnet=True)
    return config


def start(device=None):
    """``(device, n)``: this rank's device, and the ranks there are. Under
    the launcher a rank takes ``cuda:LOCAL_RANK`` (or ``device``) and joins
    its process group; alone it is one rank."""
    import torch

    from dquartic_tpu_torch.parallel.distributed import initialize_runtime, \
        launched_world_size, local_device
    from dquartic_tpu_torch.utils.device import resolve_device

    device = resolve_device(device, "multichip_deconvolution_torch")
    n = launched_world_size()
    if n > 1:
        if device.type == "cuda" and device.index is None:
            device = local_device()
        initialize_runtime(device=device)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    return device, n


def deconvolve_windows(config, checkpoint: str, device, n: int, num_steps: int = 50,
                       num_batches=None, seed: int = 0):
    """``(records, mesh)``: every global batch of ``n`` windows deconvolved
    in the shipping config, each rank on its own window, the records
    gathered over dp on every rank."""
    from dquartic_tpu_torch.infer import DDIMSampler
    from dquartic_tpu_torch.train.checkpoint import checkpoint_params, load_checkpoint
    from dquartic_tpu_torch.utils.builder import build_dataset, build_mesh, build_model, \
        build_process

    config = shipping_config(config, n)
    mesh = build_mesh(config, batch_size=n)
    ckpt = load_checkpoint(checkpoint, map_location="cpu")
    if ckpt is None:
        raise FileNotFoundError(checkpoint)
    # the float weights (the EMA where the file holds one), quantized then cast
    model = build_model(config, device=device, mesh=mesh, state_dict=checkpoint_params(ckpt))
    del ckpt
    dataset = build_dataset(config, seed=seed, mesh=mesh, device=device)
    sampler = DDIMSampler(model, build_process(config), mesh=mesh)
    records = []
    for i, batch in enumerate(iter(dataset)):
        if num_batches is not None and i >= num_batches:
            break
        records.extend(sampler.predict([batch], num_steps=num_steps, seed=seed, device=device))
        if mesh is None or mesh.rank == 0:
            print(f"batch {i}: {records[-1]['pred'].shape} deconvolved on {n} card(s)")
    return records, mesh


def save_records(records, output: str) -> None:
    """``.parquet`` (one row per batch, the training-slice schema) or npz."""
    if output.endswith(".parquet"):
        from dquartic_tpu_torch.infer.sampler import save_predictions_parquet

        save_predictions_parquet(records, output)
    else:
        import numpy as np

        np.savez_compressed(
            output, **{f"{k}_{i}": v for i, r in enumerate(records) for k, v in r.items()})
    print(f"saved {len(records)} batches to {output}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config")
    ap.add_argument("checkpoint")
    ap.add_argument("output", help=".parquet or .npz")
    ap.add_argument("--num-steps", type=int, default=50)
    ap.add_argument("--num-batches", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="device to run on (default: the rank's CUDA card); 'cpu' runs the "
                         "plain PyTorch versions of the kernels over gloo")
    args = ap.parse_args(argv)
    from dquartic_tpu_torch.utils.config import load_train_config

    try:
        device, n = start(args.device)
    except RuntimeError as e:  # no card and no --device
        sys.exit(str(e))
    records, mesh = deconvolve_windows(load_train_config(args.config), args.checkpoint, device,
                                       n, args.num_steps, args.num_batches)
    if mesh is None or mesh.rank == 0:
        save_records(records, args.output)


if __name__ == "__main__":
    main()
