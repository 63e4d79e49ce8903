"""Inspect a DIA-MS dataset on the PyTorch port (the counterpart of
examples/explore_dataset.py): shapes, intensity stats, pair mixtures.

Load either backend through the port's ``DIAMSDataset``, print the JAX
script's shape and statistic lines, take one ``PairBatches`` batch onto the
device, and render a few mixture peakmaps with the port's ``_peakmap``.

Usage:
  python examples/explore_dataset_torch.py --parquet DIR            [--plots OUT] [--device cuda]
  python examples/explore_dataset_torch.py --npy MS2.npy MS1.npy    [--plots OUT] [--device cuda]

The batch goes to the CUDA card unless ``--device`` names another device;
without a card and without ``--device`` it fails.
"""

import argparse
import os
import sys

import numpy as np


def open_dataset(parquet=None, npy=None):
    """The port's ``DIAMSDataset`` of the NPY pair or the parquet directory
    (min-max normalized, seed 0)."""
    from dquartic_tpu_torch.data import DIAMSDataset

    if npy:
        return DIAMSDataset(ms2_file=npy[0], ms1_file=npy[1], normalize="minmax")
    return DIAMSDataset(parquet_directory=parquet, normalize="minmax")


def summary(ds, device) -> list:
    """The JAX script's lines: the dataset's size and backend, one pair's
    shapes and statistics, and the keys and shapes of one batch of two
    (taken onto ``device``)."""
    import torch

    from dquartic_tpu_torch.data import PairBatches

    lines = [f"dataset: {len(ds)} samples ({ds.data_type} backend)"]
    ms2_1, ms1_1, _, _ = ds.sample_pair()
    lines.append(f"MS2 window shape: {ms2_1.shape}  MS1 shape: {ms1_1.shape}")
    for name, arr in [("ms2_1", ms2_1), ("ms1_1", ms1_1)]:
        nz = (arr > 0).mean()
        lines.append(f"{name}: min={arr.min():.4g} max={arr.max():.4g} "
                     f"mean={arr.mean():.4g} nonzero={nz * 100:.1f}%")
    batch = {k: torch.as_tensor(v, device=device)
             for k, v in next(iter(PairBatches(ds, batch_size=2))).items()}
    lines.append(f"batch keys: { {k: tuple(v.shape) for k, v in batch.items()} }")
    return lines


def plot_mixtures(ds, out_dir: str, pairs: int) -> list:
    """``pairs`` mixture peakmaps ``mixture_<i>.png`` in ``out_dir``."""
    from dquartic_tpu_torch.utils.viz import _peakmap

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i in range(pairs):
        a, _, b, _ = ds.sample_pair()
        paths.append(_peakmap(0.5 * a + 0.5 * b, f"Mixture {i}", f"{out_dir}/mixture_{i}.png"))
    return paths


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parquet", default=None)
    ap.add_argument("--npy", nargs=2, default=None, metavar=("MS2", "MS1"))
    ap.add_argument("--plots", default=None)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="device of the batch (default: the CUDA card)")
    args = ap.parse_args(argv)
    if not (args.npy or args.parquet):
        ap.error("provide --parquet or --npy")
    from dquartic_tpu_torch.utils.device import resolve_device

    try:
        device = resolve_device(args.device, "explore_dataset_torch")
    except RuntimeError as e:  # no card and no --device
        sys.exit(str(e))
    ds = open_dataset(args.parquet, args.npy)
    for line in summary(ds, device):
        print(line)
    if args.plots:
        plot_mixtures(ds, args.plots, args.pairs)
        print(f"wrote {args.pairs} mixture peakmaps to {args.plots}")


if __name__ == "__main__":
    main()
