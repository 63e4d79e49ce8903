"""Command-line interface of the PyTorch port (port of :mod:`dquartic_tpu.cli`).

The same chained click group, commands, options and defaults as the JAX
package: ``train``, ``generate-config``, ``generate-train-data``,
``predict`` and ``convert-checkpoint``. ``train`` and ``predict`` run on
the CUDA card unless ``--device`` names another device (``--device cpu``
runs the kernels' plain PyTorch versions); without a card and without
``--device`` they fail. They read the port's checkpoints and the JAX
package's.

The group is chained, so a command's options come before its positional
arguments: ``predict --num-steps 50 CONFIG CKPT OUT``.

``train`` and ``predict`` run on any ``tpu.mesh`` of (dp, sp, tp) under the
standard launcher, one process a rank, each on ``cuda:LOCAL_RANK`` (or
the ``--device`` named), over ``nccl`` where each rank has a card of its
own and ``gloo`` where ranks share one or run on the CPU::

    python -m torch.distributed.run --nproc-per-node 2 -m dquartic_tpu_torch.cli \
        train --device cpu config.json

Only mesh rank 0 logs and writes checkpoints and prediction files. One
process with a ``tpu.mesh`` of more than one rank raises, naming the
launcher. pandas and pyarrow
are imported only by the commands that need them (``generate-train-data``,
``predict`` to parquet), so ``train`` and ``predict`` to npz load without
them.

    python -m dquartic_tpu_torch.cli --help
"""

from __future__ import annotations

import ast
import os
import time
from datetime import datetime

import click

from . import __version__


class PythonLiteralOption(click.Option):
    """Parse option values as Python literals (reference cli.py:16-23)."""

    def type_cast_value(self, ctx, value):
        if not isinstance(value, str):
            return value
        try:
            return ast.literal_eval(value)
        except Exception:
            raise click.BadParameter(value)


@click.group(chain=True)
@click.version_option(__version__)
def cli():
    """
    Diffusion Deconvolution of DIA-MS/MS Data (D^4) — PyTorch port on CUDA.
    """


def _device_banner():
    import torch

    click.echo("--" * 30)
    click.echo("Device Information:")
    click.echo("--" * 30)
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            click.echo(f"CUDA {i}: {torch.cuda.get_device_name(i)}")
    else:
        click.echo("No CUDA device available")
    click.echo("--" * 30)


def _resolve_device(device, what: str):
    """``--device``, or the card (a launched rank's ``cuda:LOCAL_RANK``);
    without one and without ``--device`` the command fails with
    :func:`resolve_device`'s message. A launched rank joins its process
    group here."""
    import torch

    from .parallel.distributed import initialize_runtime, launched_world_size, local_device
    from .utils.device import resolve_device

    try:
        device = resolve_device(device, what)
    except RuntimeError as e:
        raise click.ClickException(str(e))
    if launched_world_size() > 1:
        if device.type == "cuda" and device.index is None:
            device = local_device()
        initialize_runtime(device=device)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    return device


def _build_mesh(config):
    from .utils.builder import build_mesh

    try:
        return build_mesh(config, batch_size=config["model"]["batch_size"])
    except ValueError as e:
        raise click.ClickException(str(e))


_device_option = click.option(
    "--device", default=None,
    help="Device to run on (default: the CUDA card). 'cpu' runs the plain PyTorch "
    "versions of the kernels.",
)


@cli.command()
@click.argument("config-path", type=click.Path(exists=True), required=True)
@click.option("--parquet_directory", default=None, help="Directory of slice parquet files; overrides config")
@click.option("--ms2-data-path", default=None, help="Path to MS2 NPY data; overrides config")
@click.option("--ms1-data-path", default=None, help="Path to MS1 NPY data; overrides config")
@click.option("--batch-size", default=None, type=int, help="Training batch size; overrides config")
@click.option("--checkpoint-path", default=None, help="Best-model checkpoint path; overrides config")
@click.option("--use-wandb", default=None, cls=PythonLiteralOption, help="Use wandb logging; overrides config")
@click.option("--threads", default=None, type=int, help="Host data threads; overrides config")
@_device_option
def train(config_path, parquet_directory, ms2_data_path, ms1_data_path, batch_size,
          checkpoint_path, use_wandb, threads, device):
    """Train a DDIM model on the DIAMS dataset."""
    from .utils.builder import build_dataset, build_trainer
    from .utils.config import load_train_config

    _device_banner()
    click.echo(f"Info: Loading config from {config_path}")
    config = load_train_config(
        config_path,
        parquet_directory=parquet_directory,
        ms2_data_path=ms2_data_path,
        ms1_data_path=ms1_data_path,
        batch_size=batch_size,
        checkpoint_path=checkpoint_path,
        use_wandb=use_wandb,
        threads=threads,
    )
    device = _resolve_device(device, "train")

    mesh = _build_mesh(config)
    dataset = build_dataset(config, mesh=mesh, device=device)
    trainer = build_trainer(config, device=device, mesh=mesh)
    m = config["model"]

    # Periodic prediction tables (reference model_interface.py:432-439):
    # every log_every_n_epochs, deconvolve one random window at several
    # step counts and log the panels. The hook runs between epochs, when
    # no prefetch thread draws from the dataset; on a mesh every rank
    # samples and the lead alone renders and logs.
    prediction_hook = None
    if config["tpu"].get("log_predictions"):
        from .infer import DDIMSampler
        from .utils.viz import PredictionLoggingHook

        prediction_hook = PredictionLoggingHook(
            DDIMSampler(trainer.model, trainer.process, mesh=mesh),
            dataset.inner.dataset,
            trainer.logger,
            out_dir=os.path.dirname(m["checkpoint_path"]) or ".",
            num_steps=config["tpu"]["prediction_num_steps"],
            backend=config["tpu"].get("plot_backend", "matplotlib"),
        )
    trainer.train(
        dataset,
        epochs=m["num_epochs"],
        warmup_epochs=m["warmup_epochs"],
        learning_rate=m["learning_rate"],
        checkpoint_path=m["checkpoint_path"],
        log_every_n_epochs=config["tpu"]["log_every_n_epochs"],
        checkpoint_every_n_epochs=config["tpu"]["checkpoint_every_n_epochs"],
        best_every_n_epochs=config["tpu"].get("best_every_n_epochs", 1),
        prediction_hook=prediction_hook,
    )
    if trainer.logger is not None:
        trainer.logger.finish()
    return trainer


@cli.command()
@click.argument("config-path", type=click.Path(), required=True)
def generate_config(config_path):
    """Generate a training configuration file."""
    from .utils.config import generate_train_config

    click.echo(f"Info: Generating config at {config_path}")
    generate_train_config(config_path)


@cli.command()
@click.argument("input-file", type=click.Path(exists=True), required=True)
@click.argument("output-file", type=click.Path(), required=True)
@click.option("--isolation_window_index", default=0, type=int, help="Index of the isolation window to extract")
@click.option("--window-size", default=34, type=int, help="Retention time window size for data slices")
@click.option("--sliding-step", default=5, type=int, help="Sliding step overlap for retention time windows slices")
@click.option("--mz-ppm-tol", default=10, type=int, help="m/z ppm tolerance for MS1 extraction")
@click.option("--bin-mz", default=True, type=bool, help="Bin m/z values to fixed dimension")
@click.option("--ms1-fixed-mz-size", default=10, type=int, help="Fixed m/z bins for MS1")
@click.option("--ms2-fixed-mz-size", default=7000, type=int, help="Fixed m/z bins for MS2")
@click.option("--batch-size", default=10, type=int, help="Window batch size")
@click.option("--batch-writing-size", default=20, type=int, help="Batches per parquet flush")
@click.option("--num-chunks", default=3, type=int, help="(compat) chunking, unused")
@click.option("--threads", default=3, type=int, help="(compat) chunk threads, unused")
def generate_train_data(
    input_file, output_file, isolation_window_index, window_size, sliding_step,
    mz_ppm_tol, bin_mz, ms1_fixed_mz_size, ms2_fixed_mz_size, batch_size,
    batch_writing_size, num_chunks, threads,
):
    """Generate training data slices from an sqMass file."""
    from .data.slices import generate_data_slices

    click.echo(
        f"[{datetime.now().strftime('%Y-%m-%d %H:%M:%S')}] Info: Generating data slices from - {input_file}"
    )
    n = generate_data_slices(
        input_file, output_file, isolation_window_index, window_size, sliding_step,
        mz_ppm_tol, bin_mz, ms1_fixed_mz_size, ms2_fixed_mz_size, batch_size,
        batch_writing_size, num_chunks, threads,
    )
    click.echo(
        f"[{datetime.now().strftime('%Y-%m-%d %H:%M:%S')}] Info: Saved {n} data slices to - {output_file}"
    )


@cli.command()
@click.argument("config-path", type=click.Path(exists=True), required=True)
@click.argument("checkpoint-path", type=click.Path(exists=True), required=True)
@click.argument("output-file", type=click.Path(), required=True)
@click.option("--num-steps", default=50, type=int, help="DDIM reverse steps")
@click.option("--num-batches", default=None, type=int, help="Limit number of batches")
@click.option("--use-ema/--no-use-ema", default=True, help="Use EMA weights when present")
@click.option(
    "--quantize-mid/--no-quantize-mid", default=None,
    help="Run the UNet1d mid-block convs with int8 weights (the int8 weight-streaming "
    "kernel) — halves the dominant weight stream. Defaults to tpu.quantize_mid from "
    "the config.",
)
@click.option(
    "--fused-resnet/--no-fused-resnet", default=None,
    help="Run the UNet1d conv stack transposed-resident with fused ResnetBlock "
    "kernels. Defaults to tpu.fused_resnet from the config.",
)
@click.option(
    "--format", "output_format", default=None,
    type=click.Choice(["npz", "parquet"]),
    help="Output format; inferred from the output file suffix by default",
)
@_device_option
def predict(config_path, checkpoint_path, output_file, num_steps, num_batches, use_ema,
            quantize_mid, fused_resnet, output_format, device):
    """Deconvolute dataset windows with a trained model.

    Writes NPZ by default, or parquet (one row per prediction batch with
    flattened f32 arrays + shapes, same conventions as the training-slice
    schema) with ``--format parquet`` / a ``.parquet`` output suffix.

    Note: the CLI group is chained (reference cli.py:26 parity), so
    options must come BEFORE the positional arguments:
    ``predict --num-steps 50 CONFIG CKPT OUT``.
    """
    import numpy as np

    from .infer import DDIMSampler
    from .train.checkpoint import checkpoint_params, load_checkpoint
    from .utils.builder import build_dataset, build_model, build_process
    from .utils.config import load_train_config

    _device_banner()
    config = load_train_config(config_path)
    device = _resolve_device(device, "predict")
    t0 = time.perf_counter()
    ckpt = load_checkpoint(checkpoint_path, map_location="cpu")
    params = checkpoint_params(ckpt, use_ema)
    del ckpt
    click.echo(f"Info: Loaded {checkpoint_path} in {time.perf_counter() - t0:.2f} s")

    tpu = config["tpu"]
    if quantize_mid is None:
        quantize_mid = bool(tpu.get("quantize_mid"))
    if fused_resnet is None:
        fused_resnet = bool(tpu.get("fused_resnet"))
    for flag, on in (("--quantize-mid", quantize_mid), ("--fused-resnet", fused_resnet)):
        if on and config["model"]["use_model"] != "UNet1d":
            raise click.ClickException(f"{flag} only applies to UNet1d")
    tpu.update(quantize_mid=quantize_mid, fused_resnet=fused_resnet)
    if quantize_mid:
        click.echo("Info: int8 mid-block convolutions enabled")
    if fused_resnet:
        click.echo("Info: fused transposed ResnetBlock path enabled")

    mesh = _build_mesh(config)
    if mesh is not None:
        click.echo(f"Info: sampling over mesh {mesh.shape}")
    # the float weights, quantized then cast to the serving dtype
    model = build_model(config, device=device, mesh=mesh, state_dict=params)
    del params
    dataset = build_dataset(config, mesh=mesh, device=device)
    sampler = DDIMSampler(model, build_process(config), mesh=mesh)
    records = []
    for i, batch in enumerate(iter(dataset)):
        if num_batches is not None and i >= num_batches:
            break
        records.extend(sampler.predict([batch], num_steps=num_steps, device=device))
    if mesh is not None and mesh.rank != 0:
        return  # every rank holds the records; mesh rank 0 writes them
    if output_format is None:
        output_format = "parquet" if str(output_file).endswith(".parquet") else "npz"
    if output_format == "parquet":
        from .infer.sampler import save_predictions_parquet

        save_predictions_parquet(records, output_file)
    else:
        arrays = {}
        for i, rec in enumerate(records):
            for k, v in rec.items():
                arrays[f"{k}_{i}"] = v
        np.savez_compressed(output_file, **arrays)
    click.echo(f"Info: Saved {len(records)} prediction batches to {output_file}")


@cli.command()
@click.argument("torch-checkpoint", type=click.Path(exists=True), required=True)
@click.argument("output-file", type=click.Path(), required=True)
@click.argument("config-path", type=click.Path(exists=True), required=True)
def convert_checkpoint(torch_checkpoint, output_file, config_path):
    """Convert a reference PyTorch checkpoint to this framework's format."""
    from .compat.torch_ckpt import convert_checkpoint_file

    convert_checkpoint_file(torch_checkpoint, output_file, config_path)
    click.echo(f"Info: Converted {torch_checkpoint} -> {output_file}")


def main():
    cli()


if __name__ == "__main__":
    main()
