"""JSON config loading and the config template, as
:mod:`dquartic_tpu.utils.config` does them.

A copy of ``load_train_config``, ``generate_train_config`` and their
defaults: importing the JAX package would import JAX. Reference config
files load unchanged; the ``tpu`` section keeps its name and defaults, and
``generate_train_config`` writes the file the JAX package writes, key for
key.
"""

from __future__ import annotations

import json
from typing import Any, Dict

# Defaults of the JAX package's ``tpu`` config section (same keys, same
# values), so a config resolves to the same settings in both packages.
TPU_DEFAULTS: Dict[str, Any] = {
    "mesh": {"dp": None, "sp": 1, "tp": 1},
    "compute_dtype": "float32",
    "ema_decay": 0.999,
    "attn_impl": "auto",
    "linear_attn_impl": "auto",
    "checkpoint_backend": "msgpack",
    "checkpoint_every_n_epochs": 1,
    "best_every_n_epochs": 1,
    "log_every_n_epochs": 100,
    "prefetch": 2,
    "sample_num_steps": 50,
    "prediction_num_steps": [100, 500, 1000],
    "log_predictions": False,
    "plot_backend": "matplotlib",
    "optimizer": "adamw",
    "loss_weighting": "reference",
    "quantize_mid": False,
    "fused_resnet": False,
}


_OVERRIDE_KEYS = {
    "parquet_directory": ("data", "parquet_directory"),
    "ms2_data_path": ("data", "ms2_data_path"),
    "ms1_data_path": ("data", "ms1_data_path"),
    "batch_size": ("model", "batch_size"),
    "checkpoint_path": ("model", "checkpoint_path"),
    "use_wandb": ("wandb", "use_wandb"),
    "threads": ("threads",),
}


def _apply_defaults(config: Dict[str, Any]) -> Dict[str, Any]:
    config.setdefault("data", {})
    for key in ("parquet_directory", "ms2_data_path", "ms1_data_path"):
        config["data"].setdefault(key, None)
    config["data"].setdefault("normalize", "minmax")
    tpu = dict(TPU_DEFAULTS)
    tpu.update(config.get("tpu", {}))
    mesh = dict(TPU_DEFAULTS["mesh"])
    mesh.update(tpu.get("mesh") or {})
    tpu["mesh"] = mesh
    config["tpu"] = tpu
    return config


def load_train_config(config_path: str, **kwargs) -> Dict[str, Any]:
    """Load a config and apply non-None CLI overrides
    (reference config_loader.py:4-57)."""
    with open(config_path, "r") as f:
        config = json.load(f)
    config = _apply_defaults(config)

    for key, path in _OVERRIDE_KEYS.items():
        if kwargs.get(key) is None:
            continue
        node = config
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = kwargs[key]
    return config


def generate_train_config(config_path: str) -> None:
    """Write the canonical config template (reference
    config_loader.py:60-119, plus the ``tpu`` section)."""
    full_config = {
        "data": {
            "parquet_directory": "data/",
            "ms2_data_path": None,
            "ms1_data_path": None,
            "normalize": "minmax",
        },
        "model": {
            "checkpoint_path": "best_model.ckpt",
            "num_epochs": 10000,
            "warmup_epochs": 5,
            "batch_size": 1,
            "learning_rate": 0.00001,
            "num_timesteps": 1000,
            "beta_schedule_type": "cosine",
            "pred_type": "eps",
            "auto_normalize": True,
            "ms1_loss_weight": 0.0,
            "use_model": "UNet1d",
            "CustomTransformer": {
                "input_dim": 40000,
                "hidden_dim": 1024,
                "num_heads": 8,
                "num_layers": 8,
            },
            "UNet1d": {
                "dim": 4,
                "channels": 1,
                "dim_mults": [1, 2, 2, 3, 3, 4, 4],
                "conditional": True,
                "init_cond_channels": 1,
                "attn_cond_channels": 1,
                "tfer_dim_mult": 620,
                "downsample_dim": 40000,
                "simple": True,
            },
        },
        "wandb": {
            "use_wandb": True,
            "wandb_project": "dquartic",
            "wandb_name": None,
            "wandb_id": None,
            "wandb_resume": None,
            "wandb_architecture": "DDIM(UNet1d)",
            "wandb_dataset": "MS2",
            "wandb_mode": "offline",
        },
        "threads": 4,
        "tpu": TPU_DEFAULTS,
    }
    with open(config_path, "w") as f:
        json.dump(full_config, f, indent=4)
