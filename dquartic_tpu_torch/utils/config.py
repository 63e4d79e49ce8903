"""JSON config loading, as :mod:`dquartic_tpu.utils.config` does it.

A copy of ``load_train_config`` and its defaults: importing the JAX
package would import JAX. Reference config files load unchanged; the
``tpu`` section keeps its name and defaults, and the port reads from it
``compute_dtype``, ``quantize_mid`` and ``fused_resnet``.
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
