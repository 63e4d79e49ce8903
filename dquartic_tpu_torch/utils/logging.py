"""Metrics logging: wandb when available, JSONL fallback otherwise.

A copy of :mod:`dquartic_tpu.utils.logging` (host code that imports no
JAX), kept here so that the port imports nothing of the JAX package. The
reference logs exclusively through wandb; machines that cannot reach it
get the same call surface from a local JSONL writer, and switching is
transparent to the trainer.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class NoOpLogger:
    enabled = False

    def log(self, metrics: Dict[str, Any], commit: bool = True) -> None:
        pass

    def log_table(self, name: str, columns, rows) -> None:
        pass

    def finish(self) -> None:
        pass


class JsonlLogger(NoOpLogger):
    """Appends one JSON object per log call to ``<dir>/metrics.jsonl``."""

    enabled = True

    def __init__(self, log_dir: str = ".", run_name: Optional[str] = None):
        self._log_dir = log_dir
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._f = None  # opened lazily: no empty file if nothing is logged
        self.run_name = run_name
        self._t0 = time.time()

    def _file(self):
        if self._f is None:
            os.makedirs(self._log_dir, exist_ok=True)
            self._f = open(self.path, "a", buffering=1)
        return self._f

    def log(self, metrics: Dict[str, Any], commit: bool = True) -> None:
        rec = {"_time": round(time.time() - self._t0, 3)}
        if self.run_name:
            rec["_run"] = self.run_name
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        self._file().write(json.dumps(rec) + "\n")

    def log_table(self, name: str, columns, rows) -> None:
        self._file().write(
            json.dumps({"_table": name, "columns": list(columns), "rows": rows}) + "\n"
        )

    def finish(self) -> None:
        if self._f is not None:
            self._f.close()


class WandbLogger(NoOpLogger):
    enabled = True

    def __init__(self, **init_kwargs):
        import wandb  # gated: not part of the baked environment

        self._wandb = wandb
        self.run = wandb.init(**init_kwargs)

    def log(self, metrics: Dict[str, Any], commit: bool = True) -> None:
        self._wandb.log(metrics, commit=commit)

    def log_table(self, name: str, columns, rows) -> None:
        """Table parity with the reference (model_interface.py:757-794):
        cells that are paths to rendered image files become wandb.Image
        objects so the wandb UI shows the plots, not filenames. Non-image
        cells (and non-existent paths) pass through unchanged."""

        def cell(v):
            if (
                isinstance(v, str)
                and v.lower().endswith((".png", ".jpg", ".jpeg", ".gif"))
                and os.path.exists(v)
            ):
                return self._wandb.Image(v)
            return v

        table = self._wandb.Table(columns=list(columns))
        for row in rows:
            table.add_data(*[cell(v) for v in row])
        self._wandb.log({name: table}, commit=False)

    def finish(self) -> None:
        self._wandb.finish()


def make_logger(
    use_wandb: bool = False,
    wandb_kwargs: Optional[Dict[str, Any]] = None,
    log_dir: str = ".",
    run_name: Optional[str] = None,
):
    """Best-available logger: wandb -> JSONL -> no-op."""
    if use_wandb:
        try:
            return WandbLogger(**(wandb_kwargs or {}))
        except ImportError:
            print("Info: wandb not installed; falling back to JSONL metrics log.")
            return JsonlLogger(log_dir, run_name)
    return JsonlLogger(log_dir, run_name)
