"""Single-file checkpointing with auto-resume (port of
:mod:`dquartic_tpu.train.checkpoint`).

The same file names as the JAX package: a "latest" checkpoint named
``dquartic_latest_checkpoint.ckpt`` next to the configured best-model path,
written every epoch, plus the best-loss file; training auto-resumes from
the latest file. The format is ``torch.save`` of ``{epoch, best_loss,
step, params, opt_state, ema_params}``, written atomically through a
``.tmp`` file and ``os.replace``: the port's files are ``torch.save``
files under the JAX names, whatever the JAX package would write there.
This is the port's only backend; ``build_trainer`` accepts
``tpu.checkpoint_backend = "msgpack"`` (the default) and raises for
``"orbax"`` or an unknown value. Reading the JAX package's msgpack files
is not ported yet (ROADMAP.md Queue 1 item 3).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import torch

LATEST_NAME = "dquartic_latest_checkpoint.ckpt"


def latest_path_for(checkpoint_path: str) -> str:
    """``<dirname(checkpoint_path)>/dquartic_latest_checkpoint.ckpt``."""
    d = os.path.dirname(checkpoint_path)
    return os.path.join(d, LATEST_NAME) if d else LATEST_NAME


def save_checkpoint(path: str, payload: Dict[str, Any]) -> None:
    """Atomically write a checkpoint file."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, map_location=None) -> Optional[Dict[str, Any]]:
    """Load a checkpoint (tensors, numbers and dicts only), or None when
    the file does not exist."""
    if not os.path.exists(path):
        return None
    return torch.load(path, map_location=map_location, weights_only=True)


def restore_or_init(
    checkpoint_path: str, map_location=None
) -> Tuple[Optional[Dict[str, Any]], int, float, bool]:
    """Auto-resume: ``(payload, epoch, best_loss, resumed)`` from the latest
    checkpoint beside ``checkpoint_path``, or ``(None, 0, inf, False)``.
    ``epoch`` is the last completed epoch of the file."""
    latest = latest_path_for(checkpoint_path)
    ckpt = load_checkpoint(latest, map_location)
    if ckpt is None:
        print(f"No checkpoint ({latest}) found. Starting from scratch.")
        return None, 0, float("inf"), False
    epoch, best_loss = int(ckpt["epoch"]), float(ckpt["best_loss"])
    print(f"Resumed from ({latest}) epoch {epoch}, best loss {best_loss:.6f}")
    return ckpt, epoch, best_loss, True
