"""Diffusion noise schedules.

A copy of :mod:`dquartic_tpu.core.schedules`, which is numpy only but
cannot be imported without importing JAX. Pure-numpy schedule construction
(float64 internally, cast to float32), matching the formulas of the
reference PyTorch dquartic (``model/model.py:14-54, 57-84, 204-213``).

Schedules are built once on the host as numpy arrays; the DDIM process
reads its per-step scalars from these float32 tables.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


def linear_beta_schedule(
    num_timesteps: int, beta_start: float = 1e-4, beta_end: float = 0.02
) -> np.ndarray:
    """Linearly interpolated betas (reference model.py:14-29)."""
    return np.linspace(beta_start, beta_end, num_timesteps, dtype=np.float64)


def cosine_beta_schedule(num_timesteps: int, s: float = 0.008) -> np.ndarray:
    """Nichol & Dhariwal cosine schedule (reference model.py:32-54).

    Computed in float64 and clipped to [0, 0.999], exactly as the reference.
    """
    steps = num_timesteps + 1
    x = np.linspace(0, num_timesteps, steps, dtype=np.float64)
    alphas_cumprod = np.cos(((x / num_timesteps) + s) / (1 + s) * math.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0.0, 0.999)


def get_alphas(betas: np.ndarray) -> np.ndarray:
    """alpha_t = 1 - beta_t (reference model.py:57-69)."""
    return 1.0 - betas


def get_alpha_bars(alphas: np.ndarray) -> np.ndarray:
    """Cumulative product of alphas (reference model.py:72-84)."""
    return np.cumprod(alphas, axis=0)


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Precomputed schedule tables (all float32 numpy arrays, shape (T,)).

    ``loss_weight`` follows the reference SNR weighting
    (model.py:204-213): ones for eps-prediction, snr for x0-prediction.
    """

    num_timesteps: int
    betas: np.ndarray
    alphas: np.ndarray
    alpha_bars: np.ndarray
    loss_weight: np.ndarray
    schedule_type: str
    pred_type: str

    def __post_init__(self):
        for name in ("betas", "alphas", "alpha_bars", "loss_weight"):
            arr = getattr(self, name)
            if arr.shape != (self.num_timesteps,):
                raise ValueError(f"{name} has shape {arr.shape}, expected ({self.num_timesteps},)")


def make_schedule(
    num_timesteps: int = 1000,
    schedule_type: str = "cosine",
    pred_type: str = "eps",
    weighting: str = "reference",
) -> DiffusionSchedule:
    """Build a :class:`DiffusionSchedule`.

    Mirrors DDIMDiffusionModel.__init__ (reference model.py:196-213): the
    f64 beta table is cast to f32 *before* alphas/alpha_bars are derived.

    ``weighting`` selects the per-timestep loss weight:

    * ``"reference"`` — the reference's SNR rule (model.py:204-213):
      ones for eps-prediction, raw snr for x0-prediction. The raw-snr
      x0 weight spans ~2.4e4 (t=0) to ~2.4e-9 (t=999) on the cosine
      schedule — a t=0 sample outweighs a t=999 sample by 10^13, so
      x0 training under it is numerically dominated by near-clean
      timesteps.
    * ``"uniform"`` — ones for either pred_type. For x0-prediction this
      weights every timestep's *reconstruction* equally, which shifts
      the objective's mass toward high-t where only the conditioning
      signal (not x_t) can identify the target — the standard lever for
      conditioning uptake when the conditions are strongly informative.
    * ``"min_snr:G"`` — Min-SNR-gamma (Hang et al. 2023): the x0-space
      weight min(snr, G), i.e. min(snr, G)/snr for eps-prediction and
      min(snr, G) for x0-prediction. Caps the low-t blowup of the raw
      snr rule while keeping the reference's high-t behavior.
    """
    if schedule_type == "linear":
        betas = linear_beta_schedule(num_timesteps)
    elif schedule_type == "cosine":
        betas = cosine_beta_schedule(num_timesteps)
    else:
        raise ValueError(f"Unknown schedule_type: {schedule_type!r}")

    betas = betas.astype(np.float32)
    alphas = get_alphas(betas).astype(np.float32)
    alpha_bars = get_alpha_bars(alphas).astype(np.float32)

    if pred_type not in ("eps", "x0"):
        raise ValueError(f"Unknown pred_type: {pred_type!r}")
    snr = alpha_bars / (1.0 - alpha_bars)
    if weighting == "reference":
        loss_weight = np.ones_like(snr) if pred_type == "eps" else snr
    elif weighting == "uniform":
        loss_weight = np.ones_like(snr)
    elif weighting.startswith("min_snr:"):
        gamma = float(weighting.split(":", 1)[1])
        x0_weight = np.minimum(snr, gamma)
        loss_weight = x0_weight / snr if pred_type == "eps" else x0_weight
    else:
        raise ValueError(
            f"Unknown weighting: {weighting!r} "
            "(expected 'reference', 'uniform' or 'min_snr:<gamma>')"
        )

    return DiffusionSchedule(
        num_timesteps=num_timesteps,
        betas=betas,
        alphas=alphas,
        alpha_bars=alpha_bars,
        loss_weight=loss_weight.astype(np.float32),
        schedule_type=schedule_type,
        pred_type=pred_type,
    )
