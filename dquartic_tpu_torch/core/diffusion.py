"""Deterministic (eta=0) DDIM reverse process on torch tensors.

Port of the inference half of :mod:`dquartic_tpu.core.diffusion`
(``normalize``/``unnormalize``, ``q_sample``, ``ddim_step``, ``sample``).
The reverse pass is a plain Python loop over the sub-sampled timesteps;
the JAX package compiles the same loop as one ``lax.scan``.

Per-step schedule scalars are taken from the float32 numpy tables and
combined in float32 on the host, so the DDIM algebra sees the same
float32 constants the JAX program closes over. The DDIM state stays in
float32 whatever dtype the denoiser computes in.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .schedules import DiffusionSchedule

# (x_t, t (b,) int64, init_cond, attn_cond) -> prediction (eps or x0)
DenoiseFn = Callable[
    [torch.Tensor, torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]],
    torch.Tensor,
]


def sample_timesteps(num_timesteps: int, num_steps: int) -> np.ndarray:
    """Reverse-pass timesteps T-1 .. 0, computed in float then truncated
    (``torch.linspace(T-1, 0, num_steps, dtype=long)`` semantics)."""
    return np.linspace(num_timesteps - 1, 0, num_steps).astype(np.int32)


def _f32(v) -> float:
    """A float32 value as a Python float (exact), for tensor-scalar ops."""
    return float(np.float32(v))


@dataclasses.dataclass(frozen=True)
class DDIMProcess:
    """See :class:`dquartic_tpu.core.diffusion.DDIMProcess`; its sampling
    flags with the same defaults."""

    schedule: DiffusionSchedule
    auto_normalize: bool = True
    parity_neighbor_stepping: bool = True
    clip_denoised: bool = True

    def normalize(self, x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        if x is None or not self.auto_normalize:
            return x
        return x * 2.0 - 1.0

    def unnormalize(self, x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        if x is None or not self.auto_normalize:
            return x
        return (x + 1.0) * 0.5

    def q_sample(self, x_0: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """sqrt(ab_t) x0 + sqrt(1-ab_t) eps for per-sample ``t`` (b,)."""
        ab = torch.as_tensor(self.schedule.alpha_bars, device=x_0.device)[t.long()]
        ab = ab.reshape(-1, *((1,) * (x_0.ndim - 1)))
        return torch.sqrt(ab).to(x_0.dtype) * x_0 + torch.sqrt(1.0 - ab).to(x_0.dtype) * noise

    def ddim_step(
        self,
        denoise_fn: DenoiseFn,
        x_t: torch.Tensor,
        t: int,
        t_prev: int,
        init_cond: Optional[torch.Tensor],
        attn_cond: Optional[torch.Tensor],
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One reverse step x_t -> x_{t_prev}; returns (x_prev, eps_pred).
        ``t_prev`` is ignored under ``parity_neighbor_stepping``."""
        ab = self.schedule.alpha_bars
        t_vec = torch.full((x_t.shape[0],), t, dtype=torch.long, device=x_t.device)
        ab_t = np.float32(ab[t])
        sqrt_ab_t = np.sqrt(ab_t)
        sqrt_1mab_t = np.sqrt(np.float32(1.0) - ab_t)

        pred = denoise_fn(x_t, t_vec, init_cond, attn_cond).to(x_t.dtype)
        if self.schedule.pred_type == "eps":
            eps_pred = pred
            x0_pred = (x_t - _f32(sqrt_1mab_t) * eps_pred) / _f32(sqrt_ab_t)
        elif self.schedule.pred_type == "x0":
            x0_pred = pred
            eps_pred = (x_t - _f32(sqrt_ab_t) * x0_pred) / _f32(sqrt_1mab_t)
        else:
            raise ValueError(f"Unknown pred_type: {self.schedule.pred_type!r}")

        if self.clip_denoised:
            x0_pred = torch.clamp(x0_pred, -1.0, 1.0)
            # eps re-derived from the clamped x0 (lucidrains' convention)
            eps_pred = (x_t - _f32(sqrt_ab_t) * x0_pred) / _f32(max(sqrt_1mab_t, np.float32(1e-8)))

        if t <= 0:
            return x0_pred, eps_pred
        prev = max(t - 1, 0) if self.parity_neighbor_stepping else max(t_prev, 0)
        ab_p = np.float32(ab[prev])
        x_prev = (
            _f32(np.sqrt(ab_p)) * x0_pred + _f32(np.sqrt(np.float32(1.0) - ab_p)) * eps_pred
        )
        return x_prev, eps_pred

    def sample(
        self,
        denoise_fn: DenoiseFn,
        x_t: torch.Tensor,
        ms2_cond: Optional[torch.Tensor] = None,
        ms1_cond: Optional[torch.Tensor] = None,
        num_steps: int = 1000,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full reverse pass. Returns ``(x_0_hat, pred_noise)`` in data
        space; with ``ms2_cond``, ``pred_noise = unnormalize(ms2_n) - x_0_hat``
        (the removed interference signal)."""
        ms2_n = self.normalize(ms2_cond)
        ms1_n = self.normalize(ms1_cond)
        steps = sample_timesteps(self.schedule.num_timesteps, num_steps)
        steps_prev = np.concatenate([steps[1:], np.array([-1], dtype=np.int32)])

        x, eps = x_t, torch.zeros_like(x_t)
        for t, t_prev in zip(steps.tolist(), steps_prev.tolist()):
            x, eps = self.ddim_step(denoise_fn, x, t, t_prev, ms2_n, ms1_n)

        x_out = self.unnormalize(x)
        pred_noise = self.unnormalize(eps)
        if ms2_cond is not None:
            pred_noise = self.unnormalize(ms2_n) - x_out
        return x_out, pred_noise
