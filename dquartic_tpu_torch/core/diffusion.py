"""DDIM process on torch tensors: deterministic (eta=0) reverse pass and
the training objective.

Port of :mod:`dquartic_tpu.core.diffusion` (``normalize``/``unnormalize``,
``q_sample``, ``ddim_step``, ``sample``, ``train_loss``). The reverse pass
is a plain Python loop over the sub-sampled timesteps; the JAX package
compiles the same loop as one ``lax.scan``.

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

from ..utils import profiling
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
    """See :class:`dquartic_tpu.core.diffusion.DDIMProcess`; the same
    fields with the same defaults."""

    schedule: DiffusionSchedule
    auto_normalize: bool = True
    ms1_loss_weight: float = 0.0
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
            with profiling.span("ddim.step"):
                x, eps = self.ddim_step(denoise_fn, x, t, t_prev, ms2_n, ms1_n)

        x_out = self.unnormalize(x)
        pred_noise = self.unnormalize(eps)
        if ms2_cond is not None:
            pred_noise = self.unnormalize(ms2_n) - x_out
        return x_out, pred_noise

    def train_loss(
        self,
        denoise_fn: DenoiseFn,
        x_0: torch.Tensor,
        ms2_cond: Optional[torch.Tensor] = None,
        ms1_cond: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
        *,
        t: Optional[torch.Tensor] = None,
        eps: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, dict]:
        """Diffusion training loss; returns ``(scalar_loss, aux)`` with the
        per-sample loss, ``t`` and the mean primary (MSE) loss.

        The draws are t ~ U[0, T) (b,) and eps ~ N(0, I) like ``x_0``. Pass
        them as ``t`` and ``eps`` (tests hand both packages the same draws),
        or they are drawn from ``generator`` (on ``x_0``'s device). An
        explicit ``noise`` is normalized like the data and replaces eps, as
        in the JAX function."""
        batch = x_0.shape[0]
        if t is None:
            t = torch.randint(
                0, self.schedule.num_timesteps, (batch,), generator=generator, device=x_0.device
            )
        x_0n = self.normalize(x_0)
        if noise is not None:
            noise = self.normalize(noise)
        elif eps is not None:
            noise = eps.to(x_0n.dtype)
        else:
            noise = torch.randn(
                x_0.shape, generator=generator, dtype=x_0n.dtype, device=x_0.device
            )
        ms2_n = self.normalize(ms2_cond)
        ms1_n = self.normalize(ms1_cond)

        x_t = self.q_sample(x_0n, t, noise)
        pred = denoise_fn(x_t, t, ms2_n, ms1_n)

        if self.schedule.pred_type == "eps":
            target = noise
            denoised = x_t - pred
        elif self.schedule.pred_type == "x0":
            target = x_0n
            denoised = pred
        else:
            raise ValueError(f"Unknown pred_type: {self.schedule.pred_type!r}")

        sq = torch.square(pred.to(torch.float32) - target.to(torch.float32))
        primary = torch.mean(sq.reshape(batch, -1), dim=1)
        if self.ms1_loss_weight > 0.0 and ms1_n is not None:
            additional = self._ms1_sic_loss(denoised, ms1_n)
            per_sample = (1.0 - self.ms1_loss_weight) * primary + self.ms1_loss_weight * additional
        else:
            per_sample = primary

        weight = torch.as_tensor(self.schedule.loss_weight, device=x_0.device)[t.long()]
        per_sample = per_sample * weight
        aux = {"per_sample_loss": per_sample, "t": t, "primary_loss": torch.mean(primary)}
        return torch.mean(per_sample), aux

    @staticmethod
    def _ms1_sic_loss(denoised: torch.Tensor, ms1: torch.Tensor) -> torch.Tensor:
        """MS1 pseudo-chromatogram consistency loss: sum/mean/max (values)
        projections of the denoised map over m/z, each max-normalized per
        sample, against the same projections of the MS1 condition."""
        eps = 1e-12
        projections = (
            lambda x: torch.sum(x, dim=-1),
            lambda x: torch.mean(x, dim=-1),
            lambda x: torch.amax(x, dim=-1),
        )
        total = torch.zeros((denoised.shape[0],), dtype=torch.float32, device=denoised.device)
        for fn in projections:
            sic = (denoised if denoised.ndim == 2 else fn(denoised)).to(torch.float32)
            ms1_sic = (ms1 if ms1.ndim == 2 else fn(ms1)).to(torch.float32)
            sic_n = sic / (torch.amax(torch.abs(sic), dim=-1, keepdim=True) + eps)
            ms1_n = ms1_sic / (torch.amax(torch.abs(ms1_sic), dim=-1, keepdim=True) + eps)
            total = total + torch.mean(torch.square(sic_n - ms1_n), dim=-1)
        return total
