"""Plain reference of the diffusion process: the cosine schedule, the
deterministic 50-step DDIM reverse pass, the training loss, and clip +
AdamW + EMA, all in float32.

A frozen copy of the published dquartic process (reference
``model/model.py``: the cosine betas in float64 cast to float32 before
the alphas, eps prediction, ``auto_normalize``, x0 clipped to [-1, 1]
with eps derived again from it, each reverse step to t - 1's alpha-bar).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch


def alpha_bars(num_timesteps: int = 1000, s: float = 0.008) -> np.ndarray:
    x = np.linspace(0, num_timesteps, num_timesteps + 1, dtype=np.float64)
    ac = np.cos(((x / num_timesteps) + s) / (1 + s) * math.pi * 0.5) ** 2
    ac = ac / ac[0]
    betas = np.clip(1 - (ac[1:] / ac[:-1]), 0.0, 0.999).astype(np.float32)
    return np.cumprod((1.0 - betas).astype(np.float32), axis=0).astype(np.float32)


def f32(v) -> float:
    return float(np.float32(v))


def sample(model: Callable, x_t: torch.Tensor, ms2_cond: torch.Tensor, ms1_cond: torch.Tensor,
           num_steps: int = 50, num_timesteps: int = 1000) -> torch.Tensor:
    """The reverse pass from ``x_t`` conditioned on the mixture and the MS1
    trace (data space); returns x0_hat in data space. ``model(x, t, init_cond,
    attn_cond)`` is the denoiser."""
    ab = alpha_bars(num_timesteps)
    ms2_n, ms1_n = ms2_cond * 2.0 - 1.0, ms1_cond * 2.0 - 1.0
    steps = np.linspace(num_timesteps - 1, 0, num_steps).astype(np.int32).tolist()
    x = x_t
    for t in steps:
        ab_t = np.float32(ab[t])
        sa, s1 = np.sqrt(ab_t), np.sqrt(np.float32(1.0) - ab_t)
        tv = torch.full((x.shape[0],), t, dtype=torch.long, device=x.device)
        eps = model(x, tv, ms2_n, ms1_n).float()
        x0 = torch.clamp((x - f32(s1) * eps) / f32(sa), -1.0, 1.0)
        if t <= 0:
            x = x0
            break
        eps = (x - f32(sa) * x0) / f32(max(s1, np.float32(1e-8)))
        ab_p = np.float32(ab[t - 1])
        x = f32(np.sqrt(ab_p)) * x0 + f32(np.sqrt(np.float32(1.0) - ab_p)) * eps
    return (x + 1.0) * 0.5


def train_loss(model: Callable, batch: Dict[str, torch.Tensor], t: torch.Tensor,
               eps: torch.Tensor, mixture_weights=(0.5, 0.5),
               num_timesteps: int = 1000) -> torch.Tensor:
    """The eps-prediction MSE on the pair batch: x0 = ms2_1, conditioned on
    the mixture ``w0 ms2_1 + w1 ms2_2`` and ms1_1."""
    ab = torch.as_tensor(alpha_bars(num_timesteps), device=eps.device)[t.long()]
    ab = ab.reshape(-1, 1, 1)
    x0 = batch["ms2_1"] * 2.0 - 1.0
    mix = mixture_weights[0] * batch["ms2_1"] + mixture_weights[1] * batch["ms2_2"]
    x_t = torch.sqrt(ab) * x0 + torch.sqrt(1.0 - ab) * eps
    pred = model(x_t, t, mix * 2.0 - 1.0, batch["ms1_1"] * 2.0 - 1.0)
    return torch.mean(torch.square(pred.float() - eps).reshape(eps.shape[0], -1), dim=1).mean()


class AdamW:
    """Global-norm clipping (optax: g / norm * max where norm >= max), then
    AdamW with decoupled weight decay and bias correction, then an EMA of
    the parameters; over lists of float32 tensors, updated in place."""

    def __init__(self, params: List[torch.Tensor], clip=10.0, b1=0.9, b2=0.999, eps=1e-8,
                 wd=0.01, ema_decay: Optional[float] = 0.999):
        self.params, self.clip, self.b1, self.b2, self.eps, self.wd = params, clip, b1, b2, eps, wd
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.ema_decay = ema_decay
        self.ema = [p.detach().clone() for p in params] if ema_decay is not None else None
        self.count = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor], lr: float) -> List[torch.Tensor]:
        """One update; clips ``grads`` in place and returns them."""
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        denom = torch.where(norm < self.clip, torch.ones_like(norm), norm / self.clip)
        torch._foreach_div_(grads, denom)
        self.count += 1
        bc1 = 1 - self.b1 ** self.count
        bc2 = 1 - self.b2 ** self.count
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            p.mul_(1 - lr * self.wd)
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.addcdiv_(m, v.sqrt() / math.sqrt(bc2) + self.eps, value=-lr / bc1)
        if self.ema is not None:
            d = self.ema_decay
            for e, p in zip(self.ema, self.params):
                e.mul_(d).add_(p, alpha=1 - d)
        return grads
