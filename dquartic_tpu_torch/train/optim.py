"""Optimizer and learning-rate schedule (port of
:mod:`dquartic_tpu.train.optim`).

The JAX optimizer is the optax chain clip_by_global_norm(10) ->
scale_by_adam(0.9, 0.999, 1e-8) -> add_decayed_weights(0.01), scaled by
-lr: decoupled weight decay, which is what ``torch.optim.AdamW`` computes
(p <- p - lr·(m̂/(√v̂ + eps) + wd·p)). The clipping is written out as optax
writes it: ``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, List

import torch


@dataclasses.dataclass(frozen=True)
class WarmupCosineSchedule:
    """Linear warmup then cosine decay, evaluated per epoch: epochs <
    warmup give ``(epoch+1)/warmup``, afterwards
    ``max(1e-10, 0.5*(1+cos(pi*2*cycles*progress)))``. :meth:`clamped`
    applies the reference's clamp ``warmup = epochs // 2`` when warmup >
    epochs."""

    base_lr: float
    num_warmup_steps: int
    num_training_steps: int
    num_cycles: float = 0.5

    def scale(self, epoch: int) -> float:
        if epoch < self.num_warmup_steps:
            return float(epoch + 1) / float(max(1, self.num_warmup_steps))
        progress = float(epoch - self.num_warmup_steps) / float(
            max(1, self.num_training_steps - self.num_warmup_steps)
        )
        return max(1e-10, 0.5 * (1.0 + math.cos(math.pi * self.num_cycles * 2.0 * progress)))

    def __call__(self, epoch: int) -> float:
        return self.base_lr * self.scale(epoch)

    @classmethod
    def clamped(
        cls, base_lr: float, warmup_epochs: int, num_epochs: int, num_cycles: float = 0.5
    ) -> "WarmupCosineSchedule":
        if warmup_epochs > num_epochs:
            warmup_epochs = num_epochs // 2
        return cls(base_lr, warmup_epochs, num_epochs, num_cycles)


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """float32 L2 norm over all the tensors (optax ``global_norm``)."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


class ClippedAdamW:
    """Global-norm clipping, then ``torch.optim.AdamW``, with the learning
    rate given at each step (the per-epoch schedule sets it)."""

    def __init__(
        self,
        params: Iterable[torch.nn.Parameter],
        clip_norm: float = 10.0,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        weight_decay: float = 0.01,
    ):
        self.params = [p for p in params if p.requires_grad]
        self.clip_norm = clip_norm
        self.adamw = torch.optim.AdamW(
            self.params, lr=0.0, betas=(b1, b2), eps=eps, weight_decay=weight_decay
        )

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def step(self, lr: float) -> torch.Tensor:
        """Clip the gradients in place (``g / norm * max`` when norm >
        max), take one AdamW step at ``lr``, and return the gradient norm
        before clipping, on the device (no host sync)."""
        grads = [p.grad for p in self.params]
        norm = global_norm(grads)
        # optax: select(norm < max, g, g / norm * max), without a host sync
        denom = torch.where(norm < self.clip_norm, torch.ones_like(norm), norm / self.clip_norm)
        torch._foreach_div_(grads, denom)
        for group in self.adamw.param_groups:
            group["lr"] = lr
        self.adamw.step()
        return norm

    def state_dict(self) -> dict:
        return self.adamw.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.adamw.load_state_dict(state)


def make_optimizer(
    params: Iterable[torch.nn.Parameter],
    clip_norm: float = 10.0,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.01,
    kind: str = "adamw",
) -> ClippedAdamW:
    """clip -> AdamW over ``params`` (the JAX ``make_optimizer``)."""
    if kind == "factored":
        raise NotImplementedError(
            "tpu.optimizer='factored' (Adafactor-style factored second moment) is not "
            "ported yet: ROADMAP.md Queue 1 item 6 (train/optim.py, factored)"
        )
    if kind != "adamw":
        raise ValueError(f"Unknown optimizer kind: {kind!r} (adamw|factored)")
    return ClippedAdamW(params, clip_norm, b1, b2, eps, weight_decay)
