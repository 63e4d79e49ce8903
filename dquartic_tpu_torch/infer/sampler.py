"""Batched DDIM inference on a torch denoiser.

Port of :class:`dquartic_tpu.infer.sampler.DDIMSampler` (``sample``,
``predict_batch``, ``predict``). The model holds its own weights, so no
parameter tree is passed; noise comes from an explicit
:class:`torch.Generator`. Everything runs under ``torch.inference_mode``.

With a ``mesh`` whose ``sp > 1`` every rank of the group calls the same
methods on the same data with the same seed: each draws the whole
window's noise alike, the model computes the rank's slice of m/z and
returns the whole prediction (``activation_sharding``), and the DDIM steps,
which are per element, run alike on every rank, so every rank gets the
unsharded result for that seed.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..core.diffusion import DDIMProcess
from ..utils.device import resolve_device


class DDIMSampler:
    def __init__(self, model: torch.nn.Module, process: DDIMProcess, mesh=None):
        self.model = model
        self.process = process
        if mesh is not None and mesh.sp > 1:
            if getattr(model, "activation_sharding", None) is None:
                raise ValueError(
                    f"a mesh with sp={mesh.sp} needs a model whose activation_sharding splits "
                    "m/z over it (build_model sets it from the mesh)")
            model.mesh = mesh

    @torch.inference_mode()
    def sample(
        self,
        x_t: torch.Tensor,
        ms2_cond: Optional[torch.Tensor] = None,
        ms1_cond: Optional[torch.Tensor] = None,
        num_steps: int = 1000,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Reverse-diffuse ``x_t`` into a clean MS2 map; returns
        ``(x0_hat, pred_noise)``."""
        return self.process.sample(self.model, x_t, ms2_cond, ms1_cond, num_steps=num_steps)

    def predict_batch(
        self,
        generator: torch.Generator,
        ms2_cond: torch.Tensor,
        ms1_cond: Optional[torch.Tensor],
        num_steps: int = 1000,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Start from N(0, I) noise drawn from ``generator`` (which must
        live on ``ms2_cond``'s device)."""
        x_t = torch.randn(
            ms2_cond.shape, generator=generator, dtype=torch.float32, device=ms2_cond.device
        )
        return self.sample(x_t, ms2_cond, ms1_cond, num_steps)

    def predict(
        self,
        dataset: Iterable,
        mixture_weights: Tuple[float, float] = (0.5, 0.5),
        num_steps: int = 1000,
        seed: int = 0,
        device=None,
    ) -> List[Dict[str, np.ndarray]]:
        """Deconvolve each pair batch (``ms2_1``, ``ms1_1``, ``ms2_2``): the
        mixture ``w0·ms2_1 + w1·ms2_2`` is the condition. Each record holds
        the target, its MS1, the mixture, the prediction and the removed
        signal, as numpy arrays. ``device=None`` is the card (raises
        without one)."""
        device = resolve_device(device, "DDIMSampler.predict")
        generator = torch.Generator(device=device).manual_seed(seed)
        out: List[Dict[str, np.ndarray]] = []
        for batch in dataset:
            ms2_1 = torch.as_tensor(np.asarray(batch["ms2_1"]), device=device)
            ms1_1 = torch.as_tensor(np.asarray(batch["ms1_1"]), device=device)
            ms2_2 = torch.as_tensor(np.asarray(batch["ms2_2"]), device=device)
            ms2_cond = mixture_weights[0] * ms2_1 + mixture_weights[1] * ms2_2
            pred, pred_noise = self.predict_batch(generator, ms2_cond, ms1_1, num_steps)
            out.append(
                {
                    "ms2_1": ms2_1.cpu().numpy(),
                    "ms1_1": ms1_1.cpu().numpy(),
                    "mixture": ms2_cond.cpu().numpy(),
                    "pred": pred.float().cpu().numpy(),
                    "pred_noise": pred_noise.float().cpu().numpy(),
                }
            )
        return out
