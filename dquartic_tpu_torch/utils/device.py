"""The device an entry point runs on when its caller names none."""

from __future__ import annotations

import torch


def resolve_device(device, what: str) -> torch.device:
    """``device``, or the card when it is None. Without a CUDA device a
    None raises rather than falling back to the CPU: the CPU runs the
    kernels' plain versions, and only a caller that names it gets them."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{what}: no CUDA device. The port runs on the card unless the caller "
                "names another device (device='cpu' runs the plain PyTorch versions of "
                "the kernels)"
            )
        device = "cuda"
    return torch.device(device)
