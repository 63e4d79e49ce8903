"""Seeded weights of a model, made on the device in a few large calls.

The leaves of :func:`~cuda_bench.reference.unet1d.param_shapes` are laid
out in order in one flat float32 buffer, filled with N(0, 1) draws in
chunks of ``CHUNK`` elements, each chunk from a generator seeded by the
run's seed and the chunk's index, then set leaf by leaf: a weight to
``z / sqrt(fan_in)``, a norm gain to ``1 + 0.1 z``, a bias to ``0.1 z``
(nonzero, so a kernel that drops a bias or a gain shows). Any leaf can
be made again alone from the seed, chunk by chunk
(:meth:`Weights.leaves`), which is how the benchmark reads a parameter's
change without keeping a copy of the start.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, Iterator, Tuple

import torch

CHUNK = 1 << 27


def derive(seed: int, *tags) -> int:
    """A 63-bit seed from the run's seed and ``tags``."""
    h = hashlib.sha256(":".join(map(str, (seed,) + tags)).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def affine(name: str, shape: tuple) -> Tuple[float, float]:
    """(scale, shift) taking a leaf's N(0, 1) draws to its values."""
    if name.endswith(".g"):
        return 0.1, 1.0
    if name.endswith((".bias", ".b")):
        return 0.1, 0.0
    return 1.0 / math.sqrt(math.prod(shape[1:])), 0.0


class Weights:
    def __init__(self, shapes: Dict[str, tuple], seed: int, device):
        self.shapes = dict(shapes)
        self.seed = seed
        self.device = torch.device(device)
        self.offsets = {}
        off = 0
        for name, shape in self.shapes.items():
            self.offsets[name] = off
            off += math.prod(shape)
        self.total = off

    def _chunk(self, c: int) -> torch.Tensor:
        n = min(CHUNK, self.total - c * CHUNK)
        g = torch.Generator(device=self.device).manual_seed(derive(self.seed, "weights", c))
        return torch.randn(n, generator=g, device=self.device)

    def make(self) -> Dict[str, torch.Tensor]:
        """Every leaf, as views of one flat buffer."""
        flat = torch.empty(self.total, device=self.device)
        for c in range(math.ceil(self.total / CHUNK)):
            flat[c * CHUNK:(c + 1) * CHUNK] = self._chunk(c)
        out = {}
        for name, shape in self.shapes.items():
            off = self.offsets[name]
            leaf = flat[off:off + math.prod(shape)].view(shape)
            scale, shift = affine(name, shape)
            out[name] = leaf.mul_(scale).add_(shift)
        return out

    def leaves(self) -> Iterator[Tuple[str, torch.Tensor]]:
        """(name, leaf) in order, made again chunk by chunk (one or two
        chunks held at a time)."""
        cache: Dict[int, torch.Tensor] = {}
        for name, shape in self.shapes.items():
            off, n = self.offsets[name], math.prod(shape)
            first, last = off // CHUNK, (off + n - 1) // CHUNK
            for c in [c for c in cache if c < first]:
                del cache[c]
            parts = []
            for c in range(first, last + 1):
                if c not in cache:
                    cache[c] = self._chunk(c)
                lo = max(off, c * CHUNK) - c * CHUNK
                hi = min(off + n, (c + 1) * CHUNK) - c * CHUNK
                parts.append(cache[c][lo:hi])
            leaf = (parts[0] if len(parts) == 1 else torch.cat(parts)).view(shape)
            scale, shift = affine(name, shape)
            yield name, leaf * scale + shift
