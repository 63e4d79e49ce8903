"""Timestamps on the device's timeline: CUDA events on a card, the host's
clock elsewhere (the CPU tests of the harness)."""

from __future__ import annotations

import time
from typing import List

import torch


class Stamp:
    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        if self.cuda:
            self.event = torch.cuda.Event(enable_timing=True)
            self.event.record()
        else:
            self.t = time.perf_counter()

    def ms_to(self, later: "Stamp") -> float:
        if self.cuda:
            return self.event.elapsed_time(later.event)
        return (later.t - self.t) * 1e3


class Timed:
    """``fn`` with a stamp before and after each call, under a profiler
    annotation; :meth:`mean_ms` once the device has finished."""

    def __init__(self, fn, name: str, device):
        self.fn, self.name, self.device = fn, name, device
        self.pairs: List[tuple] = []

    def __call__(self, *args, **kwargs):
        start = Stamp(self.device)
        with torch.profiler.record_function(self.name):
            out = self.fn(*args, **kwargs)
        self.pairs.append((start, Stamp(self.device)))
        return out

    def mean_ms(self) -> float:
        return sum(a.ms_to(b) for a, b in self.pairs) / len(self.pairs)
