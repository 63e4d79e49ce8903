"""Profiling and timing utilities.

Port of :mod:`dquartic_tpu.utils.profiling` on torch and CUDA:

  * :func:`trace` — context manager around ``torch.profiler`` writing a
    Chrome trace (``trace.json``, viewable in Perfetto or
    ``chrome://tracing``) of the enclosed block.
  * :class:`StepTimer` — wall-clock step statistics; with ``sync`` each
    step ends with ``torch.cuda.synchronize`` on the device of the tensor it
    observed.
  * :func:`device_memory_stats` — per-card memory from
    ``torch.cuda.memory_stats``, in MB under the JAX keys.
  * :func:`host_rss_mb` — the process's resident set size (psutil).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Profile the enclosed block (the host, and the card where there is
    one) and write ``<log_dir>/trace.json``; yields ``log_dir`` (None: a
    ``dquartic_trace`` directory under the temporary directory)."""
    from torch.profiler import ProfilerActivity, profile

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "dquartic_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Collect per-step wall-clock timings around device work.

    Usage::

        timer = StepTimer(sync=True)
        for batch in data:
            with timer.step():
                timer.observe(trainer.train_step(batch, lr)["loss"])
        print(timer.summary())

    With ``sync`` the exit of each step waits for the card that holds the
    observed tensor (``torch.cuda.synchronize``); leave it False to measure
    the host's dispatch alone."""

    def __init__(self, sync: bool = False):
        self.sync = sync
        self.times: List[float] = []
        self._last_out = None

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        yield self
        out = self._last_out
        if self.sync and getattr(out, "is_cuda", False):
            torch.cuda.synchronize(out.device)
        self.times.append(time.perf_counter() - t0)

    def observe(self, out):
        """Register the step output for sync-mode waiting."""
        self._last_out = out
        return out

    def summary(self) -> Dict[str, float]:
        """``steps``, and ``mean_ms``, ``p50_ms``, ``p95_ms``, ``max_ms`` of
        every step but the first (the warm-up), as JAX's."""
        if not self.times:
            return {}
        arr = np.asarray(self.times[1:] or self.times) * 1000.0
        return {
            "steps": len(self.times),
            "mean_ms": float(arr.mean()),
            "p50_ms": float(np.percentile(arr, 50)),
            "p95_ms": float(np.percentile(arr, 95)),
            "max_ms": float(arr.max()),
        }


def device_memory_stats() -> List[Dict[str, float]]:
    """Per-card memory in MB: the caching allocator's bytes in use and their
    peak, and the card's total memory (empty without CUDA)."""
    if not torch.cuda.is_available():
        return []
    out = []
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        out.append({
            "device": f"cuda:{i}",
            "bytes_in_use_mb": s.get("allocated_bytes.all.current", 0) / 1e6,
            "peak_bytes_mb": s.get("allocated_bytes.all.peak", 0) / 1e6,
            "bytes_limit_mb": torch.cuda.get_device_properties(i).total_memory / 1e6,
        })
    return out


def host_rss_mb() -> Optional[float]:
    """Resident set size of this process in MB (None without psutil)."""
    try:
        import psutil
    except ImportError:
        return None
    return psutil.Process(os.getpid()).memory_info().rss / 1024 / 1024
