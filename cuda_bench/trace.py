"""Short profiled slices of the card's work, and what the benchmark reads
from them.

A slice runs under ``torch.profiler`` between two spins of the card
(``torch.cuda._sleep``, kernel ``spin_kernel``): the profiler loses
records at the edges of short windows and late in long processes, and the
spins take those edges. Its chrome trace is written once (a few MB) and
read back: every device operation with its start and duration, and, where
the slice records the host too, the host's operators and the benchmark's
annotations.

:func:`measure` runs the same work twice. The first slice records CUDA
activity alone, so the profiler adds no host cost per operator: the
device's busy time (the union of the device operations' intervals) over
the wall between the spins, and the device operations, come from it. The
second records the host's operators as well, and serves only to name the
idle gaps: each gap by what the host was doing at its middle (the
innermost operator, under the benchmark's outermost annotation), summed by
name; its gaps hold the profiler's host cost.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import sys
from collections import defaultdict
from typing import Callable, Dict, List

PAD_CYCLES = 4_000_000  # about 2 ms at the card's highest SM clock
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def short(name: str) -> str:
    """A kernel's name without its return type, namespace, template
    arguments and parameters."""
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    name = re.sub(r"\(.*", "", name)
    depth, out = 0, []
    for ch in name:
        depth += ch == "<"
        if depth == 0:
            out.append(ch)
        depth -= ch == ">"
    return "".join(out).strip()[:80]


class Slice:
    """The profiler between two spins: :meth:`start`, the work, :meth:`stop`.
    ``start`` does not wait for the card: work queued before it runs
    before the first spin and falls outside the slice. ``host``: record
    the host's operators too."""

    def __init__(self, path: str, host: bool = False):
        self.path, self.host, self.prof = path, host, None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile as _profile

        both = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        # a process's first profiler session starts slowly (some 140 ms over
        # two training steps): a throwaway one first
        with _profile(activities=both):
            torch.zeros(1, device="cuda").add_(1)
        self.prof = _profile(activities=both if self.host else [ProfilerActivity.CUDA])
        self.prof.start()
        torch.cuda._sleep(PAD_CYCLES)

    def stop(self) -> dict:
        """Close the slice, write the chrome trace, and :func:`read` it."""
        import torch

        torch.cuda._sleep(PAD_CYCLES)
        torch.cuda.synchronize()
        self.prof.stop()
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self.prof.export_chrome_trace(self.path)
        with open(self.path) as f:
            out = read(json.load(f))
        out["trace_bytes"] = os.path.getsize(self.path)
        return out


def measure(run: Callable[[Slice, int], None], base: str, i: int) -> dict:
    """``run(slice, i)`` does one unit of work (a call, a step) and starts
    the slice inside it; run it in a slice of CUDA activity alone
    (``<base>.trace.json``), then as ``i + 1`` in one that names the
    host's work (``<base>.host.trace.json``). What :func:`read` reads from
    the first, with the second's ``idle_gaps``."""
    out = {}
    for k, host in enumerate((False, True)):
        s = Slice(f"{base}.host.trace.json" if host else f"{base}.trace.json", host=host)
        run(s, i + k)
        r = s.stop()
        print(f"trace{' (host)' if host else ''}: {r['trace_bytes']} bytes, "
              f"{len(r['kernels'])} device records, busy {r['busy_s']:.6f} of "
              f"{r['window_s']:.6f} s", file=sys.stderr, flush=True)
        if host:
            out["idle_gaps"] = r["idle_gaps"]
        else:
            out = r
    return out


def read(trace: dict) -> dict:
    """``kernels`` [(name, start us, duration us)] between the spins,
    ``busy_s``, ``window_s``, ``device_ops`` and ``idle_gaps`` (each at most
    ``TOP`` [name, seconds], longest first)."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    dev = sorted(((e["name"], float(e["ts"]), float(e.get("dur", 0))) for e in events
                  if e.get("cat") in DEVICE_CATS), key=lambda k: k[1])
    spins = [k for k in dev if "spin_kernel" in k[0]]
    if len(spins) >= 2:
        lo, hi = spins[0][1] + spins[0][2], spins[-1][1]
    elif dev:
        lo, hi = dev[0][1], max(k[1] + k[2] for k in dev)
    else:
        lo = hi = 0.0
    kernels = [k for k in dev if "spin_kernel" not in k[0] and k[1] >= lo and k[1] < hi]

    merged: List[List[float]] = []
    for _, ts, dur in kernels:
        end = min(ts + dur, hi)
        if merged and ts <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([ts, end])
    busy_us = sum(b - a for a, b in merged)

    by_name: Dict[str, float] = defaultdict(float)
    for name, _, dur in kernels:
        by_name[short(name)] += dur / 1e6

    def spans(keep):
        return sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"])
                      for e in events if keep(e))

    ops = spans(lambda e: e.get("cat") == "cpu_op")
    notes = spans(lambda e: e.get("cat") == "user_annotation" and e["name"].startswith("bench."))
    starts = [s for s, _, _ in ops]
    gaps: Dict[str, float] = defaultdict(float)
    edges = [lo] + [x for ab in merged for x in ab] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid)
        # operators nest, so the innermost one around mid started last
        op = next((name for s, e, name in reversed(ops[max(0, i - 400):i]) if e >= mid), None)
        note = next((name for s, e, name in reversed(notes) if s <= mid <= e), None)
        gaps[f"{note or 'host'}:{op or 'python'}"] += (b - a) / 1e6

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return dict(kernels=kernels, busy_s=busy_us / 1e6, window_s=(hi - lo) / 1e6,
                device_ops=top(by_name), idle_gaps=top(gaps))

