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
  * :func:`span`, :func:`request`, :func:`backward_span`, :func:`recording`,
    :func:`spans`, :func:`clear` — the program's spans (below).

Spans
-----
The port marks its layers with spans: ``predict`` (a pair batch of
``DDIMSampler.predict``) holding ``predict.to_device``, one ``ddim.step``
a reverse step and ``predict.to_host``; ``unet.forward`` and, within it,
``unet.mid`` (the bottleneck), with ``unet.mid.backward`` over the
bottleneck's backward; ``train_step`` (``Trainer.train_step``) holding
``train_step.batch``, ``.forward``, ``.backward``, ``.optimizer`` and
``.ema``. Spans record while :func:`recording` is active or while any
``torch.profiler`` session runs (so :func:`trace` carries them). Otherwise
a span site costs one check of a module flag and of the profiler's: no
``record_function``, no CUDA event, no autograd node.

A recorded span keeps its name, id, parent (the innermost recorded span
open at its entry), request id, host start and end (``time.time_ns()``)
and its device ms: CUDA events on the current stream at entry and exit
where CUDA is in use, else the host's ms (CPU operations run as they are
called). While a profiler runs the span also enters
``torch.profiler.record_function(name)``, so it shows in the chrome trace
as a ``user_annotation`` on the clock of the device operations (the Unix
clock, as ``time.time_ns()``). Each request (a pair batch of ``predict``,
a ``train_step``) takes the next id of a process-wide counter, whether
spans record or not.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler


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


# ---------------------------------------------------------------------- #
# spans                                                                  #
# ---------------------------------------------------------------------- #

MAX_SPANS = 100_000  # the store keeps the newest spans

_recording = 0  # depth of recording() contexts
_store: "collections.deque[Span]" = collections.deque(maxlen=MAX_SPANS)
# the recorded spans open now, innermost last; one stack for the process,
# since autograd's device thread runs a backward while its caller waits
_open: List["Span"] = []
_span_ids = itertools.count(1)
_request_ids = itertools.count(1)
_request: Optional[int] = None
_free_events: List[torch.cuda.Event] = []


@contextlib.contextmanager
def recording():
    """Record spans inside the block, profiler or not."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


class _Off:
    """What a span site gets while nothing records: enters nothing, marks
    nothing."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    @staticmethod
    def entry(x):
        return x

    exit = entry


_OFF = _Off()


def _event() -> torch.cuda.Event:
    ev = _free_events.pop() if _free_events else torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class Span:
    """One recorded span (see the module's docstring); ``device_ms`` and
    ``self_ms`` are filled by :func:`spans`."""

    __slots__ = ("name", "id", "parent", "request", "start_ns", "end_ns", "device_ms",
                 "self_ms", "_events", "_annotation")

    def __init__(self, name: str):
        self.name = name
        self.end_ns = self.device_ms = self.self_ms = self._annotation = None

    def __enter__(self) -> "Span":
        self.id = next(_span_ids)
        self.parent = _open[-1].id if _open else None
        self.request = _request
        if _autograd_profiler._is_profiler_enabled:
            self._annotation = torch.profiler.record_function(self.name)
            self._annotation.__enter__()
        self.start_ns = time.time_ns()
        self._events = (_event(),) if torch.cuda.is_initialized() else None
        _open.append(self)
        return self

    def __exit__(self, *exc):
        if self._events is not None:
            self._events += (_event(),)
        if self._annotation is not None:
            self._annotation.__exit__(None, None, None)
            self._annotation = None
        self.end_ns = time.time_ns()
        if self._events is None:
            self.device_ms = (self.end_ns - self.start_ns) / 1e6
        if _open and _open[-1] is self:
            _open.pop()
        elif self in _open:
            _open.remove(self)
        _store.append(self)
        return False

    def __repr__(self):
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"request={self.request}, device_ms={self.device_ms})")


def span(name: str):
    """A context manager that records one span named ``name`` while spans
    record, and does nothing otherwise."""
    return Span(name) if _recording or _autograd_profiler._is_profiler_enabled else _OFF


class request:
    """One request: the next id of the process-wide counter for every span
    inside, and a root span ``name`` around them."""

    __slots__ = ("name", "_span", "_prev")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> int:
        global _request
        self._prev, _request = _request, next(_request_ids)
        self._span = span(self.name)
        self._span.__enter__()
        return _request

    def __exit__(self, *exc):
        global _request
        self._span.__exit__(*exc)
        _request = self._prev
        return False


class _BackwardMark(torch.autograd.Function):
    """Identity; its backward opens the marks' span (``opens``: at the
    marked stretch's exit, which the backward reaches first) or closes it
    (at the stretch's entry, which it reaches last)."""

    @staticmethod
    def forward(ctx, x, marks, opens):
        ctx.marks, ctx.opens = marks, opens
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        marks = ctx.marks
        if ctx.opens:
            marks.span = Span(marks.name).__enter__()
        elif marks.span is not None:
            marks.span.__exit__(None, None, None)
            marks.span = None
        return grad, None, None


class _BackwardMarks:
    __slots__ = ("name", "span")

    def __init__(self, name: str):
        self.name, self.span = name, None

    def entry(self, x: torch.Tensor) -> torch.Tensor:
        return _BackwardMark.apply(x, self, False)

    def exit(self, x: torch.Tensor) -> torch.Tensor:
        return _BackwardMark.apply(x, self, True)


def backward_span(name: str):
    """A span ``name`` over the backward of a stretch of the forward:
    ``x = marks.entry(x)`` where the stretch begins and ``y =
    marks.exit(y)`` where it ends insert identity autograd Functions, and
    the span runs from the exit's backward to the entry's. Only while spans
    record and grad is enabled; otherwise both return their tensor as it
    is. Recomputation of the stretch in the backward (remat) falls inside
    the span."""
    if (_recording or _autograd_profiler._is_profiler_enabled) and torch.is_grad_enabled():
        return _BackwardMarks(name)
    return _OFF


def spans() -> List[Span]:
    """The recorded spans, in the order they ended, with ``device_ms``
    (the device's work waited for once) and ``self_ms``: ``device_ms`` less
    that of the recorded spans whose parent it is."""
    done = list(_store)
    pending = [s for s in done if s._events is not None]
    if pending:
        torch.cuda.synchronize()
        for s in pending:
            a, b = s._events
            s.device_ms = a.elapsed_time(b)
            s._events = None
            _free_events.extend((a, b))
    children: Dict[int, float] = collections.defaultdict(float)
    for s in done:
        if s.parent is not None and s.device_ms is not None:
            children[s.parent] += s.device_ms
    for s in done:
        if s.device_ms is not None:
            s.self_ms = s.device_ms - children.get(s.id, 0.0)
    return done


def clear() -> None:
    """Forget every recorded span, and any left open."""
    _store.clear()
    _open.clear()
