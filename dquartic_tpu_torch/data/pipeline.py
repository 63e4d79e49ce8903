"""Host -> device streaming (the port's counterpart of
:mod:`dquartic_tpu.data.pipeline`).

A background thread keeps ``size`` batches in flight ahead of the
consumer, so pair sampling and parquet decoding on the host overlap with
the work on the card. On a CUDA device each array is copied into pinned
host memory and sent with a ``non_blocking`` copy on the current stream,
which orders it before the kernels that read it.

Under a mesh every rank builds the same dataset from the same seed and
draws the same global batches; with ``dp > 1`` the inner iterable
(``PairBatches(rows=...)``) yields only the rank's rows, so the thread pins
and copies those alone.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterable, Iterator

import numpy as np
import torch


class prefetch_iterator:
    """Wrap an epoch-iterable of dict batches of numpy arrays; yield dicts
    of tensors on ``device``. Iteration is re-entrant: each ``__iter__``
    starts a new producer thread over the inner iterable, and an exception
    raised by the producer is raised at the consumer. A consumer that stops
    early (``break``) stops and joins the producer when its iterator is
    closed."""

    _SENTINEL = object()
    _POLL_S = 0.05

    def __init__(self, inner: Iterable, device, size: int = 2):
        self.inner = inner
        self.device = torch.device(device)
        self.size = size

    def __len__(self) -> int:
        return len(self.inner)

    def reset_epoch(self) -> None:
        if hasattr(self.inner, "reset_epoch"):
            self.inner.reset_epoch()

    def _put(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        return out

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        q: "queue.Queue" = queue.Queue(maxsize=self.size)
        stop = threading.Event()
        err: list = []

        def offer(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=self._POLL_S)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for batch in self.inner:
                    if not offer(self._put(batch)):
                        return
            except Exception as e:  # raised on the consumer side
                err.append(e)
            finally:
                offer(self._SENTINEL)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is self._SENTINEL:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            stop.set()
            t.join()
