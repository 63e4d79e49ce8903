"""Training callbacks (port of :mod:`dquartic_tpu.train.callbacks`)."""

from __future__ import annotations


class CallbackHandler:
    """Epoch/batch callbacks. ``epoch_callback`` returning False stops
    training."""

    def epoch_callback(self, epoch: int, epoch_loss: float) -> bool:
        return True

    def batch_callback(self, batch: int, batch_loss: float) -> None:
        pass
