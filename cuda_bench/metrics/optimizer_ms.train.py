"""optimizer_ms.train: mean device ms of ``trainer.optimizer.step`` (clip +
AdamW, ``train/optim.py``) in the window, from CUDA events the benchmark
records around each call."""


def read(rec):
    return rec.get("optimizer_ms")
