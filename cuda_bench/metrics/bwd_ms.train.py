"""bwd_ms.train: mean device ms of the program's ``train_step.backward``
span (``train/trainer.py`` ``Trainer.train_step``: the backward and the
gradients' reduce), in the traced slice's first request (the slice of
CUDA activity alone; ``utils/profiling.py`` ``spans``)."""


def read(rec):
    if not rec.get("slice"):
        return None
    try:
        from dquartic_tpu_torch.utils.profiling import spans
    except ImportError:  # a program that records no spans
        return None
    got = spans()
    first = min((s.request for s in got if s.request is not None), default=None)
    ms = [s.device_ms for s in got if s.request == first and s.name == "train_step.backward"]
    return sum(ms) / len(ms) if ms else None
