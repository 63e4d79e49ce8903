"""mid_ms.train: mean device ms of the program's ``unet.mid`` span plus
that of its ``unet.mid.backward`` (``models/unet1d.py``: the bottleneck,
``mid_block1``, ``mid_attn``, ``mid_block2``, forward and backward), in
the traced slice's first request (the slice of CUDA activity alone;
``utils/profiling.py`` ``spans``)."""


def read(rec):
    if not rec.get("slice"):
        return None
    try:
        from dquartic_tpu_torch.utils.profiling import spans
    except ImportError:  # a program that records no spans
        return None
    got = spans()
    first = min((s.request for s in got if s.request is not None), default=None)

    def mean(name):
        ms = [s.device_ms for s in got if s.request == first and s.name == name]
        return sum(ms) / len(ms) if ms else None

    fwd, bwd = mean("unet.mid"), mean("unet.mid.backward")
    return None if fwd is None or bwd is None else fwd + bwd
