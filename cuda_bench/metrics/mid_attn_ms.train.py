"""mid_attn_ms.train: mean device ms of the program's ``unet.mid.attn``
span plus that of its ``unet.mid.attn.backward`` (``models/unet1d.py``:
the bottleneck's mixer, forward and backward: the 4-layer transformer of
``simple: false``, the one cross attention of ``simple: true``), in the
traced slice's first request (the slice of CUDA activity alone;
``utils/profiling.py`` ``spans``). None where the program records no such
span."""


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

    fwd, bwd = mean("unet.mid.attn"), mean("unet.mid.attn.backward")
    return None if fwd is None or bwd is None else fwd + bwd
