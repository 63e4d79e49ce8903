"""to_host_ms.sample: mean device ms of the program's ``predict.to_host``
span (``infer/sampler.py`` ``DDIMSampler.predict``: a pair batch's
records copied to the host), in the traced slice's first request (the
slice of CUDA activity alone; ``utils/profiling.py`` ``spans``)."""


def read(rec):
    if not rec.get("slice"):
        return None
    try:
        from dquartic_tpu_torch.utils.profiling import spans
    except ImportError:  # a program that records no spans
        return None
    got = spans()
    first = min((s.request for s in got if s.request is not None), default=None)
    ms = [s.device_ms for s in got if s.request == first and s.name == "predict.to_host"]
    return sum(ms) / len(ms) if ms else None
