"""ddim_self_ms.sample: mean self device ms of the program's ``ddim.step``
span (``core/diffusion.py`` ``DDIMProcess.sample``, one reverse step):
the step less its ``unet.forward``, the DDIM update's arithmetic, in the
traced slice's first request (the slice of CUDA activity alone;
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
    ms = [s.self_ms for s in got if s.request == first and s.name == "ddim.step"]
    return sum(ms) / len(ms) if ms else None
