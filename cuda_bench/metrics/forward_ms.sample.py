"""forward_ms.sample: mean device ms of one denoiser call in the window,
from CUDA events the benchmark records around each call of the sampler's
model (``models/unet1d.py`` ``UNet1d.forward``)."""


def read(rec):
    return rec.get("forward_ms")
