"""mfu.sample: the model FLOPs of the window's work (the forward's
products, three times for a training step, no recomputation counted;
:func:`cuda_bench.roofline.model.forward_flops`) over the window's time, as
a percent of the card's 989 TFLOP/s bf16 peak."""

from cuda_bench.roofline import PEAK_BF16


def read(rec):
    w = rec.get("window")
    if not w or not w["seconds"]:
        return None
    return 100.0 * w["flops"] / w["seconds"] / PEAK_BF16
