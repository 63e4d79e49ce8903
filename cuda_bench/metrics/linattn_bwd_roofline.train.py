"""linattn_bwd_roofline.train: K4, the linear-attention backward
(``ops/linear_attention.py``), percent of its roofline in the traced
slice: the bounds of the calls the slice ran over the device time of the
kernels whose names hold the patterns below
(:mod:`cuda_bench.roofline.share`)."""

from cuda_bench.roofline.share import roofline

KERNELS = [("k4", ("linattn_bwd_cluster", "linattn_bwd_finish"), "linattn_bwd_cluster")]


def read(rec):
    return roofline(rec, KERNELS)
