"""linattn_roofline.sample: K1, the linear-attention forward
(``ops/linear_attention.py``), percent of its roofline in the traced
slice: the bounds of the calls the slice ran over the device time of the
kernels whose names hold the patterns below
(:mod:`cuda_bench.roofline.share`)."""

from cuda_bench.roofline.share import roofline

KERNELS = [("k1", ("linattn_cluster",), "linattn_cluster")]


def read(rec):
    return roofline(rec, KERNELS)
