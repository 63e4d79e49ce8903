"""resnet_bwd_roofline.train: K5, the fused ResnetBlock backward
(``ops/fused_resnet.py``), percent of its roofline in the traced slice:
the bounds of the calls the slice ran over the device time of the kernels
whose names hold the patterns below (:mod:`cuda_bench.roofline.share`)."""

from cuda_bench.roofline.share import roofline

KERNELS = [("k5", ("resnet_bwd",), "resnet_bwd")]


def read(rec):
    return roofline(rec, KERNELS)
