"""resnet_roofline.sample: K2, the fused ResnetBlock forward
(``ops/fused_resnet.py``), percent of its roofline in the traced slice:
the bounds of the calls the slice ran over the device time of the kernels
whose names hold the patterns below (:mod:`cuda_bench.roofline.share`)."""

from cuda_bench.roofline.share import roofline

KERNELS = [("k2", ("resnet_fwd",), "resnet_fwd")]


def read(rec):
    return roofline(rec, KERNELS)
