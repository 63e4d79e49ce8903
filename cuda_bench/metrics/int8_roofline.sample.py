"""int8_roofline.sample: K3, the int8-weight product of the mid convs
(``ops/int8_matmul.py``), percent of its roofline in the traced slice: the
bounds of the calls the slice ran over the device time of the kernels
whose names hold the patterns below (:mod:`cuda_bench.roofline.share`)."""

from cuda_bench.roofline.share import roofline

KERNELS = [("k3", ("int8_matmul_mma", "int8_matmul_reduce"), "int8_matmul_mma")]


def read(rec):
    return roofline(rec, KERNELS)
