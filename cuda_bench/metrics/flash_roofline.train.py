"""flash_roofline.train: K7a and K7b, the flash attention forward and
backward (``ops/flash_attention.py``), percent of their rooflines together
in the traced slice: the bounds of the calls the slice ran over the device
time of the kernels whose names hold the patterns below (every launch of
either path of K7b holds ``flash_bwd``; :mod:`cuda_bench.roofline.share`)."""

from cuda_bench.roofline.share import roofline

KERNELS = [("k7a", ("flash_fwd",), "flash_fwd"), ("k7b", ("flash_bwd",), "flash_bwd")]


def read(rec):
    return roofline(rec, KERNELS)
