"""The raster's (SETUP, BIN and K1: ``csrc/raster_setup.cu``,
``csrc/raster.cu``) share of its roofline, %: every render of the update
(B mains and B*K sides on the soup) against the three kernels' device
time."""

from benchmark.metrics._roofline import share


def read(record):
    return share(record, "raster")
