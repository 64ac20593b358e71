"""K3c's (``csrc/warp.cu``, the masked bilinear sample) share of its
roofline, %: a solve's per-plane samples of every side, as the data's
valid mask needs them, against K3c's device time."""

from benchmark.metrics._roofline import share


def read(record):
    return share(record, "k3c")
