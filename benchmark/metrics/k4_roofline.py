"""K4's (``csrc/hs_sweep.cu``) share of its roofline, %: the flow solve's
linearization and sweeps, a launch a pyramid level, against K4's device
time."""

from benchmark.metrics._roofline import share


def read(record):
    return share(record, "k4")
