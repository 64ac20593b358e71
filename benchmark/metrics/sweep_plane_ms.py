"""Mean device-timeline ms of a span ``plane`` in the sweep update: one
depth plane of the B mains' vote-weighted sweep (K3c and the plane's
eager cost ops, box filter and running best)."""

from benchmark.metrics import plane_ms


def read(record):
    return plane_ms.read(record)
