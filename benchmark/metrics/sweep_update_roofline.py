"""The whole sweep update's share of the card's roofline, %: the least
time of its work (renders, vote weights, 64 planes at their valid shares,
back-projection and normals; each stage the larger of bytes over 3.35
TB/s and float32 operations over 67 TFLOP/s) over the device's busy time
an update."""

from benchmark.metrics import update_roofline


def read(record):
    return update_roofline.read(record)
