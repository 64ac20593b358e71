"""The device's idle share of the traced window, %: 1 - busy / window,
busy the union of its kernels, copies and memsets."""


def read(record):
    t = record.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
