"""Mean device-timeline ms of a span ``plane``: one depth plane of the
sweep (K3c and the plane's eager cost ops, box filter and running
best)."""

from benchmark.metrics._spans import recorder


def read(record):
    rec = recorder(record)
    if rec is None:
        return None
    planes = rec.counts.get("plane", 0)
    device_s = rec.device_s.get("plane", 0)
    if not planes or device_s <= 0:
        return None
    return device_s * 1e3 / planes
