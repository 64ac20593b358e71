"""The whole update's share of the card's roofline, %: the least time of
its work (the larger of bytes over 3.35 TB/s and float32 operations over
67 TFLOP/s, summed over its stages) over the device's busy time an
update."""


def read(record):
    least = record.work.get("update_least_s")
    t = record.trace
    if t is None or least is None or t.busy_s <= 0 or not record.updates:
        return None
    return 100.0 * least * record.updates / t.busy_s
