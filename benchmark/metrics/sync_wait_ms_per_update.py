"""Host ms blocked in the update's host syncs, an update: the program's
counter ``sync_wait`` (seconds) over the window's updates."""

from benchmark.metrics._spans import counter_per_update


def read(record):
    return counter_per_update(record, "sync_wait", 1e3)
