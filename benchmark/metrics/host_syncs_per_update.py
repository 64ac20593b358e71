"""Host syncs an update: the program's counter ``host_syncs`` (every
read of a device value, blocking status check and copy from pageable
memory in the update) over the window's updates."""

from benchmark.metrics._spans import counter_per_update


def read(record):
    return counter_per_update(record, "host_syncs")
