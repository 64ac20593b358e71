"""A kernel group's share of its roofline: the least time its work needs
(``record.work["kernels"][group]``: least seconds an update and the name
fragments of its kernels), over its device time an update in the trace."""


def share(record, group: str):
    kernels = record.work.get("kernels", {})
    if record.trace is None or group not in kernels or not record.updates:
        return None
    least_s, names = kernels[group]
    device_s = record.trace.time_of(*names)
    if device_s <= 0:
        return None
    return 100.0 * least_s * record.updates / device_s
