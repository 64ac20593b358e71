"""Device events (kernels, copies, memsets) in the traced window over the
updates completed in it."""


def read(record):
    if record.trace is None or not record.updates:
        return None
    return record.trace.events / record.updates
