"""The run's peak of device memory allocated (``torch.cuda.
max_memory_allocated``, read when the window has closed), GiB."""


def read(record):
    if not record.peak_bytes:
        return None
    return record.peak_bytes / 2**30
