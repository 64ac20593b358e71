"""The mean Gauss-Newton sweep count of the window's updates (the update's
own ``gn_sweeps``; each sweep is one host sync)."""


def read(record):
    sweeps = record.work.get("counters", {}).get("gn_sweeps")
    if not sweeps:
        return None
    return sum(sweeps) / len(sweeps)
