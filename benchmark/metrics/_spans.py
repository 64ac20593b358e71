"""The program's recorder (``meshrecon_torch.utils.profiling.RECORDER``):
its spans and counters over a traced window, an update's share of each.

While torch.profiler runs, the program records its spans and counters
into that recorder. In a traced run the window is the only profiled
block, so the recorder holds the window's updates alone; it is read only
where its count of top-level spans (one an update) equals the window's
updates. A program without the recorder gives nothing to read."""


def recorder(record):
    """The program's recorder of the traced window, or None."""
    if record.trace is None or not record.updates:
        return None
    try:
        from meshrecon_torch.utils import profiling
    except ImportError:
        return None
    rec = getattr(profiling, "RECORDER", None)
    if rec is None or getattr(rec, "top_spans", None) != record.updates:
        return None
    return rec


def span_ms(record, *names):
    """Device-timeline ms an update of the spans ``names``, or None where
    a name has no span."""
    rec = recorder(record)
    if rec is None:
        return None
    device_s = rec.device_s
    if not all(device_s.get(n, 0) > 0 for n in names):
        return None
    return {n: device_s[n] * 1e3 / record.updates for n in names}


def counter_per_update(record, name: str, scale: float = 1.0):
    """The counter ``name`` an update, times ``scale`` (0 where the window
    counted none)."""
    rec = recorder(record)
    if rec is None:
        return None
    return rec.counters.get(name, 0) * scale / record.updates
