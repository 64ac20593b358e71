"""Device-timeline ms an update of the span ``sweep_render``: every render
of the sweep update (SETUP, BIN, K1 for the B mains and their B*K
sides)."""

from benchmark.metrics._spans import span_ms


def read(record):
    ms = span_ms(record, "sweep_render")
    return None if ms is None else ms["sweep_render"]
