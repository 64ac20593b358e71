"""Device-timeline ms an update of the span ``depth0``: every render of
the flow update (SETUP, BIN, K1)."""

from benchmark.metrics._spans import span_ms


def read(record):
    ms = span_ms(record, "depth0")
    return None if ms is None else ms["depth0"]
