"""Device-timeline ms an update of the span ``tri``: the Gauss-Newton
triangulation, its set-up, sweeps and host round trips."""

from benchmark.metrics._spans import span_ms


def read(record):
    ms = span_ms(record, "tri")
    return None if ms is None else ms["tri"]
