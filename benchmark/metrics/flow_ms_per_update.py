"""Device-timeline ms an update of the span ``flow``: the batched flow
solve (K3, K4) with the taylor re-warp made inside it."""

from benchmark.metrics._spans import span_ms


def read(record):
    ms = span_ms(record, "flow")
    return None if ms is None else ms["flow"]
