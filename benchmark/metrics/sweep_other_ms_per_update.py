"""Device-timeline ms an update of the span ``sweep_update`` less its
spans ``sweep_render`` and ``sweep``: ``sweep_vote`` (K2's masks as vote
weights, the z ranges), the sweep window's set-up, ``sweep_finish``
(back-projection, pdf, normals) and the device's time between the
spans."""

from benchmark.metrics._spans import span_ms


def read(record):
    ms = span_ms(record, "sweep_update", "sweep_render", "sweep")
    if ms is None:
        return None
    return ms["sweep_update"] - ms["sweep_render"] - ms["sweep"]
