"""Device-timeline ms an update of the span ``flow_update`` less its
spans ``depth0``, ``flow`` and ``tri``: ``scan`` (K2, the mix chain),
``var``, ``all`` (normals) and the device's time between the spans."""

from benchmark.metrics._spans import span_ms


def read(record):
    ms = span_ms(record, "flow_update", "depth0", "flow", "tri")
    if ms is None:
        return None
    return ms["flow_update"] - ms["depth0"] - ms["flow"] - ms["tri"]
