"""Per-layer metrics, one module a metric, named as the metric (``.`` and
``-`` as ``_``). Each has ``read(record)``: the metric's value from the
run's record (``benchmark.core.Record``), or None where the run gives it
nothing to read; a share of a roofline is never made up as 0."""
