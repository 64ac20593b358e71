"""The readers of the program's spans and counters on the CPU: nothing
without a trace or against another window's recorder, and each reading
from a filled recorder.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from benchmark import core
from meshrecon_torch.utils import profiling

READERS = ("raster_ms_per_update", "flow_ms_per_update", "tri_ms_per_update",
           "other_ms_per_update", "plane_ms", "host_syncs_per_update",
           "sync_wait_ms_per_update")


def _record(updates, trace=True):
    return core.Record(updates=updates, window_s=1.0,
                       update_s=[0.1] * updates, pixels_per_update=1,
                       peak_bytes=0, trace=object() if trace else None)


@pytest.fixture
def filled(monkeypatch):
    """A recorder of 4 updates: device seconds by span, the window's
    counters."""
    rec = SimpleNamespace(
        top_spans=4,
        counts={"flow_update": 4, "plane": 256},
        device_s={"flow_update": 0.4, "depth0": 0.02, "flow": 0.06,
                  "tri": 0.2, "plane": 1.6},
        counters={"host_syncs": 216, "sync_wait": 0.05})
    monkeypatch.setattr(profiling, "RECORDER", rec)
    return rec


@pytest.mark.parametrize("name", READERS)
def test_span_readers_need_a_trace(filled, name):
    assert core.read_metric(name, _record(4, trace=False)) is None


@pytest.mark.parametrize("name", READERS)
def test_span_readers_need_the_windows_recorder(filled, name):
    # 5 updates in the window, 4 top-level spans in the recorder
    assert core.read_metric(name, _record(5)) is None


@pytest.mark.parametrize("name,value", [
    ("raster_ms_per_update", 5.0), ("flow_ms_per_update", 15.0),
    ("tri_ms_per_update", 50.0), ("other_ms_per_update", 30.0),
    ("plane_ms", 6.25), ("host_syncs_per_update", 54.0),
    ("sync_wait_ms_per_update", 12.5)])
def test_span_readers_from_a_filled_recorder(filled, name, value):
    assert core.read_metric(name, _record(4)) == pytest.approx(value)


def test_span_readers_without_the_program_recorder(monkeypatch):
    monkeypatch.delattr(profiling, "RECORDER")
    for name in READERS:
        assert core.read_metric(name, _record(4)) is None


def test_a_cpu_window_gives_counters_but_no_device_time():
    """The real recorder, filled by two profiled updates on the CPU: the
    counters read, the spans' device time does not (no CUDA events)."""
    from torch.profiler import ProfilerActivity, profile

    from meshrecon_torch import problems
    from meshrecon_torch.pipeline.fused import FusedMainUpdate

    args = [torch.from_numpy(a)
            for a in problems.fused_problem(2, 3, 48, 64, seed=0)]
    update = FusedMainUpdate(48, 64)
    profiling.RECORDER.clear()
    try:
        sweeps = []
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(2):
                update(*args)
                sweeps.append(update.last_gn_sweeps)
        record = _record(2)
        assert core.read_metric("host_syncs_per_update", record) == (
            sum(sweeps) / 2 + 4)
        assert core.read_metric("sync_wait_ms_per_update", record) > 0
        for name in ("raster_ms_per_update", "tri_ms_per_update",
                     "other_ms_per_update", "plane_ms"):
            assert core.read_metric(name, record) is None
    finally:
        profiling.RECORDER.clear()
