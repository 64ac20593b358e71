"""The port's recorder (``utils/profiling``): spans, their nesting,
update ids and self time; where they record and where they do not; the
counters of the dense update's host syncs; the clock they share with
torch.profiler; and the spans in ``profile_trace``'s Chrome trace.

The ``cuda`` test needs an NVIDIA GPU and skips elsewhere. This file
imports no JAX, so on a machine without it run it without the
repository's conftest:

    python -m pytest --noconftest tests/test_torch_spans.py
"""

from __future__ import annotations

import json
import os
import time
import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from meshrecon_torch import problems
from meshrecon_torch.depth.plane_sweep import plane_sweep_depth
from meshrecon_torch.pipeline.fused import (FusedMainUpdate,
                                            fused_sweep_update_batched)
from meshrecon_torch.utils import profiling
from meshrecon_torch.utils.profiling import StageTimer, span

H, W = 48, 64
FLOW_SPANS = ("flow_update", "depth0", "scan", "flow", "var", "tri", "all")
# the flow update's host syncs besides Gauss-Newton's sweeps: the exit
# test, linalg.inv's status in ``scan`` and in ``tri``, the pdf's
# constant copied to the device in ``tri``
FLOW_SYNCS_BESIDES_SWEEPS = 4


@pytest.fixture
def recorder():
    profiling.RECORDER.clear()
    yield profiling.RECORDER
    profiling.RECORDER.clear()


def _args(device="cpu", b=2, k=3, h=H, w=W):
    return [torch.from_numpy(a).to(device)
            for a in problems.fused_problem(b, k, h, w, seed=0)]


def _sweep_args(args):
    """plane_sweep_depth's window of the fused problem's first main."""
    return (args[3][0], args[5][0], args[2][0], args[4][0], args[6][0],
            -0.8, 0.6)


def test_spans_nest_with_parent_update_and_self_time():
    t = StageTimer()
    with t.stage("outer") as done:
        with span("a") as a:
            time.sleep(0.002)
            with span("b") as b:
                time.sleep(0.004)
        with span("a") as a2:
            pass
        done(None)
    with t.stage("outer"):
        with span("c") as c:
            pass
    assert b.parent is a and a.parent.name == "outer"
    assert a.update == b.update == a2.update == 1 and c.update == 2
    assert t.top_spans == 2 and t.counts["a"] == 2 and t.counts["outer"] == 2
    host_b = (b.t1_ns - b.t0_ns) / 1e9
    assert a.child_ns == b.t1_ns - b.t0_ns
    assert t.self_s["a"] == pytest.approx(t.host_s["a"] - host_b, abs=1e-9)
    assert t.self_s["b"] == t.host_s["b"] >= 0.004
    # off CUDA a span's time is its host time
    assert t.times["b"] == t.host_s["b"] and not t.device_s


def test_span_records_nowhere_off_and_into_the_open_timer(recorder):
    assert span("x") is span("y")  # the shared null span
    with span("x"):
        pass
    profiling.count("gn_sweeps", 3)
    assert profiling.host_read(torch.ones(2).sum()) == 2.0
    assert not recorder.counts and not recorder.counters
    off = StageTimer(enabled=False)
    with off.stage("s"):
        with span("x"):
            pass
    assert not off.counts and not recorder.counts
    t = StageTimer()
    with t.stage("s"):
        with span("x"):
            profiling.count("gn_sweeps", 3)
    assert t.counts["x"] == 1 and t.counters == {"gn_sweeps": 3}
    assert not recorder.counts


def test_the_profiler_turns_the_process_recorder_on_and_off(recorder):
    with profile(activities=[ProfilerActivity.CPU]):
        with span("x"):
            profiling.host_read(torch.ones(1))
        t = StageTimer()
        with t.stage("s"):  # an open timer takes the thread's spans
            with span("y"):
                pass
    with span("z"):
        pass
    assert dict(recorder.counts) == {"x": 1} and recorder.top_spans == 1
    assert recorder.counters["host_syncs"] == 1
    assert t.counts["y"] == 1


def test_stage_waits_for_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a stage synchronized")

    monkeypatch.setattr(profiling, "_sync", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    t = StageTimer()
    with t.stage("a", pixels=10) as done:
        assert done({"x": [torch.ones(3)]})["x"][0].sum() == 3
    assert t.counts["a"] == 1 and t.pixels["a"] == 10


def test_report_prints_counters_only_when_set():
    t = StageTimer()
    with t.stage("a"):
        pass
    assert "counter" not in t.report()
    with t.stage("flow_update"):
        profiling.count("gn_sweeps", 50)
        profiling.host_read(torch.ones(1))
    lines = t.report().splitlines()
    assert lines[3].split() == ["counter", "total"]
    assert lines[4].split() == ["gn_sweeps", "50", "(50.0", "a",
                                "flow_update)"]
    assert lines[5].split() == ["host_syncs", "1"]
    assert lines[6].split()[0] == "sync_wait" and len(lines) == 7


def test_flow_update_opens_each_span_once_and_counts_its_syncs():
    update = FusedMainUpdate(H, W)
    args = _args()
    for rounds in (1, 2):
        t = StageTimer()
        with t.stage("call"):
            sweeps = []
            for _ in range(rounds):
                update(*args)
                sweeps.append(update.last_gn_sweeps)
        assert {n: t.counts[n] for n in FLOW_SPANS} == dict.fromkeys(
            FLOW_SPANS, rounds)
        assert set(t.counts) == {"call", *FLOW_SPANS}
        assert t.counters["gn_sweeps"] == sum(sweeps) > 0
        assert t.counters["host_syncs"] == (
            sum(sweeps) + rounds * FLOW_SYNCS_BESIDES_SWEEPS)


@pytest.mark.parametrize("variant", [{"variance": "rewarp"},
                                     {"use_farneback": True}])
def test_flow_update_rewarp_span_on_its_paths(variant):
    t = StageTimer()
    with t.stage("call"):
        FusedMainUpdate(H, W, **variant)(*_args())
    assert t.counts["rewarp"] == 1 and t.counts["flow"] == 1


def test_plane_sweep_opens_a_plane_span_a_depth():
    args = _args()
    t = StageTimer()
    with t.stage("call"):
        plane_sweep_depth(*_sweep_args(args), num_depths=6)
    assert t.counts["sweep"] == 1 and t.counts["plane"] == 6
    # the planes' range copied to the device, the planes' depths,
    # linalg.inv's status
    assert t.counters["host_syncs"] == 4
    t = StageTimer()
    with t.stage("call"):
        fused_sweep_update_batched(*args, H, W, num_depths=5)
    assert {n: t.counts[n] for n in ("sweep_update", "depth0", "scan",
                                     "sweep", "plane", "all")} == {
        "sweep_update": 1, "depth0": 1, "scan": 1, "sweep": 1, "plane": 5,
        "all": 1}


def test_span_clock_is_the_profilers(recorder):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("clock") as s:
            with record_function("probe.range"):
                torch.ones(8).add_(1)
    (start,) = [e.start_ns() for e in prof.profiler.kineto_results.events()
                if e.name() == "probe.range"]
    assert 0 <= start - s.t0_ns <= 5_000_000


def test_program_spans_stay_out_of_the_profile(recorder):
    update = FusedMainUpdate(H, W)
    args = _args()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        update(*args)
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert names and not names & set(FLOW_SPANS)
    assert recorder.counts["flow_update"] == 1


def test_profile_trace_writes_the_spans_on_its_time_base(tmp_path,
                                                         recorder):
    update = FusedMainUpdate(H, W)
    args = _args()
    update(*args)
    with profiling.profile_trace(str(tmp_path), "cpu") as summary:
        update(*args)
    trace = json.loads((tmp_path / "trace.json").read_text())
    events = trace["traceEvents"]
    spans = [e for e in events if e.get("cat") == profiling.SPAN_CAT]
    assert sorted(e["name"] for e in spans) == sorted(FLOW_SPANS)
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    lo = min(e["ts"] for e in ops)
    hi = max(e["ts"] + e["dur"] for e in ops)
    (top,) = [e for e in spans if e["name"] == "flow_update"]
    assert lo - 5000 <= top["ts"] <= lo and hi <= top["ts"] + top["dur"]
    assert all(e["args"]["update"] == top["args"]["update"] for e in spans)
    assert {e["args"]["parent"] for e in spans} == {None, "flow_update"}
    busy = json.loads((tmp_path / "device_busy.json").read_text())
    assert busy == summary and busy["device_events"] == 0


@pytest.mark.cuda
def test_counters_miss_no_sync_on_the_card():
    """Every sync the card reports inside an update is one the counter
    counted; a stage on CUDA values reports none and reads device time."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    h, w = 96, 128
    args = _args(dev, 2, 3, h, w)
    update = FusedMainUpdate(h, w)
    calls = {
        "flow_update": lambda: update(*args),
        "sweep_update": lambda: fused_sweep_update_batched(
            *args, h, w, num_depths=8),
        "sweep": lambda: plane_sweep_depth(*_sweep_args(args),
                                           num_depths=8),
    }
    x = torch.ones(1 << 20, device=dev)
    calls["stage"] = lambda: x + 1
    for name, call in calls.items():
        call()  # the kernels built and loaded
        torch.cuda.synchronize()
        t = StageTimer()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with t.stage("call") as done:
                    done(call())
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs = [f"{os.path.basename(c.filename)}:{c.lineno}"
                 for c in caught
                 if "called a synchronizing CUDA operation" in str(c.message)]
        assert len(syncs) == t.counters.get("host_syncs", 0), (name, syncs)
        assert t.device_s["call"] > 0, name
        if name == "stage":
            assert not syncs
        else:
            assert t.device_s[name] > 0 and t.counters["host_syncs"] > 0
    assert t.times["call"] == t.device_s["call"]
