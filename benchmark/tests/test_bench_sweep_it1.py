"""``koule.sweep-it1`` on the CPU at a small size: its files are found by
name, the reference equals the program's plain path, the control fails
the limits, a broken timed path is not correct, the soup is packed as the
program packs it, and the cell's per-layer readers read nothing without a
trace and the right value from a synthetic record.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import calibrate, compare, core
from benchmark.inputs.soup import load_soup, pack_soup
from benchmark.trace import reduce_events
from meshrecon_torch.utils import profiling

CELL = "koule.sweep-it1"
SMALL = {"configs": {"height": 48, "width": 64, "num_depths": 8},
         "traffic": {"batches": 2, "check_range": 4}}
READERS = ("sweep_render_ms_per_update", "sweep_plane_ms",
           "sweep_other_ms_per_update", "sweep_update_roofline",
           "sweep_k3c_roofline")


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _limits():
    bench = core.load_benchmark()
    return core.cell_files(core.find_cell(bench, CELL))[2]


def test_the_cell_finds_its_files():
    bench = core.load_benchmark()
    cell = core.find_cell(bench, CELL)
    assert cell["chips"] == 1
    config, traffic, limits = core.cell_files(cell)
    assert config["name"] == cell["config"] == "koule-tr-it1"
    assert config["reduced"] == []
    assert traffic["entry"] == "sweep_update"
    assert (core.HERE / "entries" / "sweep_update.py").is_file()
    assert (core.HERE / config["track"]).is_file()
    assert load_soup(core.HERE / config["soup"]).shape == (48, 3, 3)
    assert set(limits) == {"depth_max", "valid_mismatch", "point_p50",
                           "point_p99", "point_max", "normal_p99",
                           "pdf_p99"}
    reported = {m["name"] for m in core.cell_metrics(bench, CELL,
                                                     "per_layer")}
    assert reported == set(READERS)
    assert {m["name"] for m in core.cell_metrics(bench, CELL,
                                                 "end_to_end")} == {
        "depth_mpix_per_s", "setup_s"}


@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_reference_equals_the_programs_plain_path(seed):
    r = calibrate.readings(CELL, seed, control=False, device="cpu",
                           overrides=SMALL)
    assert r["program"] and all(v == 0.0 for v in r["program"].values()), r


def test_the_control_fails_the_limits():
    r = calibrate.readings(CELL, 5, control=True, device="cpu",
                           overrides=SMALL)
    correct, _ = compare.judge(r["control"], _limits())
    assert not correct, r["control"]


def _altered(program):
    """One valid pixel's point moved where the answer is produced."""
    def call(*args):
        out = dict(program(*args))
        t = out["point4"].clone()
        at = tuple(torch.nonzero(out["valid"])[0].tolist())
        t[at] = t[at] + 0.5
        out["point4"] = t
        return out
    return call


def _half_batch(program):
    """Half of the batch left out: the update run on its first half,
    whose outputs stand for the whole batch."""
    def call(*args):
        b = args[2].shape[0]
        half = [a if i < 2 else a[:b // 2] for i, a in enumerate(args)]
        out = program(*half)
        return {k: torch.cat([v, v]) for k, v in out.items()}
    return call


@pytest.mark.parametrize("fault", [_altered, _half_batch])
def test_a_broken_timed_path_is_not_correct(fault):
    result, _ = core.run(CELL, 9, 0.2, False, t_start=time.perf_counter(),
                         device="cpu", overrides=SMALL, wrap=fault)
    assert result["correct"] is False
    assert any(row["value"] == "inf" or row["value"] > row["limit"]
               for row in result["checks"].values())


def test_a_sound_run_is_correct():
    result, lines = core.run(CELL, 9, 0.2, False,
                             t_start=time.perf_counter(), device="cpu",
                             overrides=SMALL)
    assert result["correct"] is True, lines
    assert set(result["metrics"]) == {"depth_mpix_per_s", "setup_s"}


def test_the_soup_is_packed_as_the_program_packs_it():
    from meshrecon_torch.state import pack_soup as programs

    config = core.cell_files(core.find_cell(core.load_benchmark(), CELL))[0]
    soup = load_soup(core.HERE / config["soup"])
    ours, theirs = pack_soup(soup), programs(soup)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert ours[0].shape == (64, 3, 3) and int(ours[1].sum()) == 48
    # and a soup past the smallest capacity, in another order
    rng = np.random.default_rng(4)
    more = rng.normal(size=(100, 3, 3)).astype(np.float32)
    for a, b in zip(pack_soup(more), programs(more)):
        assert np.array_equal(a, b)


def _work(bucket: int, seed: int) -> dict:
    """The work model of a small entry whose sides are padded to
    ``bucket``, over its two batches (set up with no warm-up update)."""
    from benchmark.entries.sweep_update import Entry

    config, traffic, _ = core.cell_files(
        core.find_cell(core.load_benchmark(), CELL),
        {"configs": dict(SMALL["configs"], side_bucket=bucket),
         "traffic": dict(SMALL["traffic"], warm_updates=0)})
    entry = Entry(config, traffic, seed, "cpu", core.HERE)
    entry.setup()
    entry.ran = {0, 1}
    return entry.work(trace={})


@pytest.mark.parametrize("seed", [6, 2**31 + 7])
def test_the_work_model_counts_no_padded_side(seed):
    """A padded side slot (identity camera, zero frame, side_valid false)
    needs no render, no K3c and no cost: doubling the bucket's padding
    leaves the least time and K3c's unchanged."""
    at8, at16 = _work(8, seed), _work(16, seed)
    assert at8["update_least_s"] > 0 and at8["kernels"]["k3c"][0] > 0
    assert at16["update_least_s"] == pytest.approx(at8["update_least_s"],
                                                   rel=1e-12)
    assert at16["kernels"]["k3c"][0] == pytest.approx(
        at8["kernels"]["k3c"][0], rel=1e-12)


def _record(updates, trace=None, work=None):
    record = core.Record(updates=updates, window_s=1.0,
                         update_s=[0.1] * updates, pixels_per_update=1,
                         peak_bytes=0, trace=trace)
    record.work = work or {}
    return record


@pytest.mark.parametrize("name", READERS)
def test_the_readers_read_nothing_without_a_trace(name):
    assert core.read_metric(name, _record(4)) is None


@pytest.fixture
def filled(monkeypatch):
    """A recorder of 4 sweep updates: device seconds by span."""
    rec = SimpleNamespace(
        top_spans=4, counts={"sweep_update": 4, "plane": 256},
        device_s={"sweep_update": 0.48, "sweep_render": 0.004,
                  "sweep_vote": 0.02, "sweep": 0.4, "plane": 0.384,
                  "sweep_finish": 0.05},
        counters={})
    monkeypatch.setattr(profiling, "RECORDER", rec)
    return rec


@pytest.mark.parametrize("name,value", [
    ("sweep_render_ms_per_update", 1.0), ("sweep_plane_ms", 1.5),
    ("sweep_other_ms_per_update", 19.0), ("sweep_update_roofline", 25.0),
    ("sweep_k3c_roofline", 40.0)])
def test_the_readers_from_a_synthetic_record(filled, name, value):
    ms = 1_000_000
    # 4 updates: the device busy 8 ms, K3c 5 ms of it
    summary = reduce_events(
        [(0, 5 * ms, "sample_bilinear_masked_kernel(float const*)"),
         (6 * ms, 9 * ms, "elementwise_kernel")], [], 0, 10 * ms)
    record = _record(4, trace=summary, work={
        "update_least_s": 0.0005,
        "kernels": {"k3c": (0.0005, ("sample_bilinear_masked_kernel",))}})
    assert core.read_metric(name, record) == pytest.approx(value)
