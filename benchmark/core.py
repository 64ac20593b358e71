"""The harness: one run of one cell.

Everything that belongs to one configuration, one traffic mix, one
per-layer metric or one cell's limits is a file of its own, found by the
name ``BENCHMARK.json`` gives it:

- ``benchmark/configs/<config>.json``: the configuration's sizes;
- ``benchmark/traffic/<traffic>.json``: the mix's parameters, and in
  ``entry`` the driver of the program's entry it calls
  (``benchmark/entries/<entry>.py``, class ``Entry``);
- ``benchmark/metrics/<metric>.py``: ``read(record)`` of a per-layer
  metric, None where the run has nothing for it to read;
- ``benchmark/limits/<cell>.json``: the limit of each number compared.

A run: set-up (the entry's inputs on the card, the program built, its
warm-up), then a closed loop of one caller for ``seconds`` (each update
ends with its outputs on the host), then, with the program's state freed,
the check of the drawn updates against the plain reference.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import math
import statistics
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "meshrecon")


@dataclass
class Record:
    """What a run hands the per-layer metrics' readers."""
    updates: int
    window_s: float
    update_s: list
    pixels_per_update: int
    peak_bytes: int
    trace: object = None  # trace.TraceSummary of a traced run
    work: dict = field(default_factory=dict)


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def module_name(name: str) -> str:
    """A metric's or an entry's module: its name with ``.`` and ``-`` as
    ``_``."""
    return name.replace(".", "_").replace("-", "_")


def find_cell(bench: dict, workload: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == workload:
            return cell
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def cell_files(cell: dict, overrides: dict | None = None):
    """(config, traffic, limits) dicts of a cell, each from its own file,
    with ``overrides`` ({"config": {...}, "traffic": {...}}) applied."""
    overrides = overrides or {}

    def load(kind, name):
        with open(HERE / kind / f"{name}.json") as f:
            data = json.load(f)
        data.update(overrides.get(kind, {}))
        return data

    return (load("configs", cell["config"]), load("traffic", cell["traffic"]),
            load("limits", cell["name"]))


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The metrics of ``kind`` (end_to_end, per_layer) the cell reports."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def read_metric(name: str, record: Record):
    mod = importlib.import_module(f"benchmark.metrics.{module_name(name)}")
    return mod.read(record)


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of all values, linear between ranks."""
    xs = sorted(values)
    if not xs:
        return math.nan
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def end_to_end(name: str, record: Record, setup_s: float):
    """The end-to-end metrics, taken by the harness on the host's clock."""
    if name == "setup_s":
        return setup_s
    if name == "depth_mpix_per_s":
        return record.updates * record.pixels_per_update / record.window_s / 1e6
    if name == "update_ms_p95":
        return percentile(record.update_s, 95.0) * 1e3
    raise KeyError(f"no end-to-end metric {name!r}")


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        t_start: float, device: str = "cuda", overrides: dict | None = None,
        wrap=None, root: Path = ROOT) -> tuple[dict, list]:
    """One run of a cell. Returns (the result dict, the lines for standard
    error). ``wrap`` replaces the program's callable after the warm-up
    (tests that break the timed path)."""
    import torch

    from benchmark.trace import Tracer

    bench = load_benchmark(root)
    cell = find_cell(bench, workload)
    config, traffic, limits = cell_files(cell, overrides)
    entry_mod = importlib.import_module(
        f"benchmark.entries.{module_name(traffic['entry'])}")
    on_cuda = torch.device(device).type == "cuda"
    t_enter = time.perf_counter()
    if on_cuda:
        torch.zeros(1, device=device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t_context = time.perf_counter()
    entry = entry_mod.Entry(config, traffic, seed, device, HERE)
    entry.setup()
    if wrap is not None:
        entry.program = wrap(entry.program)
    if on_cuda:
        torch.cuda.synchronize()
    t_ready = time.perf_counter()
    setup_s = t_ready - t_start

    tracer = Tracer() if trace else None
    times = []
    with (tracer.window() if tracer else contextlib.nullcontext()):
        t0 = time.perf_counter()
        i = 0
        while True:
            ts = time.perf_counter()
            entry.step(i)
            te = time.perf_counter()
            times.append(te - ts)
            i += 1
            if te - t0 >= seconds:
                break
    window_s = te - t0
    summary = tracer.reduce() if tracer else None
    t_reduced = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() if on_cuda else 0
    name = torch.cuda.get_device_name(0) if on_cuda else "cpu"

    found = forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded: {found}")
    # an update the check drew that the window did not reach is run now,
    # outside the window: late, not missing
    done = i
    while i <= max(entry.check_at):
        entry.step(i)
        i += 1

    record = Record(updates=len(times), window_s=window_s,
                    update_s=times, pixels_per_update=entry.pixels(),
                    peak_bytes=peak, trace=summary)
    record.work = entry.work(summary)
    entry.release()

    picks = sorted(entry.kept)
    readings = [entry.readings(entry.kept[j], entry.reference(j, "float32"))
                for j in picks]
    from benchmark.compare import judge, worst

    correct, table = judge(worst(readings), limits)

    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(bench, workload, kind):
        value = (read_metric(m["name"], record) if trace
                 else end_to_end(m["name"], record, setup_s))
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_cuda else "cpu", "kind": name,
           "count": 1, "memory_peak_bytes": peak}
    if summary is not None:
        dev.update(busy_s=summary.busy_s, window_s=summary.window_s)
    result = {"correct": correct, "attempted": len(times), "failed": 0,
              "metrics": metrics, "device": dev}
    if summary is not None:
        result["breakdown"] = summary.breakdown()
    result["checks"] = {k: {"value": _finite(v["value"]),
                            "limit": v["limit"]} for k, v in table.items()}
    lines = [f"set-up {setup_s:.3f} s: to the harness (python, torch) "
             f"{t_enter - t_start:.3f}, CUDA context {t_context - t_enter:.3f},"
             f" inputs and program {t_ready - t_context - entry.warm_s:.3f}, "
             f"warm-up (the kernels' library loaded) {entry.warm_s:.3f}"]
    if summary is not None:
        lines.append(f"trace: {summary.events} device events, closed and "
                     f"reduced in {t_reduced - t0 - window_s:.3f} s")
    lines += [f"checked updates {picks} ({done} in the window); median update "
             f"{statistics.median(times) * 1e3:.3f} ms"]
    lines += [f"check {k}: {v['value']!r} (limit {v['limit']!r})"
              for k, v in table.items()]
    return result, lines


def _finite(v: float):
    return v if math.isfinite(v) else repr(v)

