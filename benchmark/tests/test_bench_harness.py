"""The harness on the CPU: its files are found by name, its arithmetic is
the program's, it imports nothing of JAX or the JAX package, and its run
command refuses to run without a card.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import ast
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import core, work

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "benchmark"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return core.load_benchmark(ROOT)


def test_every_cell_finds_its_files(bench):
    for cell in bench["workloads"]:
        config, traffic, limits = core.cell_files(cell)
        assert config["name"] == cell["config"]
        assert (HERE / "entries" / f"{core.module_name(traffic['entry'])}"
                ".py").is_file()
        assert limits and all(v >= 0 for v in limits.values())
    for m in bench["per_layer"]:
        assert (HERE / "metrics" / f"{core.module_name(m['name'])}.py"
                ).is_file(), m["name"]
    for cfg in bench["configs"]:
        assert (ROOT / cfg["file"]).is_file()


def test_names_units_and_moves(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    cells = {c["name"] for c in bench["workloads"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        moved = next(e for e in bench["end_to_end"]
                     if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for c in bench["workloads"]:
        assert NAME.match(c["name"]) and NAME.match(c["traffic"])
        assert len(c["why"]) <= 200


def test_metric_readers_return_nothing_without_a_trace():
    record = core.Record(updates=10, window_s=1.0,
                         update_s=[0.1] * 10, pixels_per_update=1,
                         peak_bytes=0)
    for name in ("device_idle_share", "device_events_per_update",
                 "update_roofline", "k4_roofline", "raster_roofline",
                 "k3c_roofline", "device_peak_gib", "gn_sweeps_per_update"):
        assert core.read_metric(name, record) is None


def test_roofline_readers_from_a_trace():
    from benchmark.trace import BETWEEN, reduce_events

    ms = 1_000_000
    summary = reduce_events(
        [(0, 2 * ms, "void hs_block_kernel<0>(Planes)"),
         (1 * ms, 3 * ms, "raster_tiles_kernel"), (5 * ms, 6 * ms, "copy")],
        [(0, 10 * ms, "aten::add"), (3 * ms, 4 * ms, "aten::mul")],
        0, 10 * ms)
    assert summary.busy_s == pytest.approx(0.004)
    assert summary.events == 3
    # each gap goes to the operator running when it began
    assert summary.idle_by_host["aten::mul"] == pytest.approx(0.002)
    assert summary.idle_by_host[BETWEEN] == pytest.approx(0.004)
    record = core.Record(updates=2, window_s=0.01, update_s=[],
                         pixels_per_update=1, peak_bytes=2**30,
                         trace=summary)
    record.work = {"update_least_s": 0.0005, "kernels": {
        "k4": (0.0005, ("hs_block_kernel",)),
        "raster": (0.0001, ("raster_tiles_kernel",))}}
    assert core.read_metric("k4_roofline", record) == pytest.approx(50.0)
    assert core.read_metric("raster_roofline", record) == pytest.approx(10.0)
    assert core.read_metric("update_roofline", record) == pytest.approx(25.0)
    assert core.read_metric("device_idle_share", record) == pytest.approx(
        60.0)
    assert core.read_metric("device_peak_gib", record) == 1.0
    assert core.read_metric("k3c_roofline", record) is None


def test_percentile_takes_every_sample():
    assert core.percentile(list(range(101)), 95.0) == 95.0
    assert core.percentile([3.0, 1.0, 2.0], 50.0) == 2.0


@pytest.mark.parametrize("b,k,h,w", [(4, 8, 48, 64), (1, 3, 40, 56)])
def test_stage_arithmetic_is_the_programs(b, k, h, w):
    import torch

    from meshrecon_torch.tools.fused_breakdown import stage_work

    cb = 16
    t = 64
    inputs = (torch.zeros(t, 3, 3), torch.ones(t, dtype=torch.bool),
              torch.zeros(b, 4, 4), torch.zeros(b, h, w),
              torch.zeros(b, k, 4, 4), torch.zeros(b, k, h, w),
              torch.zeros(b, k, dtype=torch.bool), torch.zeros(b, cb, 3),
              torch.zeros(b, cb, dtype=torch.bool),
              torch.zeros(b, dtype=torch.int32))
    theirs = stage_work(inputs, h, w, covered=0.3)
    ours = work.flow_update_stages(b, k, h, w, t, t, b * cb, 0.3, 2, 14)
    assert set(ours) == set(theirs)
    for stage, (nbytes, ops) in theirs.items():
        assert ours[stage][0] == nbytes, stage
        assert ours[stage][1] == (ops or 0), stage


def test_k3c_arithmetic_is_the_programs():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    for px, share in ((4 * 480 * 640, 0.86), (32 * 1080 * 1920, 0.2)):
        assert work.k3c_work(px, share) == chip_smoke._k3c_work(px, share)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", "") == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_nothing_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in core.FORBIDDEN, (path, name)


def test_the_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] != "meshrecon_torch", (path, name)
    for path in (HERE / "inputs").rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] != "meshrecon_torch", (path, name)


def test_a_run_loads_no_jax():
    code = ("import sys, pkgutil, importlib; sys.path[0] = '.'\n"
            "import benchmark\n"
            "for m in pkgutil.walk_packages(benchmark.__path__, "
            "'benchmark.'):\n"
            "    if '.tests' not in m.name: importlib.import_module(m.name)\n"
            "import meshrecon_torch.pipeline.fused, "
            "meshrecon_torch.depth.plane_sweep\n"
            "from benchmark import core\n"
            "print(core.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _run_command(cwd, env_extra=None):
    env = dict(os.environ, **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "koule.flow-it2",
         "--seed", "2147483659", "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_the_command_refuses_to_run_without_a_card():
    out = _run_command(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no result" in out.stderr


def test_a_run_fails_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark, a
    run (the card's look skipped) stops before any result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path[0] = '.'\n"
            "from benchmark import core\n"
            "core.run('c4.sweep-1080p-w32', 1, 0.1, False, t_start=0.0, "
            "device='cpu', overrides={'configs': {'height': 16, "
            "'width': 16, 'sides': 2, 'depths': 2, 'slide': 2}})\n"
            "print('result')")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert "result" not in out.stdout
    assert "meshrecon_torch" in out.stderr
