"""The frozen reference against the program's plain path, the control
against the cells' limits, and a run with its timed path broken, on the
CPU at small sizes; and the control at a cell's own size on the card.

The reference is a copy of the program's plain path in its arithmetic, so
at these sizes on the CPU (the program's kernels take their plain
versions there) the two agree bit for bit: a copying slip shows as a
number above 0.

    python -m pytest benchmark/tests -q                    # on the CPU
    python -m pytest benchmark/tests -q -m cuda            # on the card
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from benchmark import calibrate, compare, core
from benchmark.reference.precision import round_tf32
from benchmark.reference.raster import render_depth

SMALL = {
    "koule.flow-it2": {"configs": {"height": 48, "width": 64, "rings": 16,
                                   "segments": 32},
                       "traffic": {"batches": 2, "check_range": 4}},
    "c4.sweep-1080p-w32": {"configs": {"height": 56, "width": 96,
                                       "sides": 4, "depths": 8,
                                       "slide": 4}},
}
CELLS = sorted(SMALL)


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def limits(cell):
    bench = core.load_benchmark()
    return core.cell_files(core.find_cell(bench, cell))[2]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_reference_equals_the_programs_plain_path(cell, seed):
    r = calibrate.readings(cell, seed, control=False, device="cpu",
                           overrides=SMALL[cell])
    assert r["program"] and all(v == 0.0 for v in r["program"].values()), r


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_limits(cell):
    r = calibrate.readings(cell, 5, control=True, device="cpu",
                           overrides=SMALL[cell])
    correct, _ = compare.judge(r["control"], limits(cell))
    assert not correct, r["control"]


def test_reference_raster_equals_the_programs_render():
    from meshrecon_torch.raster.rasterizer import render_depth as theirs

    from benchmark.inputs import scene

    rng = np.random.default_rng(1)
    soup, valid = scene.noisy_uv_sphere((0.0, 0.0, 0.0), 1.0, 12, 24, 0.05,
                                        rng, "cpu")
    valid[::7] = False
    cams = torch.from_numpy(np.stack([
        _look(np.array([0.3 * i, 0.2, 3.0 - 0.4 * i])) for i in range(3)]))
    ours = render_depth(cams, soup, valid, 40, 56)
    assert torch.equal(ours, theirs(cams, soup, valid, 40, 56))
    assert (ours < 1.0).float().mean() > 0.1


def _look(eye):
    from benchmark.inputs.window import make_camera

    cam = make_camera(eye=tuple(eye), aspect=40 / 56, near=0.5, far=10.0)
    return cam.astype(np.float32)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -1.0 - 2**-12,
                      float("inf"), float("nan")])
    y = round_tf32(x)
    assert y[0] == 1.0
    assert y[1] == 1.0  # a tie rounds to even
    assert y[2] == 1.0 + 4 * 2**-11
    assert y[3] == -1.0
    assert torch.isinf(y[4]) and torch.isnan(y[5])
    bits = y[:4].view(torch.int32) & 0x1FFF
    assert bool((bits == 0).all())


def _altered(program):
    """The answer altered where it is produced: one valid pixel's output
    moved (the flow update's point, the sweep's depth)."""
    def call(*args, **kwargs):
        out = dict(program(*args, **kwargs))
        key = "point4" if "point4" in out else "depth"
        t = out[key].clone()
        at = tuple(torch.nonzero(out["valid"])[0].tolist())
        t[at] = t[at] + 0.5
        out[key] = t
        return out
    return call


def _half_batch(program):
    """Half of the batch left out: the flow update run on its first half,
    whose outputs stand for the whole batch."""
    def call(*args):
        b = args[2].shape[0]
        half = [a if i < 2 else a[:b // 2] for i, a in enumerate(args)]
        out = program(*half)
        return {k: torch.cat([v, v]) if torch.is_tensor(v) else v
                for k, v in out.items()}
    return call


def _half_window(program):
    """Half of the window left out: the sweep over the first half of its
    sides."""
    def call(fm, fs, cm, cs, sv, *rest, **kwargs):
        k = fs.shape[0] // 2
        return program(fm, fs[:k], cm, cs[:k], sv[:k], *rest, **kwargs)
    return call


@pytest.mark.parametrize("cell,fault", [
    ("koule.flow-it2", _altered), ("koule.flow-it2", _half_batch),
    ("c4.sweep-1080p-w32", _altered), ("c4.sweep-1080p-w32", _half_window)])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    result, lines = core.run(cell, 9, 0.2, False, t_start=time.perf_counter(),
                             device="cpu", overrides=SMALL[cell], wrap=fault)
    assert result["correct"] is False
    assert list(result)[-1] == "checks"
    assert any(row["value"] == "inf" or row["value"] > row["limit"]
               for row in result["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    result, lines = core.run(cell, 9, 0.2, False, t_start=time.perf_counter(),
                             device="cpu", overrides=SMALL[cell])
    assert result["correct"] is True, lines
    assert list(result)[-1] == "checks"
    assert lines[-len(result["checks"]):][0].startswith("check ")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_at_the_cells_own_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = calibrate.readings(cell, 101, control=True)
    correct, _ = compare.judge(r["control"], limits(cell))
    assert not correct, r["control"]
    correct, table = compare.judge(r["program"], limits(cell))
    assert correct, table
