"""The benchmark's plain reference of the sweep update
(``benchmark/reference/sweep_update.py``) against the program's
``FusedSweepUpdate`` on the CPU, where the program's kernels take their
plain versions: seeded scenes of the koule-tr track at 48x64 (its
value-noise sphere frames, iteration 1's 48-face mesh packed as the
renderer loads it), B=2 mains with 3 and 4 sides padded to K=4, 8 planes.

The reference composes the frozen layers in the program's order and
operation order (``ok * vmask * weight``, the sum over sides along
``dim=1``), so the two agree bit for bit.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.inputs import scene
from benchmark.inputs.soup import packed_soup
from benchmark.reference.plane_sweep import plane_sweep
from benchmark.reference.precision import Arith
from benchmark.reference.sweep_update import (sweep_update, weighted_sweep,
                                              z_ranges)
from meshrecon_torch.pipeline.fused import FusedSweepUpdate

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ROOT / "benchmark" / "configs"
H, W, K, D = 48, 64, 4, 8
SIDE_COUNTS = (3, 4)  # the first bundle has one padded side
SEEDS = [0, 3, 2**31 + 5]
EXACT = ("depth", "valid", "point4", "pdf")
# the normals: the reference's are a frozen copy of the program's plain
# normals, fed bit-identical points, validity and pdf, so nothing lets
# them part: the bound is 0
NORMALS_TOL = 0.0


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@functools.lru_cache(maxsize=None)
def _scene(seed: int):
    """The ten update inputs of a seeded scene, on the CPU."""
    rng = np.random.default_rng(seed)
    cameras, bundle_pts = scene.load_track(str(CONFIGS / "koule-tr.yaml"))
    center, radius = scene.fit_sphere(bundle_pts)
    frames, _ = scene.sphere_frames(torch.from_numpy(cameras), center,
                                    radius, H, W, int(rng.integers(0, 1000)))
    soup, soup_valid = packed_soup(CONFIGS / "koule-tr-it1-soup.json", "cpu")
    centers = np.stack([scene.camera_center(c) for c in cameras])
    bundles = sorted(scene.draw_bundles(centers, SIDE_COUNTS,
                                        len(SIDE_COUNTS), 10, rng),
                     key=lambda bundle: len(bundle[1]))
    return scene.batch_inputs(bundles, cameras, frames, centers, soup,
                              soup_valid, K)


@functools.lru_cache(maxsize=None)
def _both(seed: int):
    inputs = _scene(seed)
    with torch.no_grad():
        prog = FusedSweepUpdate(H, W, num_depths=D)(*inputs)
    ref = sweep_update(inputs, H, W, {"num_depths": D})
    return prog, ref


def _same(a, b) -> bool:
    """Equal values, NaN where the other is NaN."""
    if a.dtype == torch.bool:
        return torch.equal(a, b)
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(
        a.nan_to_num(0.0), b.nan_to_num(0.0))


@pytest.mark.parametrize("seed", SEEDS)
def test_reference_equals_the_program_bit_for_bit(seed):
    prog, ref = _both(seed)
    for key in EXACT:
        assert prog[key].shape == ref[key].shape, key
        assert _same(prog[key], ref[key]), key
    # the scene is not empty: the sweep finds depth on a share of pixels
    assert 0.05 < float(ref["valid"].to(torch.float32).mean()) < 0.95


@pytest.mark.parametrize("seed", SEEDS)
def test_reference_normals_within_their_bound(seed):
    prog, ref = _both(seed)
    gap = (prog["normals"] - ref["normals"]).abs().nan_to_num(float("inf"))
    assert float(gap.max()) <= NORMALS_TOL
    assert float(ref["normals"].abs().max()) > 0


@pytest.mark.parametrize("seed", SEEDS)
def test_unit_weights_give_the_frozen_plane_sweep_per_main(seed):
    inputs = _scene(seed)
    (_, _, cam_mains, frames_main, side_cams, side_frames, side_valid,
     *_) = inputs
    depth0 = _both(seed)[1]["depth"]
    z_min, z_max, _ = z_ranges(depth0)
    with torch.no_grad():
        out = weighted_sweep(Arith(), frames_main, side_frames, cam_mains,
                             side_cams, side_valid, z_min, z_max, D,
                             torch.ones(side_frames.shape))
    for m in range(len(SIDE_COUNTS)):
        frozen = plane_sweep(frames_main[m], side_frames[m], cam_mains[m],
                             side_cams[m], side_valid[m], float(z_min[m]),
                             float(z_max[m]), D)
        for key in ("depth", "cost", "valid"):
            assert _same(out[key][m], frozen[key]), (m, key)


@pytest.mark.parametrize("seed", SEEDS)
def test_vote_weights_and_the_padded_side(seed):
    """The masks vote: the weighted sweep's cost is not the unit-weight
    one. The padded side votes nothing: another frame there changes
    neither the program's outputs nor the reference's."""
    inputs = _scene(seed)
    prog, ref = _both(seed)
    (_, _, cam_mains, frames_main, side_cams, side_frames, side_valid,
     *_) = inputs
    z_min, z_max, _ = z_ranges(ref["depth"])
    with torch.no_grad():
        unit = weighted_sweep(Arith(), frames_main, side_frames, cam_mains,
                              side_cams, side_valid, z_min, z_max, D,
                              torch.ones(side_frames.shape))
    assert not torch.equal(1.0 / (1.0 + unit["cost"]), ref["pdf"])
    assert not bool(side_valid[0, -1])
    frames = side_frames.clone()
    frames[0, -1] = 255.0 - frames[0, -1]
    moved = list(inputs)
    moved[5] = frames
    with torch.no_grad():
        prog2 = FusedSweepUpdate(H, W, num_depths=D)(*moved)
    ref2 = sweep_update(moved, H, W, {"num_depths": D})
    for key in EXACT + ("normals",):
        assert _same(prog2[key], prog[key]), key
        assert _same(ref2[key], ref[key]), key
