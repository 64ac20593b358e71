"""The refinement loop's bookkeeping in meshrecon_torch on the CPU: point
provenance against meshrecon's, and --resume after an interrupted run.

koule-tr at 80x60 (frames made by the JAX package, seed 0), ``-n 2``
hybrid, policy seed 3, Poisson grid 64 (tests/test_torch_e2e_options.py's
configuration).

- Provenance (``hint.point_provenance``: ``iteration * 1000 + main
  camera`` a point, -1 for the sparse bundles): one code per returned
  point; the same set of codes as the JAX package's run; each code's count
  within 10% of the JAX run's (the clouds agree as closely, the filter
  keeps each update's points alike).
- Resume: a run interrupted in its second iteration's filter, resumed from
  its checkpoint, writes the mesh of an uninterrupted run bit for bit (the
  checkpoint holds the points, normals, alpha values, iteration and the
  policy's RNG state; the CPU runs are deterministic); the resumed points'
  provenance is -1 (unknown) for the checkpoint's points.
"""

import numpy as np
import pytest
import torch

from meshrecon.io.synthetic import synthetic_frames as j_frames
from meshrecon.io.tracks import load_tracks
from meshrecon.pipeline.reconstruct import _refine_cloud as j_refine_cloud
from meshrecon.pipeline.config import Config as JConfig
from meshrecon_torch.io.obj import read_mesh
from meshrecon_torch.pipeline import reconstruct
from meshrecon_torch.pipeline.config import Config
from meshrecon_torch.utils.profiling import StageTimer

torch.set_num_threads(1)

KW = dict(seed=3, depth_mode="hybrid", iteration_count=2, poisson_grid=64,
          poisson_trim=2.0)


@pytest.fixture(scope="module")
def koule_small():
    track = load_tracks("tracks/koule-tr.yaml")
    return track, j_frames(track, 80, 60, mode="sphere", seed=0)


def _ours(track, frames, **kw):
    return Config(track=track, frames=torch.from_numpy(frames.copy()),
                  device="cpu", **{**KW, **kw})


def test_provenance_matches_jax(koule_small):
    track, frames = koule_small
    pts, _, hint = reconstruct._refine_cloud(_ours(track, frames),
                                             StageTimer(enabled=False))
    j_pts, _, j_hint = j_refine_cloud(
        JConfig(track=track, frames=frames, **KW))
    prov, j_prov = hint.point_provenance, j_hint.point_provenance
    assert prov.dtype == np.int32 and len(prov) == len(pts)
    assert len(j_prov) == len(j_pts)
    codes, counts = np.unique(prov, return_counts=True)
    j_codes, j_counts = np.unique(j_prov, return_counts=True)
    np.testing.assert_array_equal(codes, j_codes)
    assert {c // 1000 for c in codes if c >= 0} == {1, 2}
    assert np.all(np.abs(counts - j_counts) <= 0.1 * j_counts), (
        dict(zip(codes, counts)), dict(zip(j_codes, j_counts)))


def test_resume_after_interruption_equals_uninterrupted(koule_small,
                                                        tmp_path,
                                                        monkeypatch):
    track, frames = koule_small
    whole = reconstruct.reconstruct(_ours(
        track, frames, out_file_name=str(tmp_path / "whole.obj")))

    calls = {"n": 0}
    real_filter = reconstruct.filter_points

    def interrupted(*args, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise KeyboardInterrupt("interrupted in iteration 2")
        return real_filter(*args, **kw)

    ck = str(tmp_path / "ck")
    monkeypatch.setattr(reconstruct, "filter_points", interrupted)
    with pytest.raises(KeyboardInterrupt):
        reconstruct.reconstruct(_ours(track, frames, checkpoint_dir=ck,
                                      out_file_name=str(tmp_path / "x.obj")))
    assert not (tmp_path / "x.obj").exists()
    monkeypatch.setattr(reconstruct, "filter_points", real_filter)

    resumed_cfg = _ours(track, frames, checkpoint_dir=ck, resume=True,
                        out_file_name=str(tmp_path / "resumed.obj"))
    pts, nrm, hint = reconstruct._refine_cloud(resumed_cfg,
                                               StageTimer(enabled=False))
    assert hint.iteration == 3  # one iteration run after the checkpoint's
    assert len(hint.point_provenance) == len(pts)
    assert set(np.unique(hint.point_provenance)) - {-1} and all(
        c == -1 or c // 1000 == 2 for c in hint.point_provenance)
    resumed = reconstruct._finish(resumed_cfg, hint, pts, nrm,
                                  StageTimer(enabled=False))
    assert len(resumed.faces) == len(whole.faces) > 0
    np.testing.assert_array_equal(resumed.faces, whole.faces)
    np.testing.assert_array_equal(resumed.vertices, whole.vertices)
    np.testing.assert_array_equal(
        read_mesh(str(tmp_path / "resumed.obj")).vertices,
        read_mesh(str(tmp_path / "whole.obj")).vertices)
