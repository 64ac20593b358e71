"""The whole reconstruction of meshrecon_torch against meshrecon on the CPU
with the flow update's options: ``--variance-mode rewarp`` and ``-f``
(Farneback), koule-tr at 80x60 (frames made by the JAX package, seed 0),
``-n 2`` hybrid, policy seed 3, Poisson grid 64, trim 2.

Bounds: closeness to the JAX run of the same configuration, as the
default's two-iteration test in tests/test_torch_pipeline.py (median
0.02 R, p90 0.05 R, faces within 10%); and a surface bound: for rewarp
the JAX package's end-to-end bound of the trimmed default mesh
(tests/test_pipeline.py: median < 0.05 R, p90 < 0.20 R); Farneback has no
such figure in the JAX package, and its JAX run at these inputs misses
that median (0.0528 R), so its bound is that run's figures with margin
(median < 0.08 R, p90 < 0.25 R). Measured: rewarp JAX 17,396 faces,
median 0.0334 R, p90 0.1490 R; port 16,951, 0.0319, 0.1414. Farneback JAX
19,095, 0.0528, 0.1768; port 18,990, 0.0527, 0.1790.
"""

import numpy as np
import pytest
import torch

from meshrecon.io.synthetic import fit_sphere
from meshrecon.io.synthetic import synthetic_frames as j_frames
from meshrecon.io.tracks import load_tracks
from meshrecon.pipeline.config import Config as JConfig
from meshrecon.pipeline.reconstruct import reconstruct as j_reconstruct
from meshrecon_torch.pipeline import reconstruct
from meshrecon_torch.pipeline.config import Config

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def koule_small():
    track = load_tracks("tracks/koule-tr.yaml")
    return track, j_frames(track, 80, 60, mode="sphere", seed=0)


def _errors(mesh, track):
    center, radius = fit_sphere(track.bundles)
    v3 = mesh.vertices[:, :3] / mesh.vertices[:, 3:4]
    err = np.abs(np.linalg.norm(v3 - center, axis=1) - radius) / radius
    return {"faces": len(mesh.faces), "med_abs": float(np.median(err)),
            "p90": float(np.percentile(err, 90))}


def compare(track, frames, option, out_dir, poisson_grid=64):
    """Both packages' reconstruction of the same frames with ``option``
    (Config fields), ``-n 2`` hybrid, policy seed 3, trim 2; returns the
    port's and the JAX run's mesh figures (faces, median, p90 of
    |r - R| / R)."""
    kw = dict(seed=3, depth_mode="hybrid", iteration_count=2,
              poisson_grid=poisson_grid, poisson_trim=2.0, **option)
    ours = _errors(reconstruct.reconstruct(Config(
        track=track, frames=torch.from_numpy(frames.copy()), device="cpu",
        out_file_name=str(out_dir / "ours.obj"), **kw)), track)
    ref = _errors(j_reconstruct(JConfig(
        track=track, frames=frames,
        out_file_name=str(out_dir / "ref.obj"), **kw)), track)
    assert (out_dir / "ours.obj").exists()
    return ours, ref


@pytest.mark.parametrize("option,bound", [
    ({"variance_mode": "rewarp"}, (0.05, 0.20)),
    ({"use_farneback": True}, (0.08, 0.25))], ids=["rewarp", "farneback"])
def test_end_to_end_option_matches_jax(koule_small, tmp_path, option,
                                       bound):
    track, frames = koule_small
    ours, ref = compare(track, frames, option, tmp_path)
    assert ours["med_abs"] < bound[0] and ours["p90"] < bound[1], ours
    assert abs(ours["faces"] - ref["faces"]) <= 0.1 * ref["faces"]
    assert abs(ours["med_abs"] - ref["med_abs"]) <= 0.02, (ours, ref)
    assert abs(ours["p90"] - ref["p90"]) <= 0.05, (ours, ref)


if __name__ == "__main__":
    # Both packages at a larger size on the CPU, e.g. -f at 160x120 on
    # frames of seed 3 with Poisson grid 128:
    #   JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_e2e_options.py \
    #       160 120 3 use_farneback
    import sys
    import tempfile
    from pathlib import Path

    width, height, frame_seed = (int(a) for a in sys.argv[1:4])
    option = {"use_farneback": {"use_farneback": True},
              "rewarp": {"variance_mode": "rewarp"}}[sys.argv[4]]
    track = load_tracks("tracks/koule-tr.yaml")
    frames = j_frames(track, width, height, mode="sphere", seed=frame_seed)
    with tempfile.TemporaryDirectory() as tmp:
        ours, ref = compare(track, frames, option, Path(tmp),
                            poisson_grid=128)
    print(f"{width}x{height} frames seed {frame_seed} {option}: port "
          f"{ours}, jax {ref}")
