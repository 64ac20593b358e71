"""The sharded pipeline paths of meshrecon_torch against meshrecon's on the
CPU, koule-tr at 80x60 (frames made by the JAX package, so both packages
see the same pixels): ``--mesh-devices 2`` through ``reconstruct``, and
the scenes at once, ``reconstruct_scenes(..., scene_devices=2)`` (each
scene's single-scene run in a thread of its own), with two scenes and
with the ensemble cases of tests/test_ensemble.py. JAX runs
on the virtual CPU devices of tests/conftest.py, the port on the CPU
repeated.

Held, for each scene (a seed of an ensemble is a scene of its own):
iteration 1's camera bundles equal JAX's, and each mesh meets the bound of
the JAX test of the same case (tests/test_pipeline.py:367-390,
tests/test_sharding.py:161-201, tests/test_ensemble.py:69-113). The port's
sharded runs also equal its own unsharded runs bit for bit on the CPU
(the camera shards and the scenes' threads run the plain code on
independent items).
Iteration 2's camera draw is chaotic (PERF.md, Open question 8), so final
face counts are not held to JAX's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from meshrecon.io.synthetic import fit_sphere
from meshrecon.io.synthetic import synthetic_frames as j_frames
from meshrecon.io.tracks import load_tracks
from meshrecon.pipeline import heuristic as j_heuristic
from meshrecon.pipeline.config import Config as JConfig
from meshrecon.pipeline.reconstruct import reconstruct as j_reconstruct
from meshrecon.pipeline.reconstruct import \
    reconstruct_scenes as j_reconstruct_scenes
from meshrecon_torch.pipeline import heuristic, reconstruct
from meshrecon_torch.pipeline.config import Config

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def koule_small():
    track = load_tracks("tracks/koule-tr.yaml")
    return track, j_frames(track, 80, 60, mode="sphere", seed=0)


@pytest.fixture
def bundles(monkeypatch):
    """Every camera choice of both packages: package -> [(seed,
    iteration, bundles)], in the order the choices were made."""
    seen = {"port": [], "jax": []}
    for name, cls in (("port", heuristic.Heuristic),
                      ("jax", j_heuristic.Heuristic)):
        original = cls.camera_bundles

        def record(self, _original=original, _log=seen[name]):
            out = _original(self)
            _log.append((self.config.seed, self.iteration,
                         tuple((fa, tuple(s)) for fa, s in out)))
            return out

        monkeypatch.setattr(cls, "camera_bundles", record)
    return seen


def _first(log):
    """seed -> iteration 1's bundles (the first call of each seed)."""
    out = {}
    for seed, it, b in log:
        if it == 1:
            out.setdefault(seed, b)
    return out


def _both(koule_small, tmp_path, tag, **kw):
    """(port Config, JAX Config) of the same run."""
    track, frames = koule_small
    ours = Config(track=track, frames=torch.from_numpy(frames), device="cpu",
                  out_file_name=str(tmp_path / f"ours{tag}.obj"), **kw)
    ref = JConfig(track=track, frames=frames,
                  out_file_name=str(tmp_path / f"ref{tag}.obj"), **kw)
    return ours, ref


def _err(mesh, track):
    center, radius = fit_sphere(track.bundles)
    v3 = mesh.vertices[:, :3] / mesh.vertices[:, 3:4]
    return np.abs(np.linalg.norm(v3 - center, axis=1) - radius) / radius


def _same_mesh(a, b):
    np.testing.assert_array_equal(a.vertices, b.vertices)
    np.testing.assert_array_equal(a.faces, b.faces)


def test_mesh_devices_pipeline(koule_small, tmp_path, bundles):
    """tests/test_pipeline.py::test_mesh_devices_pipeline: the flow update
    with two main cameras a call, one per device."""
    track, _ = koule_small
    kw = dict(iteration_count=1, seed=9, poisson_grid=48)
    ours2, ref2 = _both(koule_small, tmp_path, 2, mesh_devices=2, **kw)
    ours1, _ = _both(koule_small, tmp_path, 1, mesh_devices=1, **kw)
    m2 = reconstruct(ours2)
    m1 = reconstruct(ours1)
    j2 = j_reconstruct(ref2)
    assert _first(bundles["port"]) == _first(bundles["jax"])
    assert len(_first(bundles["port"])[9]) > 1  # the batched path
    _same_mesh(m2, m1)
    # the JAX test's bounds, against the port's single-device run and
    # against JAX's mesh-devices run
    for other in (m1, j2):
        assert abs(len(m2.faces) - len(other.faces)) <= max(
            40, 0.1 * len(other.faces))
        v2 = m2.vertices[:, :3] / m2.vertices[:, 3:4]
        vo = other.vertices[:, :3] / other.vertices[:, 3:4]
        assert np.linalg.norm(v2.mean(axis=0) - vo.mean(axis=0)) < 0.2


def test_mesh_devices_two_gpus_on_one_raise(monkeypatch):
    """On CUDA the camera axis takes distinct GPUs: too few raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    from meshrecon_torch.pipeline.config import config_from_args

    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        config_from_args(["tracks/koule-tr.yaml", "--synthetic", "sphere",
                          "--mesh-devices", "2", "--device", "cuda"])


def test_multi_scene_lockstep_driver(koule_small, tmp_path, bundles):
    """tests/test_sharding.py::test_multi_scene_full_pipeline_driver with
    two scenes: one flow iteration, the scenes at once (JAX: in lockstep,
    ROADMAP Queue C)."""
    track, _ = koule_small
    pairs = [_both(koule_small, tmp_path, s, iteration_count=1, seed=3 + s,
                   depth_mode="flow", poisson_grid=48) for s in range(2)]
    meshes = reconstruct.reconstruct_scenes([p[0] for p in pairs],
                                            scene_devices=2)
    j_meshes = j_reconstruct_scenes([p[1] for p in pairs], scene_devices=2)
    first = _first(bundles["port"])
    assert first == _first(bundles["jax"]) and set(first) == {3, 4}
    assert len(meshes) == len(j_meshes) == 2
    for s, mesh in enumerate(meshes):
        assert (tmp_path / f"ours{s}.obj").exists()
        assert len(mesh.faces) > 50, f"scene {s}: {len(mesh.faces)} faces"
        assert np.median(_err(mesh, track)) < 0.45
    assert len({len(m.faces) for m in meshes}) > 1
    # at once equals the scenes one after another
    seq = reconstruct.reconstruct_scenes([p[0] for p in pairs])
    for a, b in zip(meshes, seq):
        _same_mesh(a, b)


def test_ensemble_sharded_matches_sequential(koule_small, tmp_path,
                                             bundles):
    """tests/test_ensemble.py::test_ensemble_sharded_matches_sequential:
    two seeds at once, hybrid."""
    track, _ = koule_small
    kw = dict(iteration_count=1, seed=3, ensemble_seeds=(3, 4),
              poisson_grid=64, depth_mode="hybrid", poisson_trim=2.0)
    ours_shd, ref_shd = _both(koule_small, tmp_path, "shd", scene_devices=2,
                              **kw)
    ours_seq, _ = _both(koule_small, tmp_path, "seq", **kw)
    m_shd = reconstruct(ours_shd)
    j_shd = j_reconstruct(ref_shd)
    m_seq = reconstruct(ours_seq)
    first = _first(bundles["port"])
    assert first == _first(bundles["jax"]) and set(first) == {3, 4}
    assert np.median(_err(m_shd, track)) < 0.05
    _same_mesh(m_shd, m_seq)
    v1 = j_shd.vertices[:, :3] / j_shd.vertices[:, 3:4]
    v2 = m_shd.vertices[:, :3] / m_shd.vertices[:, 3:4]
    assert np.linalg.norm(v1.mean(axis=0) - v2.mean(axis=0)) < 0.2


def test_multi_scene_sharded_ensemble(koule_small, tmp_path, bundles):
    """tests/test_ensemble.py::test_multi_scene_sharded_ensemble: two
    scenes x two seeds, each scene's union at its own output path."""
    track, _ = koule_small
    pairs = [_both(koule_small, tmp_path, i, iteration_count=1, seed=3,
                   ensemble_seeds=(3, 4), poisson_grid=48,
                   depth_mode="hybrid", poisson_trim=2.0) for i in range(2)]
    meshes = reconstruct.reconstruct_scenes([p[0] for p in pairs],
                                            scene_devices=2)
    j_reconstruct_scenes([p[1] for p in pairs], scene_devices=2)
    ours = [b for b in bundles["port"] if b[1] == 1]
    ref = [b for b in bundles["jax"] if b[1] == 1]
    assert sorted(ours) == sorted(ref) and len(ours) == 4
    assert len(meshes) == 2
    for i, m in enumerate(meshes):
        assert len(m.faces) > 50
        assert (tmp_path / f"ours{i}.obj").exists()
        assert np.median(_err(m, track)) < 0.06


def test_lockstep_checkpoints_and_resume(koule_small, tmp_path):
    """Scenes run at once write each scene's checkpoint, the sequential
    run's own, and resume from it (JAX's lockstep driver does neither:
    ROADMAP Queue C, divergences by design)."""
    from meshrecon_torch.pipeline.checkpoint import load_checkpoint

    track, frames = koule_small

    def configs(tag, **kw):
        return [Config(track=track, frames=torch.from_numpy(frames),
                       device="cpu", iteration_count=1, seed=3 + s,
                       depth_mode="flow", poisson_grid=48,
                       checkpoint_dir=str(tmp_path / f"{tag}{s}"),
                       out_file_name=str(tmp_path / f"{tag}{s}.obj"), **kw)
                for s in range(2)]

    lock = reconstruct.reconstruct_scenes(configs("lock"), scene_devices=2)
    reconstruct.reconstruct_scenes(configs("seq"))
    for s in range(2):
        ours = load_checkpoint(str(tmp_path / f"lock{s}"))
        ref = load_checkpoint(str(tmp_path / f"seq{s}"))
        assert ours[3] == ref[3] == 1 and len(ours[0]) > 100
        for a, b in zip(ours[:3], ref[:3]):
            np.testing.assert_array_equal(a, b)
    resumed = reconstruct.reconstruct_scenes(
        [dataclasses.replace(c, checkpoint_dir=str(tmp_path / f"lock{s}"))
         for s, c in enumerate(configs("res", resume=True))],
        scene_devices=2)
    for a, b in zip(resumed, lock):
        _same_mesh(a, b)
