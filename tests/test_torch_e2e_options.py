"""The whole reconstruction of meshrecon_torch against meshrecon on the CPU
with the flow update's options, ``--variance-mode rewarp`` and ``-f``
(Farneback), and with the policy and meshing options: a seed ensemble
(``--ensemble-seeds 3,4``), ``--consensus-rounds 3`` (the two together are
``--preset quality``), ``--confidence-prune 0.1`` and ``-m`` (an initial
mesh: a sphere 5% larger than the bundles' fitted one). koule-tr at 80x60
(frames made by the JAX package, seed 0), ``-n 2`` hybrid, policy seed 3,
Poisson grid 64, trim 2.

The ensemble and consensus cases run ``-n 1``, each option acting in
full there (the ensemble's draws, union and mesh; the consensus trims on
the final mesh): one iteration keeps the file's CPU time near its old
figure. At ``-n 2`` the ensemble matched (JAX 19,368 faces, median
0.0439 R, p90 0.2684 R; port 19,905, 0.0454, 0.2706) but its union misses
the default's p90 in both packages. Measured at ``-n 1``: ensemble JAX
18,087 faces, 0.0187 R, 0.1008 R, port 18,088, 0.0188, 0.1008;
consensus both 21,928 faces, 0.0204 R, 0.0573 R.

The prune and -m cases run ``-n 2``, where the prune shapes the mesh that
iteration 2's camera policy sees (at ``-n 1`` it acts on the final mesh
alone). Every case's iteration-1 bundles must equal JAX's. For these two
the mesh the policy sees at iteration 2 must match JAX's (faces within
1%, median and p90 within the closeness bounds below), but the final
mesh's face count is not compared: with equal or one-apart meshes the
policy's area-weighted draw of iteration 2 still picks other bundles
(prune: 15,381 faces in both, -m: 31,118 against 31,117), and the final
meshes then differ in size (prune 14,095 against 23,472 faces, -m
21,746 against 30,451) while their surfaces agree (prune: median 0.0255
against 0.0387 R, p90 0.2220 against 0.2278; -m 0.0271 against 0.0190,
0.1184 against 0.1353). ``python tests/test_torch_e2e_options.py
witness prune`` prints both packages' bundles and a second JAX run whose
iteration-2 mesh lost one face. The prune's surface bound is JAX's run
with margin (p90 < 0.25 R: its JAX run misses the default's 0.20).

Bounds: closeness to the JAX run of the same configuration, as the
default's two-iteration test in tests/test_torch_pipeline.py (median
0.02 R, p90 0.05 R, faces within 10%); and a surface bound: for rewarp
the JAX package's end-to-end bound of the trimmed default mesh
(tests/test_pipeline.py: median < 0.05 R, p90 < 0.20 R); Farneback has no
such figure in the JAX package, and its JAX run at these inputs misses
that median (0.0528 R), so its bound is that run's figures with margin
(median < 0.08 R, p90 < 0.25 R). Measured: rewarp JAX 17,396 faces,
median 0.0334 R, p90 0.1490 R; port 16,951, 0.0319, 0.1414. Farneback JAX
19,095, 0.0528, 0.1768; port 18,990, 0.0527, 0.1790. The policy and
meshing cases keep the default's bound.
"""

from unittest import mock

import numpy as np
import pytest
import torch

from meshrecon.io.synthetic import fit_sphere
from meshrecon.io.synthetic import synthetic_frames as j_frames
from meshrecon.io.tracks import load_tracks
from meshrecon.pipeline.config import Config as JConfig
from meshrecon.pipeline.heuristic import Heuristic as JHeuristic
from meshrecon.pipeline.reconstruct import reconstruct as j_reconstruct
from meshrecon_torch.io.obj import Mesh, save_mesh
from meshrecon_torch.pipeline import reconstruct
from meshrecon_torch.pipeline.config import Config
from meshrecon_torch.pipeline.heuristic import Heuristic

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


def sphere_obj(track, path, scale=1.05, n_theta=12, n_phi=24):
    """A UV sphere around the bundles' fitted sphere, ``scale`` times its
    radius, written as OBJ (the -m initial mesh)."""
    center, radius = fit_sphere(track.bundles)
    th = np.linspace(0, np.pi, n_theta + 1)[1:-1]
    ph = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
    t, p = np.meshgrid(th, ph, indexing="ij")
    dirs = np.stack([np.sin(t) * np.cos(p), np.sin(t) * np.sin(p),
                     np.cos(t)], -1).reshape(-1, 3)
    dirs = np.concatenate([[[0, 0, 1.0]], dirs, [[0, 0, -1.0]]])
    faces = []
    ring = lambda i, j: 1 + i * n_phi + j % n_phi  # noqa: E731
    last = len(dirs) - 1
    for j in range(n_phi):
        faces.append((0, ring(0, j), ring(0, j + 1)))
        faces.append((last, ring(n_theta - 2, j + 1), ring(n_theta - 2, j)))
        for i in range(n_theta - 2):
            faces.append((ring(i, j), ring(i + 1, j), ring(i + 1, j + 1)))
            faces.append((ring(i, j), ring(i + 1, j + 1), ring(i, j + 1)))
    v = center + scale * radius * dirs
    save_mesh(Mesh(np.concatenate([v, np.ones((len(v), 1))], 1),
                   np.asarray(faces, np.int32)), str(path))
    return str(path)


def _policy_log(cls, log, edit_mesh=None):
    """Patch ``cls.choose_cameras`` to append (iteration, mesh figures,
    bundles) to ``log`` at each call; ``edit_mesh(iteration, mesh)`` may
    replace the mesh the policy sees."""
    orig = cls.choose_cameras

    def call(self, mesh, cameras, renderer):
        if edit_mesh is not None:
            mesh = edit_mesh(self.iteration, mesh)
            renderer.load_mesh(mesh)
        count = orig(self, mesh, cameras, renderer)
        log.append((self.iteration, _errors(mesh, self.config.track),
                    [(int(fa), [int(fb) for fb in sides])
                     for fa, sides in self.camera_bundles()]))
        return count

    return mock.patch.object(cls, "choose_cameras", call)


def compare(track, frames, option, out_dir, poisson_grid=64,
            edit_ref_mesh=None):
    """Both packages' reconstruction of the same frames with ``option``
    (Config fields), ``-n 2`` hybrid, policy seed 3, trim 2; returns the
    port's and the JAX run's mesh figures (faces, median, p90 of
    |r - R| / R) and each run's policy log (iteration, the figures of
    the mesh the policy saw, the bundles it chose)."""
    kw = dict(seed=3, depth_mode="hybrid", iteration_count=2,
              poisson_grid=poisson_grid, poisson_trim=2.0)
    kw.update(option)
    policy = {"ours": [], "ref": []}
    with _policy_log(Heuristic, policy["ours"]):
        ours = _errors(reconstruct.reconstruct(Config(
            track=track, frames=torch.from_numpy(frames.copy()),
            device="cpu", out_file_name=str(out_dir / "ours.obj"), **kw)),
            track)
    with _policy_log(JHeuristic, policy["ref"], edit_ref_mesh):
        ref = _errors(j_reconstruct(JConfig(
            track=track, frames=frames,
            out_file_name=str(out_dir / "ref.obj"), **kw)), track)
    assert (out_dir / "ours.obj").exists()
    return ours, ref, policy


@pytest.mark.parametrize("option,bound,final_faces", [
    ({"variance_mode": "rewarp"}, (0.05, 0.20), True),
    ({"use_farneback": True}, (0.08, 0.25), True),
    ({"ensemble_seeds": (3, 4), "iteration_count": 1}, (0.05, 0.20), True),
    ({"consensus_rounds": 3, "iteration_count": 1}, (0.05, 0.20), True),
    ({"confidence_prune": 0.1}, (0.05, 0.25), False),
    ({"in_mesh_file": "sphere"}, (0.05, 0.20), False)],
    ids=["rewarp", "farneback", "ensemble", "consensus", "prune",
         "initial_mesh"])
def test_end_to_end_option_matches_jax(koule_small, tmp_path, option,
                                       bound, final_faces):
    track, frames = koule_small
    if option.get("in_mesh_file"):
        option = {**option,
                  "in_mesh_file": sphere_obj(track, tmp_path / "m.obj")}
    ours, ref, policy = compare(track, frames, option, tmp_path)
    assert ours["med_abs"] < bound[0] and ours["p90"] < bound[1], ours
    if final_faces:
        assert abs(ours["faces"] - ref["faces"]) <= 0.1 * ref["faces"]
    assert abs(ours["med_abs"] - ref["med_abs"]) <= 0.02, (ours, ref)
    assert abs(ours["p90"] - ref["p90"]) <= 0.05, (ours, ref)

    def at(log, iteration):
        return [entry for entry in log if entry[0] == iteration]

    first = at(policy["ours"], 1)
    assert first and [b for *_, b in first] == [
        b for *_, b in at(policy["ref"], 1)]
    if not final_faces:
        (_, mo, _), = at(policy["ours"], 2)
        (_, mr, _), = at(policy["ref"], 2)
        assert abs(mo["faces"] - mr["faces"]) <= 0.01 * mr["faces"]
        assert abs(mo["med_abs"] - mr["med_abs"]) <= 0.02, (mo, mr)
        assert abs(mo["p90"] - mr["p90"]) <= 0.05, (mo, mr)


if __name__ == "__main__":
    # Both packages at a larger size on the CPU, e.g. -f at 160x120 on
    # frames of seed 3 with Poisson grid 128:
    #   JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_e2e_options.py \
    #       160 120 3 use_farneback
    # or the policy's divergence at the test's inputs, prune or -m at -n 2:
    # both packages' bundles an iteration, then JAX again with one face
    # dropped from the mesh its policy sees at iteration 2:
    #   JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_e2e_options.py \
    #       witness prune
    import sys
    import tempfile
    from pathlib import Path

    track = load_tracks("tracks/koule-tr.yaml")
    if sys.argv[1] == "witness":
        frames = j_frames(track, 80, 60, mode="sphere", seed=0)

        def drop_face(iteration, mesh):
            if iteration != 2:
                return mesh
            return type(mesh)(mesh.vertices, mesh.faces[:-1])

        with tempfile.TemporaryDirectory() as tmp:
            option = {"prune": {"confidence_prune": 0.1},
                      "m": {"in_mesh_file": sphere_obj(
                          track, Path(tmp) / "m.obj")}}[sys.argv[2]]
            runs = [compare(track, frames, option, Path(tmp)),
                    compare(track, frames, option, Path(tmp),
                            edit_ref_mesh=drop_face)]
        for (ours, ref, policy), label in zip(runs, ("", " one face less")):
            for name, figures in (("port", ours), ("jax" + label, ref)):
                print(f"{sys.argv[2]} {name}: final {figures}")
                key = "ours" if name == "port" else "ref"
                for iteration, mesh, bundles in policy[key]:
                    print(f"  iteration {iteration}: mesh {mesh}, "
                          f"bundles {bundles}")
        sys.exit(0)
    width, height, frame_seed = (int(a) for a in sys.argv[1:4])
    option = {"use_farneback": {"use_farneback": True},
              "rewarp": {"variance_mode": "rewarp"}}[sys.argv[4]]
    frames = j_frames(track, width, height, mode="sphere", seed=frame_seed)
    with tempfile.TemporaryDirectory() as tmp:
        ours, ref, _ = compare(track, frames, option, Path(tmp),
                               poisson_grid=128)
    print(f"{width}x{height} frames seed {frame_seed} {option}: port "
          f"{ours}, jax {ref}")
