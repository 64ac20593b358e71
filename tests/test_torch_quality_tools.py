"""The quality tools of meshrecon_torch (tools/quality_harness.py,
tools/seed_study.py and tools/remesh_lab.py) against the JAX package's
(tools/, loaded from their files) on the CPU; error_attrib's pair is in
tests/test_torch_error_attrib.py.

- Their tables (``CONFIGS``, ``SCENE_BOUNDS``, ``QUALITY_BOUNDS``,
  ``SCENE_KW``) equal the JAX tools'; ``scene_truth`` and ``surface_error``
  equal on fixed meshes of the three scenes (the same float64 NumPy).
- The harness end to end at ``--scale 8`` (80x60), koule-tr, ``default``,
  both packages on the same frames (made by the JAX package, seed 0; the
  port's own renders differ in the last bits, and the camera policy's draw
  follows them): exit code 0 in both, the port's median and p90 within
  0.02 and 0.05 of JAX's (tests/test_torch_e2e_options.py's bounds), faces
  within 10%. Measured: 18,322 faces, 0.0997 / 0.2385 R against 18,318,
  0.0997 / 0.2376. A mesh off its bound makes the exit code 1.
- The seed study: the port's own run at ``--scale 8``, seed 3, ``trim2``,
  with the JAX tool's row format.
- remesh_lab: both packages' ``main`` on one dump of 2,000 points (a
  sphere of koule's radius with 10% of its points off the surface, eight
  bundles over two iterations): each rule's kept count equal, its medians
  and p90s within the e2e bounds above (measured: both print the same
  text).
- Each tool raises without CUDA unless ``--device cpu`` is given.
"""

import contextlib
import importlib
import importlib.util
import io
import re
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from meshrecon.io.synthetic import synthetic_frames as j_frames
from meshrecon.io.tracks import load_tracks as j_load_tracks
from meshrecon_torch.io.obj import Mesh, read_mesh
from meshrecon_torch.io.tracks import load_tracks
from meshrecon_torch.tools import (error_attrib, quality_harness, remesh_lab,
                                   seed_study)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
E2E_MED, E2E_P90 = 0.02, 0.05  # tests/test_torch_e2e_options.py::compare


def jax_tool(name):
    """tools/<name>.py, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def isolate_jax_tool(mp, tmp):
    """Keep a JAX tool run in this process inside ``tmp``: its persistent
    compile cache settings (a directory under the home, and process-wide,
    so every later JAX test of the worker would use it) are dropped, and
    the meshes the JAX pipeline saves land in ``tmp`` under their own base
    names."""
    import jax

    # the package's ``reconstruct`` function hides the module of that name
    j_reconstruct = importlib.import_module("meshrecon.pipeline.reconstruct")
    update, save = jax.config.update, j_reconstruct.save_mesh
    mp.setattr(jax.config, "update", lambda key, value: None if key in (
        "jax_compilation_cache_dir",
        "jax_persistent_cache_min_compile_time_secs") else update(key, value))
    mp.setattr(j_reconstruct, "save_mesh",
               lambda mesh, path: save(mesh, str(tmp / Path(path).name)))
    mp.setattr(tempfile, "tempdir", str(tmp))


def jax_made_frames(track, w, h, mode="sphere", seed=0, device="cpu"):
    """The port's synthetic_frames replaced: the JAX package's frames."""
    return torch.from_numpy(np.array(j_frames(track, w, h, mode=mode,
                                              seed=seed)))


def run(main, argv, **kwargs):
    """(exit code, standard output) of ``main(argv)``."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv, **kwargs)
    return rc, out.getvalue()


@pytest.mark.parametrize("tool, table", [
    ("quality_harness", "CONFIGS"), ("quality_harness", "SCENE_BOUNDS"),
    ("quality_harness", "QUALITY_BOUNDS"), ("quality_harness", "SCENE_KW"),
    ("seed_study", "CONFIGS")])
def test_tables_equal_jax(tool, table):
    ours = {"quality_harness": quality_harness,
            "seed_study": seed_study}[tool]
    assert getattr(ours, table) == getattr(jax_tool(tool), table)


def _fixed_mesh(mode, params, seed):
    """Vertices scattered about the scene's truth (a sphere, or a plane
    with points beyond its extent too), as a Mesh of homogeneous vertices
    with w = 2."""
    rng = np.random.default_rng(seed)
    if mode == "sphere":
        center, radius = params
        d = rng.normal(size=(400, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        v3 = center + d * radius * (1 + rng.normal(scale=0.05, size=(400, 1)))
    else:
        pc, pn, extent, radius = params
        a = np.cross(pn, [1.0, 0.0, 0.0])
        a /= np.linalg.norm(a)
        b = np.cross(pn, a)
        uv = rng.uniform(-1.5 * extent, 1.5 * extent, size=(400, 2))
        v3 = (pc + uv[:, :1] * a + uv[:, 1:] * b
              + rng.normal(scale=0.02 * radius, size=(400, 1)) * pn)
    v4 = np.concatenate([2 * v3, np.full((len(v3), 1), 2.0)], 1)
    return v4.astype(np.float32), np.zeros((0, 3), np.int32)


@pytest.mark.parametrize("scene", ["koule-tr", "koberec-", "zatisi"])
def test_scene_truth_and_surface_error_equal_jax(scene):
    from meshrecon.io.obj import Mesh as JMesh

    jh = jax_tool("quality_harness")
    mode, params = quality_harness.scene_truth(
        load_tracks(f"tracks/{scene}.yaml"))
    j_mode, j_params = jh.scene_truth(j_load_tracks(f"tracks/{scene}.yaml"))
    assert mode == j_mode == ("plane" if scene == "koberec-" else "sphere")
    for a, b in zip(params, j_params):
        np.testing.assert_array_equal(a, b)
    verts, faces = _fixed_mesh(mode, params, seed=len(scene))
    got = quality_harness.surface_error(Mesh(verts, faces), mode, params)
    want = jh.surface_error(JMesh(verts, faces), j_mode, j_params)
    assert got == want and all(np.isfinite(got))


ROW = re.compile(r"^(\S+)\s+(\d+)\s+([\d.]+)\s+([\d.]+)\s+([\d.]+)$", re.M)


def test_quality_harness_matches_jax(monkeypatch, tmp_path):
    monkeypatch.setattr("meshrecon_torch.io.synthetic.synthetic_frames",
                        jax_made_frames)
    isolate_jax_tool(monkeypatch, tmp_path)
    argv = ["--scale", "8", "--scenes", "koule-tr", "--configs", "default"]
    j_rc, j_out = run(jax_tool("quality_harness").main, argv)
    rc, out = run(quality_harness.main, argv + ["--device", "cpu"])
    assert rc == j_rc == 0
    assert out.splitlines()[:2] == j_out.splitlines()[:2]
    (name, faces, med, p90, _), = ROW.findall(out)
    (_, j_faces, j_med, j_p90, _), = ROW.findall(j_out)
    assert name == "default"
    assert abs(float(med) - float(j_med)) <= E2E_MED
    assert abs(float(p90) - float(j_p90)) <= E2E_P90
    assert abs(int(faces) - int(j_faces)) <= 0.1 * int(j_faces)
    mesh = read_mesh(str(tmp_path / "quality_koule-tr_default.obj"))
    assert len(mesh.faces) == int(faces)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "quality_koule-tr_default.obj"]


def test_quality_harness_fails_off_its_bound(monkeypatch, capsys):
    """A mesh off the scene's sphere by half a radius: exit code 1 and a
    FAIL line naming the scene."""
    track = load_tracks("tracks/koule-tr.yaml")
    mode, (center, radius) = quality_harness.scene_truth(track)
    verts, faces = _fixed_mesh(mode, (center, 1.5 * radius), seed=1)
    monkeypatch.setattr("meshrecon_torch.pipeline.reconstruct.reconstruct",
                        lambda cfg, timer=None: Mesh(verts, faces))
    rc = quality_harness.main(["--scale", "16", "--scenes", "koule-tr",
                               "--device", "cpu"])
    assert rc == 1
    assert "FAIL koule-tr: default med" in capsys.readouterr().err


def test_seed_study_runs_with_its_row_format(monkeypatch, tmp_path):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    rc, out = run(seed_study.main, ["--scale", "8", "--seeds", "3",
                                    "--configs", "trim2", "--device", "cpu"])
    assert rc == 0
    lines = out.splitlines()
    assert lines[0] == "# koule 80x60, n=2 hybrid, radius 0.390"
    assert lines[1].split() == ["config", "seed", "faces", "med/r", "p90/r",
                                "wall", "s"]
    rows = [ln for ln in lines if ln.startswith("trim2 ")]
    assert len(rows) == 1
    name, seed, faces, med, p90, wall = rows[0].split()
    assert rows[0] == (f"{name:<10}{int(seed):>5}{int(faces):>9}"
                       f"{float(med):>9.4f}{float(p90):>9.4f}"
                       f"{float(wall):>8.1f}")
    assert seed == "3" and int(faces) > 1000
    # the default reconstruction's surface bound (tests/test_pipeline.py)
    assert float(med) < 0.05 and float(p90) < 0.20
    assert lines[-1] == f"# worst-seed med trim2: {float(med):.4f}"
    mesh = read_mesh(str(tmp_path / "seed_trim2_3.obj"))
    assert len(mesh.faces) == int(faces)


def _small_dump(path):
    """A dump with error_attrib's keys: 2,000 points about a sphere of
    radius 0.39, 10% of them off it by up to 0.3 R, with confidences and
    provenance codes of eight bundles over two iterations."""
    rng = np.random.default_rng(7)
    n, center, radius = 2000, np.array([0.1, -0.2, 0.3]), 0.39
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    bad = rng.random(n) < 0.1
    r = radius * (1 + np.where(bad, rng.uniform(-0.3, 0.3, n),
                               rng.normal(scale=0.01, size=n)))
    p3 = center + d * r[:, None]
    codes = np.array([1000, 1001, 1005, 2000, 2001, 2004, 2007, 2011])
    prov = codes[rng.integers(0, len(codes), n)].astype(np.int32)
    conf = np.exp(rng.normal(size=n)) * np.where(prov < 2000, 0.5, 0.01)
    np.savez(path, points=np.concatenate([p3, np.ones((n, 1))], 1).astype(
                 np.float32),
             normals=(d * conf[:, None]).astype(np.float32), prov=prov,
             alpha_vals=np.array([0.01, 0.005]), iteration=3,
             center=center.astype(np.float32), radius=radius, scale=8,
             seed=3, poisson_grid=128, poisson_sigma=1.5, poisson_trim=2.0)


RULE = re.compile(r"^(\S+)\s+(\d+)\s+([\d.]+)\s+([\d.]+)", re.M)


def test_remesh_lab_matches_jax(tmp_path):
    small = tmp_path / "small.npz"
    _small_dump(small)
    rc, out = run(remesh_lab.main, [str(small), "--device", "cpu"])
    j_rc, j_out = run(jax_tool("remesh_lab").main, [str(small)])
    assert rc == j_rc == 0
    rows = {m[0]: m[1:] for m in RULE.findall(out)}
    j_rows = {m[0]: m[1:] for m in RULE.findall(j_out)}
    assert set(rows) == set(j_rows) and len(rows) >= 10
    assert rows["baseline"][0] == "2000"
    assert int(rows["oracle>0.1"][0]) < 2000
    for name, (kept, med, p90) in rows.items():
        j_kept, j_med, j_p90 = j_rows[name]
        assert kept == j_kept, name
        assert abs(float(med) - float(j_med)) <= E2E_MED, name
        assert abs(float(p90) - float(j_p90)) <= E2E_P90, name
    assert remesh_lab.main([]) == 2


@pytest.mark.parametrize("tool", ["quality_harness", "seed_study",
                                  "error_attrib", "remesh_lab"])
def test_tools_without_cuda_raise(tool, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = {"quality_harness": quality_harness.main,
            "seed_study": seed_study.main, "error_attrib": error_attrib.main,
            "remesh_lab": remesh_lab.main}[tool]
    argv = [str(tmp_path / "dump.npz")] if tool == "remesh_lab" else []
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(argv)
