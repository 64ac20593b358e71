"""The JAX package's public names in the port: every name of each JAX
sub-package's ``__all__`` imports from the port's counterpart (in a fresh
process, so that no earlier import hides a cycle) and is a class where
JAX's is one and callable where JAX's is; the geometry helpers and the
near-plane clip that had no counterpart, against JAX on seeded inputs.

Bounds: the five geometry helpers within 1e-6 of the largest magnitude of
JAX's result; ``clip_triangles_near``'s valid masks equal and its vertices
within 1e-6 of the largest magnitude (the same operations in the same
order; XLA's CPU backend may contract a multiply-add into an FMA).
"""

import importlib
import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meshrecon.geometry import camera as j_camera
from meshrecon.raster.rasterizer import _W_EPS as J_W_EPS
from meshrecon.raster.rasterizer import clip_triangles_near as j_clip
from meshrecon_torch.geometry import camera
from meshrecon_torch.raster import rasterizer

torch.set_num_threads(1)

SUBPACKAGES = ["flow", "depth", "pipeline", "geometry", "points", "raster",
               "io", "utils", "sharding"]


def _kind(obj):
    return "class" if isinstance(obj, type) else (
        "callable" if callable(obj) else type(obj).__name__)


def _kinds_code(sub, names):
    """A program that imports ``names`` from the port's ``sub``, prints
    each one's kind as JSON and fails if jax or the JAX package loaded."""
    return "\n".join([
        "import json, sys",
        f"from meshrecon_torch.{sub} import {', '.join(names)}",
        "def kind(o):",
        "    return 'class' if isinstance(o, type) else (",
        "        'callable' if callable(o) else type(o).__name__)",
        f"print(json.dumps({{n: kind(o) for n, o in zip({names!r}, "
        f"[{', '.join(names)}])}}))",
        "sys.exit(any(m in sys.modules for m in ('jax', 'meshrecon')))"])


@pytest.fixture(scope="module")
def port_imports():
    """For each sub-package, its JAX ``__all__`` imported from the port in
    a process of its own (all started together): sub -> (names, process)."""
    root = Path(__file__).resolve().parent.parent
    procs = {}
    for sub in SUBPACKAGES:
        names = importlib.import_module(f"meshrecon.{sub}").__all__
        procs[sub] = names, subprocess.Popen(
            [sys.executable, "-c", _kinds_code(sub, names)], cwd=root,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield procs
    for _, proc in procs.values():
        proc.kill()
        proc.wait()


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_jax_public_names_import_from_the_port(sub, port_imports):
    names, proc = port_imports[sub]
    out, err = proc.communicate(timeout=120)
    assert proc.returncode == 0, err
    package = importlib.import_module(f"meshrecon.{sub}")
    assert json.loads(out) == {n: _kind(getattr(package, n)) for n in names}


def _close(ours, ref, bound=1e-6):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    assert np.abs(ours - ref).max() <= bound * max(np.abs(ref).max(), 1e-30)


def _cameras(rng, n):
    """Projection x world-to-camera matrices at random poses."""
    cams = []
    for _ in range(n):
        f = 1.0 / np.tan(rng.uniform(0.5, 1.4) / 2)
        near, far = rng.uniform(0.01, 1), rng.uniform(10, 100)
        proj = np.array([[f, 0, 0, 0], [0, f / 0.75, 0, 0],
                         [0, 0, (near + far) / (near - far),
                          2 * near * far / (near - far)], [0, 0, -1, 0]])
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        w2c = np.eye(4)
        w2c[:3, :3] = q
        w2c[:3, 3] = rng.normal(size=3) * 3
        cams.append(proj @ w2c)
    return np.asarray(cams, np.float32)


@pytest.mark.parametrize("name", ["extract_camera_center", "ndc_to_pixel",
                                  "pixel_to_ndc", "pixel_grid_ndc",
                                  "homogenize"])
def test_geometry_helper_matches_jax(name):
    rng = np.random.default_rng(7)
    if name == "extract_camera_center":
        cams = _cameras(rng, 16)
        _close(camera.extract_camera_center(torch.from_numpy(cams)),
               j_camera.extract_camera_center(cams))
    elif name in ("ndc_to_pixel", "pixel_to_ndc"):
        a = rng.uniform(-700, 700, size=(2, 1000)).astype(np.float32)
        ours = getattr(camera, name)(*map(torch.from_numpy, a), 640, 480)
        ref = getattr(j_camera, name)(*map(jnp.asarray, a), 640, 480)
        for o, r in zip(ours, ref):
            _close(o, r)
    elif name == "pixel_grid_ndc":
        for w, h in ((640, 480), (97, 61)):
            ours = camera.pixel_grid_ndc(w, h, device="cpu")
            for o, r in zip(ours, j_camera.pixel_grid_ndc(w, h)):
                _close(o, r)
    else:
        p = rng.normal(size=(5, 7, 3)).astype(np.float32)
        _close(camera.homogenize(torch.from_numpy(p), 2.5),
               j_camera.homogenize(p, 2.5))


def test_pixel_grid_ndc_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        camera.pixel_grid_ndc(8, 8)


@pytest.mark.parametrize("behind", [0, 1, 2, 3])
def test_clip_triangles_near_matches_jax(behind):
    """64 triangles with ``behind`` vertices at w < _W_EPS, in every
    position, and some exactly on the plane."""
    assert rasterizer._W_EPS == J_W_EPS
    rng = np.random.default_rng(behind)
    tri = rng.uniform(-5, 5, size=(64, 3, 4)).astype(np.float32)
    w = rng.uniform(0.01, 5, size=(64, 3))
    for t in range(64):
        out = rng.permutation(3)[:behind]
        w[t, out] = -rng.uniform(0, 5, size=behind)
    w[::9, 0] = J_W_EPS  # on the plane: inside
    tri[..., 3] = w.astype(np.float32)
    ours, ours_valid = rasterizer.clip_triangles_near(torch.from_numpy(tri))
    ref, ref_valid = j_clip(tri)
    np.testing.assert_array_equal(ours_valid.numpy(), np.asarray(ref_valid))
    assert ours.dtype == torch.float32
    _close(ours, ref)
