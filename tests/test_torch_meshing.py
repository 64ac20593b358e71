"""Meshing of meshrecon_torch against meshrecon on the CPU: alpha shapes,
the Poisson indicator and surface, supported components, the support trim,
decimation and the native library the port builds itself.

Tolerances: alpha faces, components, trim and decimation run the same
host numpy/scipy code on the same input, so they are equal. The Poisson
indicator is a float32 splat and FFT: the splat adds in another order and
the FFTs are other libraries (pocketfft in torch, XLA's on the CPU), so chi
agrees to a relative bound (measured 3.2e-7 of max|chi| at grid 32; bound
1e-4), and an iso-crossing at the margin may add or drop a face (measured:
16,352 faces in both at grid 32; bound 1%).
"""

import numpy as np
import pytest
import torch

from meshrecon.io.obj import Mesh as JMesh
from meshrecon.io.tracks import load_tracks
from meshrecon.meshing import alpha as j_alpha
from meshrecon.meshing import components as j_comp
from meshrecon.meshing import decimate as j_dec
from meshrecon.meshing import extras as j_extras
from meshrecon.meshing import poisson as j_poisson
from meshrecon.meshing.native import marching_tetrahedra_native
from meshrecon_torch.io.obj import Mesh
from meshrecon_torch.meshing import (alpha, components, decimate, extras,
                                     native, poisson)

torch.set_num_threads(1)


def sphere_points(n, radius=1.0, seed=0, noise=0.0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pts = v * (radius + rng.normal(scale=noise, size=(n, 1)))
    return pts.astype(np.float32), v.astype(np.float32)


def _meshes_equal(a, b):
    np.testing.assert_array_equal(a.vertices, b.vertices)
    np.testing.assert_array_equal(a.faces, b.faces)


@pytest.fixture(scope="module")
def poisson_pair():
    pts, nrm = sphere_points(3000, noise=0.01, seed=1)
    w = np.linspace(0.5, 1.5, len(pts), dtype=np.float32)[:, None]
    return (pts, nrm * w,
            poisson.poisson_surface(pts, nrm * w, grid=32, device="cpu"),
            j_poisson.poisson_surface(pts, nrm * w, grid=32))


@pytest.mark.parametrize("source", ["koule", "koberec", "random"])
def test_alpha_faces_equal_jax(source):
    if source == "random":
        pts = np.random.default_rng(4).normal(size=(60, 3))
    else:
        path = {"koule": "tracks/koule-tr.yaml",
                "koberec": "tracks/koberec.yaml"}[source]
        pts = load_tracks(path).bundles
    faces, a = alpha.alpha_shape_faces(pts)
    ref_faces, ref_a = j_alpha.alpha_shape_faces(pts)
    assert a == ref_a and len(faces) > 0
    np.testing.assert_array_equal(faces, ref_faces)


def test_indicator_grid_close_to_jax():
    import jax.numpy as jnp

    pts, nrm = sphere_points(2000, noise=0.02, seed=2)
    lo, scale = poisson.robust_grid_frame(pts.astype(np.float64), 32)
    ours = poisson._indicator_grid(
        torch.from_numpy(pts), torch.from_numpy(nrm), torch.ones(len(pts)),
        torch.from_numpy(lo.astype(np.float32)),
        torch.tensor(np.float32(scale)), grid=32).numpy()
    ref = np.asarray(j_poisson._indicator_grid(
        jnp.asarray(pts), jnp.asarray(nrm), jnp.ones(len(pts)),
        jnp.asarray(lo, jnp.float32), jnp.float32(scale), grid=32))
    assert np.abs(ref).max() > 0
    assert np.abs(ours - ref).max() <= 1e-4 * np.abs(ref).max()


def test_poisson_surface_close_to_jax(poisson_pair):
    _, _, ours, ref = poisson_pair
    assert len(ref.faces) > 500
    assert abs(len(ours.faces) - len(ref.faces)) <= 0.01 * len(ref.faces)
    r = np.linalg.norm(ours.vertices[:, :3], axis=1)
    r_ref = np.linalg.norm(ref.vertices[:, :3], axis=1)
    assert abs(np.median(r) - np.median(r_ref)) < 1e-3


def test_robust_frame_and_trilinear_equal_jax():
    pts, _ = sphere_points(500, seed=3)
    for a, b in zip(poisson.robust_grid_frame(pts, 48),
                    j_poisson.robust_grid_frame(pts, 48)):
        np.testing.assert_array_equal(a, b)
    grid = np.random.default_rng(0).normal(size=(8, 8, 8))
    q = np.random.default_rng(1).uniform(-1, 9, size=(50, 3))
    np.testing.assert_array_equal(poisson._trilinear(grid, q),
                                  j_poisson._trilinear(grid, q))


def test_native_marching_tetrahedra_equals_jax():
    g = 20
    ax = np.arange(g, dtype=np.float32) - (g - 1) / 2.0
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    chi = (6.0 - np.sqrt(x * x + y * y + z * z)).astype(np.float32)
    verts, faces = native.marching_tetrahedra(chi, 0.0)
    ref_v, ref_f = marching_tetrahedra_native(chi, 0.0)
    assert len(faces) > 100
    np.testing.assert_array_equal(verts, ref_v)
    np.testing.assert_array_equal(faces, ref_f)


def test_native_build_is_keyed_and_outside_reference():
    native.library()
    built = list(native.BUILD_DIR.glob("libmeshing_native_*.so"))
    assert built and all("meshrecon_torch" in str(p) for p in built)


def test_native_build_from_threads_builds_once(monkeypatch, tmp_path):
    """Four threads that first call ``library()`` together (the filters
    of scenes that run at once) wait for one build: one library, which loads and
    meshes a sphere as the JAX package's does."""
    import threading

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    native.library.cache_clear()
    start = threading.Barrier(4)
    libs = []

    def first_call():
        start.wait()
        libs.append(native.library())

    try:
        threads = [threading.Thread(target=first_call) for _ in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        assert len(libs) == 4 and all(lib is libs[0] for lib in libs)
        built = list(tmp_path.iterdir())
        assert len(built) == 1 and built[0].suffix == ".so", built
        g = 12
        ax = np.arange(g, dtype=np.float32) - (g - 1) / 2.0
        x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
        chi = (4.0 - np.sqrt(x * x + y * y + z * z)).astype(np.float32)
        verts, faces = native.marching_tetrahedra(chi, 0.0)
        ref_v, ref_f = marching_tetrahedra_native(chi, 0.0)
        assert len(faces) > 50
        np.testing.assert_array_equal(verts, ref_v)
        np.testing.assert_array_equal(faces, ref_f)
    finally:
        native.library.cache_clear()


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """No compiler: the build raises; nothing falls back to numpy."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    native.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            native.library()
    finally:
        native.library.cache_clear()


def test_components_trim_equal_jax(poisson_pair):
    pts, nrm, ours, ref = poisson_pair
    # a detached far sheet: component voting must drop it
    sheet = Mesh(np.array([[5, 5, 5, 1], [6, 5, 5, 1], [5, 6, 5, 1]],
                          np.float32), np.array([[0, 1, 2]]))
    both = Mesh(np.concatenate([ref.vertices, sheet.vertices]),
                np.concatenate([ref.faces, sheet.faces + len(ref.vertices)]))
    jboth = JMesh(both.vertices, both.faces)
    kept = components.keep_supported_components(both, pts)
    _meshes_equal(kept, j_comp.keep_supported_components(jboth, pts))
    assert len(kept.faces) == len(ref.faces)
    half = pts[pts[:, 2] > 0]
    trimmed = components.trim_unsupported_faces(both, half, 0.1)
    _meshes_equal(trimmed, j_comp.trim_unsupported_faces(jboth, half, 0.1))
    assert 0 < len(trimmed.faces) < len(ref.faces)


def test_decimate_and_extras_equal_jax(poisson_pair):
    pts, nrm, _, ref = poisson_pair
    target = len(ref.faces) // 4
    out = decimate.decimate_vertex_clustering(Mesh(ref.vertices, ref.faces),
                                              target)
    _meshes_equal(out, j_dec.decimate_vertex_clustering(ref, target))
    assert 0 < len(out.faces) <= target
    bad = nrm.copy()
    bad[3] = np.nan
    np.testing.assert_array_equal(extras.normalize_normals_average(bad),
                                  j_extras.normalize_normals_average(bad))
