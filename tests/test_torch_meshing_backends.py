"""The meshing backends off the pipeline's path in meshrecon_torch against
meshrecon on the CPU: the extras, greedy projection, the RBF surface and
the standalone meshing driver.

Tolerances:
- extras (all four functions) and greedy projection run the same host
  float64 NumPy/scipy code on the same input: equal, as arrays.
- RBF: the fit is the same float64 host solve: equal bit for bit. The
  port evaluates the grid in float64, the JAX package in float32
  (``Precision.HIGHEST``): the port's field is held to a float64 NumPy
  evaluation of the same fit within 1e-5 of max|f| (measured 3e-10), and
  JAX's float32 field lies within 5% of max|f| of the port's (measured
  2.9%: the float32 rounding of weights up to ~4.7e3 against a field of
  ~0.6). The meshes: faces within 0.5% (measured 37,004 against 37,028),
  the median distance of a port vertex to JAX's nearest under 1e-3 of the
  cloud's span (measured 7.9e-4) and the largest under 3e-2 (measured
  1.7e-2, where JAX's float32 field moves its surface), and the port's
  mesh closed, manifold and outward (JAX's test_rbf_surface_sphere).
- The driver: alpha and greedy meshes equal; Poisson's face count within
  tests/test_torch_meshing.py's Poisson bound (1%).
"""

import numpy as np
import pytest
import torch

from meshrecon.meshing import alpha as j_alpha
from meshrecon.meshing import driver as j_driver
from meshrecon.meshing import extras as j_extras
from meshrecon.meshing import greedy as j_greedy
from meshrecon.meshing import rbf as j_rbf
from meshrecon.io.obj import read_mesh as j_read_mesh
from meshrecon_torch.io.obj import Mesh, read_mesh
from meshrecon_torch.meshing import driver, extras, greedy, rbf

torch.set_num_threads(1)


def sphere_points(n, radius=1.0, seed=0, noise=0.0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pts = v * (radius + rng.normal(scale=noise, size=(n, 1)))
    return pts.astype(np.float32), v.astype(np.float32)


def mesh_checks(verts3, faces):
    """(manifold, signed volume): every undirected edge in two faces, and
    the volume (positive = outward), as tests/test_meshing.py's."""
    edges = np.concatenate(
        [faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]], axis=0)
    keys = edges[:, 0].astype(np.int64) * len(verts3) + edges[:, 1]
    rkeys = edges[:, 1].astype(np.int64) * len(verts3) + edges[:, 0]
    _, ucounts = np.unique(np.minimum(keys, rkeys), return_counts=True)
    a, b, c = verts3[faces[:, 0]], verts3[faces[:, 1]], verts3[faces[:, 2]]
    volume = np.sum(np.einsum("ij,ij->i", a, np.cross(b, c))) / 6.0
    return bool(np.all(ucounts == 2)), volume


@pytest.mark.parametrize("form", ["cartesian", "homogeneous", "empty"])
def test_bounding_box_size_equals_jax(form):
    pts, _ = sphere_points(500, seed=5)
    if form == "homogeneous":
        pts = np.concatenate([pts * 2.0, np.full((len(pts), 1), 2.0,
                                                 np.float32)], 1)
    elif form == "empty":
        pts = np.zeros((0, 3), np.float32)
    assert extras.bounding_box_size(pts) == j_extras.bounding_box_size(pts)


@pytest.mark.parametrize("fraction", [10.0, 0.1, 1e-6])
def test_filter_finest_equals_jax(fraction):
    from meshrecon.io.obj import Mesh as JMesh

    pts, _ = sphere_points(500, seed=5)
    verts4 = np.concatenate([pts, np.ones((len(pts), 1), np.float32)], 1)
    faces, _ = j_alpha.alpha_shape_faces(pts)
    ours = extras.filter_finest(Mesh(verts4, faces), fraction)
    ref = j_extras.filter_finest(JMesh(verts4, faces), fraction)
    np.testing.assert_array_equal(ours.faces, ref.faces)
    np.testing.assert_array_equal(ours.vertices, ref.vertices)


@pytest.mark.parametrize("viewpoint", [None, (5.0, 0.0, 0.0)])
def test_estimated_normals_equal_jax(viewpoint):
    pts, _ = sphere_points(500, seed=5, noise=0.01)
    np.testing.assert_array_equal(
        extras.estimated_normals(pts, knn=12, viewpoint=viewpoint),
        j_extras.estimated_normals(pts, knn=12, viewpoint=viewpoint))


def test_normalize_normals_average_equals_jax():
    _, nrm = sphere_points(300, seed=6)
    nrm = nrm * np.linspace(0.1, 3.0, len(nrm), dtype=np.float32)[:, None]
    nrm[7] = np.nan
    np.testing.assert_array_equal(extras.normalize_normals_average(nrm),
                                  j_extras.normalize_normals_average(nrm))


@pytest.mark.parametrize("normals", ["given", "estimated"])
def test_greedy_projection_equals_jax(normals):
    """JAX's test_greedy_projection_sphere case: faces equal as arrays."""
    pts, nrm = sphere_points(1200, radius=1.0, seed=21, noise=0.0)
    nrm = nrm if normals == "given" else None
    ours = greedy.greedy_projection(pts, nrm)
    ref = j_greedy.greedy_projection(pts, nrm)
    assert len(ref.faces) > 400
    np.testing.assert_array_equal(ours.faces, ref.faces)
    np.testing.assert_array_equal(ours.vertices, ref.vertices)


def test_greedy_projection_degenerate_equals_jax():
    pts = np.zeros((2, 3), np.float32)
    ours, ref = greedy.greedy_projection(pts), j_greedy.greedy_projection(pts)
    assert len(ours.faces) == len(ref.faces) == 0
    assert ours.vertices.shape == ref.vertices.shape


def _spy(module, name, box):
    """Record ``module.name``'s arguments and result in ``box``."""
    inner = getattr(module, name)

    def spy(*args, **kwargs):
        box["args"] = args
        box["out"] = inner(*args, **kwargs)
        return box["out"]

    return spy


def _f64_field(centers, w, c, lo, scale, grid):
    """The fitted RBF at the port's grid points, in float64 NumPy."""
    pts = rbf.grid_points(lo, scale, grid, "cpu").double().numpy()
    out = np.empty(len(pts))
    for s in range(0, len(pts), 4096):
        p = pts[s:s + 4096]
        d = p[:, None, :] - centers[None]
        r = np.sqrt(np.maximum((d * d).sum(-1), 1e-20))
        out[s:s + 4096] = (r ** 3) @ w + c[0] + p @ c[1:]
    return out.reshape(grid, grid, grid)


@pytest.fixture(scope="module")
def rbf_pair():
    """Both packages' rbf_surface on JAX's test_rbf_surface_sphere case,
    with the fit's and the grid evaluation's inputs and outputs recorded."""
    pts, nrm = sphere_points(600, radius=1.0, seed=11, noise=0.005)
    j_fit, j_eval, fit, ev = {}, {}, {}, {}
    mp = pytest.MonkeyPatch()
    mp.setattr(j_rbf, "_rbf_fit_host", _spy(j_rbf, "_rbf_fit_host", j_fit))
    mp.setattr(j_rbf, "_rbf_eval_grid", _spy(j_rbf, "_rbf_eval_grid", j_eval))
    mp.setattr(rbf, "_rbf_fit_host", _spy(rbf, "_rbf_fit_host", fit))
    mp.setattr(rbf, "rbf_eval_grid", _spy(rbf, "rbf_eval_grid", ev))
    try:
        ref = j_rbf.rbf_surface(pts, nrm, grid=48)
        ours = rbf.rbf_surface(pts, nrm, grid=48, device="cpu")
    finally:
        mp.undo()
    return pts, ours, ref, fit, ev, j_fit, j_eval


def test_rbf_fit_equals_jax(rbf_pair):
    _, _, _, fit, _, j_fit, _ = rbf_pair
    for a, b in zip(fit["args"], j_fit["args"]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(fit["out"], j_fit["out"]):
        np.testing.assert_array_equal(a, b)


def test_rbf_field_against_float64_and_jax(rbf_pair, monkeypatch):
    _, _, _, fit, ev, _, j_eval = rbf_pair
    centers, w, c, lo, scale, grid = ev["args"][:6]
    f = ev["out"].numpy()
    assert f.dtype == np.float64 and f.shape == (48, 48, 48)
    want = _f64_field(centers, w, c, lo, scale, grid)
    fmax = np.abs(want).max()
    assert np.abs(f - want).max() <= 1e-5 * fmax
    j_f = np.asarray(j_eval["out"])
    assert np.abs(j_f - f).max() <= 5e-2 * fmax
    # a chunked evaluation gives the same field
    monkeypatch.setattr(rbf, "CHUNK_BYTES", 8 * len(centers) * 1000)
    small = rbf.rbf_eval_grid(centers, w, c, lo, scale, grid, "cpu").numpy()
    np.testing.assert_allclose(small, f, rtol=0, atol=1e-12 * fmax)


def test_rbf_surface_close_to_jax(rbf_pair):
    from scipy.spatial import cKDTree

    pts, ours, ref, *_ = rbf_pair
    assert len(ref.faces) > 100
    assert abs(len(ours.faces) - len(ref.faces)) <= 0.005 * len(ref.faces)
    span = float(np.max(pts.max(0) - pts.min(0)))
    d, _ = cKDTree(ref.vertices[:, :3]).query(ours.vertices[:, :3])
    assert np.median(d) <= 1e-3 * span and d.max() <= 3e-2 * span
    v3 = ours.vertices[:, :3] / ours.vertices[:, 3:4]
    manifold, volume = mesh_checks(v3, ours.faces)
    assert manifold and volume > 0
    r = np.linalg.norm(v3 - v3.mean(axis=0), axis=1)
    assert abs(np.median(r) - 1.0) < 0.1


def test_rbf_surface_empty_and_no_cuda_raises(monkeypatch):
    empty = rbf.rbf_surface(np.zeros((0, 3)), np.zeros((0, 3)), device="cpu")
    assert empty.faces.shape == (0, 3) and empty.vertices.shape == (0, 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts, nrm = sphere_points(50, seed=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rbf.rbf_surface(pts, nrm)


def test_fixture_points_equal_jax():
    for a, b in zip(driver.fixture_points(), j_driver._fixture_points()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", ["alpha", "poisson", "greedy"])
def test_meshing_driver_matches_jax(mode, tmp_path, monkeypatch, capsys):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    assert j_driver.main([mode]) == 0
    ref = j_read_mesh(f"test/torus_{mode}.obj")
    monkeypatch.chdir(tmp_path / "port")
    assert driver.main([mode, "--device", "cpu"]) == 0
    assert f"wrote test/torus_{mode}.obj" in capsys.readouterr().out
    ours = read_mesh(f"test/torus_{mode}.obj")
    if mode == "poisson":
        assert len(ref.faces) > 1000
        assert abs(len(ours.faces) - len(ref.faces)) <= 0.01 * len(ref.faces)
    else:
        assert len(ref.faces) > 1000
        np.testing.assert_array_equal(ours.faces, ref.faces)
        np.testing.assert_array_equal(ours.vertices, ref.vertices)


def test_meshing_driver_without_cuda_raises(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        driver.main(["greedy"])
    assert not (tmp_path / "test").exists()


def test_meshing_exports_match_jax():
    import meshrecon.meshing as j_meshing
    import meshrecon_torch.meshing as meshing

    assert meshing.__all__ == j_meshing.__all__
    assert meshing.rbf_surface is rbf.rbf_surface
    assert meshing.greedy_projection is greedy.greedy_projection
