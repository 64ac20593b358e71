"""meshrecon_torch.raster against meshrecon.raster on the CPU.

Tolerances: XLA's CPU backend contracts multiply-adds into FMAs, PyTorch's
eager ops do not, so the same edge functions and barycentric z differ in
the last bits between the two packages, and bitwise equality with the JAX
renders is out of reach. Measured: no coverage flip in any scene; |dz|
<= 5.1e-6 NDC in the ordinary scenes (3.1e-4 on a 16k-triangle sphere at
480x640) and 1.3e-3 in the near-straddle scene, whose clipped vertices sit
at w = 1e-6 where rounding is amplified (the reference's own test allows
2e-2 there against float64). Bounds: coverage agrees on >= 99.9% of
pixels; |dz| <= 1e-3 NDC (5e-3 near-straddle) where both cover. Between
the port's plain render and K1 the target is bitwise
(test_torch_kernels_cuda.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import __graft_entry__ as g
import meshrecon.raster.binned as jbinned
from meshrecon.io.obj import Mesh
from meshrecon.raster.rasterizer import Renderer
from meshrecon.raster.rasterizer import clip_project_planes as j_planes
from meshrecon.raster.rasterizer import render_depth as j_render
from meshrecon_torch.raster import binned as tbinned
from meshrecon_torch.raster import rasterizer as tr
from meshrecon_torch.state import pack_soup
from tests.test_geometry import make_camera
from tests.test_raster import GLX_FACES, GLX_MVP, GLX_POINTS, _soup

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _scene(name):
    """(camera, soup, valid, h, w) of the reference's raster fixtures."""
    if name == "glx":
        soup = _soup(GLX_POINTS, GLX_FACES).astype(np.float32)
        return GLX_MVP, soup, np.ones(len(soup), bool), 60, 80
    if name == "near_straddle":  # tests/test_raster.py:115
        rng = np.random.default_rng(12345)
        soup = rng.normal(size=(25, 3, 3)).astype(np.float32)
        cam = make_camera(eye=(0, 0, 0.2), near=0.01, far=10.0)
        return cam, soup, np.ones(25, bool), 32, 48
    if name == "shared_edge":  # tests/test_raster.py:208
        e = 4.0
        soup = np.asarray([[[-e, -e, 0.0], [e, -e, 0.0], [e, e, 0.0]],
                           [[-e, -e, 0.0], [e, e, 0.0], [-e, e, 0.0]]],
                          np.float32)
        cam = make_camera(fov=1.1, near=1.0, far=40.0, eye=(0, 0, 16))
        return cam, soup, np.ones(2, bool), 96, 128
    if name == "morton_sphere":
        soup, valid = pack_soup(g._sphere_soup(16, 16))
        return g._make_camera(eye=(0.3, 0.2, 0.5)), soup, valid, 48, 64
    if name == "random_sorted":
        rng = np.random.default_rng(7)
        raw = (rng.normal(size=(200, 3, 3)) * 0.6
               + np.array([0, 0, -5.0])).astype(np.float32)
        soup, valid = pack_soup(raw)
        return g._make_camera(eye=(0.1, -0.2, 0.0)), soup, valid, 48, 64
    raise KeyError(name)


SCENES = ["glx", "near_straddle", "shared_edge", "morton_sphere",
          "random_sorted"]


def _assert_depth_close(ours, ref, scene):
    cov_o, cov_r = ours < 1.0, ref < 1.0
    assert np.mean(cov_o != cov_r) <= 1e-3, "coverage disagreement"
    both = cov_o & cov_r
    atol = 5e-3 if scene == "near_straddle" else 1e-3
    if both.any():
        assert np.abs(ours[both] - ref[both]).max() <= atol


@pytest.mark.parametrize("scene", SCENES)
def test_render_depth_matches_jax(scene):
    cam, soup, valid, h, w = _scene(scene)
    ref = np.asarray(j_render(cam, soup, valid, h, w))
    ours = tr.render_depth(_t(cam), _t(soup), _t(valid), h, w).numpy()
    assert ours.shape == (h, w) and ours.dtype == np.float32
    assert (ours < 1.0).any()
    _assert_depth_close(ours, ref, scene)


@pytest.mark.parametrize("scene", ["glx", "morton_sphere", "random_sorted"])
def test_render_depth_matches_jax_binned_kernel(scene):
    """Against the Pallas kernel itself, in interpret mode."""
    cam, soup, valid, h, w = _scene(scene)
    ref = np.asarray(jbinned.render_depth_binned(cam, soup, valid, h, w,
                                                 interpret=True))
    ours = tr.render_depth(_t(cam), _t(soup), _t(valid), h, w).numpy()
    _assert_depth_close(ours, ref, scene)


def test_shared_edge_ties_not_holed():
    """The tie slop must close the split quad's diagonal in the port too."""
    cam, soup, valid, h, w = _scene("shared_edge")
    dm = tr.render_depth(_t(cam), _t(soup), _t(valid), h, w).numpy()
    v = dm != 1.0
    rs, cs = np.where(v)
    interior = np.zeros_like(v)
    interior[rs.min() + 1:rs.max(), cs.min() + 1:cs.max()] = True
    assert (interior & ~v).sum() == 0


def test_batched_cameras_equal_single():
    cam, soup, valid, h, w = _scene("morton_sphere")
    cams = np.stack([cam, g._make_camera(eye=(1.0, 0.4, 0))])
    batch = tr.render_depth(_t(cams), _t(soup), _t(valid), h, w)
    for i in range(2):
        one = tr.render_depth(_t(cams[i]), _t(soup), _t(valid), h, w)
        assert torch.equal(batch[i], one)


def test_binned_wrapper_on_cpu_is_plain_render():
    cam, soup, valid, h, w = _scene("random_sorted")
    cams = _t(np.stack([cam, cam]))
    out = tbinned.render_depth_binned(cams, _t(soup), _t(valid), h, w)
    plain = tr.render_depth(_t(cam), _t(soup), _t(valid), h, w)
    assert torch.equal(out[0], plain) and torch.equal(out[1], plain)


@pytest.mark.parametrize("scene", ["glx", "near_straddle"])
def test_clip_project_planes_match_jax(scene):
    """Same records and validity; float32 rounding of the projection
    differs by FMA contraction only (rtol 1e-5, atol 1e-6)."""
    cam, soup, valid, _, _ = _scene(scene)
    ref = [np.asarray(p) for p in j_planes(cam, soup, valid)]
    ours = [p.numpy() for p in tr.clip_project_planes(_t(cam), _t(soup),
                                                      _t(valid))]
    assert len(ours) == 11 and ours[0].shape == (2 * len(soup),)
    np.testing.assert_array_equal(ours[10], ref[10])
    ok = ref[10]
    for o, r in zip(ours[:10], ref[:10]):
        np.testing.assert_allclose(o[ok], r[ok], rtol=1e-5, atol=1e-6)


def test_morton_order_matches_jax():
    soup = g._sphere_soup(16, 16)
    np.testing.assert_array_equal(tbinned.morton_order(soup),
                                  jbinned.morton_order(soup))


def test_pack_soup_matches_renderer_load_mesh():
    soup = g._sphere_soup(8, 8)
    verts = np.concatenate([soup.reshape(-1, 3),
                            np.ones((soup.size // 3, 1), np.float32)], 1)
    faces = np.arange(len(verts), dtype=np.int32).reshape(-1, 3)
    r = Renderer(64, 48)
    r.load_mesh(Mesh(verts, faces))
    packed, valid = pack_soup(soup)
    np.testing.assert_array_equal(packed, np.asarray(r.soup))
    np.testing.assert_array_equal(valid, np.asarray(r.soup_valid))


def _jax_lists(cam, soup, valid, h, w, monkeypatch):
    """The (lists, counts) the JAX binned wrapper hands its kernel."""
    import jax

    seen = []

    def capture(packed, lists, counts, height, width, chunk, slab,
                interpret):
        seen.append((np.asarray(lists), np.asarray(counts)))
        return jnp.zeros((-(-height // jbinned.TILE_H) * jbinned.TILE_H,
                          -(-width // jbinned.TILE_W) * jbinned.TILE_W),
                         jnp.float32)

    monkeypatch.setattr(jbinned, "_rasterize_slab", capture)
    with jax.disable_jit():
        jbinned.render_depth_binned(cam, soup, valid, h, w)
    assert len(seen) == 1  # one slab at these sizes
    return seen[0]


@pytest.mark.parametrize("scene", ["morton_sphere", "glx"])
def test_binning_matches_jax(scene, monkeypatch):
    """bin_chunks, fed the vertex bboxes the JAX wrapper bins with and its
    tile size, lists the same chunks per tile in the same order."""
    cam, soup, valid, h, w = _scene(scene)
    j_lists, j_counts = _jax_lists(cam, soup, valid, h, w, monkeypatch)
    x0, x1, x2, y0, y1, y2, *_, ok = tr.clip_project_planes(
        _t(cam), _t(soup), _t(valid))
    big = torch.tensor(3e38)
    xs, ys = torch.stack([x0, x1, x2]), torch.stack([y0, y1, y2])
    boxes = (torch.where(ok, xs.amin(0), big), torch.where(ok, xs.amax(0), -big),
             torch.where(ok, ys.amin(0), big), torch.where(ok, ys.amax(0), -big))
    pad = (-len(x0)) % tbinned.CHUNK
    boxes = [torch.nn.functional.pad(b, (0, pad), value=float(v))
             for b, v in zip(boxes, (3e38, -3e38, 3e38, -3e38))]
    lists, counts = tbinned.bin_chunks(*boxes, h, w, tile_h=jbinned.TILE_H,
                                       tile_w=jbinned.TILE_W)
    np.testing.assert_array_equal(counts.numpy(), j_counts)
    assert counts.sum() > 0
    for t, c in enumerate(j_counts):
        np.testing.assert_array_equal(lists[t, :c].numpy(), j_lists[t, :c])
    # the sentinel follows the active ids
    assert (lists[:, -1] == lists.shape[1]).any()


def test_coverage_bbox_holds_every_covered_pixel():
    """Every pixel a record covers lies in its coverage bbox, for skinny and
    near-clipped triangles too (the invariant that lets K1 cull by it)."""
    rng = np.random.default_rng(3)
    soup = (rng.normal(size=(300, 3, 3)) * [2.0, 2.0, 0.5]).astype(np.float32)
    soup[::3, 2] = soup[::3, 0] + 1e-3 * rng.normal(size=(100, 3))  # slivers
    cam = make_camera(eye=(0, 0, 1.0), near=0.05, far=20.0)
    h, w = 40, 56
    planes = tr.clip_project_planes(_t(cam), _t(soup),
                                    _t(np.ones(300, bool)))
    coeffs = tr.edge_affine_planes(*planes)
    xmin, xmax, ymin, ymax = tr.coverage_bbox(coeffs, planes[10])
    px, py = tr.pixel_grid(h, w, "cpu")
    X, Y = px[None, None, :], py[None, :, None]
    a0, b0, c0, a1, b1, c1, a2, b2, c2 = (c[:, None, None] for c in coeffs)
    cov = (((a0 * X + b0 * Y + c0) >= 0) & ((a1 * X + b1 * Y + c1) >= 0)
           & ((a2 * X + b2 * Y + c2) >= 0))
    inside = ((X >= xmin[:, None, None]) & (X <= xmax[:, None, None])
              & (Y >= ymin[:, None, None]) & (Y <= ymax[:, None, None]))
    assert cov.any()
    assert not (cov & ~inside).any()
