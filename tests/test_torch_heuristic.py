"""The camera policy of meshrecon_torch against meshrecon on the CPU:
face cameras, the occlusion probe, the bundles ``choose_cameras`` picks,
and the tessellation of both kinds of iteration.

Tolerances: face cameras and areas are the same numpy code (equal). The
probe evaluates the same affine edge functions, but the JAX CPU backend
fuses their multiply-adds and torch does not. A viewer sits on the surface
with its near plane at 0.001, so its neighbouring triangles straddle the
near plane and their clipped vertices amplify last-bit differences (the
near-straddle case of test_torch_raster.py). Measured on 960 random
samples: coverage differs on 1 (bound 1%); where both cover, the median
|dz| is below 1e-5 and the largest 0.0112 NDC (bounds 1e-5 and 0.02).
``choose_cameras`` tests ``probe != 1 & probe <= z``; the bundles it picks
from one seed are equal (seeds 1, 3, 7 on koule-tr at 80x60).
"""

import numpy as np
import pytest
import torch

from meshrecon.io.obj import Mesh as JMesh
from meshrecon.io.synthetic import synthetic_frames
from meshrecon.io.tracks import load_tracks
from meshrecon.pipeline import heuristic as j_heur
from meshrecon.pipeline.config import Config as JConfig
from meshrecon.raster import Renderer as JRenderer
from meshrecon.raster.rasterizer import depth_probe as j_probe
from meshrecon_torch.io.obj import Mesh
from meshrecon_torch.pipeline import heuristic
from meshrecon_torch.pipeline.config import Config
from meshrecon_torch.raster.rasterizer import Renderer, depth_probe
from meshrecon_torch.state import pack_soup

torch.set_num_threads(1)


def _cpu_renderer(width, height):
    return Renderer(width, height, device="cpu")


@pytest.fixture(scope="module")
def koule():
    track = load_tracks("tracks/koule-tr.yaml")
    frames = synthetic_frames(track, 80, 60, mode="sphere", seed=0)
    return track, frames


def _pair(koule, seed, **kw):
    track, frames = koule
    cfg = Config(track=track, frames=torch.from_numpy(frames), device="cpu",
                 seed=seed, **kw)
    jcfg = JConfig(track=track, frames=frames, seed=seed, **kw)
    return heuristic.Heuristic(cfg), j_heur.Heuristic(jcfg)


def test_face_camera_and_areas_equal_jax(koule):
    track, _ = koule
    rng = np.random.default_rng(0)
    verts = np.concatenate([rng.normal(size=(9, 3)), np.ones((9, 1))], 1)
    faces = rng.integers(0, 9, size=(6, 3))
    for face, u1, u2 in zip(faces, rng.uniform(size=6), rng.uniform(size=6)):
        np.testing.assert_array_equal(
            heuristic.face_camera(verts, face, u1, u2, far=12.0),
            j_heur.face_camera(verts, face, u1, u2, far=12.0))
    np.testing.assert_array_equal(heuristic.face_areas(Mesh(verts, faces)),
                                  j_heur.face_areas(JMesh(verts, faces)))


def test_depth_probe_matches_jax(koule):
    track, _ = koule
    hint, _ = _pair(koule, 0)
    hint.not_happy(track.bundles)
    mesh = hint.tessellate(track.bundles, np.zeros((len(track.bundles), 3)))
    soup, valid = pack_soup(mesh.triangle_soup)
    rng = np.random.default_rng(1)
    idx = rng.integers(0, len(mesh.faces), size=24)
    viewers = np.stack([heuristic.face_camera(mesh.vertices, mesh.faces[i],
                                              u1, u2)
                        for i, u1, u2 in zip(idx, rng.uniform(size=24),
                                             rng.uniform(size=24))])
    xy = rng.uniform(-1.1, 1.1, size=(24, 40, 2)).astype(np.float32)
    ours = depth_probe(torch.from_numpy(viewers), torch.from_numpy(soup),
                       torch.from_numpy(valid), torch.from_numpy(xy)).numpy()
    ref = np.asarray(j_probe(viewers, soup, valid, xy))
    hit = ref != 1.0
    assert 0.05 < hit.mean() < 0.95
    assert ((ours != 1.0) == hit).mean() >= 0.99
    dz = np.abs(ours - ref)[(ours != 1.0) & hit]
    assert dz.max() <= 2e-2 and np.median(dz) <= 1e-5, (dz.max(),
                                                        np.median(dz))


@pytest.mark.parametrize("seed", [1, 3, 7])
def test_choose_cameras_equals_jax(koule, seed):
    track, _ = koule
    hint, jhint = _pair(koule, seed)
    picks = []
    for h, make_renderer, mesh_cls in ((hint, _cpu_renderer, Mesh),
                                       (jhint, JRenderer, JMesh)):
        assert h.not_happy(track.bundles)
        mesh = h.tessellate(track.bundles,
                            np.zeros((len(track.bundles), 3)))
        r = make_renderer(80, 60)
        r.load_mesh(mesh)
        count = h.choose_cameras(mesh, track.cameras, r)
        picks.append((count, h.camera_bundles(), h.alpha_vals,
                      np.asarray(mesh.faces)))
    (c, b, a, f), (jc, jb, ja, jf) = picks
    np.testing.assert_array_equal(f, jf)
    assert a == ja
    assert c == jc and c > 0
    assert b == jb and len(b) > 0


def test_repairs_and_cap_equal_jax(koule):
    """The deterministic repairs (coverage, diversity, bundle floor) and the
    side cap on top of the draw."""
    track, _ = koule
    kw = dict(camera_coverage=0.9, baseline_diversity=1.5, min_bundles=6,
              max_sides=2)
    hint, jhint = _pair(koule, 5, **kw)
    out = []
    for h, make_renderer in ((hint, _cpu_renderer), (jhint, JRenderer)):
        h.not_happy(track.bundles)
        mesh = h.tessellate(track.bundles, np.zeros((len(track.bundles), 3)))
        r = make_renderer(80, 60)
        r.load_mesh(mesh)
        out.append((h.choose_cameras(mesh, track.cameras, r),
                    h.camera_bundles()))
    assert out[0] == out[1]
    assert all(len(s) <= 2 for _, s in out[0][1])


def test_poisson_tessellation_close_to_jax(koule):
    """Iteration >= 2: Poisson + supported components + support trim."""
    track, _ = koule
    rng = np.random.default_rng(2)
    center = track.bundles[:, :3].mean(0)
    v = rng.normal(size=(3000, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pts = np.concatenate([center + 0.4 * v, np.ones((3000, 1))], 1).astype(
        np.float32)
    nrm = (v * rng.uniform(0.5, 1.5, size=(3000, 1))).astype(np.float32)
    hint, jhint = _pair(koule, 0, poisson_grid=32)
    meshes = []
    for h in (hint, jhint):
        h.iteration, h.alpha_vals = 2, [0.5]
        meshes.append(h.tessellate(pts, nrm, final=True))
    assert hint.alpha_vals == jhint.alpha_vals == [0.5, 0.25]
    ours, ref = meshes
    assert len(ref.faces) > 500
    assert abs(len(ours.faces) - len(ref.faces)) <= 0.01 * len(ref.faces)
