"""``-V`` (hyper-verbose) runs of meshrecon_torch against meshrecon's on
the CPU, and the stage-by-stage per-camera path that ``-V`` takes.

Both packages decode one gray MJPG clip of koule-tr (the JAX package's
synthetic frames at 80x60, seed 0, scaled to 640x480 by nearest) at -s 8
(80x60), and run ``-V -n 1 --depth-mode flow`` in a working directory of
their own (``-V`` writes its dumps there, as the reference does).
Bounds: the same dump file names; ``frame<i>.png`` (the decoded frame,
not normalized) bit for bit, since the decode is bit-equal; every other
PNG within a mean absolute difference of 2 levels of 255 (the depth, flow
and error images are normalized by their own min and max, and the flows
differ in the last bits); the three OBJ dumps present.

The per-camera path against the port's fused update on the same bundle:
the JAX suite's fused-vs-unfused bound
(tests/test_pipeline.py::test_fused_matches_unfused: the same valid count,
points within rtol 1e-4 and atol 1e-4), the fused update run with exact
sampling and the bicubic re-warp, which the per-camera path computes; the
normals within 1e-3.
"""

import os
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from meshrecon.io.synthetic import synthetic_frames as j_frames
from meshrecon.io.tracks import load_tracks
from meshrecon.pipeline.config import apply_kernel_knobs
from meshrecon.pipeline.config import configs_from_args as j_configs
from meshrecon.pipeline.reconstruct import reconstruct_scenes as j_scenes
from meshrecon_torch import cli
from meshrecon_torch.geometry.camera import np_extract_camera_center
from meshrecon_torch.io.obj import read_mesh
from meshrecon_torch.pipeline import reconstruct
from meshrecon_torch.pipeline.config import Config
from meshrecon_torch.pipeline.fused import fused_main_update
from meshrecon_torch.pipeline.heuristic import Heuristic
from meshrecon_torch.raster.rasterizer import Renderer

cv2 = pytest.importorskip("cv2")
import imageio.v3 as iio  # noqa: E402

torch.set_num_threads(1)

OBJ_DUMPS = {"recon_orig.obj", "purepoints.obj", "filteredpoints.obj"}


@pytest.fixture(scope="module")
def gray_clip(tmp_path_factory):
    """koule-tr's YAML beside a gray MJPG clip of its synthetic frames."""
    d = tmp_path_factory.mktemp("clip")
    src = load_tracks("tracks/koule-tr.yaml")
    gray = j_frames(src, 80, 60, mode="sphere", seed=0)
    wr = cv2.VideoWriter(str(d / "koule.avi"), cv2.VideoWriter_fourcc(
        *"MJPG"), 24, (src.width, src.height))
    assert wr.isOpened()
    for f in gray:
        big = cv2.resize(f.astype(np.uint8), (src.width, src.height),
                         interpolation=cv2.INTER_NEAREST)
        wr.write(np.stack([big] * 3, axis=-1))
    wr.release()
    text = open("tracks/koule-tr.yaml").read().replace("koule-perlin.mkv",
                                                      "koule.avi")
    (d / "a.yaml").write_text(text)
    (d / "b.yaml").write_text(text)
    return d


def _dumps(path):
    return {p for p in os.listdir(path) if p.endswith((".png", ".obj"))}


@pytest.mark.parametrize("knobs", [
    [], ["--flow-levels", "3", "--flow-warps", "2", "--flow-iters", "20"]],
    ids=["default", "flow_knobs"])
def test_hyper_verbose_dumps_match_jax(gray_clip, tmp_path, monkeypatch,
                                       knobs):
    """The dumps of both packages; with ``knobs`` the per-camera flows of
    both take the given pyramid, warps and sweeps (the JAX package sets
    them as module globals, the port hands them to calculate_flow)."""
    flags = ["-V", "-s", "8", "-n", "1", "--depth-mode", "flow", "--seed",
             "3"] + knobs
    yamls = [str(gray_clip / "a.yaml"), str(gray_clip / "b.yaml")]
    ref_dir, our_dir = tmp_path / "jax", tmp_path / "torch"
    ref_dir.mkdir()
    our_dir.mkdir()
    monkeypatch.chdir(ref_dir)
    try:
        j_scenes(j_configs(yamls + flags + ["-o", str(ref_dir / "s{}.obj")]))
    finally:
        # the knobs are module globals there: restore the defaults for the
        # JAX calls of later tests in this process
        apply_kernel_knobs(SimpleNamespace())
    monkeypatch.chdir(our_dir)
    assert cli.main(yamls + flags + ["-o", str(our_dir / "s{}.obj"),
                                     "--device", "cpu"]) == 0

    names = _dumps(our_dir)
    assert names == _dumps(ref_dir)
    assert OBJ_DUMPS | {"s0.obj", "s1.obj"} <= names
    frames = {n for n in names if re.fullmatch(r"frame\d+\.png", n)}
    projections = {n for n in names if n.startswith("project-frame")}
    assert frames and projections
    # two images a main camera, four a side
    assert len([n for n in names if n.endswith(".png")]) == \
        2 * len(frames) + 4 * len(projections)
    for name in sorted(n for n in names if n.endswith(".png")):
        ours = iio.imread(our_dir / name).astype(np.float64)
        ref = iio.imread(ref_dir / name).astype(np.float64)
        assert ours.shape == ref.shape, name
        if name in frames:
            np.testing.assert_array_equal(ours, ref, err_msg=name)
        else:
            assert np.abs(ours - ref).mean() <= 2.0, name
    for name in ("s0.obj", "s1.obj"):
        mesh = read_mesh(str(our_dir / name))
        assert len(mesh.faces) and np.isfinite(mesh.vertices).all()


@pytest.mark.parametrize("knobs", [
    {}, {"flow_levels": 3, "flow_warps": 2, "flow_iters": 20,
         "flow_fine_warps": 2}, {"flow_solver": "jacobi"}],
    ids=["default", "pyramid", "jacobi"])
def test_unfused_camera_matches_fused(tmp_path, monkeypatch, knobs):
    """The port's -V per-camera path (render, project, mix, calculate_flow,
    triangulate, normals) against its fused update (tests/test_pipeline.py
    ::test_fused_matches_unfused, port side), both with the configuration's
    flow knobs."""
    track = load_tracks("tracks/koule-tr.yaml")
    frames = torch.from_numpy(j_frames(track, 80, 60, mode="sphere", seed=0))
    monkeypatch.chdir(tmp_path)
    cfg = Config(track=track, frames=frames, device="cpu", seed=2,
                 verbosity=3, **knobs)
    hint = Heuristic(cfg)
    hint.not_happy(track.bundles)
    mesh = hint.tessellate(track.bundles, np.zeros((len(track.bundles), 3)))
    r = Renderer(cfg.width, cfg.height, device="cpu")
    r.load_mesh(mesh)

    fa, sides = 0, [5, 12]
    kb = reconstruct._bucket(len(sides))
    sc = np.tile(np.eye(4, dtype=np.float32), (kb, 1, 1))
    sf = torch.zeros((kb, cfg.height, cfg.width))
    sv = np.zeros(kb, bool)
    for i, fb in enumerate(sides):
        sc[i] = cfg.camera(fb)
        sf[i] = cfg.frame(fb)
        sv[i] = True
    ctrs = [np_extract_camera_center(cfg.camera(fa))] + [
        np_extract_camera_center(cfg.camera(fb)) for fb in sides]
    c3 = np.stack([c[:3] / c[3] for c in ctrs]).astype(np.float32)
    cb = reconstruct._bucket(len(c3))
    cp = np.zeros((cb, 3), np.float32)
    cp[: len(c3)] = c3
    cv = np.zeros(cb, bool)
    cv[: len(c3)] = True
    outf = fused_main_update(
        r.soup, r.soup_valid, torch.from_numpy(cfg.camera(fa)),
        cfg.frame(fa), torch.from_numpy(sc), sf, torch.from_numpy(sv),
        torch.from_numpy(cp), torch.from_numpy(cv), len(sides),
        height=cfg.height, width=cfg.width, sampling="exact",
        variance="rewarp", flow_solver=cfg.flow_solver,
        **reconstruct._flow_knobs(cfg))
    validf = outf["valid"].numpy()
    pts_f = outf["point4"].numpy()[validf]

    pts_u, nrm_u, n_u = reconstruct.process_main_camera(
        cfg, r, fa, sides, depth_mode="flow")
    assert n_u == int(validf.sum()) > 0
    np.testing.assert_allclose(pts_f, pts_u, rtol=1e-4, atol=1e-4)
    nrm_f = outf["normals"].numpy()[validf]
    assert np.isfinite(nrm_u).all()
    np.testing.assert_allclose(nrm_f, nrm_u, rtol=1e-3, atol=1e-3)
    # the dumps of one main camera with two sides
    assert len([n for n in os.listdir(tmp_path) if n.endswith(".png")]) == \
        2 + 4 * len(sides)


@pytest.mark.parametrize("shape,normalize", [
    ((13, 17), False), ((13, 17), True), ((13, 17, 3), False),
    ((13, 17, 1), False), ((13, 17, 4), True), ((13, 17, 2), False)],
    ids=["gray", "gray_norm", "rgb", "one", "four_norm", "two"])
def test_save_image_matches_jax(tmp_path, shape, normalize):
    """The port's cv2 PNG writer gives the JAX package's imageio pixels
    (channels padded or cut to 3, RGB order, joint normalization)."""
    from meshrecon.io.images import save_image as j_save
    from meshrecon_torch.io.images import read_image, save_image

    img = np.random.default_rng(len(shape)).uniform(-40, 300, shape)
    save_image(torch.from_numpy(img), str(tmp_path / "t.png"), normalize)
    j_save(img, str(tmp_path / "j.png"), normalize)
    ours = iio.imread(tmp_path / "t.png")
    np.testing.assert_array_equal(ours, iio.imread(tmp_path / "j.png"))
    np.testing.assert_array_equal(read_image(str(tmp_path / "t.png")), ours)
