"""The port's standalone drivers and the modules only they use, against
meshrecon's on the CPU.

- The flow driver (``meshrecon_torch.flow.driver``) on its own fixture
  pair (240x320), with no knob (the pipeline's calculate_flow), with ``f``
  (Farneback) and with ``l3`` (the library flow): flow.png, remap.png and
  diff.png within a mean absolute difference of 1 level of 255 (and no
  pixel more than 64 levels apart), ``Diff sum`` within 1%. The flows
  themselves agree to ~1e-4 px (test_torch_flow.py, test_torch_farneback.py);
  the PNGs scale them by 10 (flow.png, diff.png) before rounding.
- The raster driver (``meshrecon_torch.raster.driver``) on the golden
  scene at 640x480: out-depth.png and out-projected.png within a mean
  absolute difference of 1 level, the printed depth min and max within
  1e-5.
- ``raster.reference.render_depth_reference`` bit for bit: the same
  float64 NumPy loop. The raster driver's float32 depth against it within
  tests/test_raster.py::test_glx_golden_scene's bounds (coverage
  disagreement under 1%, 99% of depths within 1e-2 NDC), the check
  chip_smoke.py makes of K1's depth.
- ``flow.shiftwarp``: within 1e-3 on the 0..255 scale (float32 sums of
  the same terms in the same order; XLA contracts the multiply-adds into
  FMAs, measured 4e-4).
"""

import re

import imageio.v3 as iio
import numpy as np
import pytest
import torch

import tests.test_flow  # noqa: F401  (the JAX drivers import these by name
import tests.test_raster  # noqa: F401  from the working directory's root)
from meshrecon.flow import driver as j_flow_driver
from meshrecon.flow.shiftwarp import shift_warp_bicubic as j_bicubic
from meshrecon.flow.shiftwarp import shift_warp_bilinear as j_bilinear
from meshrecon.raster import driver as j_raster_driver
from meshrecon.raster.reference import render_depth_reference as j_ref
from meshrecon_torch.flow import driver as t_flow_driver
from meshrecon_torch.flow.shiftwarp import shift_warp_bicubic as t_bicubic
from meshrecon_torch.flow.shiftwarp import shift_warp_bilinear as t_bilinear
from meshrecon_torch.raster import driver as t_raster_driver
from meshrecon_torch.raster.reference import render_depth_reference as t_ref
from tests.test_raster import GLX_FACES, GLX_MVP, GLX_POINTS, GLX_SIDE_MVP

torch.set_num_threads(1)


def _run_in(monkeypatch, capsys, path, main, argv):
    path.mkdir()
    monkeypatch.chdir(path)
    assert main(argv) == 0
    return capsys.readouterr().out


def _close_pngs(a_dir, b_dir, names, mean_levels=1.0, max_levels=64):
    for name in names:
        a = iio.imread(a_dir / name).astype(np.float64)
        b = iio.imread(b_dir / name).astype(np.float64)
        assert a.shape == b.shape, name
        diff = np.abs(a - b)
        assert diff.mean() <= mean_levels, (name, diff.mean())
        assert diff.max() <= max_levels, (name, diff.max())


def _diff_sum(out):
    return float(re.search(r"Diff sum: (\S+)", out).group(1))


@pytest.mark.parametrize("knobs", [[], ["f"], ["l3"]],
                         ids=["calculate_flow", "farneback", "library"])
def test_flow_driver_matches_jax(tmp_path, monkeypatch, capsys, knobs):
    """Each driver given no images writes its fixture pair to test/ and
    runs on it (one knob alone does not count as images)."""
    ref_dir, our_dir = tmp_path / "jax", tmp_path / "torch"
    ref = _run_in(monkeypatch, capsys, ref_dir, j_flow_driver.main, knobs)
    ours = _run_in(monkeypatch, capsys, our_dir, t_flow_driver.main,
                   knobs + ["--device", "cpu"])
    _close_pngs(ref_dir, our_dir, ["test/flow1.png", "test/flow2.png"],
                mean_levels=0, max_levels=0)
    _close_pngs(ref_dir, our_dir, ["flow.png", "remap.png", "diff.png"])
    assert abs(_diff_sum(ours) - _diff_sum(ref)) <= 0.01 * _diff_sum(ref)


def test_raster_driver_matches_jax(tmp_path, monkeypatch, capsys):
    ref = _run_in(monkeypatch, capsys, tmp_path / "jax",
                  j_raster_driver.main, None)
    ours = _run_in(monkeypatch, capsys, tmp_path / "torch",
                   t_raster_driver.main, ["--device", "cpu"])
    _close_pngs(tmp_path / "jax", tmp_path / "torch",
                ["test/out-depth.png", "test/out-projected.png"])
    pattern = r"Depth min: (\S+), max: (\S+)"
    np.testing.assert_allclose(
        [float(v) for v in re.search(pattern, ours).groups()],
        [float(v) for v in re.search(pattern, ref).groups()], atol=1e-5)


def test_golden_scene_is_the_jax_fixture():
    for ours, ref in ((t_raster_driver.GLX_POINTS, GLX_POINTS),
                      (t_raster_driver.GLX_FACES, GLX_FACES),
                      (t_raster_driver.GLX_MVP, GLX_MVP),
                      (t_raster_driver.GLX_SIDE_MVP, GLX_SIDE_MVP)):
        assert ours.dtype == ref.dtype
        np.testing.assert_array_equal(ours, ref)


def test_raster_driver_depth_matches_reference():
    depth = t_raster_driver.render("cpu")[0].numpy()
    ref = t_ref(GLX_MVP, t_raster_driver.golden_soup(), 480, 640)
    cover, cover_ref = depth < 1.0, ref < 1.0
    assert cover.mean() > 0.05
    assert np.mean(cover != cover_ref) < 0.01
    both = cover & cover_ref
    assert np.mean(np.abs(depth[both] - ref[both]) < 1e-2) > 0.99


@pytest.mark.parametrize("scene", ["glx", "random", "near"])
def test_render_depth_reference_bitwise(scene):
    if scene == "glx":
        cam, soup, h, w = GLX_MVP, t_raster_driver.golden_soup(), 60, 80
    else:
        from tests.test_geometry import make_camera

        rng = np.random.default_rng(12345)
        soup = rng.normal(size=(25, 3, 3)).astype(np.float32)
        eye = (0, 0, 0.2) if scene == "near" else (0, 0, 4.0)
        cam = make_camera(eye=eye, near=0.01, far=10.0)
        h, w = 32, 48
    ours = t_ref(cam, soup, h, w)
    ref = j_ref(cam, soup, h, w)
    assert ours.dtype == np.float32 and (ours < 1.0).any()
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("taps", [2, 4])
def test_shift_warps_match_jax(taps):
    from meshrecon_torch.flow.driver import smooth_image

    rng = np.random.default_rng(3)
    img = smooth_image(37, 53, seed=5)
    fx = rng.uniform(-8, 8, img.shape).astype(np.float32)
    fy = rng.uniform(-8, 8, img.shape).astype(np.float32)
    j_fn, t_fn = (j_bilinear, t_bilinear) if taps == 2 else (j_bicubic,
                                                           t_bicubic)
    ref = np.asarray(j_fn(img, fx, fy, radius=6))
    ours = t_fn(torch.from_numpy(img), torch.from_numpy(fx),
                torch.from_numpy(fy), radius=6)
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-3)
