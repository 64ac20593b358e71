"""Scene input and mesh output of meshrecon_torch against meshrecon: the
track parser, OBJ files, camera centers and the synthetic frames.

Tolerances: the parse, the OBJ round trip and the camera centers are
equal. The synthetic frames are not: their noise hash is
``|sin(h) * 43758.5453| mod 1`` with ``h`` up to ~1e4, so one ulp of ``h``
or of ``sin`` comes out of it as noise. The port rounds ``h`` as the
reference's compiled CPU program does (two fused multiply-adds), which
leaves the ulps of ``sin`` and of the ray geometry. Measured at 80x60
(frames on the 0..255 scale): sphere (koule-tr) mean |diff| 0.011, max
0.37; plane (koberec) mean 0.025, 99.9th percentile 2.07, max 14.7 where a
texture cell's floor flips; auto (zatisi) mean 0.010, 99.9th percentile
1.88. Bounds: mean <= 0.05, 99.9th percentile <= 3, and more than one grey
level on at most 0.5% of pixels.
"""

import glob

import numpy as np
import pytest
import torch

from meshrecon.geometry.camera import np_extract_camera_center as j_center
from meshrecon.io import obj as j_obj
from meshrecon.io import synthetic as j_synth
from meshrecon.io.tracks import load_tracks as j_load
from meshrecon_torch.geometry.camera import np_extract_camera_center
from meshrecon_torch.io import obj, synthetic
from meshrecon_torch.io.tracks import _read_opencv_yaml, load_tracks

torch.set_num_threads(1)

TRACKS = sorted(glob.glob("tracks/*.yaml"))


@pytest.mark.parametrize("path", TRACKS)
@pytest.mark.parametrize("skip", [1, 3])
def test_track_parse_equals_jax(path, skip):
    ours, ref = load_tracks(path, skip), j_load(path, skip)
    for name in ref.__dataclass_fields__:
        a, b = getattr(ours, name), getattr(ref, name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name


def test_yaml_reader_dialect(tmp_path):
    path = tmp_path / "t.yaml"
    path.write_text(
        "%YAML:1.0\n"
        "# comment\n"
        "clip:\n"
        "  path: a.avi\n"
        "  fov: 0.5\n"
        "seq:\n"
        "  - m: !!opencv-matrix\n"
        "      rows: 2\n"
        "      cols: 2\n"
        "      dt: f\n"
        "      data: [ 1.0, 2.0,\n"
        "          3.0, 4.5e-01 ]\n"
        "    n: [1, 2]\n"
        "  - m: 7\n")
    doc = _read_opencv_yaml(str(path))
    assert doc["clip"] == {"path": "a.avi", "fov": 0.5}
    np.testing.assert_array_equal(doc["seq"][0]["m"],
                                  np.array([[1, 2], [3, 0.45]], np.float32))
    assert doc["seq"][0]["n"] == [1, 2]
    assert doc["seq"][1] == {"m": 7}
    path.write_text("a: [1, 2\n")
    with pytest.raises(ValueError):
        _read_opencv_yaml(str(path))


def test_obj_round_trip_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    v = np.concatenate([rng.normal(size=(12, 3)), np.ones((12, 1))], 1)
    f = rng.integers(0, 12, size=(9, 3))
    ours_path, ref_path = tmp_path / "a.obj", tmp_path / "b.obj"
    obj.save_mesh(obj.Mesh(v, f), str(ours_path))
    j_obj.save_mesh(j_obj.Mesh(v, f), str(ref_path))
    assert ours_path.read_text() == ref_path.read_text()
    back, ref = obj.read_mesh(str(ours_path)), j_obj.read_mesh(str(ref_path))
    np.testing.assert_array_equal(back.vertices, ref.vertices)
    np.testing.assert_array_equal(back.faces, ref.faces)
    np.testing.assert_array_equal(back.triangle_soup, ref.triangle_soup)


@pytest.mark.parametrize("path", TRACKS)
def test_camera_centers_equal_jax(path):
    for cam in j_load(path).cameras[:8]:
        np.testing.assert_array_equal(np_extract_camera_center(cam),
                                      j_center(cam))


@pytest.mark.parametrize("path", TRACKS)
def test_surface_fits_equal_jax(path):
    bundles = j_load(path).bundles
    for a, b in zip(synthetic.fit_sphere(bundles), j_synth.fit_sphere(bundles)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(synthetic.fit_plane(bundles), j_synth.fit_plane(bundles)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("path,mode", [("tracks/koule-tr.yaml", "sphere"),
                                       ("tracks/koberec.yaml", "plane"),
                                       ("tracks/zatisi.yaml", "auto")])
def test_synthetic_frames_close_to_jax(path, mode):
    track = j_load(path)
    ref = j_synth.synthetic_frames(track, 80, 60, mode=mode, seed=3)
    ours = synthetic.synthetic_frames(track, 80, 60, mode=mode, seed=3,
                                      device="cpu")
    assert ours.dtype == torch.float32 and ours.shape == ref.shape
    diff = np.abs(ours.numpy() - ref)
    assert diff.mean() <= 0.05, diff.mean()
    assert np.quantile(diff, 0.999) <= 3.0
    assert (diff > 1.0).mean() <= 0.005
    assert ref.std() > 10.0
