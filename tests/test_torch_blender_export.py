"""The Blender exporter's serializer of meshrecon_torch
(io/blender_export_tracks.py) against meshrecon's on the CPU: the same
text byte for byte on tests/test_io.py's scene, read back by the port's
own parser; the perspective matrix, the matrix format and ``bl_info``
equal. The ``bpy`` operator is a Blender addon and stays with the JAX
package.
"""

import io

import numpy as np
import pytest

from meshrecon.io import blender_export_tracks as j_export
from meshrecon_torch.io import blender_export_tracks as export
from meshrecon_torch.io.tracks import load_tracks

PROJ = [[1.5, 0, 0, 0], [0, 2.0, 0, 0], [0, 0, -1.2, -3.4], [0, 0, -1, 0]]
CLIP = {"path": "clip.avi", "width": 640, "height": 480, "fov": 1.1,
        "distortion": (-0.1, 0.05, 0.0), "center_x": 320.0,
        "center_y": 240.0}
CAMERAS = [{"frame": 1, "near": 2.0, "far": 20.0, "projection": PROJ,
            "position": [0, 0, 0, 1]},
           {"frame": 2, "near": 2.1, "far": 20.5, "projection": PROJ,
            "position": [0.1, 0, 0, 1]}]
TRACKS = [{"bundle": [1, 2, 3, 1], "frames_enabled": [1, 2]},
          {"bundle": [4, 5, 6, 1], "frames_enabled": [2]}]


def _text(module):
    buf = io.StringIO()
    module.write_tracks_yaml(buf, CLIP, CAMERAS, TRACKS)
    return buf.getvalue()


def test_write_tracks_yaml_equals_jax_and_reads_back(tmp_path):
    text = _text(export)
    assert text.encode() == _text(j_export).encode()
    path = tmp_path / "scene.yaml"
    path.write_text(text)
    tf = load_tracks(str(path))
    assert tf.width == 640 and tf.height == 480 and tf.frame_count == 2
    assert tf.bundles.shape == (2, 4)
    np.testing.assert_allclose(tf.cameras[0], np.asarray(PROJ), rtol=1e-6)
    np.testing.assert_allclose(tf.bundles[1], [4, 5, 6, 1])
    assert tf.bundles_enabled[0] == {0, 1} and tf.bundles_enabled[1] == {1}


@pytest.mark.parametrize("aspect", [0.75, 1.0, 16 / 9])
def test_perspective_equals_jax(aspect):
    assert (export._perspective(0.9, aspect, 0.1, 50.0)
            == j_export._perspective(0.9, aspect, 0.1, 50.0))


def test_fmt_matrix_and_bl_info_equal_jax():
    rows = [[0.1, 2, -3.5], [4e-9, 5, 6]]
    assert export._fmt_matrix(rows, 2) == j_export._fmt_matrix(rows, 2)
    assert export.bl_info == j_export.bl_info
