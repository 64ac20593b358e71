"""The serializer of the Blender tracking exporter: motion-tracking data in
the OpenCV-YAML dialect that ``recon`` consumes. Port of the pure half of
meshrecon/io/blender_export_tracks.py (the reference's producer-side addon,
io_export_tracks.py):

- ``clip``: path, size, horizontal FOV, three radial distortion
  coefficients, principal point (io_export_tracks.py:40-54);
- ``camera``: per tracked frame a 1-based frame index, near/far and the
  4x4 ``projection`` (:func:`_perspective` times the inverse camera times a
  z flip, io_export_tracks.py:22-28), plus the camera ``position``;
- ``tracks``: per tracking point its homogeneous ``bundle`` and the 1-based
  frames where its marker is enabled (io_export_tracks.py:86-96).

The Blender operator that gathers these from a scene (``bpy``) is a Blender
addon and stays with the JAX package; this module writes the same bytes
from the same values.
"""

from __future__ import annotations

import math

bl_info = {
    "name": "Export tracking data (meshrecon)",
    "description": "Camera track + bundles in the OpenCV-YAML recon format",
    "category": "Import-Export",
}


def _fmt_matrix(mat_rows, indent=4):
    data = ", ".join(repr(float(v)) for row in mat_rows for v in row)
    pad = " " * indent
    return (
        f"{pad}rows: {len(mat_rows)}\n"
        f"{pad}cols: {len(mat_rows[0])}\n"
        f"{pad}dt: f\n"
        f"{pad}data: [ {data}]\n"
    )


def write_tracks_yaml(fh, clip_info, cameras, tracks):
    """Serialize the scene in the exact file dialect.

    clip_info: dict(path, width, height, fov, distortion(k1, k2, k3),
    center_x, center_y); cameras: list of dicts (frame [1-based], near, far,
    projection 4x4 nested list, position length-4 list); tracks: list of
    dicts (bundle length-4, frames_enabled list of 1-based ints).
    """
    fh.write("%YAML:1.0\n")
    fh.write("clip:\n")
    fh.write(f" path: {clip_info['path']}\n")
    fh.write(f" width: {clip_info['width']}\n")
    fh.write(f" height: {clip_info['height']}\n")
    fh.write(f" fov: {clip_info['fov']!r}\n")
    k1, k2, k3 = clip_info["distortion"]
    fh.write(f" distortion: [{k1!r}, {k2!r}, {k3!r}]\n")
    fh.write(f" center-x: {clip_info['center_x']!r}\n")
    fh.write(f" center-y: {clip_info['center_y']!r}\n")
    fh.write("camera:\n")
    for cam in cameras:
        fh.write(f" - frame: {cam['frame']}\n")
        fh.write(f"   near: {cam['near']!r}\n")
        fh.write(f"   far: {cam['far']!r}\n")
        fh.write("   projection: !!opencv-matrix\n")
        fh.write(_fmt_matrix(cam["projection"]))
        fh.write("   position: !!opencv-matrix\n")
        fh.write(_fmt_matrix([[v] for v in cam["position"]]))
    fh.write("tracks:\n")
    for tr in tracks:
        fh.write(" - bundle: !!opencv-matrix\n")
        fh.write(_fmt_matrix([[v] for v in tr["bundle"]]))
        enabled = ", ".join(str(int(f)) for f in tr["frames_enabled"])
        fh.write(f"   frames-enabled: [{enabled}]\n")


def _perspective(fov, aspect, near, far):
    """Row-major perspective matrix matching Blender's PerspectiveMatrix."""
    f = 1.0 / math.tan(fov / 2.0)
    return [
        [f, 0.0, 0.0, 0.0],
        [0.0, f / aspect if aspect < 1 else f * (1 / aspect), 0.0, 0.0],
        [0.0, 0.0, (near + far) / (near - far), 2.0 * near * far / (near - far)],
        [0.0, 0.0, -1.0, 0.0],
    ]
