"""Camera-center extraction on the host (port of the numpy helper of
meshrecon/geometry/camera.py).

A camera is one 4x4 projection matrix mapping homogeneous world points to
clip space; NDC = clip.xyz / clip.w, image row 0 at NDC y = +1.
"""

from __future__ import annotations

import numpy as np


def np_extract_camera_center(camera: np.ndarray) -> np.ndarray:
    """Center of a 4x4 camera as a homogeneous float32 4-vector: the null
    vector of its x, y and w rows (util.cpp:33-41), sign fixed so w >= 0."""
    p34 = np.asarray(camera, dtype=np.float64)[(0, 1, 3), :]
    _, _, vt = np.linalg.svd(p34)
    center = vt[-1, :]
    if center[3] < 0:
        center = -center
    return center.astype(np.float32)
