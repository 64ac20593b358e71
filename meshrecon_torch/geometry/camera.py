"""Camera geometry (port of meshrecon/geometry/camera.py): the camera
center (on the host, and on tensors), projection of homogeneous points in
float32 torch, and the pixel <-> NDC conventions.

A camera is one 4x4 projection matrix mapping homogeneous world points to
clip space; NDC = clip.xyz / clip.w, image row 0 at NDC y = +1.
"""

from __future__ import annotations

import numpy as np
import torch

from meshrecon_torch.pipeline.config import resolve_device
from meshrecon_torch.utils.profiling import host_read


def np_extract_camera_center(camera: np.ndarray) -> np.ndarray:
    """Center of a 4x4 camera as a homogeneous float32 4-vector: the null
    vector of its x, y and w rows (util.cpp:33-41), sign fixed so w >= 0."""
    p34 = np.asarray(camera, dtype=np.float64)[(0, 1, 3), :]
    _, _, vt = np.linalg.svd(p34)
    center = vt[-1, :]
    if center[3] < 0:
        center = -center
    return center.astype(np.float32)


def extract_camera_center(camera):
    """Center of a (..., 4, 4) camera tensor as a homogeneous (..., 4)
    vector, not normalized: the right-singular vector of the x, y and w
    rows (util.cpp:33-41) with the smallest singular value, sign fixed so
    that w >= 0."""
    p34 = camera[..., (0, 1, 3), :]
    center = torch.linalg.svd(p34).Vh[..., -1, :]
    sign = torch.where(center[..., 3:4] < 0, -1.0, 1.0)
    return center * sign


def invert_cameras(cameras):
    """``torch.linalg.inv`` of (..., 4, 4) camera matrices, which raises
    for a singular one: its status is read on the host once, a counted
    host read (``utils.profiling.host_read``), where ``linalg.inv``'s own
    check synchronizes once or twice by batch size."""
    inv, info = torch.linalg.inv_ex(cameras)
    if host_read(info.any()):
        raise torch.linalg.LinAlgError(
            "invert_cameras: a camera matrix is singular")
    return inv


def dehomogenize(points):
    """(..., 4) homogeneous -> (..., 3) Cartesian (util.cpp:16-29)."""
    return points[..., :3] / points[..., 3:4]


def camera_to_screen(points3, lens_distortion, aspect):
    """The exporter's radial lens distortion on (..., 3) NDC points: the
    radius from (x, y * aspect) / 2, the whole point scaled by
    ``1 + r^2 (k1 + r^2 k2)`` (configuration.cpp:250-258)."""
    k1, k2 = float(lens_distortion[0]), float(lens_distortion[1])
    rad2 = (points3[..., 0] ** 2 + (points3[..., 1] * aspect) ** 2) / 4.0
    k = 1.0 + rad2 * (k1 + rad2 * k2)
    return points3 * k[..., None]


def project_points(camera, points4, lens_distortion=None, aspect=1.0,
                   device="cuda"):
    """Project (N, 4) homogeneous world points by a (4, 4) camera, then
    distort when ``lens_distortion`` is given: (N, 3) float32 NDC points on
    ``device`` (configuration.cpp:262-267)."""
    device = resolve_device(device)
    cam = torch.as_tensor(np.asarray(camera), dtype=torch.float32,
                          device=device)
    pts = torch.as_tensor(np.asarray(points4), dtype=torch.float32,
                          device=device)
    cart = dehomogenize(pts @ cam.T)
    if lens_distortion is not None:
        cart = camera_to_screen(cart, lens_distortion, aspect)
    return cart


def ndc_to_pixel(x, y, width, height):
    """NDC (x, y) -> continuous pixel (col, row), y = +1 at row 0
    (render_glx.cpp:421)."""
    col = (x + 1.0) * 0.5 * width
    row = (1.0 - y) * 0.5 * height
    return col, row


def pixel_to_ndc(col, row, width, height):
    """Continuous pixel (col, row) -> NDC (x, y) (util.cpp:185-188)."""
    x = (col - width / 2.0) * (2.0 / width)
    y = (height / 2.0 - row) * (2.0 / height)
    return x, y


def pixel_grid_ndc(width, height, dtype=torch.float32, device="cuda"):
    """NDC (x, y) of every integer pixel index as two (H, W) tensors on
    ``device``: ``x = (col - W/2) * 2/W``, ``y = (H/2 - row) * 2/H``
    (util.cpp:180-188)."""
    device = resolve_device(device)
    cols = torch.arange(width, dtype=dtype, device=device)
    rows = torch.arange(height, dtype=dtype, device=device)
    x = (cols - width / 2.0) * (2.0 / width)
    y = (height / 2.0 - rows) * (2.0 / height)
    return (x[None, :].expand(height, width),
            y[:, None].expand(height, width))


def homogenize(points3, w=1.0):
    """(..., 3) -> (..., 4) with the given w."""
    ones = torch.full(points3.shape[:-1] + (1,), w, dtype=points3.dtype,
                      device=points3.device)
    return torch.cat([points3, ones], dim=-1)
