"""Standalone raster driver, the TEST_BUILD main of render_glx.cpp:399-433;
port of meshrecon/raster/driver.py.

    python -m meshrecon_torch.raster.driver [--device cuda|cpu]

Renders the reference's golden scene (a 25-vertex / 27-face mesh and two
cameras exported from test_glx.blend, render_glx.cpp:407-410) at 640x480:
writes test/out-depth.png (the depth, normalized) and
test/out-projected.png (a procedural grid texture projected from the side
camera, with the mesh's vertices overlaid, colored by NDC depth), and
prints the depth's min and max.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from meshrecon_torch.io.images import save_image
from meshrecon_torch.io.obj import Mesh
from meshrecon_torch.raster.rasterizer import Renderer

WIDTH, HEIGHT = 640, 480

GLX_POINTS = np.array([
    0.5127, -3.9222, -29.4300, 1.0, 0.6195, -0.2643, -27.4378, 1.0,
    4.5767, 0.2684, -28.6282, 1.0, 4.4699, -3.3895, -30.6204, 1.0,
    1.8125, -5.8448, -25.9695, 1.0, 1.9193, -2.1869, -23.9774, 1.0,
    5.8765, -1.6541, -25.1678, 1.0, -3.7263, 1.9956, -20.7352, 1.0,
    -5.1135, -5.5956, -28.2388, 1.0, -5.0067, -1.9377, -26.2467, 1.0,
    -1.0495, -1.4050, -27.4371, 1.0, -1.1563, -5.0629, -29.4292, 1.0,
    -3.8137, -7.5182, -24.7784, 1.0, 0.2503, -3.3276, -23.9766, 1.0,
    0.1435, -6.9855, -25.9688, 1.0, -4.5209, -0.3826, -22.9609, 1.0,
    -4.4455, 2.1991, -21.5549, 1.0, -1.6526, 2.5750, -22.3950, 1.0,
    -1.7281, -0.0066, -23.8010, 1.0, -3.6036, -1.7395, -20.5186, 1.0,
    -3.5282, 0.8422, -19.1126, 1.0, -0.7353, 1.2181, -19.9528, 1.0,
    -0.8107, -1.3635, -21.3588, 1.0, -3.3029, 1.3693, -19.6080, 1.0,
    -2.0139, 1.5429, -19.9957, 1.0,
], dtype=np.float32).reshape(25, 4)
GLX_FACES = np.array([
    4, 5, 1, 5, 6, 1, 0, 1, 2, 13, 14, 11, 14, 12, 8, 8, 9, 10,
    19, 20, 16, 20, 21, 16, 21, 22, 17, 22, 19, 18, 15, 16, 17,
    22, 21, 20, 0, 4, 1, 21, 17, 16, 13, 10, 9, 3, 0, 2, 8, 12, 9,
    22, 18, 17, 10, 13, 11, 11, 14, 8, 11, 8, 10, 15, 19, 16,
    23, 24, 7, 6, 2, 1, 18, 15, 17, 19, 22, 20, 19, 15, 18,
], dtype=np.int32).reshape(27, 3)
GLX_MVP = np.array([
    -1.195982575416565, 1.350219488143921, 1.237614393234253, 30.956573486328125,
    -0.1888779103755951, -2.055802583694458, 2.06032657623291, 47.59274673461914,
    -1.0203083753585815, -0.42725738883018494, -0.519854724407196, 2.6755423545837402,
    -0.834797739982605, -0.3495742380619049, -0.42533570528030396, 7.643625259399414,
], dtype=np.float32).reshape(4, 4)
GLX_SIDE_MVP = np.array([
    -1.831691861152649, -1.1502554416656494, -0.3270684480667114, -11.764444351196289,
    1.391772985458374, -2.4397428035736084, 0.7858548760414124, 19.515047073364258,
    0.3260231614112854, -0.188545361161232, -1.1627495288848877, -21.932016372680664,
    0.2667462229728699, -0.1542643904685974, -0.9513405561447144, -12.489831924438477,
], dtype=np.float32).reshape(4, 4)


def golden_soup() -> np.ndarray:
    """The golden mesh as a (27, 3, 3) float32 world-space soup."""
    v3 = GLX_POINTS[:, :3] / GLX_POINTS[:, 3:4]
    return v3[GLX_FACES]


def render(device="cuda"):
    """(depth (H, W), projected frame (H, W, 3) float32 numpy) of the
    golden scene on ``device``."""
    r = Renderer(WIDTH, HEIGHT, device=device)
    r.load_mesh(Mesh(GLX_POINTS, GLX_FACES))
    # procedural grid texture (the reference reads test/grid.png)
    yy, xx = np.mgrid[0:HEIGHT, 0:WIDTH]
    tex = (((xx // 40) + (yy // 40)) % 2 * 155 + 50).astype(np.float32)
    depth = r.depth(GLX_MVP)
    inten, mask = r.projected(GLX_MVP, torch.from_numpy(tex), GLX_SIDE_MVP)
    inten = inten.cpu().numpy()
    frame = np.stack([np.zeros_like(inten),
                      mask.cpu().numpy() * 255.0, inten], axis=-1)

    pts = GLX_POINTS[:, :3] / GLX_POINTS[:, 3:4]
    clip = (GLX_MVP[:, :3] @ pts.T).T + GLX_MVP[:, 3]
    ndc = clip[:, :3] / clip[:, 3:4]
    for x, y, z in ndc:
        c = int(WIDTH * (0.5 + x * 0.5))
        rr = int(HEIGHT * (0.5 - y * 0.5))
        if 0 <= rr < HEIGHT and 0 <= c < WIDTH:
            color = ([128 * (1 - z), 128 * (z + 1), 0] if -1 <= z <= 1
                     else [0, 0, 255])
            frame[max(0, rr - 3):rr + 3, max(0, c - 3):c + 3] = color
    return depth, frame


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m meshrecon_torch.raster.driver",
        description="Render the golden raster scene to test/*.png")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    os.makedirs("test", exist_ok=True)
    depth, frame = render(args.device)
    depth = depth.cpu().numpy()
    save_image(frame, "test/out-projected.png")
    save_image(depth, "test/out-depth.png", normalize=True)
    print(f"Depth min: {depth.min():g}, max: {depth.max():g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
