"""A slow, obviously correct NumPy rasterizer for checks (port of
meshrecon/raster/reference.py).

A per-pixel point-in-triangle loop in float64 that shares no code with the
production render (``rasterizer.render_depth`` and K1), so each checks the
other; only the shared-edge tie slop is the production paths' own.
"""

from __future__ import annotations

import numpy as np

from meshrecon_torch.raster.rasterizer import EDGE_TIE_SLOP

_EPS = 1e-6


def _clip_poly_near(poly):
    """Sutherland-Hodgman clip of a clip-space polygon against w >= eps."""
    out = []
    n = len(poly)
    for i in range(n):
        a, b = poly[i], poly[(i + 1) % n]
        ain, bin_ = a[3] >= _EPS, b[3] >= _EPS
        if ain:
            out.append(a)
        if ain != bin_:
            t = (_EPS - a[3]) / (b[3] - a[3])
            out.append(a + (b - a) * t)
    return out


def render_depth_reference(camera, triangles, height, width):
    """triangles: (T, 3, 3) world-space. Returns (H, W) float32 NDC depth,
    background 1.0."""
    camera = np.asarray(camera, dtype=np.float64)
    zbuf = np.full((height, width), np.inf)
    for tri in np.asarray(triangles, dtype=np.float64):
        clip = (camera[:, :3] @ tri.T).T + camera[:, 3]
        poly = _clip_poly_near(list(clip))
        if len(poly) < 3:
            continue
        for k in range(1, len(poly) - 1):
            _raster_tri(zbuf, [poly[0], poly[k], poly[k + 1]], height, width)
    zbuf[~np.isfinite(zbuf)] = 1.0
    return zbuf.astype(np.float32)


def _raster_tri(zbuf, verts, height, width):
    ndc = np.array([v[:3] / v[3] for v in verts])
    x, y, z = ndc[:, 0], ndc[:, 1], ndc[:, 2]
    area = (x[1] - x[0]) * (y[2] - y[0]) - (y[1] - y[0]) * (x[2] - x[0])
    if abs(area) < 1e-12:
        return
    # pixel (row, col) samples NDC ((col - W/2) 2/W, (H/2 - row) 2/H)
    cols = ((np.array([x.min(), x.max()]) / (2.0 / width)) + width / 2.0)
    rows = (height / 2.0 - (np.array([y.max(), y.min()]) / (2.0 / height)))
    c0 = int(max(0, np.floor(cols[0])))
    c1 = int(min(width - 1, np.ceil(cols[1])))
    r0 = int(max(0, np.floor(rows[0])))
    r1 = int(min(height - 1, np.ceil(rows[1])))
    for r in range(r0, r1 + 1):
        py = (height / 2.0 - r) * (2.0 / height)
        for c in range(c0, c1 + 1):
            px = (c - width / 2.0) * (2.0 / width)
            l0 = ((x[2] - x[1]) * (py - y[1])
                  - (y[2] - y[1]) * (px - x[1])) / area
            l1 = ((x[0] - x[2]) * (py - y[2])
                  - (y[0] - y[2]) * (px - x[2])) / area
            l2 = 1.0 - l0 - l1
            # the shared-edge tie slop of the production paths, so that a
            # sample exactly on a shared edge is not holed on both sides
            s0 = EDGE_TIE_SLOP * np.hypot(x[2] - x[1], y[2] - y[1]) / abs(area)
            s1 = EDGE_TIE_SLOP * np.hypot(x[0] - x[2], y[0] - y[2]) / abs(area)
            s2 = EDGE_TIE_SLOP * np.hypot(x[1] - x[0], y[1] - y[0]) / abs(area)
            if l0 < -s0 or l1 < -s1 or l2 < -s2:
                continue
            zp = l0 * z[0] + l1 * z[1] + l2 * z[2]
            if -1.0 <= zp <= 1.0 and zp < zbuf[r, c]:
                zbuf[r, c] = zp
