"""Plain z-buffer depth renders of a triangle soup.

A frozen copy of the measured program's plain render: the same near-plane
clip, the same affine edge coefficients with the shared-edge tie slop, and
the same per-pixel arithmetic (``l_i = A_i*px + B_i*py + C_i``, the depth
plane, the z-min), so the hand-written raster kernels' renders equal it.
Only the bookkeeping differs: each record is evaluated on a window of the
pixels that its coverage box can reach, records of a like window size in
one batch, and the covered samples are z-minimised by a scatter. A pixel
outside a record's coverage box is covered by none of it, so the windows
change no value.
"""

from __future__ import annotations

import torch

W_EPS = 1e-6  # near clip: keep fragments with clip w >= W_EPS
EDGE_TIE_SLOP = 6.25e-5  # the shared-edge tie slop in NDC units
BACKGROUND_DEPTH = 1.0
_WINDOWS = (4, 8, 16, 32, 64, 128)  # window edges of the record batches
_ELEMENTS = 1 << 24  # (record, pixel) pairs evaluated a batch


def pixel_grid(height: int, width: int, device):
    """NDC sample positions: px (W,) and py (H,) float32."""
    cols = (torch.arange(width, dtype=torch.float32, device=device)
            - width / 2.0) * (2.0 / width)
    rows = (height / 2.0 - torch.arange(height, dtype=torch.float32,
                                        device=device)) * (2.0 / height)
    return cols, rows


def _edge(ax, ay, bx, by, px, py):
    return (bx - ax) * (py - ay) - (by - ay) * (px - ax)


def clip_project_planes(camera, soup, soup_valid):
    """World soup -> near-clipped, perspective-divided screen records, two
    per triangle (the second valid only where the near plane cut a quad):
    (x0, x1, x2, y0, y1, y2, z0, z1, z2, area, ok), each (2T,)."""
    camera = camera.to(torch.float32)
    soup = soup.to(torch.float32)

    def clip_comp(row, v):
        p = soup[:, v, :]
        c = camera[..., row, :, None]
        return (p[:, 0] * c[..., 0, :] + p[:, 1] * c[..., 1, :]
                + p[:, 2] * c[..., 2, :] + c[..., 3, :])

    cx = [clip_comp(0, v) for v in range(3)]
    cy = [clip_comp(1, v) for v in range(3)]
    cz = [clip_comp(2, v) for v in range(3)]
    cw = [clip_comp(3, v) for v in range(3)]
    ins = [w >= W_EPS for w in cw]
    n_in = ins[0].to(torch.int32) + ins[1].to(torch.int32) + ins[2].to(
        torch.int32)
    first_in = torch.where(ins[0], 0, torch.where(ins[1], 1, 2))
    first_out = torch.where(~ins[0], 0, torch.where(~ins[1], 1, 2))
    k = torch.where(n_in == 1, first_in,
                    torch.where(n_in == 2, (first_out + 1) % 3, 0))

    def rot(comps, j):
        idx = (k + j) % 3
        return torch.where(idx == 0, comps[0],
                           torch.where(idx == 1, comps[1], comps[2]))

    A = [rot(c, 0) for c in (cx, cy, cz, cw)]
    B = [rot(c, 1) for c in (cx, cy, cz, cw)]
    C = [rot(c, 2) for c in (cx, cy, cz, cw)]

    def isect(p, q):
        t = (W_EPS - p[3]) / (q[3] - p[3])
        return [p[i] + (q[i] - p[i]) * t for i in range(4)]

    iAB, iAC, iBC = isect(A, B), isect(A, C), isect(B, C)
    one, two = n_in == 1, n_in == 2

    def pick(c1, c2, c3):
        return torch.where(one, c1, torch.where(two, c2, c3))

    s1 = [[A[i] for i in range(4)],
          [pick(iAB[i], B[i], B[i]) for i in range(4)],
          [pick(iAC[i], iBC[i], C[i]) for i in range(4)]]
    s2 = [[A[i] for i in range(4)], [iBC[i] for i in range(4)],
          [iAC[i] for i in range(4)]]
    soup_valid = soup_valid.to(torch.bool)
    valid1 = (n_in >= 1) & soup_valid
    valid2 = two & soup_valid

    def screen(slot, valid):
        xs, ys, zs = [], [], []
        for v in range(3):
            w = slot[v][3]
            safe_w = torch.where(w.abs() < W_EPS, W_EPS, w)
            xs.append(slot[v][0] / safe_w)
            ys.append(slot[v][1] / safe_w)
            zs.append(slot[v][2] / safe_w)
        area = _edge(xs[0], ys[0], xs[1], ys[1], xs[2], ys[2])
        return xs, ys, zs, area, valid & (area.abs() > 1e-12)

    x1s, y1s, z1s, a1, ok1 = screen(s1, valid1)
    x2s, y2s, z2s, a2, ok2 = screen(s2, valid2)

    def inter(p, q):
        return torch.stack([p, q], dim=-1).flatten(-2)

    return (inter(x1s[0], x2s[0]), inter(x1s[1], x2s[1]),
            inter(x1s[2], x2s[2]), inter(y1s[0], y2s[0]),
            inter(y1s[1], y2s[1]), inter(y1s[2], y2s[2]),
            inter(z1s[0], z2s[0]), inter(z1s[1], z2s[1]),
            inter(z1s[2], z2s[2]), inter(a1, a2), inter(ok1, ok2))


def edge_affine_planes(x0, x1, x2, y0, y1, y2, z0, z1, z2, area, ok):
    """(a0, b0, c0, a1, b1, c1, a2, b2, c2): ``l_i = a_i*px + b_i*py +
    c_i`` with 1/area and the tie slop baked in; invalid records get
    (0, 0, -1) for edge 0 and cover nothing."""
    inv_area = torch.where(ok & (area.abs() > 1e-12), 1.0 / area,
                           torch.zeros_like(area))

    def edge_coeffs(ax, ay, bx, by):
        dx = bx - ax
        dy = by - ay
        a = -dy * inv_area
        b = dx * inv_area
        c = (dy * ax - dx * ay) * inv_area
        c = c + EDGE_TIE_SLOP * torch.sqrt(a * a + b * b)
        return a, b, c

    a0, b0, c0 = edge_coeffs(x1, y1, x2, y2)
    a1, b1, c1 = edge_coeffs(x2, y2, x0, y0)
    a2, b2, c2 = edge_coeffs(x0, y0, x1, y1)
    bad = ~ok
    a0 = torch.where(bad, 0.0, a0)
    b0 = torch.where(bad, 0.0, b0)
    c0 = torch.where(bad, -1.0, c0)
    return a0, b0, c0, a1, b1, c1, a2, b2, c2


def coverage_bbox(coeffs, ok):
    """NDC box of the pixels a record can cover (the corners of its
    slop-widened triangle, solved in float64 and padded by 1e-5 of their
    magnitude); invalid records get an inverted box."""
    a0, b0, c0, a1, b1, c1, a2, b2, c2 = (c.to(torch.float64) for c in coeffs)
    lines = ((a0, b0, c0), (a1, b1, c1), (a2, b2, c2))
    xs, ys = [], []
    for i, j in ((1, 2), (2, 0), (0, 1)):
        ai, bi, ci = lines[i]
        aj, bj, cj = lines[j]
        det = ai * bj - aj * bi
        xs.append((bi * cj - bj * ci) / det)
        ys.append((ci * aj - cj * ai) / det)
    x = torch.stack(xs)
    y = torch.stack(ys)
    finite = torch.isfinite(x).all(0) & torch.isfinite(y).all(0)
    big = 3e38

    def padded(v, lo):
        edge = v.amin(0) if lo else v.amax(0)
        pad = 1e-5 * (1.0 + edge.abs())
        edge = edge - pad if lo else edge + pad
        edge = torch.where(finite, edge, -big if lo else big)
        return edge.clamp(-big, big).to(torch.float32)

    xmin, xmax = padded(x, True), padded(x, False)
    ymin, ymax = padded(y, True), padded(y, False)
    inv = torch.full_like(xmin, big)
    return (torch.where(ok, xmin, inv), torch.where(ok, xmax, -inv),
            torch.where(ok, ymin, inv), torch.where(ok, ymax, -inv))


def _pixel_windows(xmin, xmax, ymin, ymax, height: int, width: int):
    """Per record the inclusive pixel window (r0, r1, c0, c1), int64,
    holding every sample inside its box, widened by two pixels; ``keep``
    false where the box misses the image."""
    keep = (xmin <= xmax) & (ymin <= ymax)
    xmin = torch.where(keep, xmin, 0.0).to(torch.float64)
    xmax = torch.where(keep, xmax, 0.0).to(torch.float64)
    ymin = torch.where(keep, ymin, 0.0).to(torch.float64)
    ymax = torch.where(keep, ymax, 0.0).to(torch.float64)
    c0 = (torch.trunc(xmin.clamp(min=-4.0) * width / 2.0 + width / 2.0)
          .to(torch.int64) - 2).clamp(min=0)
    c1 = (torch.trunc(xmax.clamp(max=4.0) * width / 2.0 + width / 2.0)
          .to(torch.int64) + 2).clamp(max=width - 1)
    r0 = (torch.trunc(height / 2.0 - ymax.clamp(max=4.0) * height / 2.0)
          .to(torch.int64) - 2).clamp(min=0)
    r1 = (torch.trunc(height / 2.0 - ymin.clamp(min=-4.0) * height / 2.0)
          .to(torch.int64) + 2).clamp(max=height - 1)
    keep = keep & (c0 <= c1) & (r0 <= r1)
    return r0, r1, c0, c1, keep


def render_depth(cameras, soup, soup_valid, height: int, width: int):
    """(N, H, W) float32 NDC depth of N cameras (N, 4, 4) over a soup
    (T, 3, 3) with validity (T,); background 1.0."""
    dev = cameras.device
    px, py = pixel_grid(height, width, dev)
    out = []
    for camera in cameras:
        planes = clip_project_planes(camera, soup, soup_valid)
        coeffs = edge_affine_planes(*planes)
        ok = planes[10]
        r0, r1, c0, c1, keep = _pixel_windows(*coverage_bbox(coeffs, ok),
                                              height, width)
        fields = torch.stack(list(coeffs) + [planes[6], planes[7],
                                             planes[8]])  # (12, 2T)
        zbuf = torch.full((height * width,), float("inf"),
                          dtype=torch.float32, device=dev)
        span = torch.maximum(r1 - r0, c1 - c0) + 1
        lo = 0
        for edge in _WINDOWS + (max(height, width),):
            sel = keep & (span > lo) & (span <= edge)
            lo = edge
            idx = torch.nonzero(sel).flatten()
            if idx.numel() == 0:
                continue
            step = max(1, _ELEMENTS // (edge * edge))
            off = torch.arange(edge, device=dev)
            for s in range(0, idx.numel(), step):
                part = idx[s:s + step]
                rows = r0[part, None] + off  # (M, E)
                cols = c0[part, None] + off
                in_r = rows <= r1[part, None]
                in_c = cols <= c1[part, None]
                rows = rows.clamp(max=height - 1)
                cols = cols.clamp(max=width - 1)
                wy = py[rows][:, :, None]  # (M, E, 1)
                wx = px[cols][:, None, :]  # (M, 1, E)
                a0, b0, cc0, a1, b1, cc1, a2, b2, cc2, zz0, zz1, zz2 = (
                    f[part][:, None, None] for f in fields)
                l0 = a0 * wx + b0 * wy + cc0
                l1 = a1 * wx + b1 * wy + cc1
                l2 = a2 * wx + b2 * wy + cc2
                zs = l0 * zz0 + l1 * zz1 + l2 * zz2
                covered = ((l0 >= 0) & (l1 >= 0) & (l2 >= 0)
                           & (zs >= -1.0) & (zs <= 1.0)
                           & in_r[:, :, None] & in_c[:, None, :])
                flat = (rows[:, :, None] * width + cols[:, None, :])
                zbuf.scatter_reduce_(0, flat[covered], zs[covered], "amin")
        zbuf = zbuf.reshape(height, width)
        out.append(torch.where(torch.isfinite(zbuf), zbuf, BACKGROUND_DEPTH))
    return torch.stack(out)
