"""Triangle setup and the plain z-buffer depth render.

Port of meshrecon/raster/rasterizer.py. Depth maps hold NDC z in [-1, 1]
with background pixels = 1.0; the sample position of pixel (row, col) is
``x = (col - W/2) * 2/W``, ``y = (H/2 - row) * 2/H``.

:func:`render_depth` is the plain version of the binned raster kernel (K1,
``raster/binned.py``). Both test coverage with the same affine edge
coefficients (:func:`edge_affine_planes`) in the same operation order, so
they agree bit for bit. :func:`depth_probe`, the camera policy's sparse
occlusion probe, evaluates the same coefficients at its sample points;
:class:`Renderer` holds the pipeline's mesh.
"""

from __future__ import annotations

import torch

from meshrecon_torch.pipeline.config import resolve_device

_W_EPS = 1e-6  # near clip: keep fragments with clip w >= _W_EPS

# Shared-edge tie slop in NDC units, baked into the affine C coefficients
# (see meshrecon/raster/rasterizer.py:105-121 for the derivation).
EDGE_TIE_SLOP = 6.25e-5

# Plain render: records (two per triangle) evaluated per pass.
_CHUNK = 64


def _edge(ax, ay, bx, by, px, py):
    """Signed area*2 of triangle (a, b, p); broadcasts over p."""
    return (bx - ax) * (py - ay) - (by - ay) * (px - ax)


def clip_triangles_near(tri_clip):
    """Clip (T, 3, 4) clip-space triangles against the plane w = _W_EPS:
    (T, 2, 3, 4) triangles and a (T, 2) validity mask, at most two
    triangles for each input (the quad left when one vertex is behind).

    The JAX package's case order (rasterizer.py:44-101): with one vertex
    inside, that vertex first and slot 2 a copy of slot 1; with two, the
    outside vertex last and both slots valid; with three, the triangle
    twice, slot 2 invalid; with none, zeros."""
    v = tri_clip
    inside = v[..., 3] >= _W_EPS                       # (T, 3)
    n_in = inside.sum(dim=-1)
    first_in = torch.argmax(inside.to(torch.int8), dim=-1)
    first_out = torch.argmax((~inside).to(torch.int8), dim=-1)
    k = torch.where(n_in == 1, first_in,
                    torch.where(n_in == 2, (first_out + 1) % 3, 0))
    idx = (k[:, None] + torch.arange(3, device=v.device)) % 3
    a, b, c = (torch.gather(v, 1, idx[:, j, None, None].expand(-1, 1, 4))[:, 0]
               for j in range(3))

    def isect(p, q):
        t = (_W_EPS - p[:, 3:4]) / (q[:, 3:4] - p[:, 3:4])
        return p + (q - p) * t

    one = (n_in == 1)[:, None, None]
    two = (n_in == 2)[:, None, None]
    slot1 = torch.stack([a, isect(a, b), isect(a, c)], dim=1)
    ibc = isect(b, c)
    slot1 = torch.where(two, torch.stack([a, b, ibc], dim=1),
                        torch.where(one, slot1, v))
    slot2 = torch.where(two, torch.stack([a, ibc, isect(a, c)], dim=1),
                        slot1)
    tris = torch.stack([slot1, slot2], dim=1)
    tris = torch.where((n_in == 0)[:, None, None, None], 0.0, tris)
    return tris, torch.stack([n_in >= 1, n_in == 2], dim=-1)


def clip_project_planes(camera, soup, soup_valid):
    """World soup -> near-clipped, perspective-divided screen triangles as
    flat per-component planes.

    camera: (..., 4, 4); soup: (T, 3, 3); soup_valid: (T,) bool.
    Returns (x0, x1, x2, y0, y1, y2, z0, z1, z2, area, ok), each (..., 2T),
    slot-interleaved: a triangle that straddles the near plane becomes two
    adjacent records, the second one invalid unless it was needed.
    """
    camera = camera.to(torch.float32)
    soup = soup.to(torch.float32)

    # fixed association, never a matmul: a different accumulation order
    # perturbs vertices by ~1e-5 and can flip an edge test at a silhouette
    def clip_comp(row, v):
        p = soup[:, v, :]
        c = camera[..., row, :, None]  # (..., 4, 1)
        return (p[:, 0] * c[..., 0, :] + p[:, 1] * c[..., 1, :]
                + p[:, 2] * c[..., 2, :] + c[..., 3, :])

    cx = [clip_comp(0, v) for v in range(3)]
    cy = [clip_comp(1, v) for v in range(3)]
    cz = [clip_comp(2, v) for v in range(3)]
    cw = [clip_comp(3, v) for v in range(3)]

    ins = [w >= _W_EPS for w in cw]
    n_in = ins[0].to(torch.int32) + ins[1].to(torch.int32) + ins[2].to(
        torch.int32)
    # canonical rotation: n_in == 1 puts the inside vertex first; n_in == 2
    # puts the outside vertex last
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
        t = (_W_EPS - p[3]) / (q[3] - p[3])
        return [p[i] + (q[i] - p[i]) * t for i in range(4)]

    iAB = isect(A, B)
    iAC = isect(A, C)
    iBC = isect(B, C)

    one = n_in == 1
    two = n_in == 2

    def pick(c1, c2, c3):
        return torch.where(one, c1, torch.where(two, c2, c3))

    # slot 1: case1 (A, iAB, iAC); case2 (A, B, iBC); case3 the original
    s1 = [[A[i] for i in range(4)],
          [pick(iAB[i], B[i], B[i]) for i in range(4)],
          [pick(iAC[i], iBC[i], C[i]) for i in range(4)]]
    # slot 2: only case2 (A, iBC, iAC)
    s2 = [[A[i] for i in range(4)],
          [iBC[i] for i in range(4)],
          [iAC[i] for i in range(4)]]
    soup_valid = soup_valid.to(torch.bool)
    valid1 = (n_in >= 1) & soup_valid
    valid2 = two & soup_valid

    def screen(slot, valid):
        xs, ys, zs = [], [], []
        for v in range(3):
            w = slot[v][3]
            safe_w = torch.where(w.abs() < _W_EPS, _W_EPS, w)
            xs.append(slot[v][0] / safe_w)
            ys.append(slot[v][1] / safe_w)
            zs.append(slot[v][2] / safe_w)
        area = _edge(xs[0], ys[0], xs[1], ys[1], xs[2], ys[2])
        ok = valid & (area.abs() > 1e-12)
        return xs, ys, zs, area, ok

    x1s, y1s, z1s, a1, ok1 = screen(s1, valid1)
    x2s, y2s, z2s, a2, ok2 = screen(s2, valid2)

    def inter(p, q):
        return torch.stack([p, q], dim=-1).flatten(-2)

    return (
        inter(x1s[0], x2s[0]), inter(x1s[1], x2s[1]), inter(x1s[2], x2s[2]),
        inter(y1s[0], y2s[0]), inter(y1s[1], y2s[1]), inter(y1s[2], y2s[2]),
        inter(z1s[0], z2s[0]), inter(z1s[1], z2s[1]), inter(z1s[2], z2s[2]),
        inter(a1, a2), inter(ok1, ok2),
    )


def edge_affine_planes(x0, x1, x2, y0, y1, y2, z0, z1, z2, area, ok):
    """Affine barycentric coefficients ``l_i(p) = A_i*px + B_i*py + C_i``
    with the 1/area normalization and the tie slop baked into C_i. Invalid
    triangles get (A0, B0, C0) = (0, 0, -1), so they cover nothing.

    Returns (a0, b0, c0, a1, b1, c1, a2, b2, c2)."""
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
    """Screen bbox of the pixels a triangle can cover: the region where all
    three slop-biased edge functions are >= 0.

    That region is the triangle with each edge pushed out by the tie slop,
    so its corners lie outside the vertices, by slop/sin(angle/2) at a
    sharp one. The bbox of the VERTICES (what meshrecon's binned kernel
    culls with) can therefore miss covered pixels in that fringe; this bbox
    cannot, which keeps binned renders equal to the brute-force one. The
    corners (intersections of pairs of edge lines) are solved in float64
    and padded outward by 1e-5 NDC (relative to the corner's magnitude),
    far above the float32 rounding of the per-pixel edge functions.

    coeffs: the 9 planes of :func:`edge_affine_planes`; ok: validity.
    Returns float32 (xmin, xmax, ymin, ymax); invalid records get an
    inverted box (+big, -big) that overlaps nothing.
    """
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


def pixel_grid(height: int, width: int, device):
    """NDC sample positions: px (W,) and py (H,) float32."""
    cols = (torch.arange(width, dtype=torch.float32, device=device)
            - width / 2.0) * (2.0 / width)
    rows = (height / 2.0 - torch.arange(height, dtype=torch.float32,
                                        device=device)) * (2.0 / height)
    return cols, rows


def _pixel_window(xmin, xmax, ymin, ymax, height, width):
    """Inclusive (r0, r1, c0, c1) pixel window holding every sample point
    inside the NDC box, widened by one pixel against rounding; None when
    the box misses the image."""
    if xmin > xmax or ymin > ymax:
        return None
    c0 = max(int(max(xmin, -4.0) * width / 2.0 + width / 2.0) - 2, 0)
    c1 = min(int(min(xmax, 4.0) * width / 2.0 + width / 2.0) + 2, width - 1)
    r0 = max(int(height / 2.0 - min(ymax, 4.0) * height / 2.0) - 2, 0)
    r1 = min(int(height / 2.0 - max(ymin, -4.0) * height / 2.0) + 2,
             height - 1)
    if c0 > c1 or r0 > r1:
        return None
    return r0, r1, c0, c1


def render_depth(camera, soup, soup_valid, height: int, width: int,
                 rows=None):
    """Full-frame z-buffer depth render; the plain version of K1.

    camera: (4, 4) or (N, 4, 4); soup: (T, 3, 3); soup_valid: (T,) bool.
    Returns (H, W) or (N, H, W) float32 NDC depth, background = 1.0;
    ``rows`` (r0, r1) renders those rows of the frame alone, (r1 - r0, W)
    a camera, each pixel as in the whole render.

    Brute force in the arithmetic (every record's edge functions at every
    pixel it can cover, z-min), restricted per 64-record chunk to the
    pixel window of the chunk's :func:`coverage_bbox`: a pixel outside it is
    covered by none of the chunk's records, so the restriction changes no
    value and spares the CPU most of the work. One host sync per camera
    fetches the windows.
    """
    if camera.dim() == 3:
        return torch.stack([render_depth(c, soup, soup_valid, height, width,
                                         rows) for c in camera])
    row_lo, row_hi = (0, height) if rows is None else rows
    planes = clip_project_planes(camera, soup, soup_valid)
    coeffs = edge_affine_planes(*planes)
    z0, z1, z2, ok = planes[6], planes[7], planes[8], planes[10]
    boxes = coverage_bbox(coeffs, ok)
    n = z0.shape[-1]
    n_chunks = -(-n // _CHUNK)
    pad = n_chunks * _CHUNK - n
    box_lo = torch.stack([boxes[0], boxes[2]])
    box_hi = torch.stack([boxes[1], boxes[3]])
    if pad:
        box_lo = torch.nn.functional.pad(box_lo, (0, pad), value=3e38)
        box_hi = torch.nn.functional.pad(box_hi, (0, pad), value=-3e38)
    lo = box_lo.reshape(2, n_chunks, _CHUNK).amin(-1)
    hi = box_hi.reshape(2, n_chunks, _CHUNK).amax(-1)
    chunk_boxes = torch.stack([lo[0], hi[0], lo[1], hi[1]], 1).cpu().tolist()

    px, py = pixel_grid(height, width, camera.device)
    zbuf = torch.full((row_hi - row_lo, width), float("inf"), dtype=torch.float32,
                      device=camera.device)
    fields = coeffs + (z0, z1, z2)
    for ci, box in enumerate(chunk_boxes):
        win = _pixel_window(*box, height, width)
        if win is None:
            continue
        r0, r1, c0, c1 = win
        r0, r1 = max(r0, row_lo), min(r1, row_hi - 1)
        if r0 > r1:
            continue
        sl = slice(ci * _CHUNK, min((ci + 1) * _CHUNK, n))
        a0, b0, c0_, a1, b1, c1_, a2, b2, c2, zz0, zz1, zz2 = (
            f[sl][:, None, None] for f in fields)
        wx = px[c0:c1 + 1][None, None, :]
        wy = py[r0:r1 + 1][None, :, None]
        l0 = a0 * wx + b0 * wy + c0_
        l1 = a1 * wx + b1 * wy + c1_
        l2 = a2 * wx + b2 * wy + c2
        zs = l0 * zz0 + l1 * zz1 + l2 * zz2
        covered = ((l0 >= 0) & (l1 >= 0) & (l2 >= 0)
                   & (zs >= -1.0) & (zs <= 1.0))
        zc = torch.where(covered, zs, float("inf")).amin(0)
        zbuf[r0 - row_lo:r1 + 1 - row_lo, c0:c1 + 1] = torch.minimum(
            zbuf[r0 - row_lo:r1 + 1 - row_lo, c0:c1 + 1], zc)
    return torch.where(torch.isfinite(zbuf), zbuf, 1.0)


# depth_probe: (sample points x records) elements evaluated per block
_PROBE_BLOCK = 1 << 22


def depth_probe(cameras, soup, soup_valid, sample_xy):
    """Depth at sparse NDC sample points for a batch of viewer cameras.

    cameras: (S, 4, 4); soup: (T, 3, 3); soup_valid: (T,) bool; sample_xy:
    (S, N, 2) NDC positions. Returns (S, N) float32 NDC depth, background
    1.0: the camera policy's occlusion probe (heuristic.cpp:448-456), which
    evaluates only the pixels it reads instead of S full renders.

    One shot at a time (each shot's triangle setup is O(T)), all of its N
    points against blocks of records sized so that a block holds about
    4M (point, record) pairs; the same affine edge coefficients as
    :func:`render_depth`.
    """
    cameras = cameras.to(torch.float32)
    soup = soup.to(torch.float32)
    sample_xy = sample_xy.to(torch.float32)
    out = []
    for camera, xy in zip(cameras, sample_xy):
        planes = clip_project_planes(camera, soup, soup_valid)
        a0, b0, c0, a1, b1, c1, a2, b2, c2 = edge_affine_planes(*planes)
        z0, z1, z2 = planes[6], planes[7], planes[8]
        px, py = xy[None, :, 0], xy[None, :, 1]
        n = z0.shape[0]
        block = max(1, _PROBE_BLOCK // max(1, xy.shape[0]))
        zmin = torch.full((xy.shape[0],), float("inf"), dtype=torch.float32,
                          device=xy.device)
        for s in range(0, n, block):
            sl = slice(s, s + block)

            def lin(a, b, c):
                return a[sl, None] * px + b[sl, None] * py + c[sl, None]

            l0 = lin(a0, b0, c0)
            l1 = lin(a1, b1, c1)
            l2 = lin(a2, b2, c2)
            zs = (l0 * z0[sl, None] + l1 * z1[sl, None]
                  + l2 * z2[sl, None])
            covered = ((l0 >= 0) & (l1 >= 0) & (l2 >= 0)
                       & (zs >= -1.0) & (zs <= 1.0))
            zc = torch.where(covered, zs, float("inf")).amin(0)
            zmin = torch.minimum(zmin, zc)
        out.append(torch.where(torch.isfinite(zmin), zmin, 1.0))
    return torch.stack(out)


class Renderer:
    """Pipeline-facing renderer (the reference's ``Render`` seam,
    recon.hpp:93-100): holds the mesh as a Morton-sorted, capacity-padded
    triangle soup on ``device`` and renders depth through
    ``render_depth_binned`` (K1 on a CUDA device, the plain render on the
    CPU) and projective texturing through K2."""

    def __init__(self, width: int, height: int, device="cuda"):
        self.width = int(width)
        self.height = int(height)
        self.device = resolve_device(device)
        self._soup = None
        self._valid = None

    def load_mesh(self, mesh) -> None:
        """Dehomogenize the mesh's vertices into a soup
        (render_glx.cpp:230-258), sorted and padded by ``state.pack_soup``."""
        from meshrecon_torch.state import pack_soup

        soup, valid = pack_soup(mesh.triangle_soup)
        self._soup = torch.from_numpy(soup).to(self.device)
        self._valid = torch.from_numpy(valid).to(self.device)

    @property
    def soup(self):
        return self._soup

    @property
    def soup_valid(self):
        return self._valid

    def _check_loaded(self):
        if self._soup is None:
            raise RuntimeError("Renderer: load_mesh first")

    def _camera(self, camera):
        return torch.as_tensor(camera, dtype=torch.float32,
                               device=self.device)

    def depth(self, camera) -> torch.Tensor:
        """(H, W) depth of one camera (4, 4)."""
        from meshrecon_torch.raster.binned import render_depth_binned

        self._check_loaded()
        return render_depth_binned(self._camera(camera)[None], self._soup,
                                   self._valid, self.height, self.width)[0]

    def depth_at(self, cameras, sample_xy) -> torch.Tensor:
        """(S, N) depth of S viewer cameras at their (S, N, 2) samples."""
        self._check_loaded()
        return depth_probe(self._camera(cameras), self._soup, self._valid,
                           torch.as_tensor(sample_xy, dtype=torch.float32,
                                           device=self.device))

    def projected(self, camera, frame, projector, depth_main=None,
                  shadow_sample: str = "nearest"):
        """Projective texturing of one side frame into one main view:
        (intensity (H, W), mask (H, W) bool); ``shadow_sample`` is the
        shadow map's sampler (nearest or bilinear)."""
        from meshrecon_torch.raster.fragment import projected_image_batched

        self._check_loaded()
        if depth_main is None:
            depth_main = self.depth(camera)
        depth_side = self.depth(projector)
        inten, mask = projected_image_batched(
            self._camera(camera)[None], depth_main[None],
            frame.to(self.device)[None, None],
            self._camera(projector)[None, None], depth_side[None, None],
            shadow_sample=shadow_sample)
        return inten[0, 0], mask[0, 0]
