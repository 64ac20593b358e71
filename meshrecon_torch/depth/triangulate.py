"""Per-pixel depth triangulation by Gauss-Newton on z.

Port of meshrecon/depth/triangulate.py (both sampling modes). Every dense
intermediate is a plane, (B, K, H, W) or (B, H, W); the batch is a leading
dimension where the JAX package vmaps.

The Gauss-Newton loop keeps the reference's global exit: an item stops
once at most ``_GN_TAIL`` of its pixels are still active after at least
``_GN_MIN_SWEEPS`` sweeps, or after ``gn_iters`` sweeps, and the batch
sweeps while any item has not stopped (the vmapped ``while_loop``'s
semantics). Each sweep tests that condition on the host: one device sync
per sweep, counted in the output's ``gn_sweeps``.
"""

from __future__ import annotations

import torch

from meshrecon_torch import BACKGROUND_DEPTH
from meshrecon_torch.flow.pyramid import pad_reflect

_GN_TAIL = 64
_GN_MIN_SWEEPS = 6


def sobel_gradient(image):
    """Unnormalized 3x3 Sobel (gx, gy) over the last two axes, reflect-101
    borders (util.cpp:465-479)."""
    h, w = image.shape[-2:]
    p = pad_reflect(pad_reflect(image, 1, image.dim() - 2), 1, image.dim() - 1)

    def sl(dr, dc):
        return p[..., 1 + dr:1 + dr + h, 1 + dc:1 + dc + w]

    gx = ((sl(-1, 1) - sl(-1, -1)) + 2.0 * (sl(0, 1) - sl(0, -1))
          + (sl(1, 1) - sl(1, -1)))
    gy = ((sl(1, -1) - sl(-1, -1)) + 2.0 * (sl(1, 0) - sl(-1, 0))
          + (sl(1, 1) - sl(-1, 1)))
    return gx, gy


def _bilinear_plane(plane, col, row, height: int, plane_row0: int = 0):
    """Bilinear sample of (B, h, W) planes at (B, K, hb, W) positions; also
    returns the 4 corner values and whether the cell is inside. The planes
    hold rows [plane_row0, plane_row0 + h) of an image of ``height`` rows,
    ``row`` is a row of that image, and the taps must lie in the rows
    held."""
    w = plane.shape[-1]
    h = plane.shape[-2]
    c0 = torch.floor(col).nan_to_num(0.0).to(torch.int64)
    r0 = torch.floor(row).nan_to_num(0.0).to(torch.int64)
    inside = (c0 >= 1) & (c0 < w - 1) & (r0 >= 1) & (r0 < height - 1)
    c0c = c0.clamp(0, w - 2)
    r0c = r0.clamp(0, height - 2)
    rl = r0c - plane_row0 if plane_row0 else r0c
    flat = plane.reshape(plane.shape[0], 1, h * w).expand(
        col.shape[0], col.shape[1], h * w)

    def at(r, c):
        idx = (r * w + c).reshape(col.shape[0], col.shape[1], -1)
        return torch.gather(flat, -1, idx).reshape(col.shape)

    v00 = at(rl, c0c)
    v01 = at(rl, c0c + 1)
    v10 = at(rl + 1, c0c)
    v11 = at(rl + 1, c0c + 1)
    fc = col - c0c
    fr = row - r0c
    val = (v00 * (1 - fr) * (1 - fc) + v01 * (1 - fr) * fc
           + v10 * fr * (1 - fc) + v11 * fr * fc)
    return val, (v00, v01, v10, v11), inside


class GaussNewtonBand:
    """The triangulation of rows [row0, row0 + hb) of B main frames of
    ``height`` rows (the whole frame by default): the fields the
    Gauss-Newton sweeps read, :meth:`step`, one sweep, and :meth:`result`.

    flx, fly, var_in: (B, K, hb, W); depth: (B, hd, W), rows [depth_row0,
    depth_row0 + hd) of the depth map, which hold the band's rows and one
    more each side where the image goes on (the Sobel gradients), and with
    exact sampling every row its taps read: ``ceil(max |fly|) + 2`` rows
    each side (a band of a tile group, ``sharding/tiles.py``).
    """

    def __init__(self, flx, fly, var_in, main_cams, side_cams, side_valid,
                 depth, sampling: str = "exact", *, row0: int = 0,
                 height=None, depth_row0: int = 0):
        flx, fly, var_in = (t.to(torch.float32) for t in (flx, fly, var_in))
        main_cams = main_cams.to(torch.float32)
        side_cams = side_cams.to(torch.float32)
        depth_win = depth.to(torch.float32)
        side_valid = side_valid.to(torch.bool)
        hb, w = flx.shape[-2:]
        h = depth_win.shape[-2] if height is None else height
        dev = depth_win.device
        own = slice(row0 - depth_row0, row0 - depth_row0 + hb)
        depth = depth_win[:, own]

        main_inv = torch.linalg.inv(main_cams)
        cm = side_cams @ main_inv[:, None]  # (B, K, 4, 4)

        def cmc(i, j):
            return cm[:, :, i, j, None, None]

        cols = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
        rows = torch.arange(row0, row0 + hb, dtype=torch.float32,
                            device=dev)[:, None]
        sx, sy = 2.0 / w, 2.0 / h
        x = (cols - w / 2.0) * sx * torch.ones((hb, 1), dtype=torch.float32,
                                               device=dev)
        y = (h / 2.0 - rows) * sy * torch.ones((1, w), dtype=torch.float32,
                                               device=dev)
        center_valid = depth != BACKGROUND_DEPTH

        gx_win, gy_win = sobel_gradient(depth_win)
        gx, gy = gx_win[:, own], gy_win[:, own]
        variance = var_in.clamp(min=1e-2)
        dep = depth[:, None]

        if sampling == "exact":
            fcol = cols + flx
            frow = rows + fly
            zs, (z00, z01, z10, z11), inside = _bilinear_plane(
                depth_win, fcol, frow, h, depth_row0)
            good = (inside & (z00 != BACKGROUND_DEPTH)
                    & (z01 != BACKGROUND_DEPTH) & (z10 != BACKGROUND_DEPTH)
                    & (z11 != BACKGROUND_DEPTH))
            zk = torch.where(good, zs, dep)
            gxs, _, _ = _bilinear_plane(gx_win, fcol, frow, h, depth_row0)
            gys, _, _ = _bilinear_plane(gy_win, fcol, frow, h, depth_row0)
            g1 = torch.where(good, gxs, gx[:, None])
            g2 = torch.where(good, gys, gy[:, None])
        elif sampling == "taylor":
            # Sobel is 8x the central-difference derivative per pixel step
            zk = dep + (gx[:, None] * flx + gy[:, None] * fly) / 8.0
            zk = zk.clamp(-1.0, 1.0)
            fcol = cols + flx
            frow = rows + fly
            good = ((fcol >= 1) & (fcol < w - 1) & (frow >= 1)
                    & (frow < h - 1) & center_valid[:, None])
            zk = torch.where(good, zk, dep)
            g1 = gx[:, None].expand(zk.shape)
            g2 = gy[:, None].expand(zk.shape)
        else:
            raise ValueError(f"unknown sampling mode {sampling}")

        mx_in = x + flx * sx
        my_in = y + fly * sy

        def apply_cm(row):
            return (cmc(row, 0) * mx_in + cmc(row, 1) * my_in
                    + cmc(row, 2) * zk + cmc(row, 3))

        m0, m1, m2, m3 = apply_cm(0), apply_cm(1), apply_cm(2), apply_cm(3)
        mw_safe = torch.where(m3.abs() < 1e-12, 1e-12, m3)
        sx_meas = m0 / mw_safe
        sy_meas = m1 / mw_safe
        mz_ndc = m2 / mw_safe
        sv = side_valid[:, :, None, None]
        ok_pixel = center_valid & torch.where(sv, mz_ndc >= -1.0,
                                              True).all(dim=1)

        a11 = (cmc(0, 0) + cmc(0, 2) * g1) / mw_safe
        a12 = (cmc(0, 1) + cmc(0, 2) * g2) / mw_safe
        a21 = (cmc(1, 0) + cmc(1, 2) * g1) / mw_safe
        a22 = (cmc(1, 1) + cmc(1, 2) * g2) / mw_safe
        s11 = a11 * a11 + a12 * a12
        s12 = a11 * a21 + a12 * a22
        s22 = a21 * a21 + a22 * a22
        det_s = s11 * s22 - s12 * s12
        det_s = torch.where(det_s.abs() < 1e-20, 1e-20, det_s)
        ic11 = s22 / (det_s * variance)
        ic12 = -s12 / (det_s * variance)
        ic22 = s11 / (det_s * variance)
        vmask = sv.to(torch.float32)
        self.ic = (ic11 * vmask, ic12 * vmask, ic22 * vmask)

        # --- Gauss-Newton on z: projections are affine in z ---
        self.n0x = cmc(0, 0) * x + cmc(0, 1) * y + cmc(0, 3)
        self.n0y = cmc(1, 0) * x + cmc(1, 1) * y + cmc(1, 3)
        self.w0 = cmc(3, 0) * x + cmc(3, 1) * y + cmc(3, 3)
        self.nz = (cmc(0, 2), cmc(1, 2), cmc(3, 2))
        self.meas = (sx_meas, sy_meas)
        self.sv, self.main_inv, self.x, self.y = sv, main_inv, x, y
        # the vmapped while_loop: only valid pixels iterate
        self.z = depth
        self.active = center_valid & ok_pixel
        self.ok_pixel = ok_pixel

    def residuals(self, z):
        nzx, nzy, wz = self.nz
        wi = self.w0 + wz * z[:, None]
        wi = torch.where(wi.abs() < 1e-12, 1e-12, wi)
        inv_wi = 1.0 / wi
        rx = (self.n0x + nzx * z[:, None]) * inv_wi - self.meas[0]
        ry = (self.n0y + nzy * z[:, None]) * inv_wi - self.meas[1]
        return rx, ry, inv_wi

    def step(self, z, active):
        """One Gauss-Newton sweep: (z, active) after it."""
        ic11, ic12, ic22 = self.ic
        pdx, pdy = self.nz[:2]  # frozen Jacobian numerators (util.cpp:86)
        rx, ry, inv_wi = self.residuals(z)
        dpx = pdx * inv_wi
        dpy = pdy * inv_wi
        tx = ic11 * dpx + ic12 * dpy
        ty = ic12 * dpx + ic22 * dpy
        first = (rx * tx + ry * ty).sum(dim=1)
        second = (dpx * tx + dpy * ty).sum(dim=1)
        second = torch.where(second.abs() < 1e-30, 1e-30, second)
        dz = -first / second
        step = torch.where(active, dz, 0.0)
        active = active & (dz.abs() >= 1e-7)
        return z + step, active

    def result(self, sweeps: int) -> dict:
        """dict(point4, pdf, valid, gn_sweeps) at the band's final z."""
        ic11, ic12, ic22 = self.ic
        z_final, sv, x, y = self.z, self.sv, self.x, self.y
        ok_pixel = self.ok_pixel & (z_final >= -1.0) & (z_final <= 1.0)
        rx, ry, _ = self.residuals(z_final)
        quad = rx * (ic11 * rx + ic12 * ry) + ry * (ic12 * rx + ic22 * ry)
        exponent = -quad.sum(dim=1)
        det_ic = ic11 * ic22 - ic12 * ic12
        det_ic = torch.where(sv, det_ic.clamp(min=1e-30), 1.0)
        dev = z_final.device
        log_pdf = (torch.log(torch.tensor(0.159, dtype=torch.float32,
                                          device=dev))
                   + torch.log(det_ic).sum(dim=1) + 0.5 * exponent)
        pdf = torch.exp(log_pdf.clamp(-30.0, 30.0))

        def apply_minv(row):
            mi = self.main_inv[:, row, :, None, None]
            return mi[:, 0] * x + mi[:, 1] * y + mi[:, 2] * z_final + mi[:, 3]

        point4 = torch.stack([apply_minv(r) for r in range(4)], dim=-1)
        return {"point4": point4, "pdf": pdf, "valid": ok_pixel,
                "gn_sweeps": sweeps}


def gauss_newton(bands: list, gn_iters: int = 50) -> int:
    """Sweep the bands of one batch of main frames (one band: the whole
    frame) to the reference's global exit and return the sweep count;
    each band's ``z`` and ``active`` are left at their final values.

    An item stops once at most ``_GN_TAIL`` of its pixels are still active
    after ``_GN_MIN_SWEEPS`` sweeps, or after ``gn_iters``: its active
    pixels are counted over the whole frame, the bands' counts summed on
    the first band's device in band order (exact integers), so every band
    of an item takes the same sweeps. One host sync a sweep."""
    first = bands[0].z
    it = torch.zeros(first.shape[0], dtype=torch.int64, device=first.device)
    sweeps = 0
    while True:
        n_active = bands[0].active.sum(dim=(1, 2))
        for band in bands[1:]:
            n_active = n_active + band.active.sum(dim=(1, 2)).to(first.device)
        tail = torch.where(it < _GN_MIN_SWEEPS, 0, _GN_TAIL)
        cond = (n_active > tail) & (it < gn_iters)
        if not bool(cond.any()):  # host sync
            break
        for band in bands:
            z_new, active_new = band.step(band.z, band.active)
            c = cond.to(band.z.device)[:, None, None]
            band.z = torch.where(c, z_new, band.z)
            band.active = torch.where(c, active_new, band.active)
        it = it + cond.to(torch.int64)
        sweeps += 1
    return sweeps


def triangulate_pixels_batched(flx, fly, var_in, main_cams, side_cams,
                               side_valid, depth, gn_iters: int = 50,
                               sampling: str = "exact"):
    """Triangulate every valid pixel of B main frames against K side flows.

    flx, fly, var_in: (B, K, H, W) flow and variance planes; main_cams
    (B, 4, 4); side_cams (B, K, 4, 4); side_valid (B, K) bool; depth
    (B, H, W) NDC depth with background 1.0.
    Returns dict(point4 (B, H, W, 4), pdf (B, H, W), valid (B, H, W) bool,
    gn_sweeps int).
    """
    band = GaussNewtonBand(flx, fly, var_in, main_cams, side_cams,
                           side_valid, depth, sampling)
    return band.result(gauss_newton([band], gn_iters))


def triangulate_pixels(flows, main_camera, side_cameras, side_valid, depth,
                       gn_iters: int = 50, sampling: str = "exact"):
    """Single-camera form with the JAX package's signature: flows is
    (K, H, W, >=3) or a tuple of three (K, H, W) planes (fx, fy, variance);
    main_camera (4, 4); side_cameras (K, 4, 4); side_valid (K,); depth
    (H, W). Returns dict(point4 (H, W, 4), pdf (H, W), valid (H, W))."""
    if isinstance(flows, (tuple, list)):
        flx, fly, var = flows
    else:
        flx, fly, var = flows[..., 0], flows[..., 1], flows[..., 2]
    out = triangulate_pixels_batched(
        flx[None], fly[None], var[None], main_camera[None], side_cameras[None],
        side_valid[None], depth[None], gn_iters=gn_iters, sampling=sampling)
    return {k: out[k][0] for k in ("point4", "pdf", "valid")}
