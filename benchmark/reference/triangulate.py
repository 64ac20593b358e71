"""Plain per-pixel depth triangulation by Gauss-Newton on z (a frozen copy
of the program's plain path, the first-order "taylor" sampling of the
side depth): every pixel's reprojection residuals in the K sides,
weighted by the inverse measurement covariance, minimised over its NDC
depth with the reference's global exit (a main frame stops once at most
64 of its pixels are still moving, after at least 6 sweeps, or after
``gn_iters``)."""

from __future__ import annotations

import torch

from benchmark.reference.flow import pad_reflect
from benchmark.reference.raster import BACKGROUND_DEPTH

GN_TAIL = 64
GN_MIN_SWEEPS = 6


def sobel_gradient(image):
    h, w = image.shape[-2:]
    p = pad_reflect(pad_reflect(image, 1, image.dim() - 2), 1,
                    image.dim() - 1)

    def sl(dr, dc):
        return p[..., 1 + dr:1 + dr + h, 1 + dc:1 + dc + w]

    gx = ((sl(-1, 1) - sl(-1, -1)) + 2.0 * (sl(0, 1) - sl(0, -1))
          + (sl(1, 1) - sl(1, -1)))
    gy = ((sl(1, -1) - sl(-1, -1)) + 2.0 * (sl(1, 0) - sl(-1, 0))
          + (sl(1, 1) - sl(-1, 1)))
    return gx, gy


def triangulate(arith, flx, fly, var_in, main_cams, side_cams, side_valid,
                depth, sampling: str = "taylor", gn_iters: int = 50):
    """flx, fly, var_in (B, K, H, W); main_cams (B, 4, 4); side_cams
    (B, K, 4, 4); side_valid (B, K); depth (B, H, W). Returns dict(point4
    (B, H, W, 4), pdf (B, H, W), valid (B, H, W), gn_sweeps)."""
    if sampling != "taylor":
        raise ValueError(f"the reference has the taylor sampling only: "
                         f"{sampling!r}")
    flx, fly, var_in = (t.to(torch.float32) for t in (flx, fly, var_in))
    main_cams = main_cams.to(torch.float32)
    side_cams = side_cams.to(torch.float32)
    depth = depth.to(torch.float32)
    side_valid = side_valid.to(torch.bool)
    h, w = flx.shape[-2:]
    dev = depth.device
    main_inv = torch.linalg.inv(main_cams)
    cm = arith.matmul(side_cams, main_inv[:, None])  # (B, K, 4, 4)

    def cmc(i, j):
        return cm[:, :, i, j, None, None]

    cols = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    rows = torch.arange(0, h, dtype=torch.float32, device=dev)[:, None]
    sx, sy = 2.0 / w, 2.0 / h
    x = (cols - w / 2.0) * sx * torch.ones((h, 1), dtype=torch.float32,
                                           device=dev)
    y = (h / 2.0 - rows) * sy * torch.ones((1, w), dtype=torch.float32,
                                           device=dev)
    center_valid = depth != BACKGROUND_DEPTH
    gx, gy = sobel_gradient(depth)
    variance = var_in.clamp(min=1e-2)
    dep = depth[:, None]

    zk = dep + (gx[:, None] * flx + gy[:, None] * fly) / 8.0
    zk = zk.clamp(-1.0, 1.0)
    fcol = cols + flx
    frow = rows + fly
    good = ((fcol >= 1) & (fcol < w - 1) & (frow >= 1) & (frow < h - 1)
            & center_valid[:, None])
    zk = torch.where(good, zk, dep)
    g1 = gx[:, None].expand(zk.shape)
    g2 = gy[:, None].expand(zk.shape)

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
    ic11, ic12, ic22 = ic11 * vmask, ic12 * vmask, ic22 * vmask

    n0x = cmc(0, 0) * x + cmc(0, 1) * y + cmc(0, 3)
    n0y = cmc(1, 0) * x + cmc(1, 1) * y + cmc(1, 3)
    w0 = cmc(3, 0) * x + cmc(3, 1) * y + cmc(3, 3)
    nzx, nzy, wz = cmc(0, 2), cmc(1, 2), cmc(3, 2)

    def residuals(z):
        wi = w0 + wz * z[:, None]
        wi = torch.where(wi.abs() < 1e-12, 1e-12, wi)
        inv_wi = 1.0 / wi
        rx = (n0x + nzx * z[:, None]) * inv_wi - sx_meas
        ry = (n0y + nzy * z[:, None]) * inv_wi - sy_meas
        return rx, ry, inv_wi

    def step(z, active):
        rx, ry, inv_wi = residuals(z)
        dpx = nzx * inv_wi
        dpy = nzy * inv_wi
        tx = ic11 * dpx + ic12 * dpy
        ty = ic12 * dpx + ic22 * dpy
        first = (rx * tx + ry * ty).sum(dim=1)
        second = (dpx * tx + dpy * ty).sum(dim=1)
        second = torch.where(second.abs() < 1e-30, 1e-30, second)
        dz = -first / second
        return z + torch.where(active, dz, 0.0), active & (dz.abs() >= 1e-7)

    z = depth
    active = center_valid & ok_pixel
    it = torch.zeros(z.shape[0], dtype=torch.int64, device=dev)
    sweeps = 0
    while True:
        n_active = active.sum(dim=(1, 2))
        tail = torch.where(it < GN_MIN_SWEEPS, 0, GN_TAIL)
        cond = (n_active > tail) & (it < gn_iters)
        if not bool(cond.any()):
            break
        z_new, active_new = step(z, active)
        c = cond[:, None, None]
        z = torch.where(c, z_new, z)
        active = torch.where(c, active_new, active)
        it = it + cond.to(torch.int64)
        sweeps += 1

    ok_pixel = ok_pixel & (z >= -1.0) & (z <= 1.0)
    rx, ry, _ = residuals(z)
    quad = rx * (ic11 * rx + ic12 * ry) + ry * (ic12 * rx + ic22 * ry)
    exponent = -quad.sum(dim=1)
    det_ic = ic11 * ic22 - ic12 * ic12
    det_ic = torch.where(sv, det_ic.clamp(min=1e-30), 1.0)
    log_pdf = (torch.log(torch.tensor(0.159, dtype=torch.float32,
                                      device=dev))
               + torch.log(det_ic).sum(dim=1) + 0.5 * exponent)
    pdf = torch.exp(log_pdf.clamp(-30.0, 30.0))

    def apply_minv(row):
        mi = main_inv[:, row, :, None, None]
        return mi[:, 0] * x + mi[:, 1] * y + mi[:, 2] * z + mi[:, 3]

    point4 = torch.stack([apply_minv(r) for r in range(4)], dim=-1)
    return {"point4": point4, "pdf": pdf, "valid": ok_pixel,
            "gn_sweeps": sweeps}
