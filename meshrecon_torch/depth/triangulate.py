"""Per-pixel depth triangulation by Gauss-Newton on z.

Port of meshrecon/depth/triangulate.py (both sampling modes). Every dense
intermediate is a plane, (B, K, H, W) or (B, H, W); the batch is a leading
dimension where the JAX package vmaps.

The Gauss-Newton loop keeps the reference's global exit: an item stops
once at most ``_GN_TAIL`` of its pixels are still active after at least
``_GN_MIN_SWEEPS`` sweeps, or after ``gn_iters`` sweeps, and the batch
sweeps while any item has not stopped (the vmapped ``while_loop``'s
semantics); the output's ``gn_sweeps`` is the batch's sweep count.

- On the CPU (the plain version): :class:`GaussNewtonBand` and
  :func:`gauss_newton`, eager sweeps, each ending in a host test of the
  exit.
- On CUDA: :class:`KernelBand`, the GN kernels (``csrc/triangulate.cu``).
  GN_SOBEL takes the depth window's gradients; GN_WALK walks each pixel
  to its own stop and counts its steps in a histogram per item; GN_EXIT finds each item's stop sweep from the
  histograms (a pixel's steps depend on no other pixel, so its z after s
  sweeps is its z after min(s, its steps)); GN_FINISH writes each pixel's
  result at that sweep. The host reads the sweep count once, after
  GN_FINISH is queued (:func:`solve_bands`).
"""

from __future__ import annotations

import torch

from meshrecon_torch import BACKGROUND_DEPTH
from meshrecon_torch.flow.pyramid import pad_reflect
from meshrecon_torch.geometry.camera import invert_cameras
from meshrecon_torch.kernels._build import Kernel, check_cuda
from meshrecon_torch.utils.profiling import (count, host_read, host_values,
                                             to_device)

_GN_TAIL = 64
_GN_MIN_SWEEPS = 6
_PDF_SCALE = 0.159  # the pdf's constant factor: log_pdf = log(0.159) + ...

_GN_SOURCE = "meshrecon_torch/csrc/triangulate.cu"
_GN_REPLACES = "meshrecon/depth/triangulate.py:295 (XLA while_loop)"
GN_SOBEL = Kernel("gn_sobel", "mr_gn_sobel", _GN_SOURCE, _GN_REPLACES)
GN_WALK = Kernel("gn_walk", "mr_gn_walk", _GN_SOURCE, _GN_REPLACES)
GN_EXIT = Kernel("gn_exit", "mr_gn_exit", _GN_SOURCE, _GN_REPLACES)
GN_FINISH = Kernel("gn_finish", "mr_gn_finish", _GN_SOURCE, _GN_REPLACES)


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

        main_inv = invert_cameras(main_cams)
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
        log_pdf = (torch.log(to_device(_PDF_SCALE, dev, torch.float32))
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
        if not host_read(cond.any()):
            break
        for band in bands:
            z_new, active_new = band.step(band.z, band.active)
            c = cond.to(band.z.device)[:, None, None]
            band.z = torch.where(c, z_new, band.z)
            band.active = torch.where(c, active_new, band.active)
        it = it + cond.to(torch.int64)
        sweeps += 1
    count("gn_sweeps", sweeps)
    return sweeps


def _flow_planes(flx, fly):
    """(flx, fly, step): the planes as GN reads them, each element ``step``
    floats after the one before: 2 for the two channels of one contiguous
    (..., 2) flow tensor, which are then read in place, else 1."""
    flx, fly = flx.to(torch.float32), fly.to(torch.float32)
    dense, stride = [], 1
    for size in reversed(flx.shape):
        dense.insert(0, stride)
        stride *= size
    for step in (1, 2):
        want = tuple(step * x for x in dense)
        if (flx.stride() == want and fly.stride() == want
                and fly.shape == flx.shape):
            return flx, fly, step
    return flx.contiguous(), fly.contiguous(), 1


def gn_sobel(depth):
    """GN_SOBEL: :func:`sobel_gradient` of a contiguous (B, h, W) float32
    CUDA tensor, h and W at least 2; returns (gx, gy)."""
    gx, gy = torch.empty_like(depth), torch.empty_like(depth)
    check_cuda("gn_sobel", depth, gx, gy)
    GN_SOBEL.launch(depth, gx, gy, *depth.shape)
    return gx, gy


class KernelBand:
    """:class:`GaussNewtonBand` on CUDA tensors, the same arguments: the
    inputs of the GN kernels (``csrc/triangulate.cu``), and the band's
    share of :func:`solve_bands`: :meth:`walk`, then :meth:`finish`. The
    camera inversion and products stay eager ((B, 4, 4) and (B, K, 4, 4)
    tensors: torch's own bits)."""

    def __init__(self, flx, fly, var_in, main_cams, side_cams, side_valid,
                 depth, sampling: str = "exact", *, row0: int = 0,
                 height=None, depth_row0: int = 0):
        if sampling not in ("exact", "taylor"):
            raise ValueError(f"unknown sampling mode {sampling}")
        self.flx, self.fly, self.flow_step = _flow_planes(flx, fly)
        self.var = var_in.to(torch.float32).contiguous()
        self.depth = depth.to(torch.float32).contiguous()
        self.side_valid = side_valid.to(torch.bool).contiguous()
        self.b, self.k, self.rows, self.width = self.flx.shape
        self.height = self.depth.shape[-2] if height is None else height
        self.row0, self.depth_row0 = row0, depth_row0
        if (self.fly.shape != self.flx.shape
                or self.var.shape != self.flx.shape
                or self.depth.dim() != 3
                or self.depth.shape[::2] != (self.b, self.width)
                or self.side_valid.shape != (self.b, self.k)
                or main_cams.shape != (self.b, 4, 4)
                or side_cams.shape != (self.b, self.k, 4, 4)):
            raise ValueError("KernelBand: the inputs' shapes disagree")
        if self.width < 2 or self.height < 2 or self.depth.shape[-2] < 2:
            raise ValueError("GN needs an image and a depth window of at "
                             "least 2x2 pixels")
        self.exact = int(sampling == "exact")
        # the status is read with the sweep count (solve_bands), not here
        main_inv, self.inv_status = torch.linalg.inv_ex(
            main_cams.to(torch.float32))
        self.cm = (side_cams.to(torch.float32)
                   @ main_inv[:, None]).contiguous()
        self.main_inv = main_inv.contiguous()
        check_cuda("KernelBand", self.depth, self.var, self.cm,
                   self.main_inv)
        self.gx, self.gy = gn_sobel(self.depth)
        self.z = self.t = None
        for t in (self.flx, self.fly, self.side_valid):
            if t.device != self.depth.device:
                raise ValueError(f"KernelBand: an input on {t.device}, "
                                 f"the depth on {self.depth.device}")

    def _geometry(self) -> tuple:
        return (self.exact, self.b, self.k, self.rows, self.width,
                self.height, self.row0, self.depth_row0,
                self.depth.shape[-2], self.flow_step)

    def _inputs(self) -> tuple:
        return (self.flx, self.fly, self.var, self.depth, self.gx, self.gy,
                self.cm, self.side_valid)

    def walk(self, gn_iters: int) -> torch.Tensor:
        """GN_WALK: every pixel to its own stop, up to ``gn_iters`` steps;
        returns the (B, gn_iters + 1) int32 histogram of its step counts."""
        dev = self.depth.device
        shape = (self.b, self.rows, self.width)
        self.z = torch.empty(shape, dtype=torch.float32, device=dev)
        self.t = torch.empty(shape, dtype=torch.int32, device=dev)
        hist = torch.zeros((self.b, gn_iters + 1), dtype=torch.int32,
                           device=dev)
        GN_WALK.launch(*self._inputs(), self.z, self.t, hist,
                       *self._geometry(), gn_iters, 2.0 / self.width,
                       2.0 / self.height, BACKGROUND_DEPTH)
        return hist

    def finish(self, stop: torch.Tensor) -> dict:
        """GN_FINISH at each item's stop sweep ``stop`` (B,) int32: dict(
        point4, pdf, valid)."""
        dev = self.depth.device
        shape = (self.b, self.rows, self.width)
        point4 = torch.empty(shape + (4,), dtype=torch.float32, device=dev)
        pdf = torch.empty(shape, dtype=torch.float32, device=dev)
        valid = torch.empty(shape, dtype=torch.bool, device=dev)
        GN_FINISH.launch(*self._inputs(), self.z, self.t, stop,
                         self.main_inv, point4, pdf, valid,
                         *self._geometry(), 2.0 / self.width,
                         2.0 / self.height, BACKGROUND_DEPTH, _PDF_SCALE)
        return {"point4": point4, "pdf": pdf, "valid": valid}


def gn_exit(hist: torch.Tensor, inv_status: torch.Tensor):
    """GN_EXIT on a (B, gn_iters + 1) int32 histogram of step counts and
    the main cameras' (B,) inversion status: (stop (B,) int32, info (3,)
    int64: the sweep count, the pixel-steps taken, the singular
    cameras)."""
    hist = hist.contiguous()
    inv_status = inv_status.to(torch.int32).contiguous()
    b = hist.shape[0]
    stop = torch.empty(b, dtype=torch.int32, device=hist.device)
    info = torch.empty(3, dtype=torch.int64, device=hist.device)
    check_cuda("gn_exit", hist, inv_status, stop, dtype=torch.int32)
    check_cuda("gn_exit", info, dtype=torch.int64)
    GN_EXIT.launch(hist, inv_status, stop, info, b, hist.shape[1] - 1,
                   _GN_TAIL, _GN_MIN_SWEEPS)
    return stop, info


def gn_exit_plain(hist) -> tuple:
    """GN_EXIT's plain version, on a (B, gn_iters + 1) histogram of the
    pixels' step counts (the sweep after which each went inactive, 0 if it
    never started, ``gn_iters`` if it never stopped): (each item's stop
    sweep, the batch's sweep count, the pixel-steps taken), as lists and
    ints. :func:`gauss_newton`'s exit, found afterwards: an item's active
    count after s sweeps is the number of its pixels with more than s
    steps."""
    gn_iters = hist.shape[1] - 1
    stop = []
    for h in hist.tolist():
        active, s = sum(h[1:]), 0
        while (s < gn_iters
               and active > (0 if s < _GN_MIN_SWEEPS else _GN_TAIL)):
            s += 1
            active -= h[s]
        stop.append(s)
    steps = sum(c * min(s, t) for h, s in zip(hist.tolist(), stop)
                for t, c in enumerate(h))
    return stop, max(stop, default=0), steps


def gauss_newton_band(flx, fly, var_in, main_cams, side_cams, side_valid,
                      depth, sampling: str = "exact", **band):
    """The band's triangulation: :class:`GaussNewtonBand` on the CPU,
    :class:`KernelBand` on CUDA (the same arguments)."""
    cls = KernelBand if depth.is_cuda else GaussNewtonBand
    return cls(flx, fly, var_in, main_cams, side_cams, side_valid, depth,
               sampling, **band)


def solve_bands(bands: list, gn_iters: int = 50) -> list:
    """Triangulate the bands of one batch of main frames (one band: the
    whole frame) to the global exit: each band's dict(point4, pdf, valid,
    gn_sweeps). On CUDA the bands' histograms are summed on the first
    band's device in band order (exact integers), so every band of an item
    stops at the unsharded sweep; the sweep count is read once, after
    every GN_FINISH is queued, with the cameras' inversion status, and
    counted (``gn_kernel``, ``gn_steps``, ``gn_sweeps``)."""
    if not isinstance(bands[0], KernelBand):
        sweeps = gauss_newton(bands, gn_iters)
        return [band.result(sweeps) for band in bands]
    hists = [band.walk(gn_iters) for band in bands]
    dev0 = hists[0].device
    hist = hists[0]
    for h in hists[1:]:
        hist = hist + h.to(dev0)
    stop, info = gn_exit(hist, bands[0].inv_status)
    outs = [band.finish(stop.to(band.depth.device)) for band in bands]
    sweeps, steps, singular = host_values(info)
    if singular:
        raise torch.linalg.LinAlgError(
            "invert_cameras: a camera matrix is singular")
    count("gn_kernel")
    count("gn_steps", steps)
    count("gn_sweeps", sweeps)
    for out in outs:
        out["gn_sweeps"] = sweeps
    return outs


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
    band = gauss_newton_band(flx, fly, var_in, main_cams, side_cams,
                             side_valid, depth, sampling)
    return solve_bands([band], gn_iters)[0]


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
