"""Per-pixel surface normals from windowed moment sums.

Port of meshrecon/depth/normals.py: box-filtered moment images (count, p,
p p^T) give each pixel's 21x21-window covariance, whose smallest
eigenvector (analytic 3x3 solve) is the normal, oriented by the cameras'
inverse-distance vote and scaled by pdf^(1/K).

The box sums keep the reference's doubling shifted adds: a float32
cumulative-sum integral image would lose the p p^T moments' precision at
640x480.

On the CPU :func:`estimate_normals_batched` is eager ops (the plain
version). On CUDA it is two kernels (``csrc/normals.cu``): NORMALS_COLS
forms the moments and their vertical window sums, NORMALS_FINISH the
horizontal sums and everything after them; no eager op runs, the outputs
are the eager path's bit for bit, and each estimation counts
``normals_kernel``.
"""

from __future__ import annotations

import math

import torch

from meshrecon_torch.kernels._build import Kernel
from meshrecon_torch.utils.profiling import count

_NORMALS_SOURCE = "meshrecon_torch/csrc/normals.cu"
_NORMALS_REPLACES = ("meshrecon/depth/normals.py:157 (estimate_normals; "
                     "XLA-fused)")
NORMALS_COLS = Kernel("normals_cols", "mr_normals_cols", _NORMALS_SOURCE,
                      _NORMALS_REPLACES)
NORMALS_FINISH = Kernel("normals_finish", "mr_normals_finish",
                        _NORMALS_SOURCE, _NORMALS_REPLACES)
# the largest radius the kernels take: NORMALS_COLS holds a column's 64
# rows, a strip and its reach of 2r, in registers (csrc/normals.cu)
CARD_MAX_RADIUS = 31
# n_side's dtypes NORMALS_FINISH reads as they are (its n_side_kind)
_SIDE_KINDS = {torch.float32: 0, torch.int32: 1, torch.int64: 2}


def _shift(a, s: int, axis: int):
    """a shifted toward lower indices by s along axis, zero-filled."""
    n = a.shape[axis]
    if s == 0:
        return a
    if s >= n:
        return torch.zeros_like(a)
    zeros_shape = list(a.shape)
    zeros_shape[axis] = s
    return torch.cat([a.narrow(axis, s, n - s),
                      a.new_zeros(zeros_shape)], dim=axis)


def _window_sums_chw(field, radius: int):
    """Sum of a (..., C, H, W) field over (2r+1)^2 windows (zero outside),
    by binary decomposition of the box into doubled power-of-two sums."""
    size = 2 * radius + 1

    def suffix_box(x, axis):
        pows = {1: x}
        k = 1
        while k * 2 <= size:
            pows[k * 2] = pows[k] + _shift(pows[k], k, axis)
            k *= 2
        acc = None
        offset = 0
        b = 1
        while b <= size:
            if size & b:
                term = _shift(pows[b], offset, axis)
                acc = term if acc is None else acc + term
                offset += b
            b *= 2
        return acc

    def centered_box(x, axis):
        n = x.shape[axis]
        pad_shape = list(x.shape)
        pad_shape[axis] = radius
        zeros = x.new_zeros(pad_shape)
        xp = torch.cat([zeros, x, zeros], dim=axis)
        return suffix_box(xp, axis).narrow(axis, 0, n)

    return centered_box(centered_box(field, field.dim() - 2), field.dim() - 1)


def _smallest_eigvec_3x3_planes(a00, a11, a22, a01, a02, a12):
    """Unit eigenvector of the smallest eigenvalue of a symmetric 3x3 given
    as 6 planes: analytic trigonometric eigenvalues, then the largest
    cross product of two rows of (A - lam I)."""
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * (
        a01 * a01 + a02 * a02 + a12 * a12)
    p = torch.sqrt((p2 / 6.0).clamp(min=1e-30))
    inv_p = 1.0 / p
    c00, c11, c22 = b00 * inv_p, b11 * inv_p, b22 * inv_p
    c01, c02, c12 = a01 * inv_p, a02 * inv_p, a12 * inv_p
    half_det = (c00 * (c11 * c22 - c12 * c12)
                - c01 * (c01 * c22 - c12 * c02)
                + c02 * (c01 * c12 - c11 * c02)) * 0.5
    half_det = half_det.clamp(-1.0, 1.0)
    phi = torch.acos(half_det) / 3.0
    lam = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)

    r0x, r0y, r0z = a00 - lam, a01, a02
    r1x, r1y, r1z = a01, a11 - lam, a12
    r2x, r2y, r2z = a02, a12, a22 - lam

    def cross(ax, ay, az, bx, by, bz):
        return ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx

    cax, cay, caz = cross(r0x, r0y, r0z, r1x, r1y, r1z)
    cbx, cby, cbz = cross(r0x, r0y, r0z, r2x, r2y, r2z)
    ccx, ccy, ccz = cross(r1x, r1y, r1z, r2x, r2y, r2z)
    na = cax * cax + cay * cay + caz * caz
    nb = cbx * cbx + cby * cby + cbz * cbz
    nc = ccx * ccx + ccy * ccy + ccz * ccz

    use_b = nb > na
    bx = torch.where(use_b, cbx, cax)
    by = torch.where(use_b, cby, cay)
    bz = torch.where(use_b, cbz, caz)
    nab = torch.maximum(na, nb)
    use_c = nc > nab
    bx = torch.where(use_c, ccx, bx)
    by = torch.where(use_c, ccy, by)
    bz = torch.where(use_c, ccz, bz)
    nbest = torch.maximum(nab, nc)
    degen = nbest <= 1e-30  # isotropic: +z
    bx = torch.where(degen, 0.0, bx)
    by = torch.where(degen, 0.0, by)
    bz = torch.where(degen, 1.0, bz)
    inv_n = 1.0 / torch.sqrt((bx * bx + by * by + bz * bz).clamp(min=1e-30))
    return bx * inv_n, by * inv_n, bz * inv_n


def estimate_normals_batched(point4, valid, pdf, camera_centers,
                             centers_valid, n_side, radius: int = 10):
    """Confidence-scaled normals for B frames.

    point4 (B, H, W, 4); valid (B, H, W) bool; pdf (B, H, W);
    camera_centers (B, C, 3) (main camera first); centers_valid (B, C);
    n_side (B,) real side counts. Returns (B, H, W, 3) float32. On CUDA
    the NORMALS kernels (:func:`normals_on_card`), elsewhere
    :func:`normals_eager`.
    """
    fn = normals_on_card if point4.is_cuda else normals_eager
    return fn(point4, valid, pdf, camera_centers, centers_valid, n_side,
              radius)


def normals_eager(point4, valid, pdf, camera_centers, centers_valid,
                  n_side, radius: int = 10):
    """The plain version of :func:`estimate_normals_batched`, its
    arguments: eager ops on any device."""
    point4 = point4.to(torch.float32)
    w4 = point4[..., 3]
    w4 = torch.where(w4.abs() < 1e-20, 1.0, w4)
    vmask = valid.to(torch.float32)
    px = point4[..., 0] / w4 * vmask
    py = point4[..., 1] / w4 * vmask
    pz = point4[..., 2] / w4 * vmask

    moments = torch.stack([vmask, px, py, pz, px * px, py * py, pz * pz,
                           px * py, px * pz, py * pz], dim=1)  # (B, 10, H, W)
    sums = _window_sums_chw(moments, radius)
    cnt = sums[:, 0]
    n = cnt.clamp(min=1.0)
    mx, my, mz = sums[:, 1] / n, sums[:, 2] / n, sums[:, 3] / n
    cxx = sums[:, 4] / n - mx * mx
    cyy = sums[:, 5] / n - my * my
    czz = sums[:, 6] / n - mz * mz
    cxy = sums[:, 7] / n - mx * my
    cxz = sums[:, 8] / n - mx * mz
    cyz = sums[:, 9] / n - my * mz

    eps = 1e-12
    nx, ny, nz = _smallest_eigvec_3x3_planes(cxx + eps, cyy + eps, czz + eps,
                                             cxy, cxz, cyz)

    centers = camera_centers.to(torch.float32)
    cmask = centers_valid.to(torch.float32)
    vote = torch.zeros_like(nx)
    fbx = torch.zeros_like(nx)
    fby = torch.zeros_like(nx)
    fbz = torch.zeros_like(nx)
    for i in range(centers.shape[1]):
        dx = centers[:, i, 0, None, None] - px
        dy = centers[:, i, 1, None, None] - py
        dz = centers[:, i, 2, None, None] - pz
        ci = cmask[:, i, None, None]
        ndot = nx * dx + ny * dy + nz * dz
        ndot = torch.where(ndot.abs() < 1e-12, 1e-12, ndot)
        vote = vote + ci / ndot
        d2 = (dx * dx + dy * dy + dz * dz).clamp(min=1e-12)
        fbx = fbx + ci * dx / d2
        fby = fby + ci * dy / d2
        fbz = fbz + ci * dz / d2

    flip = vote < 0
    nx = torch.where(flip, -nx, nx)
    ny = torch.where(flip, -ny, ny)
    nz = torch.where(flip, -nz, nz)

    few = cnt < 3.0  # fallback when the window holds fewer than 3 points
    nx = torch.where(few, fbx, nx)
    ny = torch.where(few, fby, ny)
    nz = torch.where(few, fbz, nz)

    k = n_side.to(torch.float32).clamp(min=1.0)[:, None, None]
    pdf_root = torch.where(k > 1.0, torch.pow(pdf.clamp(min=0.0), 1.0 / k),
                           pdf)
    inv_len = 1.0 / torch.sqrt(nx * nx + ny * ny + nz * nz).clamp(min=1e-12)
    scale = pdf_root * inv_len * vmask
    out = torch.stack([nx * scale, ny * scale, nz * scale], dim=-1)
    # non-finite normals from degenerate covariances would poison every
    # global reduction downstream
    return torch.where(torch.isfinite(out), out, 0.0)


def _frames(t: torch.Tensor):
    """(t, the elements from one of its frames to the next): t as it is
    where each frame (t[i]) is contiguous, else a contiguous copy."""
    frame = math.prod(t.shape[1:])
    if t.is_contiguous():
        return t, frame
    if t[0].is_contiguous():
        return t, t.stride(0)
    return t.contiguous(), frame


def normals_on_card(point4, valid, pdf, camera_centers, centers_valid,
                    n_side, radius: int = 10):
    """:func:`estimate_normals_batched` on CUDA tensors, its arguments:
    NORMALS_COLS into a (B, 10, H, W) scratch, then NORMALS_FINISH, counted
    (``normals_kernel``). A frame of point4, valid or pdf may lie at any
    stride from the next (a band of rows); valid and centers_valid are
    bool, pdf float32, n_side float32, int32 or int64 as it is (another
    type converted). Raises ValueError on inputs it does not take."""
    name = "estimate_normals_batched"
    b, h, w = valid.shape
    c = camera_centers.shape[1] if camera_centers.dim() == 3 else -1
    if (point4.shape != (b, h, w, 4) or pdf.shape != (b, h, w)
            or camera_centers.shape != (b, c, 3)
            or centers_valid.shape != (b, c) or n_side.shape != (b,)):
        raise ValueError(f"{name}: the inputs' shapes disagree")
    if not 0 <= radius <= CARD_MAX_RADIUS:
        raise ValueError(f"{name}: radius {radius} outside [0, "
                         f"{CARD_MAX_RADIUS}] on the card")
    if n_side.dtype not in _SIDE_KINDS:
        n_side = n_side.to(torch.float32)
    point4 = point4.to(torch.float32)
    centers = camera_centers.to(torch.float32)
    dev = point4.device
    for i, (t, dtype) in enumerate((
            (valid, torch.bool), (pdf, torch.float32),
            (centers, torch.float32), (centers_valid, torch.bool),
            (n_side, n_side.dtype))):
        if t.device != dev or t.dtype is not dtype:
            raise ValueError(f"{name}: input {i + 1} is {t.dtype} on "
                             f"{t.device}, expected {dtype} on {dev}")
    out = torch.empty((b, h, w, 3), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    point4, p4_stride = _frames(point4)
    if point4.data_ptr() % 16 or p4_stride % 4:
        raise ValueError(f"{name}: point4's frames must start 16-byte "
                         "aligned (the kernels read a point as a float4)")
    valid, valid_stride = _frames(valid)
    pdf, pdf_stride = _frames(pdf)
    sums = torch.empty((b, 10, h, w), dtype=torch.float32, device=dev)
    NORMALS_COLS.launch(point4, valid, sums, p4_stride, valid_stride, b, h,
                        w, radius)
    NORMALS_FINISH.launch(sums, point4, valid, pdf, centers.contiguous(),
                          centers_valid.contiguous(), n_side.contiguous(),
                          out, p4_stride, valid_stride, pdf_stride,
                          _SIDE_KINDS[n_side.dtype], b, c, h, w, radius)
    count("normals_kernel")
    return out


def estimate_normals(point4, valid, pdf, camera_centers, centers_valid,
                     n_side, radius: int = 10):
    """Single-frame form with the JAX package's signature: point4 (H, W, 4),
    valid (H, W), pdf (H, W), camera_centers (C, 3), centers_valid (C,),
    n_side scalar. Returns (H, W, 3)."""
    n_side = torch.as_tensor(n_side, device=point4.device).reshape(1)
    return estimate_normals_batched(
        point4[None], valid[None], pdf[None], camera_centers[None],
        centers_valid[None], n_side, radius=radius)[0]
