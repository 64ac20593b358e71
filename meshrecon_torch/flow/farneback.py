"""Farneback-style dense optical flow via polynomial expansion (``-f``).

Port of meshrecon/flow/farneback.py: fit a local quadratic
f(x) ~= c + b.x + x.A.x under a Gaussian applicability window by
separable moment filters, then solve per pixel for the displacement that
aligns the two quadratics, coarse to fine over a dyadic pyramid (the JAX
package's form, not OpenCV's 10-level 0.8-scale pyramid of flow.cpp:22-26).

Batched over leading axes: prev (..., H, W) broadcasts against next_
(..., H, W), e.g. (B, 1, H, W) against (B, K, H, W), as the JAX fused
update vmaps over (B, K). Every filter is a loop of shifted multiply-adds
in the XLA twin's order, not a convolution: cuDNN's TF32 and its sum
order would move the last bits, which the per-pixel 2x2 solve amplifies
where its determinant is small. The second frame's quadratics are
resampled at the displaced positions through K3 (``tile_warp_flow_batched``
with taps=2), whose arithmetic is ``bilinear_sample``'s.
"""

from __future__ import annotations

import numpy as np
import torch

from meshrecon_torch.flow.pyramid import pad_reflect, pyr_down, pyr_up
from meshrecon_torch.flow.tile_warp import tile_warp_flow_batched


def _poly_exp_setup(n: int, sigma: float):
    """Separable moment kernels and the inverse Gram matrix, on the host in
    float64. Basis ordering: [1, x, y, x^2, y^2, xy] over the (2n+1)^2
    window with Gaussian weight w. Returns (offsets u, w, G_inv) as numpy
    arrays."""
    u = np.arange(-n, n + 1, dtype=np.float64)
    w = np.exp(-(u**2) / (2.0 * sigma * sigma))
    w /= w.sum()
    W = np.outer(w, w)
    X, Y = np.meshgrid(u, u, indexing="xy")
    basis = [np.ones_like(X), X, Y, X * X, Y * Y, X * Y]
    G = np.zeros((6, 6))
    for i in range(6):
        for j in range(6):
            G[i, j] = np.sum(W * basis[i] * basis[j])
    G_inv = np.linalg.inv(G)
    return u, w, G_inv


def _taps(k):
    """1-D kernel -> (offset, float32 coefficient) of its non-zero taps."""
    k32 = np.asarray(k, np.float64).astype(np.float32)
    return [(i, float(kv)) for i, kv in enumerate(k32) if kv != 0.0]


def _sep_correlate(img, kx, ky):
    """Separable correlation of the last two axes with 1-D kernels kx
    (columns) and ky (rows), reflect-101 borders."""
    n = (len(kx) - 1) // 2
    h, w = img.shape[-2:]
    p = pad_reflect(img, n, img.dim() - 2)
    acc = None
    for i, kv in _taps(ky):
        term = kv * p[..., i:i + h, :]
        acc = term if acc is None else acc + term
    p2 = pad_reflect(acc, n, acc.dim() - 1)
    out = None
    for j, kv in _taps(kx):
        term = kv * p2[..., :, j:j + w]
        out = term if out is None else out + term
    return out


def _poly_expansion(img, u, w, g_inv):
    """Per-pixel quadratic coefficients (b1, b2, a11, a22, a12) of the
    image: moments by separable correlations, mixed by the constant G^-1
    (float32), each coefficient summed over the moments in order."""
    wu = w * u
    wu2 = w * u * u
    m = [
        _sep_correlate(img, w, w),  # 1
        _sep_correlate(img, wu, w),  # x
        _sep_correlate(img, w, wu),  # y
        _sep_correlate(img, wu2, w),  # x^2
        _sep_correlate(img, w, wu2),  # y^2
        _sep_correlate(img, wu, wu),  # xy
    ]
    g32 = np.asarray(g_inv, np.float32)

    def coef(i):
        out = None
        for j in range(6):
            if g32[i, j] != 0.0:
                term = float(g32[i, j]) * m[j]
                out = term if out is None else out + term
        return out

    # f = c + b.x + x.A.x with A = [[a11, a12], [a12, a22]]
    return coef(1), coef(2), coef(3), coef(4), coef(5) * 0.5


def _box(img, n):
    """(2n+1)^2 box average (the displacement-field smoothing window)."""
    k = np.ones(2 * n + 1) / (2 * n + 1)
    return _sep_correlate(img, k, k)


def flow_step(pa, pb, samp, dx, dy, win):
    """One iteration of a level: the first frame's coefficients ``pa``
    (b1, b2, a11, a22, a12), the second's ``pb`` sampled at the displaced
    positions by ``samp``, the displacement (dx, dy) and the box
    half-width. Returns the new (dx, dy). Its rows reach ``win`` rows
    each way, and ``samp``'s reach the displacement's."""
    b1a, b2a, a11a, a22a, a12a = pa
    b1b, b2b, a11b, a22b, a12b = pb
    # average the two quadratics, the second at the displaced position
    a11 = 0.5 * (a11a + samp(a11b))
    a22 = 0.5 * (a22a + samp(a22b))
    a12 = 0.5 * (a12a + samp(a12b))
    db1 = -0.5 * (samp(b1b) - b1a) + (a11 * dx + a12 * dy)
    db2 = -0.5 * (samp(b2b) - b2a) + (a12 * dx + a22 * dy)

    # normal equations G d = h smoothed over the window
    g11 = _box(a11 * a11 + a12 * a12, win)
    g12 = _box(a11 * a12 + a12 * a22, win)
    g22 = _box(a12 * a12 + a22 * a22, win)
    h1 = _box(a11 * db1 + a12 * db2, win)
    h2 = _box(a12 * db1 + a22 * db2, win)
    det = g11 * g22 - g12 * g12
    det = torch.where(det.abs() < 1e-9, 1e-9, det)
    return (g22 * h1 - g12 * h2) / det, (g11 * h2 - g12 * h1) / det


def _flow_level(f1, f2, dx, dy, poly, win, iters):
    u, w, g_inv = poly
    pa = _poly_expansion(f1, u, w, g_inv)
    pb = tuple(t.contiguous() for t in _poly_expansion(f2, u, w, g_inv))

    for _ in range(iters):
        dxc, dyc = dx.contiguous(), dy.contiguous()

        def samp(img):
            # a true gather warp (K3): the carried flow is full-magnitude
            return tile_warp_flow_batched(img, dxc, dyc)

        dx, dy = flow_step(pa, pb, samp, dx, dy, win)
    return dx, dy


def farneback_flow(prev, next_, levels: int = 5, iters: int = 5,
                   poly_n: int = 5, poly_sigma: float = 1.2,
                   winsize: int = 15, min_size: int = 16):
    """Dense flow prev -> next_ by polynomial expansion: next(x + flow(x))
    ~= prev(x). prev broadcasts against next_ (..., H, W); returns
    (..., H, W, 2) float32 (fx, fy).

    winsize is OpenCV's: the full width of the displacement-smoothing box
    (the reference passes (h+w)/100, flow.cpp:24-26).
    """
    f1 = prev.to(torch.float32)
    f2 = next_.to(torch.float32)
    shape = torch.broadcast_shapes(f1.shape, f2.shape)
    f2 = f2.expand(shape)
    win = max(int(winsize) // 2, 1)  # box half-width: 2*win+1 taps
    poly = _poly_exp_setup(poly_n, poly_sigma)

    pyr1, pyr2 = [f1], [f2]
    for _ in range(levels - 1):
        if min(pyr1[-1].shape[-2:]) <= min_size:
            break
        pyr1.append(pyr_down(pyr1[-1]))
        pyr2.append(pyr_down(pyr2[-1]))

    dx = torch.zeros(pyr2[-1].shape, dtype=torch.float32, device=f2.device)
    dy = torch.zeros_like(dx)
    for lvl in range(len(pyr1) - 1, -1, -1):
        a, b = pyr1[lvl], pyr2[lvl]
        if dx.shape[-2:] != a.shape[-2:]:
            dx = pyr_up(dx, a.shape[-2:]) * 2.0
            dy = pyr_up(dy, a.shape[-2:]) * 2.0
        dx, dy = _flow_level(a, b, dx, dy, poly, win, iters)
    return torch.stack([dx, dy], dim=-1)
