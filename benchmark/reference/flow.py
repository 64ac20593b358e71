"""Plain coarse-to-fine Horn-Schunck flow and the pyramid-L1 variance (a
frozen copy of the program's plain flow path): 5-tap binomial pyramids
with reflect-101 borders, a bilinear warp of the target by the current
flow at each level, Chebyshev-weighted Jacobi sweeps, and the first-order
re-warp through the finest level's linearization."""

from __future__ import annotations

import torch

from benchmark.reference.fragment import bilinear_sample

_K5 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def reflect_index(n: int, pad: int, device) -> torch.Tensor:
    i = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    j = torch.remainder(i, period)
    return torch.where(j >= n, period - j, j)


def pad_reflect(img, pad: int, axis: int):
    return img.index_select(axis, reflect_index(img.shape[axis], pad,
                                                img.device))


def _sep5(img, axis):
    p = pad_reflect(img, 2, axis)
    n = img.shape[axis]
    out = 0
    for i, w in enumerate(_K5):
        out = out + w * p.narrow(axis, i, n)
    return out


def gauss5(img):
    return _sep5(_sep5(img, img.dim() - 2), img.dim() - 1)


def pyr_down(img):
    return gauss5(img)[..., ::2, ::2]


def pyr_up(img, out_shape):
    oh, ow = out_shape
    h, w = img.shape[-2:]
    up = torch.zeros(img.shape[:-2] + (2 * h, 2 * w), dtype=img.dtype,
                     device=img.device)
    up[..., ::2, ::2] = img
    return gauss5(up[..., :oh, :ow]) * 4.0


def compare(prev, next_):
    """Pyramid-cascaded L1 difference, summed back to full resolution."""
    d = prev.to(torch.float32) - next_.to(torch.float32)
    diffs = []
    size = min(d.shape[-2], d.shape[-1])
    while True:
        diffs.append(d.abs())
        if size <= 2:
            break
        d = pyr_down(d)
        size //= 2
    acc = diffs[-1]
    for lvl in range(len(diffs) - 2, -1, -1):
        acc = diffs[lvl] + pyr_up(acc, diffs[lvl].shape[-2:])
    return acc


def bilinear_warp(image, u, v):
    """out(r, c) = image(c + u, r + v), bilinear, border-clamped."""
    h, w = image.shape[-2:]
    cols = torch.arange(w, dtype=torch.float32, device=image.device)[None, :]
    rows = torch.arange(h, dtype=torch.float32, device=image.device)[:, None]
    return bilinear_sample(image.to(torch.float32), cols + u, rows + v)


def _pad_hw(u):
    h, w = u.shape[-2:]
    ri = torch.arange(-1, h + 1, device=u.device).clamp(0, h - 1)
    ci = torch.arange(-1, w + 1, device=u.device).clamp(0, w - 1)
    return u.index_select(u.dim() - 2, ri).index_select(u.dim() - 1, ci)


def _hs_average(u):
    p = _pad_hw(u)
    s4 = (p[..., :-2, 1:-1] + p[..., 2:, 1:-1]
          + p[..., 1:-1, :-2] + p[..., 1:-1, 2:])
    s8 = (p[..., :-2, :-2] + p[..., :-2, 2:]
          + p[..., 2:, :-2] + p[..., 2:, 2:])
    return s4 / 6.0 + s8 / 12.0


def _gradients(a, b):
    m = 0.5 * (a + b)
    p = _pad_hw(m)
    ix = (p[..., 1:-1, 2:] - p[..., 1:-1, :-2]) * 0.5
    iy = (p[..., 2:, 1:-1] - p[..., :-2, 1:-1]) * 0.5
    return ix, iy


def cheb_coeffs_f32(iters: int, rho: float):
    """Chebyshev semi-iteration coefficients (a_k, b_k), rounded to
    float32, as Python floats."""
    mus = [1.0, 1.0 / rho]
    ab = [(1.0, 0.0)]
    for k in range(1, iters):
        mu_next = 2.0 / rho * mus[k] - mus[k - 1]
        ab.append((2.0 * mus[k] / (rho * mu_next), -mus[k - 1] / mu_next))
        mus.append(mu_next)
    t = torch.tensor(ab, dtype=torch.float32)
    return [tuple(row) for row in t.tolist()]


def hs_sweeps_cheb(prev, warped, u0, v0, alpha2, iters, rho):
    """Chebyshev-accelerated Jacobi relaxation of the HS system linearized
    at (u0, v0)."""
    ix, iy = _gradients(prev, warped)
    it = warped - prev
    denom = alpha2 + ix * ix + iy * iy

    def jac(u, v):
        ub = _hs_average(u)
        vb = _hs_average(v)
        num = (ix * (ub - u0) + iy * (vb - v0) + it) / denom
        return ub - ix * num, vb - iy * num

    u, v, up, vp = u0, v0, u0, v0
    for a_k, b_k in cheb_coeffs_f32(iters, rho):
        yu, yv = jac(u, v)
        un = a_k * yu + b_k * up
        vn = a_k * yv + b_k * vp
        u, v, up, vp = un, vn, u, v
    return u, v


def variational_flow(prev, next_, levels: int, iters: int, warps: int,
                     alpha: float, rho: float, fine_warps: int,
                     min_size: int = 12):
    """Dense flow prev -> next_ ((..., H, W, 2)) and the first-order
    re-warped image through the finest level's linearization."""
    prev = prev.to(torch.float32)
    next_ = next_.to(torch.float32)
    alpha2 = float(alpha * alpha)
    pyr_a = [prev]
    pyr_b = [next_]
    for _ in range(levels - 1):
        if min(pyr_a[-1].shape[-2:]) <= min_size:
            break
        pyr_a.append(pyr_down(pyr_a[-1]))
        pyr_b.append(pyr_down(pyr_b[-1]))
    u = torch.zeros_like(pyr_b[-1])
    v = torch.zeros_like(pyr_b[-1])
    for lvl in range(len(pyr_a) - 1, -1, -1):
        a, b = pyr_a[lvl], pyr_b[lvl]
        if u.shape[-2:] != a.shape[-2:]:
            u = pyr_up(u, a.shape[-2:]) * 2.0
            v = pyr_up(v, a.shape[-2:]) * 2.0
        for _ in range(fine_warps if lvl == 0 else warps):
            u_lin, v_lin = u, v
            warped = bilinear_warp(b, u, v)
            u, v = hs_sweeps_cheb(a, warped, u, v, alpha2, iters, rho)
    flow = torch.stack([u, v], dim=-1)
    ix, iy = _gradients(pyr_a[0], warped)
    rewarped = warped + ix * (u - u_lin) + iy * (v - v_lin)
    return flow, rewarped
