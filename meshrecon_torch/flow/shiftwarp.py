"""Image warps by shift decomposition (port of meshrecon/flow/shiftwarp.py,
XLA code in the JAX package, so plain torch here).

A warp by a flow of bounded magnitude is a weighted sum of shifted copies
of the edge-padded image:

    warp(img, f)[p] = sum_{d in window} img[p + d] * k(f(p) - d)

with k the bilinear hat or the Keys bicubic kernel (a = -0.75). Flows are
clamped to [-radius, radius] first, so the result equals a gather-based
interpolation only where |f| <= radius. The standalone flow driver uses
the bicubic form for its variance.
"""

from __future__ import annotations

import torch


def _warp_loop(img, fx, fy, radius: int, taps: int, kernel):
    """Sum over the window offsets [-radius - taps/2 + 1, radius + taps/2]
    per axis, row offset outer, column offset inner, as the JAX loop."""
    img = img.to(torch.float32)
    h, w = img.shape
    fx = fx.clamp(-radius, radius)
    fy = fy.clamp(-radius, radius)
    lo = -radius - (taps // 2 - 1)
    hi = radius + taps // 2
    pad = max(-lo, hi)
    rows = (torch.arange(h + 2 * pad, device=img.device) - pad).clamp(0, h - 1)
    cols = (torch.arange(w + 2 * pad, device=img.device) - pad).clamp(0, w - 1)
    p = img[rows][:, cols]  # edge padding
    out = torch.zeros_like(img)
    for dy in range(lo, hi + 1):
        wy = kernel(fy - float(dy))
        for dx in range(lo, hi + 1):
            shifted = p[pad + dy: pad + dy + h, pad + dx: pad + dx + w]
            out = out + shifted * (wy * kernel(fx - float(dx)))
    return out


def _hat(t):
    return torch.clamp(1.0 - t.abs(), min=0.0)


def _cubic_kernel(t, a=-0.75):
    """Keys bicubic kernel (OpenCV's a = -0.75) at |t|."""
    at = t.abs()
    at2 = at * at
    at3 = at2 * at
    w1 = (a + 2.0) * at3 - (a + 3.0) * at2 + 1.0
    w2 = a * at3 - 5.0 * a * at2 + 8.0 * a * at - 4.0 * a
    return torch.where(at <= 1.0, w1, torch.where(at < 2.0, w2, 0.0))


def shift_warp_bilinear(img, fx, fy, radius: int = 6):
    """out[p] = the bilinear sample of img at p + (fx, fy) for |f| <= radius."""
    return _warp_loop(img, fx, fy, radius, 2, _hat)


def shift_warp_bicubic(img, fx, fy, radius: int = 6):
    """The bicubic (a = -0.75) warp, exact for |f| <= radius."""
    return _warp_loop(img, fx, fy, radius, 4, _cubic_kernel)
