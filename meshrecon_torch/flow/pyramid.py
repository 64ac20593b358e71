"""Gaussian image pyramids and the pyramid-summed L1 difference.

Port of meshrecon/flow/pyramid.py. Every filter is a 5-tap separable
binomial written as shifted adds (no convolution, so no TF32 on a GPU),
with the reflect-101 borders of ``jnp.pad(mode="reflect")`` including its
repeated reflection when a level is no larger than the pad.
"""

from __future__ import annotations

import torch

# binomial 5-tap kernel, the classic pyramid filter
_K5 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def reflect_index(n: int, pad: int, device) -> torch.Tensor:
    """Source indices of ``numpy.pad(mode="reflect")`` along one axis of
    length n padded by ``pad`` on each side (periodic beyond one
    reflection, index 0 everywhere for n == 1)."""
    i = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    j = torch.remainder(i, period)
    return torch.where(j >= n, period - j, j)


def pad_reflect(img, pad: int, axis: int):
    """Reflect-101 pad of one axis by ``pad`` on both sides."""
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
    """5x5 binomial blur, reflect-101 borders (last two axes)."""
    return _sep5(_sep5(img, img.dim() - 2), img.dim() - 1)


def pyr_down(img):
    """Blur + decimate by 2 (keeps even rows/cols; output ceil(n/2))."""
    return gauss5(img)[..., ::2, ::2]


def pyr_up(img, out_shape):
    """Zero-stuff upsample to ``out_shape``, then blur with the 2x-gain
    kernel (gauss5 * 4)."""
    oh, ow = out_shape
    h, w = img.shape[-2:]
    up = torch.zeros(img.shape[:-2] + (2 * h, 2 * w), dtype=img.dtype,
                     device=img.device)
    up[..., ::2, ::2] = img
    return gauss5(up[..., :oh, :ow]) * 4.0


def compare(prev, next_):
    """Pyramid-cascaded L1 difference (util.cpp:332-361): |prev - next| at
    every pyramid level of the difference, upsampled and summed back to
    full resolution. prev, next_ broadcast; returns float32."""
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
