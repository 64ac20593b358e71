"""Gather kernels for resampling image stacks: the K2 and K3 wrappers.

Port of the two meshrecon/flow/tile_warp.py entry points on the fused
update's path. On a TPU those kernels fit a per-tile integer base offset
and enumerate bounded residual taps because gathers are slow there; their
coordinate preparation, vertical stacking and guard bands are not ported.
On Hopper a gather is cheap, so K2 and K3 (``csrc/warp.cu``) are plain
per-pixel gathers that compute exactly what the XLA twins compute, with no
residual budget to clamp.

- :func:`tile_warp_sample2_batched` (K2): nearest sample of source A and
  bilinear sample of source B at one coordinate field. Plain version:
  ``raster.fragment.nearest_sample`` / ``bilinear_sample``.
- :func:`tile_warp_flow_batched` (K3, taps=2): bilinear warp of a stack by
  a flow field. Plain version: ``flow.remap.bilinear_warp``.
"""

from __future__ import annotations

import torch

from meshrecon_torch.kernels._build import Kernel, check_cuda

K2 = Kernel("sample_shadow_frame", "mr_sample_shadow_frame",
            "meshrecon_torch/csrc/warp.cu", "meshrecon/flow/tile_warp.py:256")
K3 = Kernel("warp_bilinear", "mr_warp_bilinear",
            "meshrecon_torch/csrc/warp.cu", "meshrecon/flow/tile_warp.py:97")


def tile_warp_sample2_batched(srcs_a, srcs_b, scols, srows):
    """Sample two (N, H, W) stacks at one coordinate field (N, H, W): A
    nearest (rounding half up), B bilinear, both border-clamped.
    Returns (out_a, out_b), each (N, H, W) float32."""
    if not srcs_a.is_cuda:
        from meshrecon_torch.raster.fragment import (bilinear_sample,
                                                     nearest_sample)

        return (nearest_sample(srcs_a, scols, srows),
                bilinear_sample(srcs_b, scols, srows))
    n, h, w = srcs_a.shape
    for t in (srcs_b, scols, srows):
        if t.shape != srcs_a.shape:
            raise ValueError(f"shape {tuple(t.shape)} != {tuple(srcs_a.shape)}")
    out_a = torch.empty_like(srcs_a)
    out_b = torch.empty_like(srcs_b)
    check_cuda("tile_warp_sample2_batched", srcs_a, srcs_b, scols, srows,
               out_a, out_b)
    K2.launch(srcs_a, srcs_b, scols, srows, out_a, out_b, n, h, w)
    return out_a, out_b


def tile_warp_flow_batched(images, u, v):
    """Bilinear warp: out[..., r, c] = images(c + u, r + v), border-clamped.
    images, u, v: (..., H, W) float32 of one shape."""
    if not images.is_cuda:
        from meshrecon_torch.flow.remap import bilinear_warp

        return bilinear_warp(images, torch.stack([u, v], dim=-1))
    if u.shape != images.shape or v.shape != images.shape:
        raise ValueError(f"flow {tuple(u.shape)}/{tuple(v.shape)} != image "
                         f"{tuple(images.shape)}")
    h, w = images.shape[-2:]
    n = images.numel() // (h * w)
    out = torch.empty_like(images)
    check_cuda("tile_warp_flow_batched", images, u, v, out)
    K3.launch(images, u, v, out, n, h, w)
    return out
