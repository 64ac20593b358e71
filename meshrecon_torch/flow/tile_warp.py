"""Gather kernels for resampling image stacks: K2, K3 and K3c wrappers.

Port of the three meshrecon/flow/tile_warp.py entry points on the default
reconstruction's path. On a TPU those kernels fit a per-tile integer base
offset and enumerate bounded residual taps because gathers are slow there;
their coordinate preparation, vertical stacking, guard bands, invalid-pixel
rewrites and dead-tile sentinels are not ported. On Hopper a gather is
cheap, so K2, K3 and K3c (``csrc/warp.cu``) are plain per-pixel gathers
that compute exactly what the XLA twins compute, with no residual budget
to clamp.

- :func:`tile_warp_sample2_batched` (K2): nearest sample of source A and
  bilinear sample of source B at one coordinate field. Plain version:
  ``raster.fragment.nearest_sample`` / ``bilinear_sample``.
- :func:`tile_warp_flow_batched` (K3, taps=2): bilinear warp of a stack by
  a flow field. Plain version: ``flow.remap.bilinear_warp``.
- :func:`tile_warp_sample_batched` (K3c, the valid-mask form): bilinear
  sample of a stack at absolute coordinates, exactly 0.0 where the mask is
  false (the plane sweep's per-plane resample). Plain version:
  :func:`sample_bilinear_masked_plain`.
"""

from __future__ import annotations

import torch

from meshrecon_torch.kernels._build import Kernel, check_cuda

K2 = Kernel("sample_shadow_frame", "mr_sample_shadow_frame",
            "meshrecon_torch/csrc/warp.cu", "meshrecon/flow/tile_warp.py:256")
K3 = Kernel("warp_bilinear", "mr_warp_bilinear",
            "meshrecon_torch/csrc/warp.cu", "meshrecon/flow/tile_warp.py:97")
K3C = Kernel("sample_bilinear_masked", "mr_sample_bilinear_masked",
             "meshrecon_torch/csrc/warp.cu",
             "meshrecon/flow/tile_warp.py:97 (valid mask)")


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


def sample_bilinear_masked_plain(srcs, scols, srows, valid):
    """The plain version of K3c: ``bilinear_sample`` where valid, else 0."""
    from meshrecon_torch.raster.fragment import bilinear_sample

    return torch.where(valid, bilinear_sample(srcs, scols, srows), 0.0)


def tile_warp_sample_batched(srcs, scols, srows, valid):
    """Bilinear sample of a (..., H, W) stack at absolute coordinates
    (scols, srows) of the same shape, border-clamped; pixels where the bool
    mask ``valid`` is false come out as 0.0. Returns (..., H, W) float32."""
    if not srcs.is_cuda:
        return sample_bilinear_masked_plain(srcs, scols, srows, valid)
    for t in (scols, srows, valid):
        if t.shape != srcs.shape:
            raise ValueError(f"shape {tuple(t.shape)} != {tuple(srcs.shape)}")
    h, w = srcs.shape[-2:]
    n = srcs.numel() // (h * w)
    out = torch.empty_like(srcs)
    check_cuda("tile_warp_sample_batched", srcs, scols, srows, out)
    check_cuda("tile_warp_sample_batched", valid, dtype=torch.bool)
    if valid.device != srcs.device:
        raise ValueError(f"tile_warp_sample_batched: mask on {valid.device}, "
                         f"expected {srcs.device}")
    K3C.launch(srcs, scols, srows, valid, out, n, h, w)
    return out
