"""Gather kernels for resampling image stacks: K2, K3, K3b and K3c wrappers.

Port of the meshrecon/flow/tile_warp.py entry points on the
reconstruction's paths. On a TPU those kernels fit a per-tile integer base
offset and enumerate bounded residual taps because gathers are slow there;
their coordinate preparation, vertical stacking, guard bands, invalid-pixel
rewrites and dead-tile sentinels are not ported. On Hopper a gather is
cheap, so K2, K3, K3b and K3c (``csrc/warp.cu``) are plain per-pixel
gathers that compute exactly what the XLA twins compute, with no residual
budget to clamp.

- :func:`tile_warp_sample2_batched` (K2): nearest (or, with
  ``bilinear_a``, bilinear) sample of source A and bilinear sample of
  source B at one coordinate field. Plain version:
  ``raster.fragment.nearest_sample`` / ``bilinear_sample``.
- :func:`tile_warp_flow_batched`: warp of a stack by a flow field, K3 with
  taps=2 (bilinear; plain version ``flow.remap.bilinear_warp``) and K3b
  with taps=4 (Keys bicubic; plain version ``flow.remap.flow_remap``). K3b
  runs two pixels a thread, 32 columns apart, on K3's 3-D grid; a warp
  whose pixels' 4x4 tap windows all lie inside the image reads them with
  no clamp, any other warp clamps each tap (:func:`bicubic_warp_paths`
  mirrors that choice; :func:`warp_bicubic_paths` counts it on the card).
- :func:`tile_warp_bicubic`: K3b's absolute-coordinate form.

- :func:`tile_warp_sample_batched` (K3c, the valid-mask form): bilinear
  sample of a stack at absolute coordinates, exactly 0.0 where the mask is
  false (the plane sweep's per-plane resample). Plain version:
  :func:`sample_bilinear_masked_plain`.

K2 samples full sources at a band's coordinates (its output plane apart
from its source plane), and K3 and K3b warp a band of rows of a taller
image from the source rows around it (``row0``, ``height``,
``src_row0``): the tile axis (``sharding/tiles.py``) runs them on its
bands, bit for bit the whole frame's rows.
"""

from __future__ import annotations

import torch

from meshrecon_torch.kernels._build import (Kernel, check_cuda, check_like,
                                            library)

K2 = Kernel("sample_shadow_frame", "mr_sample_shadow_frame",
            "meshrecon_torch/csrc/warp.cu", "meshrecon/flow/tile_warp.py:256")
K3 = Kernel("warp_bilinear", "mr_warp_bilinear",
            "meshrecon_torch/csrc/warp.cu", "meshrecon/flow/tile_warp.py:97")
K3C = Kernel("sample_bilinear_masked", "mr_sample_bilinear_masked",
             "meshrecon_torch/csrc/warp.cu",
             "meshrecon/flow/tile_warp.py:97 (valid mask)")
K3B = Kernel("warp_bicubic", "mr_warp_bicubic",
             "meshrecon_torch/csrc/warp.cu",
             "meshrecon/flow/tile_warp.py:97 (taps=4)")

# K3b's geometry (csrc/warp.cu, mr_warp_bicubic_shape): threads across a
# row, rows a CTA, pixels a thread (K3B_COLS columns apart)
K3B_COLS, K3B_ROWS, K3B_PIX = 32, 8, 2


def _cubic_origin(x, n: int):
    """K3b's tap origin: floor(x) clamped to [-3, n + 2] as a float (NaN
    maps to -3, as C's fmaxf gives), then to int."""
    return torch.nan_to_num(torch.floor(x), nan=-3.0).clamp(
        -3.0, n + 2.0).to(torch.int64)


def bicubic_warp_paths(u, v):
    """Which warps of K3b read their taps with no clamp, as the kernel
    decides: a warp takes ``K3B_COLS * K3B_PIX`` consecutive columns of one
    row (lanes past the last column sample it), and reads unclamped when
    every one of its pixels' 4x4 windows, at origin (c0 - 1, r0 - 1), lies
    inside the image. u, v: (..., H, W) float32. Returns a bool tensor
    (..., H, ceil(W / span))."""
    h, w = u.shape[-2:]
    cols = torch.arange(w, dtype=torch.float32, device=u.device)
    rows = torch.arange(h, dtype=torch.float32, device=u.device)[:, None]
    c0 = _cubic_origin(cols + u, w)
    r0 = _cubic_origin(rows + v, h)
    inside = (c0 >= 1) & (c0 <= w - 3) & (r0 >= 1) & (r0 <= h - 3)
    span = K3B_COLS * K3B_PIX
    blocks = -(-w // span)
    lanes = torch.arange(blocks * span, device=u.device).clamp(max=w - 1)
    return inside[..., lanes].reshape(*inside.shape[:-1], blocks,
                                      span).all(-1)


def warp_bicubic_paths(images, u, v):
    """K3b on CUDA tensors through its counting entry
    (``mr_warp_bicubic_paths``, ctypes): (out, the warps that read their
    taps unclamped). A check of the path split; it is not a launch of the
    port's path and leaves ``K3B.launches`` alone."""
    check_like("warp_bicubic_paths", images, u, v)
    h, w = images.shape[-2:]
    out = torch.empty_like(images)
    count = torch.zeros(1, dtype=torch.int32, device=images.device)
    code = library().cdll.mr_warp_bicubic_paths(
        images.data_ptr(), u.data_ptr(), v.data_ptr(), out.data_ptr(),
        count.data_ptr(), images.numel() // (h * w), h, w,
        torch.cuda.current_stream(images.device).cuda_stream)
    if code:
        raise RuntimeError(f"mr_warp_bicubic_paths: CUDA error {code}")
    return out, int(count.item())


def tile_warp_sample2_batched(srcs_a, srcs_b, scols, srows,
                              bilinear_a: bool = False):
    """Sample two (N, H, W) stacks at one coordinate field (N, R, W), R any
    count of rows (H for the whole frame, a band's): A nearest (rounding
    half up) or, with ``bilinear_a``, bilinear (the TPU kernel's
    ``nearest_a=False``); B bilinear; all border-clamped.
    Returns (out_a, out_b), each (N, R, W) float32."""
    if not srcs_a.is_cuda:
        from meshrecon_torch.raster.fragment import (bilinear_sample,
                                                     nearest_sample)

        sample_a = bilinear_sample if bilinear_a else nearest_sample
        return (sample_a(srcs_a, scols, srows),
                bilinear_sample(srcs_b, scols, srows))
    check_like("tile_warp_sample2_batched", srcs_a, srcs_b)
    check_like("tile_warp_sample2_batched", scols, srows)
    n, h, w = srcs_a.shape
    if scols.dim() != 3 or scols.shape[0] != n or scols.shape[2] != w \
            or scols.device != srcs_a.device:
        raise ValueError(f"tile_warp_sample2_batched: coordinates "
                         f"{tuple(scols.shape)} on {scols.device} for "
                         f"sources {tuple(srcs_a.shape)} on {srcs_a.device}")
    out_a = torch.empty_like(scols)
    out_b = torch.empty_like(scols)
    K2.launch(srcs_a, srcs_b, scols, srows, out_a, out_b,
              1 if bilinear_a else 0, n, h, w, scols.shape[1])
    return out_a, out_b


def tile_warp_flow_batched(images, u, v, taps: int = 2, *, row0: int = 0,
                           height=None, src_row0: int = 0):
    """Warp: out[..., r, c] = images(c + u, r + v), border-clamped;
    bilinear (taps=2, K3) or Keys bicubic (taps=4, K3b).
    images, u, v: (..., H, W) float32 of one shape.

    A band: u, v hold rows [row0, row0 + hb) of an image of ``height``
    rows, ``images`` its rows [src_row0, src_row0 + hs), which must hold
    every tap the samples read; the leading shape and W are shared, and
    out is (..., hb, W)."""
    if taps not in (2, 4):
        raise ValueError(f"taps must be 2 or 4: {taps}")
    hb, w = u.shape[-2:]
    hs = images.shape[-2]
    height = hs if height is None else height
    if not (images.shape[:-2] == u.shape[:-2] and images.shape[-1] == w
            and 0 <= row0 and row0 + hb <= height and 0 <= src_row0
            and src_row0 + hs <= height):
        raise ValueError(f"tile_warp_flow_batched: images "
                         f"{tuple(images.shape)} from row {src_row0}, flow "
                         f"{tuple(u.shape)} from row {row0}, of {height} "
                         "rows")
    band = dict(row0=row0, height=height, src_row0=src_row0)
    if not images.is_cuda:
        from meshrecon_torch.flow.remap import bilinear_warp, flow_remap

        flow = torch.stack([u, v], dim=-1)
        if taps == 4:
            return flow_remap(flow, images, **band)
        return bilinear_warp(images, flow, **band)
    check_like("tile_warp_flow_batched", u, v)
    check_cuda("tile_warp_flow_batched", images, u)
    out = torch.empty_like(u)
    (K3B if taps == 4 else K3).launch(images, u, v, out, u.numel() // (hb * w),
                                      hb, w, row0, height, src_row0, hs)
    return out


def tile_warp_bicubic(src, scol, srow):
    """Keys bicubic (a = -0.75) sample of a (..., H, W) stack at absolute
    coordinates (scol, srow) of its shape: K3b on the flow
    ``(scol - col, srow - row)``. Plain version: ``remap.bicubic_sample``
    (up to the rounding of that difference)."""
    h, w = src.shape[-2:]
    cols = torch.arange(w, dtype=torch.float32, device=src.device)
    rows = torch.arange(h, dtype=torch.float32, device=src.device)[:, None]
    return tile_warp_flow_batched(src.contiguous(),
                                  (scol - cols).contiguous(),
                                  (srow - rows).contiguous(), taps=4)


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
