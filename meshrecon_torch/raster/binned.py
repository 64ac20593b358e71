"""Binned depth rendering: torch-side tile binning and the K1 wrapper.

Port of meshrecon/raster/binned.py (its one-level path,
``render_depth_binned(two_level=False)``):

1. :func:`morton_order` (numpy, on the host) sorts a soup by the Morton code
   of its centroids once per mesh, so 8-triangle chunks stay compact.
2. :func:`pack_records` projects the soup for every camera and packs 16
   float planes per record (affine edge coefficients, vertex z, bbox).
3. :func:`bin_chunks` lists, per screen tile, the chunks whose bbox union
   overlaps it, sorted, with a count.
4. K1 (``csrc/raster.cu``) walks each tile's list, one CTA per 16x16 tile,
   all cameras in one launch.

Unlike the TPU kernel, the records carry the bbox of the pixels a triangle
can cover (:func:`~meshrecon_torch.raster.rasterizer.coverage_bbox`), not of
its vertices, so binning never drops a pixel inside the edge-tie fringe and
K1 equals the plain ``render_depth`` bit for bit. There is no slab split:
the whole soup is binned in one pass.
"""

from __future__ import annotations

import numpy as np
import torch

from meshrecon_torch.kernels._build import Kernel, check_cuda
from meshrecon_torch.raster.rasterizer import (clip_project_planes,
                                               coverage_bbox,
                                               edge_affine_planes,
                                               pixel_grid, render_depth)

TILE = 16   # screen tile edge in pixels: one 256-thread CTA per tile
CHUNK = 8   # records per binned chunk

K1 = Kernel("raster_tiles", "mr_raster_tiles",
            "meshrecon_torch/csrc/raster.cu", "meshrecon/raster/binned.py:119")


def morton_order(soup: np.ndarray) -> np.ndarray:
    """Host-side spatial sort: permutation ordering triangles by the Morton
    code of their centroid (10 bits/axis)."""
    soup = np.asarray(soup)
    cent = soup.mean(axis=1)  # (T, 3)
    lo = cent.min(axis=0)
    span = np.maximum(cent.max(axis=0) - lo, 1e-12)
    q = np.minimum(((cent - lo) / span * 1023.0).astype(np.uint64), 1023)

    def spread(v):
        v = (v | (v << 16)) & np.uint64(0x030000FF)
        v = (v | (v << 8)) & np.uint64(0x0300F00F)
        v = (v | (v << 4)) & np.uint64(0x030C30C3)
        v = (v | (v << 2)) & np.uint64(0x09249249)
        return v

    code = (spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1))
            | (spread(q[:, 2]) << np.uint64(2)))
    return np.argsort(code, kind="stable")


def tile_extents(height: int, width: int, tile_h: int, tile_w: int, device):
    """NDC extents of each tile's pixel sample positions, as the JAX binned
    path computes them: tx0/tx1 (ntx,) left/right, ty0/ty1 (nty,)
    bottom/top. Ragged tiles extend past the image (conservative)."""
    ntx = -(-width // tile_w)
    nty = -(-height // tile_h)
    ax = torch.arange(ntx, dtype=torch.float32, device=device)
    ay = torch.arange(nty, dtype=torch.float32, device=device)
    tx0 = (ax * tile_w - width / 2.0) * (2.0 / width)
    tx1 = ((ax * tile_w + tile_w - 1) - width / 2.0) * (2.0 / width)
    ty1 = (height / 2.0 - ay * tile_h) * (2.0 / height)
    ty0 = (height / 2.0 - (ay * tile_h + tile_h - 1)) * (2.0 / height)
    return tx0, tx1, ty0, ty1


def bin_chunks(xmin, xmax, ymin, ymax, height: int, width: int,
               tile_h: int = TILE, tile_w: int = TILE, chunk: int = CHUNK):
    """Per-tile lists of the chunks whose bbox union overlaps the tile.

    xmin..ymax: (..., R) per-record boxes, R a multiple of ``chunk``.
    Returns (lists, counts): lists (..., nty*ntx, R/chunk) int32 with the
    active chunk ids first, ascending, then the sentinel R/chunk; counts
    (..., nty*ntx) int32. Tiles are row-major (tile row, tile column).
    """
    *lead, r = xmin.shape
    nch = r // chunk
    tx0, tx1, ty0, ty1 = tile_extents(height, width, tile_h, tile_w,
                                      xmin.device)

    def agg(a, op):
        return op(a.reshape(*lead, nch, chunk), dim=-1)

    cxmin = agg(xmin, torch.amin)
    cxmax = agg(xmax, torch.amax)
    cymin = agg(ymin, torch.amin)
    cymax = agg(ymax, torch.amax)
    ax = ((cxmin[..., None, :] <= tx1[:, None])
          & (cxmax[..., None, :] >= tx0[:, None]))  # (..., ntx, nch)
    ay = ((cymin[..., None, :] <= ty1[:, None])
          & (cymax[..., None, :] >= ty0[:, None]))  # (..., nty, nch)
    active = (ay[..., :, None, :] & ax[..., None, :, :]).flatten(-3, -2)
    keys = torch.where(
        active, torch.arange(nch, dtype=torch.int32, device=xmin.device),
        torch.tensor(nch, dtype=torch.int32, device=xmin.device))
    lists = torch.sort(keys, dim=-1).values
    counts = active.sum(dim=-1, dtype=torch.int32)
    return lists, counts


def pack_records(cameras, soup, soup_valid):
    """(N, 16, R) float32 records for K1: a0 b0 c0 a1 b1 c1 a2 b2 c2, z0 z1
    z2, xmin xmax ymin ymax, with R = 2T rounded up to a whole chunk (the
    padding records are invalid)."""
    planes = clip_project_planes(cameras, soup, soup_valid)
    coeffs = edge_affine_planes(*planes)
    ok = planes[10]
    boxes = coverage_bbox(coeffs, ok)
    packed = torch.stack(coeffs + planes[6:9] + boxes, dim=-2)
    pad = (-packed.shape[-1]) % CHUNK
    if pad:
        fill = torch.zeros(packed.shape[:-1] + (pad,), dtype=packed.dtype,
                           device=packed.device)
        fill[..., 2, :] = -1.0                      # c0 = -1: no coverage
        fill[..., 12, :], fill[..., 14, :] = 3e38, 3e38     # inverted box
        fill[..., 13, :], fill[..., 15, :] = -3e38, -3e38
        packed = torch.cat([packed, fill], dim=-1)
    return packed.contiguous()


def render_depth_binned(cameras, soup, soup_valid, height: int, width: int):
    """N depth renders of one soup: cameras (N, 4, 4) -> (N, H, W) float32,
    background 1.0; same per-pixel contract as ``render_depth``.

    CPU tensors take the plain ``render_depth``; CUDA tensors launch K1 once
    for all N cameras. ``soup`` should be Morton-sorted (state.pack_soup);
    an unsorted soup is still right, only slower.
    """
    if not cameras.is_cuda:
        return render_depth(cameras, soup, soup_valid, height, width)
    cameras = cameras.to(torch.float32)
    n = cameras.shape[0]
    packed = pack_records(cameras, soup, soup_valid)
    lists, counts = bin_chunks(packed[:, 12], packed[:, 13], packed[:, 14],
                               packed[:, 15], height, width)
    px, py = pixel_grid(height, width, cameras.device)
    tx0, tx1, ty0, ty1 = tile_extents(height, width, TILE, TILE,
                                      cameras.device)
    out = torch.empty((n, height, width), dtype=torch.float32,
                      device=cameras.device)
    check_cuda("render_depth_binned", packed, px, py, tx0, tx1, ty0, ty1, out)
    check_cuda("render_depth_binned", lists, counts, dtype=torch.int32)
    K1.launch(packed, lists, counts, px, py, tx0, tx1, ty0, ty1, out,
              n, packed.shape[-1], lists.shape[-1], height, width, TILE,
              CHUNK)
    return out
