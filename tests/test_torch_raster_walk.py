"""The coverage walk of K1 and K5 (meshrecon_torch/csrc/raster.cu), modelled
in torch on the CPU.

The kernels cull each candidate record once per tile (its box against the
tile's sample extents), compact the survivors in list order, then cull
them once per warp (the box against the sample extents of the warp's 8x4
footprint) and run the coverage test only on what is left.
``_model_walk`` does the same, tile by tile and footprint by footprint,
with the plain render's arithmetic: it must equal ``render_depth`` bit for
bit, on the scenes and chunk / superchunk cases of test_torch_binned2.py's
walk test and on ragged screens, and its counts must be the sweep tool's
``walk_counts``. The premise of both culls is held apart: the tile and
footprint extents are the samples of their first and last pixels.
"""

import numpy as np
import pytest
import torch

import __graft_entry__ as g
from meshrecon_torch.raster import binned as tbinned
from meshrecon_torch.raster import rasterizer as tr
from meshrecon_torch.tools import raster_sweep
from tests.test_torch_raster import _scene, _t

torch.set_num_threads(1)

TILE = tbinned.TILE
FOOT_W, FOOT_H = 8, 4  # a warp's footprint: 2 across and 4 down a tile


def _footprints(tx, ty, h, w):
    """(warp, c0, r0) of each footprint of tile (tx, ty) that has a pixel
    in the image."""
    for warp in range(TILE * TILE // 32):
        c0 = tx * TILE + (warp % (TILE // FOOT_W)) * FOOT_W
        r0 = ty * TILE + (warp // (TILE // FOOT_W)) * FOOT_H
        if c0 < w and r0 < h:
            yield warp, c0, r0


def _model_walk(bins):
    """The kernels' walk on ``bins``: (depth (N, H, W), counts)."""
    packed, lists, counts = bins["packed"], bins["lists"], bins["counts"]
    h, w, chunk, supers = (bins[k] for k in ("height", "width", "chunk",
                                             "supers"))
    px, py = bins["grid"]
    tx0, tx1, ty0, ty1 = bins["tiles"]
    zbuf = torch.full((packed.shape[0], h, w), float("inf"))
    n = dict(records=0, tile_hits=0, warp_hits=0, longest_walk=0,
             longest_warp=0)
    for cam in range(packed.shape[0]):
        for t in range(lists.shape[1]):
            ty, tx = divmod(t, len(tx0))
            ids = lists[cam, t, :counts[cam, t]].long()
            if bins["cbox"] is not None:
                ids = (ids[:, None] * supers + torch.arange(supers)).flatten()
                cb = bins["cbox"][cam][:, ids]
                ids = ids[(cb[0] <= tx1[tx]) & (cb[1] >= tx0[tx])
                          & (cb[2] <= ty1[ty]) & (cb[3] >= ty0[ty])]
            f = packed[cam][:, (ids[:, None] * chunk
                                + torch.arange(chunk)).flatten()]
            n["records"] += f.shape[1]
            n["longest_walk"] = max(n["longest_walk"], f.shape[1])
            # the tile cull; a boolean mask keeps list order (compaction)
            f = f[:, (f[12] <= tx1[tx]) & (f[13] >= tx0[tx])
                  & (f[14] <= ty1[ty]) & (f[15] >= ty0[ty])]
            n["tile_hits"] += f.shape[1]
            for _, c0, r0 in _footprints(tx, ty, h, w):
                cols = torch.arange(c0, c0 + FOOT_W)
                rows = torch.arange(r0, r0 + FOOT_H)
                x = px[cols.clamp(max=w - 1)]
                y = py[rows.clamp(max=h - 1)]
                # the warp cull against the footprint's sample extents
                keep = ((f[12] <= x[-1]) & (f[13] >= x[0])
                        & (f[14] <= y[0]) & (f[15] >= y[-1]))
                n["warp_hits"] += int(keep.sum())
                n["longest_warp"] = max(n["longest_warp"], int(keep.sum()))
                if not keep.any():
                    continue
                a0, b0, c0_, a1, b1, c1, a2, b2, c2, z0, z1, z2 = (
                    v[:, None, None] for v in f[:12, keep])
                xx, yy = x[None, None, :], y[None, :, None]
                l0 = a0 * xx + b0 * yy + c0_
                l1 = a1 * xx + b1 * yy + c1
                l2 = a2 * xx + b2 * yy + c2
                zs = l0 * z0 + l1 * z1 + l2 * z2
                covered = ((l0 >= 0) & (l1 >= 0) & (l2 >= 0)
                           & (zs >= -1.0) & (zs <= 1.0))
                z = torch.where(covered, zs, float("inf")).amin(0)
                inside = (rows < h)[:, None] & (cols < w)[None, :]
                rr, cc = torch.nonzero(inside, as_tuple=True)
                zbuf[cam, rows[rr], cols[cc]] = z[rr, cc]
    return torch.where(torch.isfinite(zbuf), zbuf, 1.0), n


@pytest.mark.parametrize("scene,chunk,two_level,supers,size", [
    ("near_straddle", 8, True, 8, None), ("near_straddle", 16, True, 3, None),
    ("random_sorted", 64, True, 8, None), ("random_sorted", 16, True, 1, None),
    ("morton_sphere", 8, True, 8, None), ("morton_sphere", 32, True, 2, None),
    ("random_sorted", 16, False, 8, None),
    ("morton_sphere", 64, False, 8, None), ("shared_edge", 8, True, 8, None),
    ("morton_sphere", 8, False, 8, (50, 70)),
    ("random_sorted", 16, True, 8, (37, 53))])
def test_walk_model_equals_plain_render(scene, chunk, two_level, supers,
                                        size):
    """Tile cull, compaction and footprint cull drop no covering record:
    the model equals the plain render bit for bit, for soups that are not a
    whole number of chunks or superchunks and on ragged screens too; its
    counts are ``walk_counts``'."""
    cam, soup, valid, h, w = _scene(scene)
    h, w = size or (h, w)
    cams = _t(np.stack([cam, g._make_camera(eye=(0.2, -0.1, 0.3))]))
    bins = tbinned.bin_soup(cams, _t(soup), _t(valid), h, w, chunk,
                            two_level, supers)
    ref = tr.render_depth(cams, _t(soup), _t(valid), h, w)
    assert (ref < 1.0).any()
    out, counts = _model_walk(bins)
    assert torch.equal(out, ref)
    got = raster_sweep.walk_counts(bins)
    for key, value in counts.items():
        assert got[key] == value, key
    assert got["coverage_tests"] == 32 * counts["warp_hits"]
    assert got["first_design_tests"] == 256 * counts["tile_hits"]
    # both culls bite on these scenes
    assert counts["tile_hits"] < counts["records"]
    assert counts["warp_hits"] < 8 * counts["tile_hits"]


@pytest.mark.parametrize("h,w", [(48, 64), (37, 53), (480, 640), (17, 1)])
def test_tile_extents_are_first_and_last_pixel_samples(h, w):
    """``_screen``'s tile extents are the samples of each tile's first and
    last pixel (pixel_grid's formula past the image for a ragged tile,
    which is then wider than its pixels: conservative)."""
    (px, py), (tx0, tx1, ty0, ty1) = tbinned._screen(h, w,
                                                     torch.device("cpu"))
    ntx, nty = -(-w // TILE), -(-h // TILE)
    # pixel_grid's formula on indices past the image
    cols = (torch.arange(ntx * TILE, dtype=torch.float32) - w / 2.0) * (
        2.0 / w)
    rows = (h / 2.0 - torch.arange(nty * TILE, dtype=torch.float32)) * (
        2.0 / h)
    assert torch.equal(cols[:w], px) and torch.equal(rows[:h], py)
    first, last = torch.arange(0, ntx * TILE, TILE), torch.arange(
        TILE - 1, ntx * TILE, TILE)
    assert torch.equal(tx0, cols[first]) and torch.equal(tx1, cols[last])
    first, last = torch.arange(0, nty * TILE, TILE), torch.arange(
        TILE - 1, nty * TILE, TILE)
    assert torch.equal(ty1, rows[first]) and torch.equal(ty0, rows[last])
    # each tile's extents hold the samples of its pixels in the image
    for tx in range(ntx):
        x = px[tx * TILE:(tx + 1) * TILE]
        assert tx0[tx] <= x.min() and x.max() <= tx1[tx]
    for ty in range(nty):
        y = py[ty * TILE:(ty + 1) * TILE]
        assert ty0[ty] <= y.min() and y.max() <= ty1[ty]


@pytest.mark.parametrize("h,w", [(48, 64), (37, 53)])
def test_footprint_extents_are_their_pixels_samples(h, w):
    """The sweep tool's footprint extents (the kernels': their first and
    last lanes' samples) are the extremes of each warp's clamped pixel
    samples, inside its tile's extents; footprints past a ragged edge have
    no pixel in the image."""
    (px, py), (tx0, tx1, ty0, ty1) = tbinned._screen(h, w,
                                                     torch.device("cpu"))
    ntx, nty = len(tx0), len(ty0)
    tile_x = torch.arange(ntx).repeat(nty)
    tile_y = torch.arange(nty).repeat_interleave(ntx)
    (x_lo, x_hi, y_lo, y_hi), inside = raster_sweep.footprint_extents(
        tile_x, tile_y, (px, py))
    for t in range(ntx * nty):
        tx, ty = int(tile_x[t]), int(tile_y[t])
        feet = list(_footprints(tx, ty, h, w))
        assert int(inside[t].sum()) == len(feet)
        for warp, c0, r0 in feet:
            x = px[torch.arange(c0, c0 + FOOT_W).clamp(max=w - 1)]
            y = py[torch.arange(r0, r0 + FOOT_H).clamp(max=h - 1)]
            assert inside[t, warp]
            assert x_lo[t, warp] == x.min() and x_hi[t, warp] == x.max()
            assert y_lo[t, warp] == y.min() and y_hi[t, warp] == y.max()
            assert tx0[tx] <= x_lo[t, warp] and x_hi[t, warp] <= tx1[tx]
            assert ty0[ty] <= y_lo[t, warp] and y_hi[t, warp] <= ty1[ty]
