"""Binned depth rendering: the tile binning and the K1 / K5 wrappers.

Port of meshrecon/raster/binned.py, both of its paths:

1. :func:`morton_order` (numpy, on the host) sorts a soup by the Morton code
   of its centroids once per mesh, so chunks of consecutive records stay
   compact.
2. :func:`setup_records` projects the soup for every camera and packs 16
   float planes per record (affine edge coefficients, vertex z, bbox), and
   the bbox union of each chunk of records.
3. One level (``render_depth_binned``): :func:`tile_lists` lists, per screen
   tile, the chunks whose bbox union overlaps it, and K1
   (``csrc/raster.cu``) walks each tile's list.
4. Two levels (``render_depth_binned(two_level=True)``,
   ``render_depth_binned_batched``): :func:`tile_lists` lists, per tile,
   the superchunks (``supers`` chunks each) whose bbox union overlaps it,
   and K5 tests each listed chunk's bbox against the tile before it stages
   the chunk's records.

On CUDA tensors the binning (:func:`bin_soup`) is two hand-written kernels
(``csrc/raster_setup.cu``): SETUP, a thread per triangle, and BIN, clusters
of CTAs that build each camera's coarse level (the union of each run of 32
groups) once and walk its tiles against it, compacting their hits with
ballots, so a render is three launches. Their plain versions, :func:`pack_records`,
:func:`bin_chunks` and :func:`bin_superchunks` (torch ops), run on CPU
tensors, and the kernels equal them bit for bit.

Both raster kernels run one CTA per 16x16 tile and all cameras in one
launch. K1 also renders a window of rows (``rows=(r0, r1)``, a band of a
tile group, ``sharding/tiles.py``): the binning still lists every tile,
and only the tiles that meet the window launch, at their global places, so
the window's rows equal the whole render's bit for bit. Unlike the TPU kernels, the records carry the bbox of the pixels a
triangle can cover (:func:`~meshrecon_torch.raster.rasterizer.coverage_bbox`),
not of its vertices, so binning never drops a pixel inside the edge-tie
fringe and the kernels equal the plain ``render_depth`` bit for bit. There
is no slab split: the whole soup is binned in one pass, padded with invalid
records to a whole number of chunks (of superchunks with two levels).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from meshrecon_torch.kernels._build import Kernel, check_cuda
from meshrecon_torch.raster.rasterizer import (clip_project_planes,
                                               coverage_bbox,
                                               edge_affine_planes,
                                               pixel_grid, render_depth)

TILE = 16   # screen tile edge in pixels: one 256-thread CTA per tile
CHUNK = 8   # records per binned chunk
CHUNKS = (8, 16, 32, 64)  # the chunk sizes the kernels take
SUPERS = 8  # chunks per superchunk of the two-level lists

K1 = Kernel("raster_tiles", "mr_raster_tiles",
            "meshrecon_torch/csrc/raster.cu", "meshrecon/raster/binned.py:119")
# one entry point serves both two-level kernels; each keeps its own count
K5A = Kernel("raster_tiles2", "mr_raster_tiles2",
             "meshrecon_torch/csrc/raster.cu",
             "meshrecon/raster/binned.py:242")
K5B = Kernel("raster_tiles2_batched", "mr_raster_tiles2",
             "meshrecon_torch/csrc/raster.cu",
             "meshrecon/raster/binned.py:259")
# the binning: XLA code and a sort on the TPU, feeding its raster kernels
SETUP = Kernel("raster_setup", "mr_raster_setup",
               "meshrecon_torch/csrc/raster_setup.cu",
               "meshrecon/raster/rasterizer.py:129,241 (XLA setup feeding "
               "binned.py:119)")
BIN = Kernel("raster_bin", "mr_raster_bin",
             "meshrecon_torch/csrc/raster_setup.cu",
             "meshrecon/raster/binned.py:597,612 (jnp.sort tile lists)")


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


@functools.lru_cache(maxsize=None)
def _screen(height: int, width: int, device: torch.device):
    """``pixel_grid`` and ``tile_extents`` (TILE) of a render, made once per
    (height, width, device)."""
    return (pixel_grid(height, width, device),
            tile_extents(height, width, TILE, TILE, device))


def _group_boxes(xmin, xmax, ymin, ymax, size: int):
    """Bbox unions of consecutive groups of ``size`` along the last axis."""
    *lead, r = xmin.shape

    def agg(a, op):
        return op(a.reshape(*lead, r // size, size), dim=-1)

    return (agg(xmin, torch.amin), agg(xmax, torch.amax),
            agg(ymin, torch.amin), agg(ymax, torch.amax))


def _tile_keys(gxmin, gxmax, gymin, gymax, height, width, tile_h, tile_w):
    """(keys, active): per tile and group, the group's id where its box
    overlaps the tile, else the sentinel (the group count); and the
    overlaps."""
    n = gxmin.shape[-1]
    tx0, tx1, ty0, ty1 = tile_extents(height, width, tile_h, tile_w,
                                      gxmin.device)
    ax = ((gxmin[..., None, :] <= tx1[:, None])
          & (gxmax[..., None, :] >= tx0[:, None]))  # (..., ntx, n)
    ay = ((gymin[..., None, :] <= ty1[:, None])
          & (gymax[..., None, :] >= ty0[:, None]))  # (..., nty, n)
    active = (ay[..., :, None, :] & ax[..., None, :, :]).flatten(-3, -2)
    keys = torch.where(
        active, torch.arange(n, dtype=torch.int32, device=gxmin.device),
        torch.tensor(n, dtype=torch.int32, device=gxmin.device))
    return keys, active


def _tile_lists(gxmin, gxmax, gymin, gymax, height, width, tile_h, tile_w):
    """Per-tile sorted lists of the groups whose box overlaps the tile,
    then the sentinel (the group count), and the counts."""
    keys, active = _tile_keys(gxmin, gxmax, gymin, gymax, height, width,
                              tile_h, tile_w)
    lists = torch.sort(keys, dim=-1).values
    counts = active.sum(dim=-1, dtype=torch.int32)
    return lists, counts


def bin_chunks(xmin, xmax, ymin, ymax, height: int, width: int,
               tile_h: int = TILE, tile_w: int = TILE, chunk: int = CHUNK):
    """Per-tile lists of the chunks whose bbox union overlaps the tile.

    xmin..ymax: (..., R) per-record boxes, R a multiple of ``chunk``.
    Returns (lists, counts): lists (..., nty*ntx, R/chunk) int32 with the
    active chunk ids first, ascending, then the sentinel R/chunk; counts
    (..., nty*ntx) int32. Tiles are row-major (tile row, tile column).
    """
    boxes = _group_boxes(xmin, xmax, ymin, ymax, chunk)
    return _tile_lists(*boxes, height, width, tile_h, tile_w)


def bin_superchunks(xmin, xmax, ymin, ymax, height: int, width: int,
                    tile_h: int = TILE, tile_w: int = TILE,
                    chunk: int = CHUNK, supers: int = SUPERS):
    """Two-level binning: per-chunk bbox unions, and per-tile lists of the
    superchunks (``supers`` consecutive chunks) whose union overlaps the
    tile.

    xmin..ymax: (..., R) per-record boxes, R a multiple of chunk * supers.
    Returns ((cxmin, cxmax, cymin, cymax), lists, counts): the chunk boxes
    (..., R/chunk) float32; lists (..., nty*ntx, nsup) int32 with the active
    superchunk ids first, ascending, then the sentinel nsup = R/(chunk *
    supers); counts (..., nty*ntx) int32.
    """
    cboxes = _group_boxes(xmin, xmax, ymin, ymax, chunk)
    sboxes = _group_boxes(*cboxes, supers)
    return (cboxes, *_tile_lists(*sboxes, height, width, tile_h, tile_w))


def pack_records(cameras, soup, soup_valid, multiple: int = CHUNK):
    """(N, 16, R) float32 records: a0 b0 c0 a1 b1 c1 a2 b2 c2, z0 z1 z2,
    xmin xmax ymin ymax, with R = 2T rounded up to a multiple of
    ``multiple`` (the padding records are invalid)."""
    planes = clip_project_planes(cameras, soup, soup_valid)
    coeffs = edge_affine_planes(*planes)
    ok = planes[10]
    boxes = coverage_bbox(coeffs, ok)
    packed = torch.stack(coeffs + planes[6:9] + boxes, dim=-2)
    pad = (-packed.shape[-1]) % multiple
    if pad:
        fill = torch.zeros(packed.shape[:-1] + (pad,), dtype=packed.dtype,
                           device=packed.device)
        fill[..., 2, :] = -1.0                      # c0 = -1: no coverage
        fill[..., 12, :], fill[..., 14, :] = 3e38, 3e38     # inverted box
        fill[..., 13, :], fill[..., 15, :] = -3e38, -3e38
        packed = torch.cat([packed, fill], dim=-1)
    return packed.contiguous()


def _check_args(chunk: int, supers: int) -> None:
    if chunk not in CHUNKS:
        raise ValueError(f"chunk must be one of {CHUNKS} (got {chunk})")
    if supers < 1:
        raise ValueError(f"supers must be >= 1 (got {supers})")


def _on_cpu(name, cameras, soup, soup_valid) -> bool:
    """True when every input lies on the CPU (the plain version's case);
    False when all lie on one CUDA device as the kernels take them; raises
    on anything else, a mix of devices included."""
    if all(t.device.type == "cpu" for t in (cameras, soup, soup_valid)):
        return True
    check_cuda(name, cameras, soup)
    check_cuda(name, soup_valid, dtype=torch.bool)
    return False


def setup_records(cameras, soup, soup_valid, multiple: int = CHUNK,
                  chunk: int = CHUNK):
    """The triangle setup: ``packed`` (N, 16, R) as :func:`pack_records`
    gives it (R = 2T rounded up to a multiple of ``multiple``, itself a
    multiple of ``chunk``), and the bbox union of each chunk of ``chunk``
    records, ``cbox`` (N, 4, R / chunk) float32 (xmin, xmax, ymin, ymax).

    CUDA tensors launch SETUP; CPU tensors take the plain version,
    :func:`pack_records` and :func:`_group_boxes`."""
    if chunk not in CHUNKS or multiple < 1 or multiple % chunk:
        raise ValueError(f"setup_records: chunk {chunk} (of {CHUNKS}) must "
                         f"divide multiple {multiple}")
    if _on_cpu("setup_records", cameras, soup, soup_valid):
        packed = pack_records(cameras, soup, soup_valid, multiple)
        cbox = torch.stack(_group_boxes(*packed[:, 12:16].unbind(1), chunk),
                           1)
        return packed, cbox
    n, t = cameras.shape[0], soup.shape[0]
    if (cameras.shape[1:] != (4, 4) or soup.shape[1:] != (3, 3)
            or soup_valid.shape != (t,)):
        raise ValueError(f"setup_records: cameras {tuple(cameras.shape)}, "
                         f"soup {tuple(soup.shape)}, soup_valid "
                         f"{tuple(soup_valid.shape)}; expected (N, 4, 4), "
                         "(T, 3, 3), (T,)")
    n_rec = -(-2 * t // multiple) * multiple
    packed = torch.empty((n, 16, n_rec), dtype=torch.float32,
                         device=cameras.device)
    cbox = torch.empty((n, 4, n_rec // chunk), dtype=torch.float32,
                       device=cameras.device)
    SETUP.launch(cameras, soup, soup_valid, packed, cbox, n, t, n_rec, chunk)
    return packed, cbox


def tile_lists(cbox, height: int, width: int, supers: int = 1):
    """Per-tile lists of the groups of ``supers`` consecutive chunks whose
    bbox union overlaps the tile (TILE x TILE, row-major), from the chunk
    boxes ``cbox`` (N, 4, nch) of :func:`setup_records`, nch a multiple of
    ``supers``. Returns (lists, counts): lists (N, tiles, nch / supers)
    int32 with the ids of the active groups first, ascending; counts (N,
    tiles) int32.

    CUDA tensors launch BIN, which leaves the entries past each count
    unwritten; CPU tensors take the plain version (:func:`bin_chunks`' and
    :func:`bin_superchunks`' lists, the sentinel nch / supers past each
    count)."""
    if supers < 1 or cbox.dim() != 3 or cbox.shape[1] != 4 \
            or cbox.shape[2] % supers:
        raise ValueError(f"tile_lists: cbox {tuple(cbox.shape)} is not (N, "
                         f"4, a multiple of supers={supers})")
    if cbox.device.type == "cpu":
        return bin_chunks(*cbox.unbind(1), height, width, chunk=supers)
    check_cuda("tile_lists", cbox)
    n, nch = cbox.shape[0], cbox.shape[2]
    ntx, nty = -(-width // TILE), -(-height // TILE)
    lists = torch.empty((n, nty * ntx, nch // supers), dtype=torch.int32,
                        device=cbox.device)
    counts = torch.empty((n, nty * ntx), dtype=torch.int32,
                         device=cbox.device)
    BIN.launch(cbox, *_screen(height, width, cbox.device)[1], lists, counts,
               n, nch, supers, ntx, nty)
    return lists, counts


def bin_soup(cameras, soup, soup_valid, height: int, width: int,
             chunk: int = CHUNK, two_level: bool = False,
             supers: int = SUPERS) -> dict:
    """The binning of a render, on the inputs' device: the packed records
    and the tile lists, one or two levels (:func:`setup_records`, then
    :func:`tile_lists` of chunks or of superchunks). Its result is what
    :func:`raster_binned` launches a kernel on."""
    _check_args(chunk, supers)
    group = supers if two_level else 1
    packed, cbox = setup_records(cameras, soup, soup_valid, chunk * group,
                                 chunk)
    lists, counts = tile_lists(cbox, height, width, group)
    grid, tiles = _screen(height, width, packed.device)
    return dict(packed=packed, lists=lists, counts=counts,
                cbox=cbox if two_level else None, grid=grid, tiles=tiles,
                height=height, width=width, chunk=chunk, supers=supers)


def _window(rows, height: int) -> tuple:
    """(r0, r1): the rows ``rows`` names, all of them for None; an empty or
    out-of-range window raises."""
    r0, r1 = (0, height) if rows is None else (int(rows[0]), int(rows[1]))
    if not 0 <= r0 < r1 <= height:
        raise ValueError(f"rows [{r0}, {r1}) is not a window of {height} "
                         "rows")
    return r0, r1


def raster_binned(kernel: Kernel, bins: dict, rows=None) -> torch.Tensor:
    """Launch K1 (``bins`` of one level) or K5 (two levels, through
    ``kernel``, K5A or K5B) on the output of :func:`bin_soup`: (N, H, W)
    float32 depth, background 1.0. ``rows`` (K1 only): (r0, r1), the rows
    to render, into an (N, r1 - r0, W) buffer."""
    packed, lists, counts = bins["packed"], bins["lists"], bins["counts"]
    height, width, chunk = bins["height"], bins["width"], bins["chunk"]
    px, py = bins["grid"]
    tx0, tx1, ty0, ty1 = bins["tiles"]
    n = packed.shape[0]
    r0, r1 = _window(rows, height)
    if rows is not None and kernel is not K1:
        raise ValueError(f"{kernel.name}: a row window is K1's only")
    out = torch.empty((n, r1 - r0, width), dtype=torch.float32,
                      device=packed.device)
    name = kernel.name
    check_cuda(name, packed, px, py, tx0, tx1, ty0, ty1, out)
    check_cuda(name, lists, counts, dtype=torch.int32)
    if bins["cbox"] is None:
        if kernel is not K1:
            raise ValueError(f"{name}: one-level bins launch K1 only")
        kernel.launch(packed, lists, counts, px, py, tx0, tx1, ty0, ty1, out,
                      n, packed.shape[-1], lists.shape[-1], height, width,
                      TILE, chunk, r0, r1)
    else:
        if kernel is K1:
            raise ValueError(f"{name}: two-level bins launch K5 only")
        check_cuda(name, bins["cbox"])
        kernel.launch(packed, bins["cbox"], lists, counts, px, py, tx0, tx1,
                      ty0, ty1, out, n, packed.shape[-1], lists.shape[-1],
                      height, width, TILE, chunk, bins["supers"])
    return out


def render_depth_binned(cameras, soup, soup_valid, height: int, width: int,
                        chunk: int = CHUNK, two_level: bool = False,
                        supers: int = SUPERS, rows=None):
    """N depth renders of one soup: cameras (N, 4, 4) -> (N, H, W) float32,
    background 1.0; same per-pixel contract as ``render_depth``. ``rows``
    (one level only): (r0, r1), the rows to render, (N, r1 - r0, W) out.

    CPU tensors take the plain ``render_depth``; CUDA tensors launch K1
    (two_level=False) or K5 through K5A (two_level=True) once for all N
    cameras. ``soup`` should be Morton-sorted (state.pack_soup); an unsorted
    soup is still right, only slower.
    """
    _check_args(chunk, supers)
    if rows is not None and two_level:
        raise ValueError("render_depth_binned: a row window is K1's only")
    if _on_cpu("render_depth_binned", cameras, soup, soup_valid):
        return render_depth(cameras, soup, soup_valid, height, width,
                            rows=rows)
    bins = bin_soup(cameras, soup, soup_valid, height, width, chunk,
                    two_level, supers)
    return raster_binned(K5A if two_level else K1, bins, rows)


def render_depth_binned_batched(cameras, soup, soup_valid, height: int,
                                width: int, chunk: int = CHUNK,
                                supers: int = SUPERS):
    """The camera-batched two-level render: cameras (N, 4, 4) -> (N, H, W),
    as ``render_depth_binned(two_level=True)``, counted as K5B. CPU tensors
    take the plain ``render_depth``."""
    _check_args(chunk, supers)
    if _on_cpu("render_depth_binned_batched", cameras, soup, soup_valid):
        return render_depth(cameras, soup, soup_valid, height, width)
    bins = bin_soup(cameras, soup, soup_valid, height, width, chunk, True,
                    supers)
    return raster_binned(K5B, bins)
