"""The hand-written CUDA kernels against their plain PyTorch versions.

Needs an NVIDIA GPU (sm_90a) and nvcc; skipped elsewhere, since a CUDA
kernel has no CPU mode. This file imports no JAX, so on a machine without
it run it without the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Bounds: K1 and K5 (the two-level raster, through both of its wrappers)
bitwise against ``render_depth`` (same affine edge coefficients,
explicitly rounded operations in the same order); the binning's SETUP
bitwise against ``pack_records`` (NaN where it has NaN) and BIN's counts and
list prefixes equal to ``bin_chunks`` / ``bin_superchunks``; K3 bitwise
against ``bilinear_warp``; K2's nearest sample
bitwise (an index pick); K2's bilinear sample 1e-4 on a 0..255
scale (the library is built with -fmad=false, so the operation order is
the plain one); K3c the same 1e-4 on valid pixels and exactly 0 on the
others; K4 1e-4 px (the kernel folds the data term into cc and 1/denom as
pallas_jacobi.py does, the plain version does not); K4 and K6 with several
sweeps a launch bitwise against one sweep a launch; K3b 1e-4 on a 0..255
scale (the twin's weights and tap order, -fmad=false); K6 1e-3 px, the
JAX package's bound for hs_jacobi (it repeats hs_jacobi_plain's
arithmetic); K2's bilinear shadow mode 1e-4. The roofline probes: R1, R3
and R4 bitwise (one float32 operation each); R2 1e-6 relative (its plain
version's float64 sum can round before the float32 rounding). The sweep
update, the flow update's variants and the reconstruction on the card
against their plain runs on the CPU; the roofline and breakdown tools on
the card. The tile axis's bands: K1's row window and K2's band output
bitwise against the whole frame's rows and against their plain versions
(K2's bilinear 1e-4), K3's and K3b's bands bitwise against the whole
frame's rows (K3 also against ``bilinear_warp``'s band), and the tile-
sharded update on one card's ``[cuda:0] * n`` bitwise against the
unsharded update.
"""

import ctypes
import math

import numpy as np
import pytest
import torch

from meshrecon_torch import parity, problems, state
from meshrecon_torch.flow import jacobi, tile_warp
from meshrecon_torch.flow.remap import bilinear_warp, flow_remap
from meshrecon_torch.flow.variational import _hs_sweeps, _hs_sweeps_cheb
from meshrecon_torch.kernels import library
from meshrecon_torch.pipeline.fused import (fused_main_update_batched,
                                            fused_sweep_update_batched)
from meshrecon_torch.raster import binned, rasterizer
from meshrecon_torch.raster.fragment import bilinear_sample, nearest_sample
from meshrecon_torch.tools import roofline

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _cams(b, k, dev):
    args = problems.fused_problem(b, k, 8, 8)
    cams = np.concatenate([args[2][:, None], args[4]], 1).reshape(-1, 4, 4)
    return torch.from_numpy(cams).to(dev)


@pytest.mark.parametrize("h,w,sphere", [(48, 64, (16, 16)),
                                        (50, 70, (32, 64)),
                                        (480, 640, (64, 128))])
def test_raster_tiles_bitwise(dev, h, w, sphere):
    soup, valid = (torch.from_numpy(a).to(dev) for a in
                   state.pack_soup(problems.sphere_soup(*sphere)))
    cams = _cams(2, 2, dev)
    before = binned.K1.launches
    out = binned.render_depth_binned(cams, soup, valid, h, w)
    assert binned.K1.launches == before + 1
    ref = rasterizer.render_depth(cams, soup, valid, h, w)
    assert (ref < 1.0).any()
    assert torch.equal(out, ref)


def test_raster_tiles_near_straddle_bitwise(dev):
    rng = np.random.default_rng(12345)
    soup = torch.from_numpy(rng.normal(size=(200, 3, 3)).astype(
        np.float32)).to(dev)
    valid = torch.ones(200, dtype=torch.bool, device=dev)
    cam = torch.from_numpy(problems.make_camera(near=0.01, far=10.0,
                                                eye=(0, 0, 0.2))).to(dev)
    out = binned.render_depth_binned(cam[None], soup, valid, 96, 128)[0]
    ref = rasterizer.render_depth(cam, soup, valid, 96, 128)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("rows", [(0, 480), (5, 37), (100, 101), (250, 480),
                                  (479, 480), (16, 32)])
def test_raster_tiles_row_window(dev, rows):
    """K1's row window: rows not aligned to the 16-row tile, one row, the
    whole frame; bitwise against the whole render's rows and the plain
    render's window."""
    soup, valid = (torch.from_numpy(a).to(dev) for a in
                   state.pack_soup(problems.sphere_soup(64, 128)))
    cams = _cams(2, 2, dev)
    whole = binned.render_depth_binned(cams, soup, valid, 480, 640)
    before = binned.K1.launches
    win = binned.render_depth_binned(cams, soup, valid, 480, 640, rows=rows)
    assert binned.K1.launches == before + 1
    assert win.shape == (len(cams), rows[1] - rows[0], 640)
    assert torch.equal(win, whole[:, rows[0]:rows[1]])
    assert torch.equal(win, rasterizer.render_depth(cams, soup, valid, 480,
                                                    640, rows=rows))
    with pytest.raises(ValueError, match="not a window"):
        binned.render_depth_binned(cams, soup, valid, 480, 640, rows=(5, 5))


@pytest.mark.parametrize("bilinear_a", [False, True])
@pytest.mark.parametrize("rows", [(0, 96), (7, 41), (95, 96)])
def test_sample_shadow_frame_band(dev, rows, bilinear_a):
    """K2's output plane apart from its source plane: a band's coordinates
    against whole sources, bitwise the whole frame's rows; against the
    plain samplers (nearest bitwise, bilinear 1e-4)."""
    n, h, w = 6, 96, 128
    g = torch.Generator().manual_seed(8)
    a = torch.rand((n, h, w), generator=g).to(dev)
    b = (255 * torch.rand((n, h, w), generator=g)).to(dev)
    col = ((w + 10) * torch.rand((n, h, w), generator=g) - 5).to(dev)
    row = ((h + 10) * torch.rand((n, h, w), generator=g) - 5).to(dev)
    r0, r1 = rows
    whole = tile_warp.tile_warp_sample2_batched(a, b, col, row, bilinear_a)
    bc, br = col[:, r0:r1].contiguous(), row[:, r0:r1].contiguous()
    oa, ob = tile_warp.tile_warp_sample2_batched(a, b, bc, br, bilinear_a)
    assert oa.shape == (n, r1 - r0, w)
    assert torch.equal(oa, whole[0][:, r0:r1])
    assert torch.equal(ob, whole[1][:, r0:r1])
    plain_a = (bilinear_sample if bilinear_a else nearest_sample)(a, bc, br)
    assert (oa - plain_a).abs().max().item() <= (1e-4 if bilinear_a else 0)
    assert (ob - bilinear_sample(b, bc, br)).abs().max().item() <= 1e-4


@pytest.mark.parametrize("taps", [2, 4])
@pytest.mark.parametrize("lo,hi,shift", [(0, 120, 0.0), (120, 240, 19.3),
                                         (40, 41, -9.7), (200, 240, 30.2)])
def test_warp_band(dev, taps, lo, hi, shift):
    """K3 and K3b on a band of rows from the source rows its samples reach
    (fractional flows reaching past the next band): bitwise the whole
    frame's rows; K3 also bitwise against ``bilinear_warp``'s band."""
    n, h, w = 4, 240, 320
    g = torch.Generator().manual_seed(4)
    img = (255 * torch.rand((n, h, w), generator=g)).to(dev)
    u = (3 * torch.randn((n, h, w), generator=g)).to(dev)
    v = (torch.rand((n, h, w), generator=g) * 2 - 1).to(dev) + shift
    reach = math.ceil(v.abs().max().item()) + taps // 2
    w0, w1 = max(lo - reach, 0), min(hi + reach, h)
    band = dict(row0=lo, height=h, src_row0=w0)
    args = (img[:, w0:w1].contiguous(), u[:, lo:hi].contiguous(),
            v[:, lo:hi].contiguous())
    kernel = tile_warp.K3B if taps == 4 else tile_warp.K3
    before = kernel.launches
    out = tile_warp.tile_warp_flow_batched(*args, taps, **band)
    assert kernel.launches == before + 1
    whole = tile_warp.tile_warp_flow_batched(img, u, v, taps)
    assert torch.equal(out, whole[:, lo:hi])
    if taps == 2:
        assert torch.equal(out, bilinear_warp(
            args[0], torch.stack(args[1:], -1), **band))
    else:
        ref = flow_remap(torch.stack(args[1:], -1), args[0], **band)
        assert (out - ref).abs().max().item() <= 1e-4


@pytest.mark.parametrize("n_tile", [2, 4])
def test_tiled_fused_update_on_the_card(dev, n_tile):
    """The tile-sharded update on ``[cuda:0] * 2 n_tile`` (2 camera shards)
    bitwise against the unsharded update on the card: K4 in one launch a
    level, in three (60 Jacobi sweeps) and in two carrying the Chebyshev
    state (30 sweeps) between each band's windows."""
    from meshrecon_torch.sharding import make_device_mesh, sharded_fused_update

    h, w = 96, 128
    args = state.from_numpy(problems.fused_problem(4, 2, h, w), dev)
    for opts in ({}, dict(variance="rewarp", sampling="exact"),
                 dict(flow_solver="jacobi"), dict(iters=30)):
        ref = fused_main_update_batched(*args, h, w, **opts)
        out = sharded_fused_update(make_device_mesh(
            2, n_tile, devices=[dev] * (2 * n_tile)), h, w, **opts)(*args)
        for key in ("point4", "normals", "pdf", "valid", "depth"):
            assert torch.equal(out[key], ref[key]), key


def _counts():
    return tuple(k.launches for k in (binned.K1, binned.K5A, binned.K5B))


@pytest.mark.parametrize("h,w,sphere", [(48, 64, (16, 16)),
                                        (50, 70, (32, 64)),
                                        (480, 640, (64, 128)),
                                        (480, 640, (128, 256))])
def test_raster_tiles2_bitwise(dev, h, w, sphere):
    """K5 through both wrappers, each counted on its own object."""
    soup, valid = (torch.from_numpy(a).to(dev) for a in
                   state.pack_soup(problems.sphere_soup(*sphere)))
    cams = _cams(1, 3, dev)
    k1, k5a, k5b = _counts()
    out_a = binned.render_depth_binned(cams, soup, valid, h, w,
                                       two_level=True)
    assert _counts() == (k1, k5a + 1, k5b)
    out_b = binned.render_depth_binned_batched(cams, soup, valid, h, w)
    assert _counts() == (k1, k5a + 1, k5b + 1)
    ref = rasterizer.render_depth(cams, soup, valid, h, w)
    assert (ref < 1.0).any()
    assert torch.equal(out_a, ref) and torch.equal(out_b, ref)


@pytest.mark.parametrize("chunk,supers", [(8, 8), (16, 3), (64, 1)])
def test_raster_tiles2_near_straddle_bitwise(dev, chunk, supers):
    """200 triangles (400 records: never a whole number of superchunks)
    straddling the near plane."""
    rng = np.random.default_rng(12345)
    soup = torch.from_numpy(rng.normal(size=(200, 3, 3)).astype(
        np.float32)).to(dev)
    valid = torch.ones(200, dtype=torch.bool, device=dev)
    cam = torch.from_numpy(problems.make_camera(near=0.01, far=10.0,
                                                eye=(0, 0, 0.2))).to(dev)
    ref = rasterizer.render_depth(cam, soup, valid, 96, 128)
    out = binned.render_depth_binned(cam[None], soup, valid, 96, 128,
                                     chunk=chunk, two_level=True,
                                     supers=supers)[0]
    assert torch.equal(out, ref)
    out = binned.render_depth_binned_batched(cam[None], soup, valid, 96, 128,
                                             chunk=chunk, supers=supers)[0]
    assert torch.equal(out, ref)


@pytest.mark.parametrize("chunk,supers", [(8, 1), (16, 3), (32, 8), (64, 8),
                                          (64, 2)])
def test_raster_tiles2_chunks_bitwise(dev, chunk, supers):
    """An unsorted 4,000-triangle soup (8,000 records, padded to whole
    superchunks) at every chunk size."""
    soup = torch.from_numpy(problems.sphere_soup(40, 50)).to(dev)
    valid = torch.ones(len(soup), dtype=torch.bool, device=dev)
    cams = _cams(1, 3, dev)
    ref = rasterizer.render_depth(cams, soup, valid, 96, 128)
    out = binned.render_depth_binned_batched(cams, soup, valid, 96, 128,
                                             chunk=chunk, supers=supers)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_raster_tiles_chunks_bitwise(dev, chunk):
    """K1 at the sweep's other chunk sizes against chunk 8."""
    soup, valid = (torch.from_numpy(a).to(dev) for a in
                   state.pack_soup(problems.sphere_soup(64, 128)))
    cams = _cams(1, 3, dev)
    want = binned.render_depth_binned(cams, soup, valid, 120, 160)
    before = binned.K1.launches
    out = binned.render_depth_binned(cams, soup, valid, 120, 160,
                                     chunk=chunk)
    assert binned.K1.launches == before + 1
    assert (want < 1.0).any() and torch.equal(out, want)


def _cull_soup(kind):
    """203 triangles (406 records: never a whole number of chunks) that
    make the walk's tile and footprint culls bite, with the camera
    that sees them: large triangles across many tiles and their corners;
    slivers (long, nearly degenerate); the near-plane straddle soup."""
    rng = np.random.default_rng({"large": 1, "slivers": 2,
                                 "near_straddle": 3}[kind])
    t = 203
    cam = problems.make_camera()
    if kind == "large":
        centers = rng.uniform([-1.6, -1.2, -6.5], [1.6, 1.2, -4.0], (t, 1, 3))
        soup = centers + rng.normal(scale=0.7, size=(t, 3, 3))
    elif kind == "slivers":
        a = rng.uniform([-1.6, -1.2, -6.5], [1.6, 1.2, -4.0], (t, 3))
        d = rng.normal(size=(t, 3)) * rng.uniform(0.3, 2.0, (t, 1))
        c = (a + d * rng.uniform(0.2, 0.8, (t, 1))
             + rng.normal(scale=1e-3, size=(t, 3)))
        soup = np.stack([a, a + d, c], 1)
    else:
        soup = rng.normal(size=(t, 3, 3))
        cam = problems.make_camera(near=0.01, far=10.0, eye=(0, 0, 0.2))
    return soup.astype(np.float32), cam


@pytest.mark.parametrize("kind", ["large", "slivers", "near_straddle"])
@pytest.mark.parametrize("ncam", [1, 16])
def test_raster_walk_culls_bitwise(dev, kind, ncam):
    """K1 and K5 (both wrappers) bitwise against ``render_depth`` on soups
    where the walk's culls bite (the sweep tool's counts say so), at 1 and
    16 cameras on a ragged 250x330 screen, chunks 8 and 64."""
    from meshrecon_torch.tools import raster_sweep

    soup_np, cam = _cull_soup(kind)
    soup = torch.from_numpy(soup_np).to(dev)
    valid = torch.ones(len(soup), dtype=torch.bool, device=dev)
    cams = torch.cat([torch.from_numpy(cam)[None].to(dev),
                      _cams(4, 3, dev)[1:]])[:ncam].contiguous()
    h, w = 250, 330
    ref = rasterizer.render_depth(cams, soup, valid, h, w)
    assert (ref < 1.0).any()
    for chunk in (8, 64):
        bins = binned.bin_soup(cams, soup, valid, h, w, chunk)
        n = raster_sweep.walk_counts(bins)
        assert n["tile_hits"] < n["records"]
        assert n["warp_hits"] < 8 * n["tile_hits"]
        k1, k5a, k5b = _counts()
        assert torch.equal(binned.render_depth_binned(
            cams, soup, valid, h, w, chunk), ref)
        assert torch.equal(binned.render_depth_binned(
            cams, soup, valid, h, w, chunk, two_level=True), ref)
        assert torch.equal(binned.render_depth_binned_batched(
            cams, soup, valid, h, w, chunk), ref)
        assert _counts() == (k1 + 1, k5a + 1, k5b + 1)


def test_raster_wrappers_refuse(dev):
    soup, valid = (torch.from_numpy(a).to(dev) for a in
                   state.pack_soup(problems.sphere_soup(8, 8)))
    cams = _cams(1, 1, dev)
    for fn, kwargs in ((binned.render_depth_binned, {"chunk": 12}),
                       (binned.render_depth_binned,
                        {"two_level": True, "supers": 0}),
                       (binned.render_depth_binned_batched, {"chunk": 4}),
                       (binned.render_depth_binned_batched, {"supers": 0})):
        with pytest.raises(ValueError):
            fn(cams, soup, valid, 32, 48, **kwargs)
    for fn in (binned.render_depth_binned,
               binned.render_depth_binned_batched):
        for args in ((cams.cpu(), soup, valid), (cams, soup.cpu(), valid),
                     (cams, soup, valid.cpu()), (cams.double(), soup, valid)):
            with pytest.raises(ValueError):
                fn(*args, 32, 48)
    # the C entries refuse a chunk or a table they do not take
    counts = _counts()
    bins = binned.bin_soup(cams, soup, valid, 32, 48)
    bins["chunk"] = 12
    with pytest.raises(RuntimeError, match="raster_tiles"):
        binned.raster_binned(binned.K1, bins)
    bins = binned.bin_soup(cams, soup, valid, 32, 48, two_level=True)
    bins["supers"] = 3
    with pytest.raises(RuntimeError, match="raster_tiles2"):
        binned.raster_binned(binned.K5B, bins)
    with pytest.raises(ValueError):
        binned.raster_binned(binned.K1, bins)
    assert _counts() == counts


def _bits_equal(a, b):
    """Bit for bit, NaN-aware: the same bits, or NaN in both."""
    return a.shape == b.shape and bool(
        ((a.view(torch.int32) == b.view(torch.int32))
         | (a.isnan() & b.isnan())).all())


def _setup_case(name, dev):
    """(cameras, soup, soup_valid): a sphere seen by 6 cameras; 200 random
    triangles straddling the near plane; the same with invalid, degenerate
    (zero-area, collinear) and NaN triangles."""
    if name == "sphere":
        soup, valid = (torch.from_numpy(a).to(dev) for a in
                       state.pack_soup(problems.sphere_soup(32, 64)))
        return _cams(2, 2, dev), soup, valid
    rng = np.random.default_rng(12345)
    soup = rng.normal(size=(200, 3, 3)).astype(np.float32)
    valid = np.ones(200, bool)
    if name == "invalid_degenerate":
        valid[::7] = False
        soup[1::5, 1] = soup[1::5, 0]                       # zero area
        soup[2::9, 2] = 2 * soup[2::9, 1] - soup[2::9, 0]   # collinear
        soup[3, 0, 0] = np.nan
    cam = problems.make_camera(near=0.01, far=10.0, eye=(0, 0, 0.2))
    return (torch.from_numpy(cam).to(dev)[None],
            torch.from_numpy(soup).to(dev), torch.from_numpy(valid).to(dev))


@pytest.mark.parametrize("case", ["sphere", "straddle",
                                  "invalid_degenerate"])
@pytest.mark.parametrize("multiple,chunk", [(c * s, c) for c in binned.CHUNKS
                                            for s in (1, 3, 8)])
def test_raster_setup_bitwise(dev, case, multiple, chunk):
    """SETUP's records against pack_records bit for bit (NaN where it has
    NaN), padding records included, and its chunk boxes against the plain
    bbox unions."""
    cams, soup, valid = _setup_case(case, dev)
    before = binned.SETUP.launches
    packed, cbox = binned.setup_records(cams, soup, valid, multiple, chunk)
    assert binned.SETUP.launches == before + 1
    want = binned.pack_records(cams, soup, valid, multiple)
    assert _bits_equal(packed, want)
    boxes = want[:, 12], want[:, 13], want[:, 14], want[:, 15]
    assert _bits_equal(cbox, torch.stack(binned._group_boxes(*boxes, chunk),
                                         1))


@pytest.mark.parametrize("chunk", binned.CHUNKS)
@pytest.mark.parametrize("supers,h,w", [(1, 120, 160), (3, 120, 160),
                                        (8, 50, 70)])
def test_raster_bin_matches_plain(dev, chunk, supers, h, w):
    """BIN's counts and list prefixes against bin_chunks (supers 1) and
    bin_superchunks, on the plain version's chunk boxes."""
    soup, valid = (torch.from_numpy(a).to(dev) for a in
                   state.pack_soup(problems.sphere_soup(64, 128)))
    cams = _cams(1, 3, dev)
    packed = binned.pack_records(cams, soup, valid, chunk * supers)
    boxes = packed[:, 12], packed[:, 13], packed[:, 14], packed[:, 15]
    if supers == 1:
        cboxes = binned._group_boxes(*boxes, chunk)
        lists, counts = binned.bin_chunks(*boxes, h, w, chunk=chunk)
    else:
        cboxes, lists, counts = binned.bin_superchunks(
            *boxes, h, w, chunk=chunk, supers=supers)
    before = binned.BIN.launches
    got, got_counts = binned.tile_lists(torch.stack(cboxes, 1), h, w, supers)
    assert binned.BIN.launches == before + 1
    assert got.shape == lists.shape and counts.sum() > 0
    assert torch.equal(got_counts, counts)
    live = torch.arange(lists.shape[-1], device=dev) < counts[..., None]
    assert torch.equal(torch.where(live, got, 0), torch.where(live, lists, 0))


def _bin_against_plain(dev, cbox, h, w, supers=1):
    """BIN on the chunk boxes ``cbox`` (N, 4, nch), one launch, against
    the plain lists of the same boxes on the CPU: counts and list
    prefixes equal. Returns the counts."""
    want, want_n = binned.tile_lists(cbox, h, w, supers)
    before = binned.BIN.launches
    got, got_n = binned.tile_lists(cbox.to(dev), h, w, supers)
    assert binned.BIN.launches == before + 1
    got, got_n = got.cpu(), got_n.cpu()
    assert got.shape == want.shape
    assert torch.equal(got_n, want_n)
    live = torch.arange(want.shape[-1]) < want_n[..., None]
    assert torch.equal(torch.where(live, got, 0), torch.where(live, want, 0))
    return want_n


def _random_boxes(n, nch, seed):
    """(n, 4, nch) float32 chunk boxes: centres over the screen and past
    it, half-sizes from under a pixel to past the frame; every 7th box
    empty (the inverted box of padding records)."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1.3, 1.3, (n, 2, nch))
    half = rng.exponential(0.04, (n, 2, nch)) * rng.choice(
        [1.0, 10.0], (n, 2, nch), p=[0.9, 0.1])
    box = np.stack([c[:, 0] - half[:, 0], c[:, 0] + half[:, 0],
                    c[:, 1] - half[:, 1], c[:, 1] + half[:, 1]], 1)
    box[..., 3::7] = np.array([3e38, -3e38, 3e38, -3e38])[:, None]
    return torch.from_numpy(box.astype(np.float32))


# BIN's sizes: a run is 32 groups, a staged batch 32 runs (1,024 groups),
# a round 512 runs (16,384 groups); a cluster's 8 CTAs of 8 warps build
# 128 runs of the coarse level a pass, two a warp (4,096 groups)
@pytest.mark.parametrize("groups", [0, 1, 31, 33, 1023, 1025, 4095, 4097,
                                    16383, 16385])
@pytest.mark.parametrize("supers", [1, 3])
def test_raster_bin_group_counts(dev, groups, supers):
    """BIN at group counts just under and over its run, batch, cluster
    pass and round sizes, zero included, on a 4 x 5 tile grid (partial
    CTA rows and columns), against the plain lists."""
    cbox = _random_boxes(2, groups * supers, seed=groups + supers)
    counts = _bin_against_plain(dev, cbox, 50, 70, supers)
    assert groups == 0 or counts.sum() > 0


@pytest.mark.parametrize("n", [1, 16])
@pytest.mark.parametrize("h,w", [(480, 640), (50, 70), (96, 128),
                                 (16, 4112)])
def test_raster_bin_cameras_and_grids(dev, n, h, w):
    """BIN at 1 and 16 cameras on tile grids of 30 x 40 (partial CTA
    rows), 4 x 5, 6 x 8 and 1 x 257 tiles (a row past the 256 tiles BIN
    keeps in shared memory), against the plain lists."""
    cbox = _random_boxes(n, 3000, seed=n * h)
    assert _bin_against_plain(dev, cbox, h, w).sum() > 0


def test_raster_bin_every_tile_every_group(dev):
    """A soup of triangles that each cover the whole screen: every tile
    lists every group, through SETUP (bitwise) and BIN (one launch each)
    against the plain binning."""
    cams = torch.from_numpy(problems.make_camera(eye=(0, 0, 0))).to(dev)
    cams = cams[None].repeat(3, 1, 1)
    tri = np.array([[-300.0, -300.0, -5.0], [300.0, -300.0, -5.0],
                    [0.0, 300.0, -5.0]], np.float32)
    soup = torch.from_numpy(np.repeat(tri[None], 100, 0)).to(dev)
    valid = torch.ones(100, dtype=torch.bool, device=dev)
    before = (binned.SETUP.launches, binned.BIN.launches)
    bins = binned.bin_soup(cams, soup, valid, 96, 128)
    assert (binned.SETUP.launches, binned.BIN.launches) == (
        before[0] + 1, before[1] + 1)
    plain = binned.pack_records(cams, soup, valid)
    assert _bits_equal(bins["packed"], plain)
    ngroups = bins["lists"].shape[-1]
    assert ngroups == 25
    assert bool((bins["counts"] == ngroups).all())
    assert torch.equal(bins["lists"], torch.arange(
        ngroups, dtype=torch.int32, device=dev).expand_as(bins["lists"]))


def test_raster_binning_zero_records(dev):
    """No triangles: SETUP and BIN launch once each, every count is 0."""
    cams = _cams(1, 3, dev)
    soup = torch.zeros((0, 3, 3), device=dev)
    valid = torch.zeros(0, dtype=torch.bool, device=dev)
    before = (binned.SETUP.launches, binned.BIN.launches)
    bins = binned.bin_soup(cams, soup, valid, 50, 70)
    assert (binned.SETUP.launches, binned.BIN.launches) == (
        before[0] + 1, before[1] + 1)
    assert bins["packed"].shape == (4, 16, 0)
    assert bins["lists"].shape == (4, 20, 0)
    assert bool((bins["counts"] == 0).all())


def test_raster_binning_65k_sphere_16_cameras(dev):
    """The main path's largest shape: the 65,536-triangle sphere seen by
    the flow update's 16 cameras at 640x480, chunk 8: SETUP bitwise
    against pack_records, BIN's counts and list prefixes against
    bin_chunks, one launch each."""
    soup, valid = (torch.from_numpy(a).to(dev) for a in
                   state.pack_soup(problems.sphere_soup(128, 256)))
    cams = _cams(4, 3, dev)
    before = binned.SETUP.launches
    packed, cbox = binned.setup_records(cams, soup, valid)
    assert binned.SETUP.launches == before + 1
    plain = binned.pack_records(cams, soup, valid)
    assert _bits_equal(packed, plain)
    boxes = plain[:, 12], plain[:, 13], plain[:, 14], plain[:, 15]
    lists, counts = binned.bin_chunks(*boxes, 480, 640)
    before = binned.BIN.launches
    got, got_counts = binned.tile_lists(cbox, 480, 640)
    assert binned.BIN.launches == before + 1
    assert torch.equal(got_counts, counts) and counts.sum() > 0
    live = torch.arange(lists.shape[-1], device=dev) < counts[..., None]
    assert torch.equal(torch.where(live, got, 0), torch.where(live, lists, 0))


def test_binning_never_takes_the_eager_setup_or_sort(dev, monkeypatch):
    """On the card the renders bin with SETUP and BIN only: with the plain
    setup and the sort patched to raise, they still equal render_depth."""
    soup, valid = (torch.from_numpy(a).to(dev) for a in
                   state.pack_soup(problems.sphere_soup(32, 64)))
    cams = _cams(1, 3, dev)
    ref = rasterizer.render_depth(cams, soup, valid, 96, 128)

    def eager(*args, **kwargs):
        raise AssertionError("the eager binning ran on the card")

    for name in ("pack_records", "_tile_lists", "_group_boxes", "bin_chunks",
                 "bin_superchunks", "clip_project_planes",
                 "edge_affine_planes", "coverage_bbox"):
        monkeypatch.setattr(binned, name, eager)
    before = (binned.SETUP.launches, binned.BIN.launches)
    outs = (binned.render_depth_binned(cams, soup, valid, 96, 128),
            binned.render_depth_binned(cams, soup, valid, 96, 128,
                                       two_level=True),
            binned.render_depth_binned_batched(cams, soup, valid, 96, 128))
    assert (binned.SETUP.launches, binned.BIN.launches) == (
        before[0] + 3, before[1] + 3)
    assert (ref < 1.0).any()
    for out in outs:
        assert torch.equal(out, ref)


def test_raw_stream_is_the_current_stream(dev):
    from meshrecon_torch.kernels import _build

    assert _build._current_device() == torch.cuda.current_device()
    assert _build._raw_stream(dev.index) == torch.cuda.current_stream(
        dev).cuda_stream
    side = torch.cuda.Stream(dev)
    x = torch.zeros((8, 128), device=dev)
    with torch.cuda.stream(side):
        assert _build._raw_stream(dev.index) == side.cuda_stream
        out = roofline.add_one(x)
    torch.cuda.synchronize()
    assert torch.equal(out, torch.ones_like(x))


def test_raster_sweep_on_gpu(dev):
    from meshrecon_torch.tools import raster_sweep

    rows = raster_sweep.main(["--height", "96", "--width", "128", "--tris",
                              "3200", "--reps", "2", "--chunks", "8,64",
                              "--batched"])
    assert len(rows) == 2 * 2 * 5 + 1
    for r in rows:
        if r["variant"] != "plain":
            assert r["kernel_ms"] > 0 and r["peak_mb"] > 0


@pytest.mark.parametrize("n,h,w", [(3, 37, 53), (12, 96, 128)])
def test_sample_shadow_frame(dev, n, h, w):
    g = torch.Generator().manual_seed(1)
    a = torch.rand((n, h, w), generator=g).to(dev)
    b = (255 * torch.rand((n, h, w), generator=g)).to(dev)
    col = ((w + 10) * torch.rand((n, h, w), generator=g) - 5).to(dev)
    row = ((h + 10) * torch.rand((n, h, w), generator=g) - 5).to(dev)
    col[:, 0, :10] = torch.arange(10, device=dev) + 0.5
    oa, ob = tile_warp.tile_warp_sample2_batched(a, b, col, row)
    assert torch.equal(oa, nearest_sample(a, col, row))
    assert (ob - bilinear_sample(b, col, row)).abs().max().item() <= 1e-4


@pytest.mark.parametrize("n,h,w", [(3, 37, 53), (12, 96, 128)])
def test_sample_shadow_frame_bilinear_mode(dev, n, h, w):
    g = torch.Generator().manual_seed(5)
    a = torch.rand((n, h, w), generator=g).to(dev)
    b = (255 * torch.rand((n, h, w), generator=g)).to(dev)
    col = ((w + 10) * torch.rand((n, h, w), generator=g) - 5).to(dev)
    row = ((h + 10) * torch.rand((n, h, w), generator=g) - 5).to(dev)
    before = tile_warp.K2.launches
    oa, ob = tile_warp.tile_warp_sample2_batched(a, b, col, row,
                                                 bilinear_a=True)
    assert tile_warp.K2.launches == before + 1
    assert (oa - bilinear_sample(a, col, row)).abs().max().item() <= 1e-4
    assert (ob - bilinear_sample(b, col, row)).abs().max().item() <= 1e-4


def _nan_aware_err(out, ref):
    """Max |out - ref|, where both must be NaN at the same pixels."""
    assert torch.equal(out.isnan(), ref.isnan())
    keep = ~out.isnan()
    return (out[keep] - ref[keep]).abs().max().item()


@pytest.mark.parametrize("n,h,w,field", [
    (2, 31, 45, "noise"), (12, 120, 160, "noise"), (3, 37, 53, "noise"),
    (2, 45, 200, "smooth"), (12, 480, 640, "smooth"), (3, 37, 130, "far"),
    (2, 9, 70, "far")])
def test_warp_bicubic(dev, n, h, w, field):
    """K3b against flow_remap: flows that reach off the frame (noise, in
    ragged shapes: rows not a multiple of 8, columns not of 64); a smooth
    field whose warps read their taps unclamped in the interior and clamp
    at the borders; NaN and far-off coordinates (NaN where flow_remap is
    NaN). The kernel's count of unclamped warps equals its mirror's."""
    g = torch.Generator().manual_seed(6)
    img = (255 * torch.rand((n, h, w), generator=g)).to(dev)
    scale = 6.0 if field == "noise" else 1.5
    u = (scale * torch.randn((n, h, w), generator=g)).to(dev)
    v = (scale * torch.randn((n, h, w), generator=g)).to(dev)
    if field == "smooth":
        u = torch.nn.functional.avg_pool2d(u[:, None], 9, 1, 4)[:, 0]
        v = torch.nn.functional.avg_pool2d(v[:, None], 9, 1, 4)[:, 0]
    if field == "far":
        u.view(-1)[::37] = float("nan")
        v.view(-1)[5::41] = float("nan")
        u.view(-1)[7::43] = 1e9
        v.view(-1)[3::47] = -1e9
        u.view(-1)[11::53] = -3e38
    u, v = u.contiguous(), v.contiguous()
    before = (tile_warp.K3.launches, tile_warp.K3B.launches)
    out = tile_warp.tile_warp_flow_batched(img, u, v, taps=4)
    assert (tile_warp.K3.launches, tile_warp.K3B.launches) == (
        before[0], before[1] + 1)
    ref = flow_remap(torch.stack([u, v], -1), img)
    if field == "far":
        # flow_remap's int64 index of -3e38 is undefined; compare the rest
        keep = ~(u.view(-1) < -1e30)
        assert _nan_aware_err(out.view(-1)[keep], ref.view(-1)[keep]) <= 1e-4
    else:
        assert (out - ref).abs().max().item() <= 1e-4
    counted, unclamped = tile_warp.warp_bicubic_paths(img, u, v)
    assert tile_warp.K3B.launches == before[1] + 1
    assert torch.equal(counted.nan_to_num(nan=-1.0), out.nan_to_num(nan=-1.0))
    paths = tile_warp.bicubic_warp_paths(u, v)
    assert unclamped == int(paths.sum().item())
    if field == "smooth":
        assert paths.any() and not paths.all()
    cols = torch.arange(w, dtype=torch.float32, device=dev)
    rows = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    if field != "far":
        scol, srow = cols + u, rows + v
        out = tile_warp.tile_warp_bicubic(img, scol, srow)
        ref = tile_warp.tile_warp_bicubic(img.cpu(), scol.cpu(), srow.cpu())
        assert (out.cpu() - ref).abs().max().item() <= 1e-4


def test_warp_bicubic_paths_agree(dev):
    """The unclamped and the clamped path give the same bits: a smooth
    field, then the same field with one pixel of every warp sent 1e9 px
    off, which puts every warp on the clamped path; the other pixels
    must not move by a bit."""
    g = torch.Generator().manual_seed(12)
    n, h, w = 3, 64, 256
    img = (255 * torch.rand((n, h, w), generator=g)).to(dev)
    u, v = ((1.5 * torch.randn((2, n, h, w), generator=g)).to(dev))
    u = torch.nn.functional.avg_pool2d(u[:, None], 9, 1, 4)[:, 0]
    v = torch.nn.functional.avg_pool2d(v[:, None], 9, 1, 4)[:, 0]
    span = tile_warp.K3B_COLS * tile_warp.K3B_PIX
    off = u.clone()
    off[..., span - 1::span] = 1e9
    a, unclamped_a = tile_warp.warp_bicubic_paths(img, u.contiguous(),
                                                  v.contiguous())
    b, unclamped_b = tile_warp.warp_bicubic_paths(img, off.contiguous(),
                                                  v.contiguous())
    assert unclamped_a > n * h and unclamped_b == 0
    keep = torch.ones(w, dtype=torch.bool, device=dev)
    keep[span - 1::span] = False
    assert torch.equal(a[..., keep], b[..., keep])
    assert torch.equal(a, tile_warp.tile_warp_flow_batched(
        img, u.contiguous(), v.contiguous(), taps=4))


def test_warp_bicubic_shape(dev):
    """K3b's geometry in C (mr_warp_bicubic_shape) is the one its Python
    mirror (tile_warp.K3B_*) assumes."""
    out = (ctypes.c_int * 3)()
    assert library().cdll.mr_warp_bicubic_shape(out) == 0
    assert tuple(out) == (tile_warp.K3B_COLS, tile_warp.K3B_ROWS,
                          tile_warp.K3B_PIX)


@pytest.mark.parametrize("iters", [1, 2, 60])
def test_hs_jacobi_fields(dev, iters):
    g = torch.Generator().manual_seed(7)
    shape = (3, 40, 56)
    ix, iy = (8 * torch.randn(shape, generator=g)).to(dev), (
        8 * torch.randn(shape, generator=g)).to(dev)
    c = (20 * torch.randn(shape, generator=g)).to(dev)
    u0 = torch.randn(shape, generator=g).to(dev)
    v0 = torch.randn(shape, generator=g).to(dev)
    before = jacobi.K6.launches
    u, v = jacobi.hs_jacobi(ix, iy, c, u0, v0, 144.0, iters=iters)
    assert jacobi.K6.launches == before + math.ceil(
        iters / jacobi.K6_SWEEPS_PER_LAUNCH)
    ur, vr = jacobi.hs_jacobi_plain(ix, iy, c, u0, v0, 144.0, iters=iters)
    assert (u - ur).abs().max().item() <= 1e-3
    assert (v - vr).abs().max().item() <= 1e-3


@pytest.mark.parametrize("n,h,w,offset", [
    (3, 37, 53, 0), (2, 31, 45, 0), (4, 48, 64, 0), (4, 48, 64, 1),
    (12, 120, 160, 0), (12, 240, 320, 0)])
def test_warp_bilinear(dev, n, h, w, offset):
    """K3 bit for bit against bilinear_warp: four pixels a thread where the
    width is a multiple of 4, one where it is not or where the flow is not
    16-byte aligned (offset 1)."""
    g = torch.Generator().manual_seed(2)
    img = (255 * torch.rand((n, h, w), generator=g)).to(dev)
    flow = (6 * torch.randn((2, n * h * w + offset), generator=g)).to(dev)
    u = flow[0, offset:].view(n, h, w)
    v = flow[1, offset:].view(n, h, w)
    before = tile_warp.K3.launches
    out = tile_warp.tile_warp_flow_batched(img, u, v)
    assert tile_warp.K3.launches == before + 1
    assert torch.equal(out, bilinear_warp(img, torch.stack([u, v], -1)))


@pytest.mark.parametrize("solver,iters", [("cheb", 14), ("cheb", 1),
                                          ("cheb", 2), ("jacobi", 20)])
def test_hs_sweep(dev, solver, iters):
    g = torch.Generator().manual_seed(3)
    shape = (2, 3, 40, 56)
    prev = (255 * torch.rand((2, 1, 40, 56), generator=g)).to(dev)
    warped = (prev + 5 * torch.randn(shape, generator=g).to(dev))
    u0 = torch.randn(shape, generator=g).to(dev)
    v0 = torch.randn(shape, generator=g).to(dev)
    before = jacobi.K4.launches
    u, v = jacobi.hs_level_fused(prev, warped, u0, v0, 144.0, iters=iters,
                                 solver=solver)
    assert jacobi.K4.launches == before + math.ceil(
        iters / jacobi.MAX_SWEEPS_PER_LAUNCH)
    if solver == "cheb":
        ur, vr = _hs_sweeps_cheb(prev, warped, u0, v0, 144.0, iters)
    else:
        ur, vr = _hs_sweeps(prev, warped, u0, v0, 144.0, iters)
    assert (u - ur).abs().max().item() <= 1e-4
    assert (v - vr).abs().max().item() <= 1e-4


def _hs_inputs(pshape, shape, dev, seed):
    g = torch.Generator().manual_seed(seed)
    prev = (255 * torch.rand(pshape, generator=g)).to(dev)
    warped = (prev + 5 * torch.randn(shape, generator=g).to(dev))
    u0 = torch.randn(shape, generator=g).to(dev)
    v0 = torch.randn(shape, generator=g).to(dev)
    return prev, warped, u0, v0


@pytest.mark.parametrize("solver,iters", [
    ("cheb", 1), ("cheb", 2), ("cheb", 14), ("cheb", 24), ("jacobi", 60)])
@pytest.mark.parametrize("pshape,shape", [
    ((3, 37, 53), (3, 37, 53)), ((2, 1, 40, 56), (2, 3, 40, 56)),
    ((1, 150, 300), (2, 150, 300)), ((12, 240, 320), (12, 240, 320))])
def test_hs_sweep_blocked_equals_one_sweep_a_launch(dev, solver, iters,
                                                    pshape, shape):
    """K4's sweeps blocked in shared memory, bit for bit against one sweep
    a launch; 60 Jacobi sweeps cross launches (3 of 20). Shapes that are
    not multiples of the tile (100x36 at 14 sweeps), and the coarse level."""
    prev, warped, u0, v0 = _hs_inputs(pshape, shape, dev, 4)
    before = jacobi.K4.launches
    u, v = jacobi.hs_level_fused(prev, warped, u0, v0, 144.0, iters=iters,
                                 solver=solver)
    assert jacobi.K4.launches == before + math.ceil(
        iters / jacobi.MAX_SWEEPS_PER_LAUNCH)
    u1, v1 = jacobi.hs_level_fused(prev, warped, u0, v0, 144.0, iters=iters,
                                   solver=solver, _sweeps_per_launch=1)
    assert jacobi.K4.launches == before + math.ceil(
        iters / jacobi.MAX_SWEEPS_PER_LAUNCH) + iters
    assert torch.equal(u, u1) and torch.equal(v, v1)
    plain = _hs_sweeps_cheb if solver == "cheb" else _hs_sweeps
    ur, vr = plain(prev, warped, u0, v0, 144.0, iters)
    assert (u - ur).abs().max().item() <= 1e-4
    assert (v - vr).abs().max().item() <= 1e-4


@pytest.mark.parametrize("iters", [
    1, 2, jacobi.K6_SWEEPS_PER_LAUNCH, jacobi.K6_SWEEPS_PER_LAUNCH + 1, 60])
@pytest.mark.parametrize("shape", [(3, 37, 53), (2, 3, 40, 56),
                                   (12, 240, 320)])
def test_hs_jacobi_blocked_equals_one_sweep_a_launch(dev, iters, shape):
    """K6 blocked (S sweeps a launch) bit for bit against one sweep a
    launch, at 1, 2, S, S + 1 and 60 sweeps."""
    g = torch.Generator().manual_seed(8)
    ix, iy = (8 * torch.randn(shape, generator=g)).to(dev), (
        8 * torch.randn(shape, generator=g)).to(dev)
    c = (20 * torch.randn(shape, generator=g)).to(dev)
    u0 = torch.randn(shape, generator=g).to(dev)
    v0 = torch.randn(shape, generator=g).to(dev)
    before = jacobi.K6.launches
    u, v = jacobi.hs_jacobi(ix, iy, c, u0, v0, 144.0, iters=iters)
    assert jacobi.K6.launches == before + math.ceil(
        iters / jacobi.K6_SWEEPS_PER_LAUNCH)
    u1, v1 = jacobi.hs_jacobi(ix, iy, c, u0, v0, 144.0, iters=iters,
                              _sweeps_per_launch=1)
    assert torch.equal(u, u1) and torch.equal(v, v1)
    ur, vr = jacobi.hs_jacobi_plain(ix, iy, c, u0, v0, 144.0, iters=iters)
    assert (u - ur).abs().max().item() <= 1e-3
    assert (v - vr).abs().max().item() <= 1e-3


def test_hs_division_equals_ieee_over_every_float(dev):
    """K4's and K6's branch-free x / 6 and x / 12 (csrc/hs_sweep.cu,
    ``div_const``) against IEEE division (a tensor divisor: torch divides
    by a scalar as a product with its reciprocal) over all 2^32 floats:
    the same bits, signed zeros included, for every finite x whose
    quotients are not subnormal; they may differ only there, at inf and
    at NaN."""
    from meshrecon_torch.kernels import library

    divide = library().ext.mr_hs_divide
    chunk = 1 << 28
    q6 = torch.empty(chunk, device=dev)
    q12 = torch.empty_like(q6)
    d6, d12 = torch.full_like(q6, 6.0), torch.full_like(q6, 12.0)
    checked = 0
    for start in range(0, 1 << 32, chunk):
        bits = torch.arange(start, start + chunk, dtype=torch.int64,
                            device=dev)
        x = (bits - (bits >= 1 << 31).long() * (1 << 32)).to(
            torch.int32).view(torch.float32)
        assert divide(x.data_ptr(), q6.data_ptr(), q12.data_ptr(), chunk,
                      torch.cuda.current_stream().cuda_stream) == 0
        r6, r12 = x / d6, x / d12
        ok = x.isfinite() & ((x == 0) | (r12.abs() >= 2.0 ** -126))
        assert torch.equal(q6.view(torch.int32)[ok], r6.view(torch.int32)[ok])
        assert torch.equal(q12.view(torch.int32)[ok],
                           r12.view(torch.int32)[ok])
        checked += int(ok.sum())
    assert checked > 4.2e9


def test_hs_kernels_refuse_more_sweeps_than_a_launch_holds(dev):
    """The wrappers and the C entry agree on the most sweeps a launch: one
    more is refused by both, with no fallback."""
    prev, warped, u0, v0 = _hs_inputs((1, 40, 56), (1, 40, 56), dev, 5)
    top = jacobi.MAX_SWEEPS_PER_LAUNCH
    assert jacobi.block_shape(top, 480, 640)["smem_bytes"] > 48 * 1024
    with pytest.raises(ValueError):
        jacobi.block_shape(top + 1, 480, 640)
    with pytest.raises(ValueError):
        jacobi.hs_level_fused(prev, warped, u0, v0, 144.0, iters=30,
                              solver="cheb", _sweeps_per_launch=top + 1)
    with pytest.raises(RuntimeError, match="hs_sweep"):
        jacobi.K4.launch(prev, warped, u0, v0, u0, v0, None, None,
                         torch.empty_like(u0), torch.empty_like(v0), None,
                         None, None, top + 1, 144.0, 1, 40, 56)
    # an output that aliases an input is refused too
    with pytest.raises(RuntimeError, match="hs_jacobi_fields"):
        jacobi.K6.launch(u0, v0, u0, u0, v0, u0, torch.empty_like(v0), 1,
                         144.0, 1, 40, 56)


def _plane_coords(n, h, w, dev):
    """One depth plane's sample field of real camera pairs: off-frame and
    behind-camera pixels are invalid."""
    main = problems.make_camera(eye=(0, 0, 0))
    cm = torch.from_numpy(np.stack([
        problems.make_camera(eye=(2.0 * i - 2.0, 0.6, 0.8))
        @ np.linalg.inv(main) for i in range(n)])).to(dev)
    cols, rows = rasterizer.pixel_grid(h, w, dev)
    x, y = cols[None, None, :], rows[None, :, None]

    def row(r):
        c = cm[:, r, :, None, None]
        return c[:, 0] * x + c[:, 1] * y + c[:, 2] * 0.9 + c[:, 3]

    sw = row(3)
    ok = sw > 1e-6
    sw = torch.where(sw.abs() < 1e-6, 1e-6, sw)
    sx, sy = row(0) / sw, row(1) / sw
    ok &= (sx.abs() < 1.0) & (sy.abs() < 1.0)
    return ((sx + 1.0) * 0.5 * w).contiguous(), \
        ((1.0 - sy) * 0.5 * h).contiguous(), ok.contiguous()


@pytest.mark.parametrize("n,h,w", [(3, 37, 53), (16, 480, 640)])
def test_sample_bilinear_masked(dev, n, h, w):
    g = torch.Generator().manual_seed(4)
    img = (255 * torch.rand((n, h, w), generator=g)).to(dev)
    scol, srow, ok = _plane_coords(n, h, w, dev)
    assert 0.05 < ok.float().mean().item() < 0.99
    before = tile_warp.K3C.launches
    out = tile_warp.tile_warp_sample_batched(img, scol, srow, ok)
    assert tile_warp.K3C.launches == before + 1
    ref = tile_warp.sample_bilinear_masked_plain(img, scol, srow, ok)
    assert (out[~ok] == 0).all()
    assert (out - ref)[ok].abs().max().item() <= 1e-4


def test_wrappers_reject_what_kernels_do_not_take(dev):
    x = torch.zeros((2, 8, 8), device=dev)
    with pytest.raises(ValueError):
        tile_warp.tile_warp_flow_batched(x, x.transpose(1, 2), x)
    with pytest.raises(ValueError):
        tile_warp.tile_warp_sample2_batched(x, x, x.double(), x)
    with pytest.raises(ValueError):
        tile_warp.tile_warp_sample2_batched(x, x, x, x.cpu())
    with pytest.raises(ValueError):
        tile_warp.tile_warp_sample_batched(x, x, x, (x > 0.5).float())
    with pytest.raises(ValueError):
        tile_warp.tile_warp_sample_batched(x, x, x, (x > 0)[:1])
    with pytest.raises(ValueError):
        tile_warp.tile_warp_flow_batched(x, x, x, taps=3)
    with pytest.raises(ValueError):
        jacobi.hs_jacobi(x, x, x[:1], x, x, 144.0)


def test_fused_slice_on_gpu_matches_cpu(dev):
    """The small slice on the card (kernels) against the CPU (plain), within
    meshrecon_torch/parity.py's bounds."""
    args = problems.fused_problem(2, 2, 48, 64, seed=3)
    counts = {k: k.launches for k in (binned.K1, tile_warp.K2, tile_warp.K3,
                                      jacobi.K4)}
    gpu = state.to_numpy(fused_main_update_batched(
        *state.from_numpy(args, dev), 48, 64))
    assert all(k.launches > n for k, n in counts.items())
    cpu = state.to_numpy(fused_main_update_batched(
        *state.from_numpy(args, "cpu"), 48, 64))
    parity.check_slice(gpu, cpu)


@pytest.mark.parametrize("kwargs,kernel", [
    ({"variance": "rewarp"}, "K3B"), ({"use_farneback": True}, "K3B"),
    ({"flow_solver": "mg"}, "K3"), ({"shadow_sample": "bilinear"}, "K2"),
    ({"variance": "rewarp", "variance_taps": 2}, "K3")])
def test_fused_variants_on_gpu_match_cpu(dev, kwargs, kernel):
    """The flow update's options on the card against the CPU."""
    args = problems.fused_problem(2, 2, 48, 64, seed=3)
    k = getattr(tile_warp, kernel)
    before = k.launches
    gpu = state.to_numpy(fused_main_update_batched(
        *state.from_numpy(args, dev), 48, 64, **kwargs))
    assert k.launches > before
    cpu = state.to_numpy(fused_main_update_batched(
        *state.from_numpy(args, "cpu"), 48, 64, **kwargs))
    parity.check_slice(gpu, cpu)


def test_sweep_update_on_gpu_matches_cpu(dev):
    """The sweep update on the card (K1, K2, K3c) against the CPU."""
    args = list(problems.fused_problem(2, 3, 48, 64, seed=5))
    args[0], args[1] = state.pack_soup(problems.sphere_soup(16, 32))
    counts = {k: k.launches for k in (binned.K1, tile_warp.K2,
                                      tile_warp.K3C)}
    gpu = state.to_numpy(fused_sweep_update_batched(
        *state.from_numpy(args, dev), 48, 64, num_depths=16, passes=2))
    assert all(k.launches > n for k, n in counts.items())
    cpu = state.to_numpy(fused_sweep_update_batched(
        *state.from_numpy(args, "cpu"), 48, 64, num_depths=16, passes=2))
    assert np.array_equal(gpu["depth"], cpu["depth"])
    assert (gpu["valid"] == cpu["valid"]).mean() >= 0.999
    both = gpu["valid"] & cpu["valid"]
    assert both.mean() > 0.05
    d = np.linalg.norm(gpu["point4"][both] - cpu["point4"][both], axis=-1)
    assert (d <= 1e-3 * np.linalg.norm(cpu["point4"][both], axis=-1)
            ).mean() >= 0.99


def _cli_launches(tmp_path, flags):
    """Run the CLI at 1/8 size on the card; kernel name -> launches."""
    from meshrecon_torch import cli
    from meshrecon_torch.io.obj import read_mesh
    from meshrecon_torch.kernels import all_kernels

    kernels = all_kernels()
    before = {k.name: k.launches for k in kernels}
    out = str(tmp_path / "gpu.obj")
    assert cli.main(["tracks/koule-tr.yaml", "--synthetic", "sphere", "-s",
                     "8", "-n", "2", "--seed", "3", "-o", out,
                     "--poisson-grid", "64", *flags]) == 0
    assert len(read_mesh(out).faces) > 0
    return {k.name: k.launches - before[k.name] for k in kernels}


def test_cli_on_gpu(dev, tmp_path):
    """The default reconstruction at 1/8 size through every kernel of its
    path."""
    launches = _cli_launches(tmp_path, [])
    for k in (binned.K1, tile_warp.K2, tile_warp.K3, tile_warp.K3C,
              jacobi.K4):
        assert launches[k.name] > 0, k.name
    assert launches[tile_warp.K3B.name] == launches[jacobi.K6.name] == 0


@pytest.mark.parametrize("flags,kernels", [
    (["--variance-mode", "rewarp"], ("K3B", "K3", "K4")),
    (["-f"], ("K3B", "K3")),
    (["--flow-solver", "mg", "--shadow-sample", "bilinear"], ("K2", "K3"))])
def test_cli_variants_on_gpu(dev, tmp_path, flags, kernels):
    launches = _cli_launches(tmp_path, flags)
    for name in kernels:
        k = getattr(tile_warp, name, None) or getattr(jacobi, name)
        assert launches[k.name] > 0, name


@pytest.mark.parametrize("shape", [
    (1,), (3,), (4,), (5,), (1023,), (8, 128), (4096, 4096), (3, 1001),
    (3 * 4096 + 1028,), ((1 << 20) + 20,)])
def test_roofline_copy(dev, shape):
    """R1, with a tail of n % 4 elements past the float4 loads, and a last
    CTA's chunk cut short (the last two shapes)."""
    x = torch.rand(shape, generator=torch.Generator().manual_seed(8)).to(dev)
    before = roofline.R1.launches
    out = roofline.copy_scale(x)
    assert roofline.R1.launches == before + 1
    assert torch.equal(out, roofline.copy_scale_plain(x))


@pytest.mark.parametrize("shape,inner", [((256, 512), 2048), ((5, 77), 3),
                                         ((100003,), 2050)])
def test_roofline_fma(dev, shape, inner):
    """R2 against its plain version: the tool's block; n below one warp a
    chain and inner below the unroll; a prime n (chains past n in the last
    CTAs) with inner not a multiple of the unroll."""
    g = torch.Generator().manual_seed(9)
    x = (0.999 + 0.002 * torch.rand(shape, generator=g)).to(dev)
    before = roofline.R2.launches
    out = roofline.fma_chain(x, inner)
    assert roofline.R2.launches == before + 1
    ref = roofline.fma_chain_plain(x, inner)
    assert ((out - ref).abs() / ref.abs()).max().item() <= 1e-6


@pytest.mark.parametrize("n", [256 * 512, 5 * 77, 7919, 100003, 1_000_003])
@pytest.mark.parametrize("sms", [132, 114, 1])
def test_roofline_fma_shape(dev, n, sms):
    """R2's geometry in C (mr_roofline_fma_shape) equals its Python mirror,
    which tests/test_torch_roofline_fma.py holds on the CPU."""
    out = (ctypes.c_int * 3)()
    assert library().cdll.mr_roofline_fma_shape(n, sms, out) == 0
    assert tuple(out) == roofline.fma_shape(n, sms)


@pytest.mark.parametrize("rows,nblocks", [
    (8, 1), (8, 2), (8, 8), (40, 1), (64, 2), (64, 64), (264, 1), (296, 2),
    (512, 1), (512, 2), (512, 8), (512, 64)])
def test_roofline_tiny(dev, rows, nblocks):
    """R3 (one CTA) and R4 (a grid of CTAs), each on its own counter; CTAs
    of more float4s than threads (40 rows and up in one CTA), with a last
    batch of loads cut short (264 and 296 rows)."""
    x = torch.randn((rows, 128), generator=torch.Generator().manual_seed(
        10)).to(dev)
    counts = (roofline.R3.launches, roofline.R4.launches)
    if nblocks == 1 and rows == 8:
        out = roofline.add_one(x)
        assert (roofline.R3.launches, roofline.R4.launches) == (
            counts[0] + 1, counts[1])
    else:
        out = roofline.add_one_grid(x, nblocks)
        assert (roofline.R3.launches, roofline.R4.launches) == (
            counts[0], counts[1] + 1)
    assert torch.equal(out, roofline.add_one_plain(x))


def test_roofline_wrappers_refuse(dev):
    x = torch.zeros((8, 128), device=dev)
    with pytest.raises(ValueError):
        roofline.copy_scale(x.view(-1)[1:1025])  # not 16-byte aligned
    with pytest.raises(ValueError):
        roofline.copy_scale(x, out=torch.empty((8, 128)))  # CPU output
    with pytest.raises(ValueError):
        roofline.add_one_grid(x, 3)
    with pytest.raises(ValueError):
        roofline.fma_chain(x.double())


def test_roofline_tiny_refuses_misaligned_pointers(dev):
    """R3's and R4's float4 rows need 16-byte aligned tensors: the
    wrappers raise, and so does the C entry, launching nothing."""
    flat = torch.zeros(9 * 128, device=dev)
    x, ok = flat[1:1 + 8 * 128].view(8, 128), flat[:8 * 128].view(8, 128)
    counts = (roofline.R3.launches, roofline.R4.launches)
    for a, b in ((x, ok), (ok, x)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            roofline.add_one(a, out=b)
        with pytest.raises(ValueError, match="16-byte aligned"):
            roofline.add_one_grid(a, 2, out=b)
        with pytest.raises(RuntimeError, match="roofline_tiny"):
            roofline.R3.launch(a, b, 8, 1)
    assert (roofline.R3.launches, roofline.R4.launches) == counts


def test_a_failed_binding_import_raises(dev, monkeypatch):
    """No fallback: with the binding's import patched to fail, a launch
    raises and nothing is launched (the library has no other path)."""
    from meshrecon_torch.kernels import _build

    def broken(path):
        raise ImportError("the binding's import patched to fail")

    x = torch.zeros((8, 128), device=dev)
    before = roofline.R3.launches
    _build.library.cache_clear()
    monkeypatch.setattr(_build, "import_binding", broken)
    monkeypatch.setattr(roofline.R3, "_fn", None)
    try:
        with pytest.raises(ImportError, match="patched to fail"):
            roofline.add_one(x)
    finally:
        _build.library.cache_clear()
    assert roofline.R3.launches == before


def test_graph_capture_is_not_counted(dev):
    """A launch recorded under CUDA-graph capture runs nothing and is not
    counted; the replay computes."""
    x = torch.zeros((8, 128), device=dev)
    out = torch.empty_like(x)
    roofline.add_one(x, out=out)
    before = roofline.R3.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        roofline.add_one(x, out=out)
    assert roofline.R3.launches == before
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, torch.ones_like(x))


def test_roofline_tool_on_gpu(dev):
    out = roofline.main([])
    assert out["copy_gbs"] > 100 and out["fma_gflops"] > 100
    assert out["mm_tflops"] > 10
    assert 0 < out["launch_graph_us"] and 0 < out["launch_eager_us"]
    assert out["mm_eager_ms"] > 0 and out["fma_eager_ms"] > 0
    graphed = out["graph_launches"]
    assert graphed[roofline.R1.name] == graphed[roofline.R2.name] == 4 * 100
    assert graphed[roofline.R3.name] == 4 * 5000
    assert graphed[roofline.R4.name] == 2 * 4 * 2000


def test_fused_breakdown_on_gpu(dev):
    from meshrecon_torch.tools import fused_breakdown as fb

    out = fb.main(["96", "128", "2", "2", "2", "--launch-us", "2.0"])
    rows = out["stages"]
    assert [r["stage"] for r in rows] == list(fb.STAGES)
    assert all(r["d_events"] is not None for r in rows)
    assert rows[0]["d_events"] > 0 and rows[-1]["ms"] > 0
    ref = fused_main_update_batched(*state.from_numpy(
        problems.fused_problem(2, 2, 96, 128, seed=0), dev), 96, 128)
    parity.check_slice(state.to_numpy(out["all"]),
                       state.to_numpy(ref))
    cost = fb.main(["96", "128", "2", "1", "2", "--cost-only"])
    assert cost["stages"][0]["launches"] == {
        binned.K1.name: 1, binned.SETUP.name: 1, binned.BIN.name: 1}
