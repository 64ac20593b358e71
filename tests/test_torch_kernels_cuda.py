"""The hand-written CUDA kernels against their plain PyTorch versions.

Needs an NVIDIA GPU (sm_90a) and nvcc; skipped elsewhere, since a CUDA
kernel has no CPU mode. This file imports no JAX, so on a machine without
it run it without the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Bounds: K1 and K5 (the two-level raster, through both of its wrappers)
bitwise against ``render_depth`` (same affine edge coefficients,
explicitly rounded operations in the same order); K2's nearest sample
bitwise (an index pick); K2's bilinear sample and K3 1e-4 on a 0..255
scale (the library is built with -fmad=false, so the operation order is
the plain one); K3c the same 1e-4 on valid pixels and exactly 0 on the
others; K4 1e-4 px (the kernel folds the data term into cc and 1/denom as
pallas_jacobi.py does, the plain version does not); K3b 1e-4 on a 0..255
scale (the twin's weights and tap order, -fmad=false); K6 1e-3 px, the
JAX package's bound for hs_jacobi (it repeats hs_jacobi_plain's
arithmetic); K2's bilinear shadow mode 1e-4. The roofline probes: R1, R3
and R4 bitwise (one float32 operation each); R2 1e-6 relative (its plain
version's float64 sum can round before the float32 rounding). The sweep
update, the flow update's variants and the reconstruction on the card
against their plain runs on the CPU; the roofline and breakdown tools on
the card.
"""

import numpy as np
import pytest
import torch

from meshrecon_torch import parity, problems, state
from meshrecon_torch.flow import jacobi, tile_warp
from meshrecon_torch.flow.remap import bilinear_warp, flow_remap
from meshrecon_torch.flow.variational import _hs_sweeps, _hs_sweeps_cheb
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


@pytest.mark.parametrize("n,h,w", [(2, 31, 45), (12, 120, 160)])
def test_warp_bicubic(dev, n, h, w):
    """K3b against flow_remap, with flows that reach off the frame."""
    g = torch.Generator().manual_seed(6)
    img = (255 * torch.rand((n, h, w), generator=g)).to(dev)
    u = (6 * torch.randn((n, h, w), generator=g)).to(dev)
    v = (6 * torch.randn((n, h, w), generator=g)).to(dev)
    before = (tile_warp.K3.launches, tile_warp.K3B.launches)
    out = tile_warp.tile_warp_flow_batched(img, u, v, taps=4)
    assert (tile_warp.K3.launches, tile_warp.K3B.launches) == (
        before[0], before[1] + 1)
    ref = flow_remap(torch.stack([u, v], -1), img)
    assert (out - ref).abs().max().item() <= 1e-4
    cols = torch.arange(w, dtype=torch.float32, device=dev)
    rows = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    scol, srow = cols + u, rows + v
    out = tile_warp.tile_warp_bicubic(img, scol, srow)
    ref = tile_warp.tile_warp_bicubic(img.cpu(), scol.cpu(), srow.cpu())
    assert (out.cpu() - ref).abs().max().item() <= 1e-4


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
    assert jacobi.K6.launches == before + iters
    ur, vr = jacobi.hs_jacobi_plain(ix, iy, c, u0, v0, 144.0, iters=iters)
    assert (u - ur).abs().max().item() <= 1e-3
    assert (v - vr).abs().max().item() <= 1e-3


@pytest.mark.parametrize("n,h,w", [(2, 31, 45), (12, 120, 160)])
def test_warp_bilinear(dev, n, h, w):
    g = torch.Generator().manual_seed(2)
    img = (255 * torch.rand((n, h, w), generator=g)).to(dev)
    u = (6 * torch.randn((n, h, w), generator=g)).to(dev)
    v = (6 * torch.randn((n, h, w), generator=g)).to(dev)
    before = tile_warp.K3.launches
    out = tile_warp.tile_warp_flow_batched(img, u, v)
    assert tile_warp.K3.launches == before + 1
    ref = bilinear_warp(img, torch.stack([u, v], -1))
    assert (out - ref).abs().max().item() <= 1e-4


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
    assert jacobi.K4.launches == before + iters
    if solver == "cheb":
        ur, vr = _hs_sweeps_cheb(prev, warped, u0, v0, 144.0, iters)
    else:
        ur, vr = _hs_sweeps(prev, warped, u0, v0, 144.0, iters)
    assert (u - ur).abs().max().item() <= 1e-4
    assert (v - vr).abs().max().item() <= 1e-4


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


@pytest.mark.parametrize("shape", [(8, 128), (4096, 4096), (3, 1001)])
def test_roofline_copy(dev, shape):
    """R1, with a tail of n % 4 elements past the float4 loads."""
    x = torch.rand(shape, generator=torch.Generator().manual_seed(8)).to(dev)
    before = roofline.R1.launches
    out = roofline.copy_scale(x)
    assert roofline.R1.launches == before + 1
    assert torch.equal(out, roofline.copy_scale_plain(x))


@pytest.mark.parametrize("shape,inner", [((256, 512), 2048), ((5, 77), 3)])
def test_roofline_fma(dev, shape, inner):
    g = torch.Generator().manual_seed(9)
    x = (0.999 + 0.002 * torch.rand(shape, generator=g)).to(dev)
    before = roofline.R2.launches
    out = roofline.fma_chain(x, inner)
    assert roofline.R2.launches == before + 1
    ref = roofline.fma_chain_plain(x, inner)
    assert ((out - ref).abs() / ref.abs()).max().item() <= 1e-6


@pytest.mark.parametrize("rows,nblocks", [(8, 1), (512, 1), (512, 64)])
def test_roofline_tiny(dev, rows, nblocks):
    """R3 (one CTA) and R4 (a grid of CTAs), each on its own counter."""
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
    assert cost["stages"][0]["launches"] == {binned.K1.name: 1}
