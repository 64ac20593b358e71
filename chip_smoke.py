#!/usr/bin/env python3
"""Chip check of meshrecon_torch, the PyTorch / CUDA port, on one GPU.

Run from the root of a checkout:  python3 chip_smoke.py

1. Prints the device (``torch.cuda.get_device_name`` and nvidia-smi's name
   and power limit); exits non-zero without a CUDA device.
2. Builds the hand-written kernels (meshrecon_torch/csrc, one nvcc per
   source in parallel) and the native host meshing library, and prints the
   build times and the compiler's register report.
3. Kernel phases: each kernel against its plain PyTorch version on the
   card, at the shapes its path gives it (the fused update at 640x480, K=3
   sides, B=4): max difference against a stated bound, kernel and plain
   times (CUDA events after a warm-up), the least time the card could take
   (``bound_ms``: bytes over 3.35 TB/s or float32 operations over 67
   TFLOP/s, whichever is larger, H100 SXM data sheet; the peaks and
   ``bound`` live in ``meshrecon_torch.tools.roofline``), and the time of the
   one PyTorch call that computes the same function where there is one
   (``grid_sample``; a yardstick only, never called by the port). K1-K4;
   K2's bilinear shadow mode; K3b (the bicubic re-warp) at 12x480x640 and
   at the K=8 bucket 4x8x480x640; K6 (Jacobi sweeps given the fields) at
   12x480x640, 60 sweeps. A missed bound raises.
   After K1: the raster phase. K5 (the two-level raster, one kernel for
   the TPU's K5a and K5b) bitwise against ``render_depth`` through
   ``render_depth_binned(two_level=True)`` at one camera (K5a) and
   ``render_depth_binned_batched`` at 4 and 16 cameras (K5b), on the
   16,384- and 65,536-triangle spheres and the fused problem's soup at
   640x480, with the binning's and the kernel's ms apart; K1's binning /
   kernel split and both binnings' peak memory at 16 cameras; then the
   raster sweep tool (``meshrecon_torch.tools.raster_sweep``) at its
   defaults with chunks 8 and 16.
   Then the roofline phase: R1-R4 (the roofline probes) against their
   plain versions at the roofline tool's shapes (R1 4096x4096, R2 one
   256x512 block of 2,048 FMAs, R3 8x128 in one CTA, R4 512x128 in 64 and
   in 1 CTAs; R1, R3, R4 bitwise, R2 1e-6 relative), with ``torch.mul`` /
   ``torch.add`` as the library yardsticks; then the roofline tool
   (``meshrecon_torch.tools.roofline``) in-process, counters reset just
   before. Then the breakdown phase: the breakdown tool
   (``meshrecon_torch.tools.fused_breakdown``) at 640x480, K=3, B=1 and
   B=4, its bound taking the tool's graph launch floor; its ``all`` stage
   against ``FusedMainUpdate`` on the same inputs within
   meshrecon_torch/parity.py's bounds.
4. The solver check (the multigrid solver's path on the card): at
   12x240x320, ``hs_solve_mg`` (2 cycles) and 60 K6 sweeps against a
   1,500-sweep K6 fixed point; the multigrid error must beat the 60-sweep
   error and stay under 1 px (tests/test_multigrid.py's check), and the
   card's multigrid solve must agree with the port's CPU solve.
5. The flow update: 3 fused updates (``FusedMainUpdate``) at 640x480, K=3,
   B=4 on a 16,384-triangle sphere, with launch counters reset just
   before; every kernel of its path must have launched, outputs must be
   finite where valid, and batch item 0 must agree with the port's plain
   run of the same inputs on the CPU within meshrecon_torch/parity.py's
   bounds. Then its options the same way, two updates each:
   ``variance="rewarp"`` and ``use_farneback=True`` (K3b), ``flow_solver=
   "mg"`` (K3 warps, no K4), ``shadow_sample="bilinear"`` (K2's mode).
6. K3c (the plane sweep's masked bilinear sample) against its plain
   version at the sweep's shapes: koule-tr's cameras at 640x480, B=4 main
   cameras x K=4 sides and the K=8 bucket, depth planes' coordinate
   fields, so that off-frame and behind-camera pixels are invalid.
7. The sweep update (``FusedSweepUpdate``, 64 depths) on those cameras,
   synthetic frames and a 16,384-triangle sphere fitted to the scene's
   bundles: K1, K2 and K3c must launch, the valid share must pass a floor,
   and batch item 0 must agree with the port's plain CPU run.
8. End to end, three times: ``meshrecon_torch.cli.main`` on koule-tr at
   the defaults (640x480, -n 2, hybrid, 64 depths, Poisson grid 128, trim
   2), seed 3; then with ``--variance-mode rewarp``; then with ``-f``.
   Every kernel of each run's path must launch, the OBJ must have faces,
   and its vertices must lie on the scene's fitted sphere within the run's
   bounds. Prints the wall seconds of each run and of each stage.
9. Prints one JSON line of per-kernel results, then the device line
   ``{"ok": true, "device": {...}}`` last. Each kernel's ``launches`` is
   the count of the path it serves, read just after that path's run with
   the counters reset just before: K1, K2, K3, K3c and K4 from the default
   reconstruction, K3b from the rewarp reconstruction, K6 from the solver
   check, K5a and K5b from the raster sweep tool's run, R1-R4 from the
   roofline tool's run (R3's and R4's eager launches plus its CUDA-graph
   replays x the launches captured, since a replay does not pass through
   ``Kernel.launch``).

TF32 is switched off for matmuls and cuDNN: the reference computes in full
float32 (``Precision.HIGHEST``).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

H, W = 480, 640
B, K = 4, 3
UPDATES = 3
VARIANT_UPDATES = 2
SEED = 0

TRACK = "tracks/koule-tr.yaml"
SWEEP_K = 4
SWEEP_DEPTHS = 64
SWEEP_MAINS = (6, 12, 18, 24)    # each with sides m-6, m-3, m+3, m+6
SWEEP_SEED = 3
VALID_FLOOR = 0.05
SOLVER_N, SOLVER_H, SOLVER_W = 12, 240, 320
ALPHA2 = 144.0  # alpha 12, the pipeline's

# |r - R| / R bounds of the end-to-end meshes (median, p90). The default's
# and the re-warp's: the default reconstruction's bound (the JAX package
# measured the re-warp within draw noise of taylor, BASELINE.md). -f has
# no published figure; on the CPU at 160x120 (-s 4, seed 3, the same JAX-
# made frames for both; tests/test_torch_e2e_options.py run as a script)
# the port gave median 0.0184 / p90 0.0537 and the JAX package 0.0186 /
# 0.0555 (PERF.md): the bound is five times the larger of each, rounded
# up.
E2E_BOUNDS = {"default": (0.20, 0.50), "rewarp": (0.20, 0.50),
              "farneback": (0.10, 0.30)}

def _device_lines(torch):
    print(f"device: {torch.cuda.get_device_name(0)} "
          f"(count {torch.cuda.device_count()})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print("nvidia-smi --query-gpu=name,power.limit:")
    for line in smi.stdout.strip().splitlines():
        print(line.strip())


def _cuda_ms(torch, fn, reps, warm_up=True):
    """Mean milliseconds per call on the GPU timeline, after one warm-up
    call unless the caller has just run ``fn``."""
    if warm_up:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class Results:
    """Per-kernel max error, and the times and bound at its first (main)
    shape."""

    def __init__(self):
        self.err = {}
        self.main = {}

    def add(self, kernel, label, err, bound, ms, plain_ms, work=None,
            library_ms=None):
        """``work``: (bytes, float32 operations) of the call, given at the
        kernel's main shape, which is the first one added."""
        from meshrecon_torch.tools import roofline

        text = (f"{kernel.name} [{label}]: max_abs_err {err:.3e} (bound "
                f"{bound:.1e}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        if work is not None:
            bound_ms, bound_by = roofline.bound(*work)
            text += (f", bound {bound_ms:.4f} ms ({bound_by}: "
                     f"{work[0] / 1e6:.1f} MB, {work[1] / 1e9:.3f} GFLOP)")
        if library_ms is not None:
            text += f", library {library_ms:.4f} ms"
        print(text)
        if not err <= bound:
            raise AssertionError(f"{kernel.name} [{label}]: max abs error "
                                 f"{err} exceeds {bound}")
        self.err[kernel.name] = max(self.err.get(kernel.name, 0.0), err)
        if kernel.name not in self.main:
            if work is None:
                raise AssertionError(f"{kernel.name}: main shape has no work")
            self.main[kernel.name] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def _raster_work(ncam, soup, valid, covered):
    """(bytes, operations) of ``ncam`` depth renders of a soup (K1, K5):
    bytes: cameras, soup, validity in, depth out; operations:
    ``fused_breakdown.raster_ops``."""
    from meshrecon_torch.tools.fused_breakdown import raster_ops

    ntri = int(valid.sum().item())
    return (ncam * 64 + soup.numel() * 4 + valid.numel() + ncam * H * W * 4,
            raster_ops(ncam, ntri, covered, H, W))


def _smooth_field(torch, gen, shape, scale, device):
    """Smooth random field: noise box-blurred twice (torch ops only)."""
    x = torch.randn(shape, generator=gen).to(device)
    lead = x.shape[:-2]
    x = x.reshape(-1, *x.shape[-2:])
    for _ in range(2):
        x = torch.nn.functional.avg_pool2d(x[:, None], 9, 1, 4,
                                           count_include_pad=False)[:, 0]
    x = x.reshape(*lead, *x.shape[-2:])
    return x * (scale / x.abs().amax().clamp(min=1e-6))


def _grid(torch, scol, srow):
    """grid_sample's normalized grid (align_corners=True) for absolute
    pixel coordinates (..., H, W) -> (N, H, W, 2)."""
    h, w = scol.shape[-2:]
    return torch.stack([scol * (2.0 / (w - 1)) - 1.0,
                        srow * (2.0 / (h - 1)) - 1.0],
                       -1).reshape(-1, h, w, 2)


def _library_sample(torch, imgs, grid, mode):
    """The PyTorch call that computes a border-clamped bilinear or bicubic
    (a = -0.75, each tap clamped) sample: imgs (N, C, H, W)."""
    return torch.nn.functional.grid_sample(
        imgs, grid, mode=mode, padding_mode="border", align_corners=True)


def kernel_phases(torch, dev, res, slice_args):
    from meshrecon_torch import problems, state
    from meshrecon_torch.flow import jacobi, tile_warp
    from meshrecon_torch.flow.remap import bilinear_warp
    from meshrecon_torch.flow.variational import _hs_sweeps_cheb
    from meshrecon_torch.raster import binned, rasterizer
    from meshrecon_torch.raster.fragment import (bilinear_sample,
                                                 dilate3x3_max,
                                                 nearest_sample)
    from meshrecon_torch.tools import fused_breakdown as fb

    gen = torch.Generator().manual_seed(SEED)
    cams = torch.cat([slice_args[2][:, None], slice_args[4]], 1).reshape(
        B * (K + 1), 4, 4)
    ncam = B * (K + 1)

    # K1: 16 cameras, the 16k main-path soup and the 65k face cap; bitwise
    depth_sides = None
    for nt, nph in ((64, 128), (128, 256)):
        label = f"{ncam}x{H}x{W}, {2 * nt * nph} tris"
        soup, valid = (torch.from_numpy(a).to(dev) for a in
                       state.pack_soup(problems.sphere_soup(nt, nph)))
        out = binned.render_depth_binned(cams, soup, valid, H, W)
        ref = rasterizer.render_depth(cams, soup, valid, H, W)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        covered = (ref < 1.0).float().mean().item()
        print(f"raster_tiles [{label}]: covered share {covered:.4f}")
        if covered < 0.05:
            raise AssertionError("the sphere is not on screen")
        ms = _cuda_ms(torch, lambda: binned.render_depth_binned(
            cams, soup, valid, H, W), 10)
        plain_ms = _cuda_ms(torch, lambda: rasterizer.render_depth(
            cams, soup, valid, H, W), 1, warm_up=False)
        res.add(binned.K1, label, err, 0.0, ms, plain_ms,
                work=_raster_work(ncam, soup, valid, covered))
        if depth_sides is None:
            depth_sides = out.reshape(B, K + 1, H, W)[:, 1:].reshape(
                B * K, H, W)

    # K2: the side shadow maps and frames at a perturbed reprojection field
    n = B * K
    px = n * H * W
    shadow = dilate3x3_max(depth_sides).contiguous()
    frames = slice_args[5].reshape(n, H, W).contiguous()
    cols = torch.arange(W, dtype=torch.float32, device=dev)
    rows = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    scol = (cols + 1.3 + _smooth_field(torch, gen, (n, H, W), 40.0,
                                       dev)).contiguous()
    srow = (rows - 0.7 + _smooth_field(torch, gen, (n, H, W), 30.0,
                                       dev)).contiguous()
    scol[:, 0, :64] = torch.arange(64, device=dev) + 0.5  # exact .5 ties
    a_k, b_k = tile_warp.tile_warp_sample2_batched(shadow, frames, scol, srow)
    a_p, b_p = nearest_sample(shadow, scol, srow), bilinear_sample(
        frames, scol, srow)
    torch.cuda.synchronize()
    err_a = (a_k - a_p).abs().max().item()
    err_b = (b_k - b_p).abs().max().item()
    ms = _cuda_ms(torch, lambda: tile_warp.tile_warp_sample2_batched(
        shadow, frames, scol, srow), 50)
    plain_ms = _cuda_ms(torch, lambda: (nearest_sample(shadow, scol, srow),
                                        bilinear_sample(frames, scol, srow)),
                        10)
    # the library call samples both sources bilinearly: the bilinear mode
    lib_in = torch.stack([shadow, frames], 1).contiguous()
    grid = _grid(torch, scol, srow)
    lib_ms = _cuda_ms(torch, lambda: _library_sample(
        torch, lib_in, grid, "bilinear"), 50)
    # bytes: 4 float inputs, 2 float outputs a pixel; operations
    # (fb.K2_OPS): ~20 for the bilinear weights and taps, 4 for the
    # nearest pick
    # nearest is a pure index pick; bilinear repeats the plain order of
    # operations (-fmad=false), 1e-4 on the 0..255 scale absorbs nothing
    # but a changed rounding
    res.add(tile_warp.K2, f"{n}x{H}x{W} nearest", err_a, 0.0, ms, plain_ms,
            work=(24 * px, fb.K2_OPS * px), library_ms=lib_ms)
    res.add(tile_warp.K2, f"{n}x{H}x{W} bilinear", err_b, 1e-4, ms, plain_ms)

    # K2's bilinear shadow mode (--shadow-sample bilinear): A on B's taps
    a_k, b_k = tile_warp.tile_warp_sample2_batched(shadow, frames, scol, srow,
                                                   bilinear_a=True)
    a_p = bilinear_sample(shadow, scol, srow)
    lib = _library_sample(torch, lib_in, grid, "bilinear")
    torch.cuda.synchronize()
    err = max((a_k - a_p).abs().max().item(),
              (b_k - b_p).abs().max().item())
    lib_err = max((lib[:, 0] - a_k).abs().max().item(),
                  (lib[:, 1] - b_k).abs().max().item())
    ms = _cuda_ms(torch, lambda: tile_warp.tile_warp_sample2_batched(
        shadow, frames, scol, srow, bilinear_a=True), 50)
    plain_ms = _cuda_ms(torch, lambda: (bilinear_sample(shadow, scol, srow),
                                        bilinear_sample(frames, scol, srow)),
                        10)
    print(f"sample_shadow_frame [bilinear shadow mode]: grid_sample differs "
          f"from the kernel by {lib_err:.3e} at most (its normalized grid)")
    res.add(tile_warp.K2, f"{n}x{H}x{W} bilinear shadow mode", err, 1e-4, ms,
            plain_ms)

    # K3 and K4 at both pyramid levels of the flow solve
    for h, w in ((H, W), (H // 2, W // 2)):
        npx = n * h * w
        img = (127.5 + _smooth_field(torch, gen, (n, h, w), 120.0,
                                     dev)).contiguous()
        u = _smooth_field(torch, gen, (n, h, w), 3.0, dev).contiguous()
        v = _smooth_field(torch, gen, (n, h, w), 3.0, dev).contiguous()
        out = tile_warp.tile_warp_flow_batched(img, u, v)
        ref = bilinear_warp(img, torch.stack([u, v], -1))
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        ms = _cuda_ms(torch, lambda: tile_warp.tile_warp_flow_batched(
            img, u, v), 50)
        plain_ms = _cuda_ms(torch, lambda: bilinear_warp(
            img, torch.stack([u, v], -1)), 10)
        ccols = torch.arange(w, dtype=torch.float32, device=dev)
        crows = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
        grid = _grid(torch, ccols + u, crows + v)
        lib_in = img[:, None]
        lib_ms = _cuda_ms(torch, lambda: _library_sample(
            torch, lib_in, grid, "bilinear"), 50)
        # bytes: image, u, v in, one float out; ~22 operations a pixel
        res.add(tile_warp.K3, f"{n}x{h}x{w}", err, 1e-4, ms, plain_ms,
                work=(16 * npx, fb.K3_OPS * npx), library_ms=lib_ms)

        prev = (127.5 + _smooth_field(torch, gen, (n, h, w), 120.0,
                                      dev)).contiguous()
        warped = (prev + _smooth_field(torch, gen, (n, h, w), 6.0,
                                       dev)).contiguous()
        uk, vk = jacobi.hs_level_fused(prev, warped, u, v, ALPHA2, iters=14,
                                       solver="cheb")
        up, vp = _hs_sweeps_cheb(prev, warped, u, v, ALPHA2, 14)
        torch.cuda.synchronize()
        err = max((uk - up).abs().max().item(), (vk - vp).abs().max().item())
        ms = _cuda_ms(torch, lambda: jacobi.hs_level_fused(
            prev, warped, u, v, ALPHA2, iters=14, solver="cheb"), 20)
        plain_ms = _cuda_ms(torch, lambda: _hs_sweeps_cheb(
            prev, warped, u, v, ALPHA2, 14), 5)
        # the kernel folds the data term into cc and 1/denom
        # (pallas_jacobi.py's form), the plain version does not: 1e-4 px.
        # bytes: prev, warped, u0, v0 in, u, v out; operations: 22 for the
        # linearization, 33 a Chebyshev sweep
        res.add(jacobi.K4, f"{n}x{h}x{w}, 14 cheb sweeps", err, 1e-4, ms,
                plain_ms, work=(24 * npx, (fb.K4_LIN_OPS
                                           + 14 * fb.K4_SWEEP_OPS) * npx))


def _peak_mb(torch, fn):
    """Peak device memory of one call of ``fn`` above what was allocated
    before it, in MB."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 1e6


def raster_phase(torch, dev, res, slice_args):
    """K5 (the two-level raster) against ``render_depth``, bitwise, through
    both of its wrappers: K5a at one camera, K5b at 4 and at the flow
    update's 16 cameras, on the 16,384- and 65,536-triangle spheres and the
    fused problem's soup at 640x480; each with its wrapper, binning and
    kernel ms, and K1's split and both binnings' peak memory at 16 cameras.
    Then the raster sweep tool at its defaults with chunks 8 and 16, its
    launch counts reset just before: returns them (K5a's and K5b's path)."""
    from meshrecon_torch import problems, state
    from meshrecon_torch.kernels import all_kernels
    from meshrecon_torch.raster import binned, rasterizer
    from meshrecon_torch.tools import raster_sweep

    cams16 = torch.cat([slice_args[2][:, None], slice_args[4]], 1).reshape(
        B * (K + 1), 4, 4)
    soups = [(f"{2 * nt * nph} tris", state.pack_soup(
        problems.sphere_soup(nt, nph))) for nt, nph in ((64, 128),
                                                        (128, 256))]
    soups.append(("fused problem soup, 512 tris",
                  problems.fused_problem(1, K, 8, 8, seed=SEED)[:2]))
    for soup_label, arrays in soups:
        soup, valid = (torch.from_numpy(a).to(dev) for a in arrays)
        for kernel, ncam in ((binned.K5A, 1), (binned.K5B, B * (K + 1)),
                             (binned.K5B, K + 1)):
            cams = cams16[:ncam]
            label = f"{ncam}x{H}x{W}, {soup_label}"
            if kernel is binned.K5A:
                def fn():
                    return binned.render_depth_binned(
                        cams, soup, valid, H, W, two_level=True)
            else:
                def fn():
                    return binned.render_depth_binned_batched(
                        cams, soup, valid, H, W)
            ref = rasterizer.render_depth(cams, soup, valid, H, W)
            out = fn()
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            covered = (ref < 1.0).float().mean().item()
            if covered < 0.01:
                raise AssertionError(f"{label}: the soup is not on screen")
            ms = _cuda_ms(torch, fn, 10)
            plain_ms = _cuda_ms(torch, lambda: rasterizer.render_depth(
                cams, soup, valid, H, W), 1, warm_up=False)
            bins = binned.bin_soup(cams, soup, valid, H, W, two_level=True)
            bin_ms = _cuda_ms(torch, lambda: binned.bin_soup(
                cams, soup, valid, H, W, two_level=True), 10)
            kern_ms = _cuda_ms(torch, lambda: binned.raster_binned(
                kernel, bins), 10)
            print(f"{kernel.name} [{label}]: covered share {covered:.4f}; "
                  f"binning {bin_ms:.4f} ms, kernel alone {kern_ms:.4f} ms "
                  f"(list table {bins['lists'].numel()} entries)")
            del bins
            res.add(kernel, label, err, 0.0, ms, plain_ms,
                    work=_raster_work(ncam, soup, valid, covered))

        # K1 at 16 cameras: the binning against the kernel, and the peak
        # memory of each binning
        cams = cams16
        bins = binned.bin_soup(cams, soup, valid, H, W)
        k1_ms = _cuda_ms(torch, lambda: binned.render_depth_binned(
            cams, soup, valid, H, W), 10)
        k1_bin = _cuda_ms(torch, lambda: binned.bin_soup(
            cams, soup, valid, H, W), 10)
        k1_kern = _cuda_ms(torch, lambda: binned.raster_binned(binned.K1,
                                                               bins), 10)
        del bins
        mem1 = _peak_mb(torch, lambda: binned.bin_soup(cams, soup, valid, H,
                                                       W))
        mem2 = _peak_mb(torch, lambda: binned.bin_soup(
            cams, soup, valid, H, W, two_level=True))
        print(f"raster_tiles [{len(cams)}x{H}x{W}, {soup_label}]: wrapper "
              f"{k1_ms:.4f} ms = binning {k1_bin:.4f} ms + kernel alone "
              f"{k1_kern:.4f} ms; binning peak memory: one level (K1) "
              f"{mem1:.1f} MB, two levels (K5b) {mem2:.1f} MB")

    for k in all_kernels():
        k.launches = 0
    t0 = time.perf_counter()
    raster_sweep.main(["--chunks", "8,16"])
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in all_kernels()}
    print(f"raster sweep tool: {time.perf_counter() - t0:.1f} s, launches "
          f"{launches}")
    for k in (binned.K1, binned.K5A, binned.K5B):
        if launches[k.name] == 0:
            raise AssertionError(f"{k.name} not launched by the sweep tool")
    return launches


def roofline_phase(torch, dev, res):
    """R1-R4 against their plain versions at the roofline tool's shapes:
    R1, R3 and R4 bitwise, R2 to 1e-6 relative (the plain version's float64
    sum can round before its float32 rounding); then the roofline tool
    (``meshrecon_torch.tools.roofline``) in-process, its launch counts reset
    just before. Returns (the tool's numbers, its launches); R3's and R4's
    launches add the tool's CUDA-graph replays x the launches captured."""
    from meshrecon_torch.kernels import all_kernels
    from meshrecon_torch.tools import roofline as rl

    gen = torch.Generator().manual_seed(SEED + 4)
    x = torch.rand(rl.COPY_SHAPE, generator=gen).to(dev)
    y = torch.empty_like(x)
    err = (rl.copy_scale(x) - rl.copy_scale_plain(x)).abs().max().item()
    ms = _cuda_ms(torch, lambda: rl.copy_scale(x, out=y), 50)
    plain_ms = _cuda_ms(torch, lambda: rl.copy_scale_plain(x), 50)
    lib_ms = _cuda_ms(torch, lambda: torch.mul(x, rl.COPY_SCALE, out=y), 50)
    # bytes: one float in, one out; one multiply an element
    res.add(rl.R1, "4096x4096", err, 0.0, ms, plain_ms,
            work=(8 * x.numel(), x.numel()), library_ms=lib_ms)
    del x, y

    b = (0.999 + 0.002 * torch.rand(rl.FMA_SHAPE, generator=gen)).to(dev)
    o = torch.empty_like(b)
    out, ref = rl.fma_chain(b), rl.fma_chain_plain(b)
    rel = ((out - ref).abs() / ref.abs()).max().item()
    print(f"{rl.R2.name}: max relative error {rel:.3e} (bound 1e-6)")
    if not rel <= 1e-6:
        raise AssertionError(f"{rl.R2.name}: relative error {rel}")
    ms = _cuda_ms(torch, lambda: rl.fma_chain(b, out=o), 50)
    plain_ms = _cuda_ms(torch, lambda: rl.fma_chain_plain(b), 2)
    # bytes: one float in, one out; operations: 2 an FMA
    res.add(rl.R2, f"256x512, {rl.INNER} FMAs", (out - ref).abs().max().item(),
            1e-6 * ref.abs().max().item(), ms, plain_ms,
            work=(8 * b.numel(), 2 * rl.INNER * b.numel()))

    for kernel, rows, nblocks in ((rl.R3, rl.TINY_ROWS, 1),
                                  (rl.R4, rl.GRID_ROWS, 64),
                                  (rl.R4, rl.GRID_ROWS, 1)):
        c = torch.randn((rows, rl.TINY_COLS), generator=gen).to(dev)
        o = torch.empty_like(c)

        def fn(out=None):
            if kernel is rl.R3:
                return rl.add_one(c, out=out)
            return rl.add_one_grid(c, nblocks, out=out)
        err = (fn() - rl.add_one_plain(c)).abs().max().item()
        ms = _cuda_ms(torch, lambda: fn(o), 1000)
        plain_ms = _cuda_ms(torch, lambda: rl.add_one_plain(c), 1000)
        lib_ms = _cuda_ms(torch, lambda: torch.add(c, 1.0, out=o), 1000)
        res.add(kernel, f"{rows}x{rl.TINY_COLS}, {nblocks} CTA(s)", err, 0.0,
                ms, plain_ms, work=(8 * c.numel(), c.numel()),
                library_ms=lib_ms)

    for k in all_kernels():
        k.launches = 0
    t0 = time.perf_counter()
    numbers = rl.main([])
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in all_kernels()}
    for name, count in numbers["graph_launches"].items():
        launches[name] += count
    print(f"roofline tool: {time.perf_counter() - t0:.1f} s, launches "
          f"{launches} (eager Kernel.launch calls; R3 and R4 add their "
          f"graph replays x launches captured: {numbers['graph_launches']})")
    for k in (rl.R1, rl.R2, rl.R3, rl.R4):
        if launches[k.name] == 0:
            raise AssertionError(f"{k.name} not launched by the roofline "
                                 "tool")
    return numbers, launches


def breakdown_phase(torch, dev, launch_us):
    """The breakdown tool (``meshrecon_torch.tools.fused_breakdown``) at
    640x480, K=3, B=1 (its default) and B=4 (the CLI's batch), its bound
    taking ``launch_us`` a launch; its ``all`` stage against
    ``FusedMainUpdate`` on the same inputs within parity.py's bounds."""
    from meshrecon_torch import parity, problems, state
    from meshrecon_torch.pipeline.fused import FusedMainUpdate
    from meshrecon_torch.tools import fused_breakdown

    for b in (1, B):
        t0 = time.perf_counter()
        out = fused_breakdown.main([str(H), str(W), str(K), "10", str(b),
                                    "--launch-us", repr(launch_us)])
        args = state.from_numpy(problems.fused_problem(b, K, H, W, seed=0),
                                dev)
        ref = FusedMainUpdate(H, W).to(dev)(*args)
        metrics = parity.check_slice(state.to_numpy(out["all"]),
                                     state.to_numpy(ref))
        print(f"breakdown B={b}: {time.perf_counter() - t0:.1f} s; all "
              f"stage vs FusedMainUpdate (meshrecon_torch/parity.py "
              "bounds): " + ", ".join(f"{k} {v:.3e}"
                                     for k, v in metrics.items()))


def k3b_phase(torch, dev, res):
    """K3b against flow_remap: the e2e re-warp's B*K=12 stack and the K=8
    bucket, a smooth flow of a few px pushed 20 px off the left border on
    its first 16 columns and off the bottom on its last 8 rows, so that
    every tap there clamps."""
    from meshrecon_torch.flow import tile_warp
    from meshrecon_torch.flow.remap import flow_remap

    gen = torch.Generator().manual_seed(SEED + 1)
    for shape in ((B * K, H, W), (B, 8, H, W)):
        px = int(np.prod(shape))
        label = "x".join(map(str, shape))
        img = (127.5 + _smooth_field(torch, gen, shape, 120.0,
                                     dev)).contiguous()
        u = _smooth_field(torch, gen, shape, 3.0, dev)
        v = _smooth_field(torch, gen, shape, 3.0, dev)
        u[..., :16] -= 20.0
        v[..., -8:, :] += 20.0
        u, v = u.contiguous(), v.contiguous()
        out = tile_warp.tile_warp_flow_batched(img, u, v, taps=4)
        ref = flow_remap(torch.stack([u, v], -1), img)
        cols = torch.arange(W, dtype=torch.float32, device=dev)
        rows = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
        grid = _grid(torch, cols + u, rows + v)
        lib_in = img.reshape(-1, 1, H, W)
        lib = _library_sample(torch, lib_in, grid, "bicubic")
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        lib_err = (lib.reshape(shape) - ref).abs().max().item()
        ms = _cuda_ms(torch, lambda: tile_warp.tile_warp_flow_batched(
            img, u, v, taps=4), 50)
        plain_ms = _cuda_ms(torch, lambda: flow_remap(
            torch.stack([u, v], -1), img), 5)
        lib_ms = _cuda_ms(torch, lambda: _library_sample(
            torch, lib_in, grid, "bicubic"), 50)
        print(f"warp_bicubic [{label}]: grid_sample(bicubic, border) "
              f"differs from flow_remap by {lib_err:.3e} at most (its "
              f"normalized grid)")
        # the twin's weights and tap order, -fmad=false: 1e-4 on 0..255.
        # bytes: image, u, v in, one float out; operations: ~34 for the
        # 4 + 4 weights, 32 for the 16 taps, 8 for the row sums, 6 for the
        # coordinates
        res.add(tile_warp.K3B, label, err, 1e-4, ms, plain_ms,
                work=(16 * px, 80 * px), library_ms=lib_ms)


def _linearization(torch, dev, gen, n, h, w):
    """A stack of smooth images shifted by (3, -2) px, warped (K3) by the
    flow (2.5, -1.5): the problem of tests/test_multigrid.py. Returns
    (prev, warped, u0, v0)."""
    from meshrecon_torch.flow import tile_warp

    base = 127.5 + _smooth_field(torch, gen, (n, h + 8, w + 8), 120.0, dev)
    prev = base[:, 4:4 + h, 4:4 + w].contiguous()
    nxt = base[:, 6:6 + h, 1:1 + w].contiguous()  # next(c+3, r-2) = prev
    u0 = torch.full((n, h, w), 2.5, device=dev)
    v0 = torch.full((n, h, w), -1.5, device=dev)
    return prev, tile_warp.tile_warp_flow_batched(nxt, u0, v0), u0, v0


def k6_phase(torch, dev, res):
    """K6 against hs_jacobi_plain: 60 sweeps at 12x480x640."""
    from meshrecon_torch.flow import jacobi
    from meshrecon_torch.flow.multigrid import hs_fields

    gen = torch.Generator().manual_seed(SEED + 2)
    n = B * K
    px = n * H * W
    prev, warped, u0, v0 = _linearization(torch, dev, gen, n, H, W)
    ix, iy, c = (t.contiguous() for t in hs_fields(prev, warped, u0, v0))
    uk, vk = jacobi.hs_jacobi(ix, iy, c, u0, v0, ALPHA2, iters=60)
    up, vp = jacobi.hs_jacobi_plain(ix, iy, c, u0, v0, ALPHA2, iters=60)
    torch.cuda.synchronize()
    err = max((uk - up).abs().max().item(), (vk - vp).abs().max().item())
    ms = _cuda_ms(torch, lambda: jacobi.hs_jacobi(ix, iy, c, u0, v0, ALPHA2,
                                                  iters=60), 10)
    plain_ms = _cuda_ms(torch, lambda: jacobi.hs_jacobi_plain(
        ix, iy, c, u0, v0, ALPHA2, iters=60), 3)
    # the plain version's arithmetic in its order (-fmad=false); 1e-3 px is
    # the JAX package's bound for hs_jacobi (tests/test_pallas_jacobi.py).
    # bytes: ix, iy, c, u0, v0 in, u, v out; operations: 5 for 1/denom,
    # 27 a sweep (two 9-operation averages, the data term, the update)
    res.add(jacobi.K6, f"{n}x{H}x{W}, 60 sweeps", err, 1e-3, ms, plain_ms,
            work=(28 * px, (5 + 60 * 27) * px))


def solver_check(torch, dev):
    """The multigrid solver against the K6 fixed point, on the card and
    against the port's CPU solve. Returns the launch counts of the run."""
    from meshrecon_torch.flow import jacobi
    from meshrecon_torch.flow.multigrid import hs_fields, hs_solve_mg
    from meshrecon_torch.kernels import all_kernels

    gen = torch.Generator().manual_seed(SEED + 3)
    n, h, w = SOLVER_N, SOLVER_H, SOLVER_W
    prev, warped, u0, v0 = _linearization(torch, dev, gen, n, h, w)
    torch.cuda.synchronize()
    for k in all_kernels():
        k.launches = 0
    t0 = time.perf_counter()
    ix, iy, c = (t.contiguous() for t in hs_fields(prev, warped, u0, v0))
    u_star, v_star = jacobi.hs_jacobi(ix, iy, c, u0, v0, ALPHA2, iters=1500)
    u60, v60 = jacobi.hs_jacobi(ix, iy, c, u0, v0, ALPHA2, iters=60)
    um, vm = hs_solve_mg(prev, warped, u0, v0, ALPHA2, cycles=2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in all_kernels()}

    def interior_err(u, v):
        return ((u - u_star)[:, 8:-8, 8:-8].abs().max()
                + (v - v_star)[:, 8:-8, 8:-8].abs().max()).item()

    err_mg, err_60 = interior_err(um, vm), interior_err(u60, v60)
    mg_ms = _cuda_ms(torch, lambda: hs_solve_mg(prev, warped, u0, v0,
                                                ALPHA2, cycles=2), 5)
    t0 = time.perf_counter()
    cu, cv = hs_solve_mg(*(t.cpu() for t in (prev, warped, u0, v0)), ALPHA2,
                         cycles=2)
    cpu_s = time.perf_counter() - t0
    diff = max((um.cpu() - cu).abs().max().item(),
               (vm.cpu() - cv).abs().max().item())
    print(f"solver check [{n}x{h}x{w}]: interior error against the "
          f"1,500-sweep K6 fixed point: mg (2 cycles) {err_mg:.4f} px, 60 "
          f"K6 sweeps {err_60:.4f} px (mg must beat it and stay under 1 "
          f"px); card mg vs CPU mg {diff:.3e} px (bound 1e-3); mg {mg_ms:.3f}"
          f" ms on the card, {cpu_s:.2f} s on the CPU; the check took "
          f"{wall:.3f} s, launches {launches}")
    if not (err_mg < err_60 and err_mg < 1.0):
        raise AssertionError(f"mg error {err_mg} does not beat 60 Jacobi "
                             f"sweeps ({err_60}) or exceeds 1 px")
    # the same torch ops in the same order on both devices: 1e-3 px, the
    # fixed point's own bound
    if not diff <= 1e-3:
        raise AssertionError(f"card mg differs from CPU mg by {diff}")
    if launches[jacobi.K6.name] == 0:
        raise AssertionError("K6 not launched by the solver check")
    return launches


def _check_update(out, label):
    from meshrecon_torch import state

    out = state.to_numpy(out)
    valid = out["valid"]
    share = float(valid.mean())
    print(f"{label}: valid share {share:.4f} (floor 0.05)")
    if share < 0.05:
        raise AssertionError(f"{label}: valid share {share} below 0.05")
    for key in ("point4", "normals", "pdf"):
        if not np.isfinite(out[key][valid]).all():
            raise AssertionError(f"{label}: non-finite {key} on valid pixels")
    return out


def run_slice(torch, dev, args_np, label, updates, path, **options):
    """``updates`` fused updates with ``options`` on the card, counters
    reset just before; every kernel of ``path`` must launch; batch item 0
    against the plain run of the same inputs on the CPU."""
    from meshrecon_torch import parity, state
    from meshrecon_torch.kernels import all_kernels
    from meshrecon_torch.pipeline.fused import (FusedMainUpdate,
                                                fused_main_update_batched)

    args = state.from_numpy(args_np, dev)
    model = FusedMainUpdate(H, W, **options).to(dev)
    for k in all_kernels():
        k.launches = 0
    times = []
    for _ in range(updates):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model(*args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = {k.name: k.launches for k in all_kernels()}
    print(f"{label}: B={B} K={K} {W}x{H}, {int(args_np[1].sum())} tris, "
          f"ms/update {[round(t, 3) for t in times]}, "
          f"GN sweeps {model.last_gn_sweeps}, launches {launches}")
    missing = [k.name for k in path if launches[k.name] == 0]
    if missing:
        raise AssertionError(f"{label}: kernels not launched: {missing}")
    out = _check_update(out, label)

    # batch item 0 against the plain versions on the CPU, at B=1
    t0 = time.perf_counter()
    cpu = state.to_numpy(fused_main_update_batched(
        *state.from_numpy([a[:1] if i > 1 else a
                           for i, a in enumerate(args_np)], "cpu"), H, W,
        **options))
    print(f"{label}: CPU plain run of item 0 took "
          f"{time.perf_counter() - t0:.1f} s")
    metrics = parity.slice_agreement({k: v[:1] for k, v in out.items()}, cpu)
    print(f"{label} vs CPU (meshrecon_torch/parity.py bounds): "
          + ", ".join(f"{k} {v:.3e}" for k, v in metrics.items()))
    parity.check_slice({k: v[:1] for k, v in out.items()}, cpu)


def sweep_problem(torch, dev):
    """The sweep update's ten inputs on koule-tr at 640x480: synthetic
    frames made on the card, B=4 main cameras with K=4 sides each, and a
    16,384-triangle sphere fitted to the scene's bundles. Returns numpy
    arrays (the CPU check needs them)."""
    from meshrecon_torch import problems, state
    from meshrecon_torch.geometry.camera import np_extract_camera_center
    from meshrecon_torch.io.synthetic import fit_sphere, synthetic_frames
    from meshrecon_torch.io.tracks import load_tracks

    track = load_tracks(TRACK)
    frames = synthetic_frames(track, W, H, mode="sphere", seed=SWEEP_SEED,
                              device=dev).cpu().numpy()
    center, radius = fit_sphere(track.bundles)
    soup, soup_valid = state.pack_soup(
        problems.sphere_soup(64, 128, center=center, radius=radius))
    b, k, cb = len(SWEEP_MAINS), SWEEP_K, 8
    mains = np.stack([track.cameras[m] for m in SWEEP_MAINS])
    sides = [[m - 6, m - 3, m + 3, m + 6] for m in SWEEP_MAINS]
    scs = np.stack([track.cameras[s_] for s_ in sides])
    ctrs = np.zeros((b, cb, 3), np.float32)
    cvs = np.zeros((b, cb), bool)
    for i, m in enumerate(SWEEP_MAINS):
        c4 = np.stack([np_extract_camera_center(track.cameras[f])
                       for f in [m] + sides[i]])
        ctrs[i, : k + 1] = c4[:, :3] / c4[:, 3:]
        cvs[i, : k + 1] = True
    args = [soup, soup_valid, mains, frames[list(SWEEP_MAINS)], scs,
            frames[np.asarray(sides)], np.ones((b, k), bool), ctrs, cvs,
            np.full(b, k, np.int32)]
    return args


def k3c_phase(torch, dev, res, sweep_args):
    """K3c against its plain version on the sweep's coordinate fields: at
    K=4 sides the plane in the middle of the main cameras' rendered depth
    range, and at K=8 (the bucket of bundles with 5 to 8 sides) that plane
    beside the one at the lower quartile."""
    from meshrecon_torch.flow import tile_warp
    from meshrecon_torch.raster import binned
    from meshrecon_torch.raster.rasterizer import pixel_grid

    soup, soup_valid, mains, _, scs, sfs = sweep_args[:6]
    depth = binned.render_depth_binned(mains, soup, soup_valid, H, W)
    cm = scs @ torch.linalg.inv(mains)[:, None]
    cols, rows = pixel_grid(H, W, dev)

    def field(z):
        def row(r):
            c = cm[:, :, r, :, None, None]
            return c[:, :, 0] * cols + c[:, :, 1] * rows[:, None] \
                + c[:, :, 2] * z + c[:, :, 3]

        sw = row(3)
        ok = sw > 1e-6
        sw = torch.where(sw.abs() < 1e-6, 1e-6, sw)
        sx, sy = row(0) / sw, row(1) / sw
        ok = ok & (sx.abs() < 1.0) & (sy.abs() < 1.0)
        return (sx + 1.0) * 0.5 * W, (1.0 - sy) * 0.5 * H, ok

    zs = depth[depth < 1.0]
    planes = [field(zs.median()), field(zs.quantile(0.25))]
    for parts in (planes[:1], planes):
        scol, srow, ok = (torch.cat(f, 1).contiguous() for f in zip(*parts))
        srcs = torch.cat([sfs] * len(parts), 1).contiguous()
        b, k = srcs.shape[:2]
        px = b * k * H * W
        share = ok.float().mean().item()
        label = f"{b}x{k}x{H}x{W} valid pixels"
        print(f"sample_bilinear_masked [{label}]: valid share {share:.4f}")
        if not 0.05 < share < 1.0:
            raise AssertionError(f"K3c plane: valid share {share} is not a "
                                 "mix of valid and invalid pixels")
        out = tile_warp.tile_warp_sample_batched(srcs, scol, srow, ok)
        ref = tile_warp.sample_bilinear_masked_plain(srcs, scol, srow, ok)
        torch.cuda.synchronize()
        if (out[~ok] != 0).any():
            raise AssertionError("K3c: invalid pixels are not exactly 0")
        err = (out - ref)[ok].abs().max().item()
        ms = _cuda_ms(torch, lambda: tile_warp.tile_warp_sample_batched(
            srcs, scol, srow, ok), 50)
        plain_ms = _cuda_ms(
            torch, lambda: tile_warp.sample_bilinear_masked_plain(
                srcs, scol, srow, ok), 10)
        # the library call samples every pixel and does not mask
        grid = _grid(torch, scol, srow)
        lib_in = srcs.reshape(-1, 1, H, W)
        lib_ms = _cuda_ms(torch, lambda: _library_sample(
            torch, lib_in, grid, "bilinear"), 50)
        # the same arithmetic in the same order (-fmad=false): 1e-4 on
        # 0..255. bytes: image, coordinates, mask byte in, one float out;
        # ~22 operations a valid pixel
        res.add(tile_warp.K3C, label, err, 1e-4, ms, plain_ms,
                work=(17 * px, 22 * share * px), library_ms=lib_ms)


def _swept_ndc(out, mains):
    """NDC depth of the swept points: point4 projected by the main camera."""
    p = np.einsum("bij,bhwj->bhwi", mains.astype(np.float64),
                  out["point4"].astype(np.float64))
    return p[..., 2] / np.where(np.abs(p[..., 3]) < 1e-30, 1e-30, p[..., 3])


def run_sweep(torch, dev, args_np):
    """The sweep update on the card, with the launch counts of its run, and
    batch item 0 against the plain CPU run."""
    from meshrecon_torch import state
    from meshrecon_torch.flow import tile_warp
    from meshrecon_torch.pipeline.fused import (FusedSweepUpdate,
                                                fused_sweep_update_batched)
    from meshrecon_torch.raster import binned

    args = state.from_numpy(args_np, dev)
    model = FusedSweepUpdate(H, W, num_depths=SWEEP_DEPTHS)
    kernels = (binned.K1, tile_warp.K2, tile_warp.K3C)
    times = []
    for _ in range(2):
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model(*args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = {k.name: k.launches for k in kernels}
    print(f"sweep: B={len(SWEEP_MAINS)} K={SWEEP_K} {W}x{H}, "
          f"{int(args_np[1].sum())} tris, {SWEEP_DEPTHS} depths, "
          f"ms/update {[round(t, 3) for t in times]}, launches {launches}")
    missing = [name for name, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched by the sweep: {missing}")
    out = state.to_numpy(out)
    share = float(out["valid"].mean())
    print(f"sweep: valid share {share:.4f} (floor {VALID_FLOOR})")
    if share < VALID_FLOOR:
        raise AssertionError(f"sweep valid share {share} below {VALID_FLOOR}")
    for key in ("point4", "normals", "pdf"):
        if not np.isfinite(out[key][out["valid"]]).all():
            raise AssertionError(f"sweep: non-finite {key} on valid pixels")

    t0 = time.perf_counter()
    cpu = state.to_numpy(fused_sweep_update_batched(
        *state.from_numpy([a[:1] if i > 1 else a
                           for i, a in enumerate(args_np)], "cpu"), H, W,
        num_depths=SWEEP_DEPTHS))
    print(f"sweep: CPU plain run of item 0 took "
          f"{time.perf_counter() - t0:.1f} s")
    gpu = {k_: v[:1] for k_, v in out.items()}
    valid_agree = float((gpu["valid"] == cpu["valid"]).mean())
    both = gpu["valid"] & cpu["valid"]
    dz = np.abs(_swept_ndc(gpu, args_np[2][:1]) - _swept_ndc(
        cpu, args_np[2][:1]))[both]
    within = float((dz <= 1e-4).mean())
    rendered = float(np.abs(gpu["depth"] - cpu["depth"]).max())
    print(f"sweep vs CPU: valid masks equal on {valid_agree:.6f} (bound "
          f"0.999), swept NDC depth within 1e-4 on {within:.6f} of valid "
          f"pixels (bound 0.99), rendered depth max diff {rendered:.3e} "
          f"(bound 1e-5)")
    if valid_agree < 0.999 or within < 0.99 or rendered > 1e-5:
        raise AssertionError("sweep update disagrees with its CPU run")


def run_e2e(torch, dev, label, flags, path):
    """One reconstruction through the CLI, in-process, with ``flags``; the
    counters reset just before, every kernel of ``path`` must launch.
    Returns the launch counts."""
    from meshrecon_torch import cli
    from meshrecon_torch.io.obj import read_mesh
    from meshrecon_torch.io.synthetic import fit_sphere
    from meshrecon_torch.io.tracks import load_tracks
    from meshrecon_torch.kernels import all_kernels
    from meshrecon_torch.utils.profiling import StageTimer

    out_dir = Path("build") / "chip_smoke"  # git-ignored
    out_dir.mkdir(parents=True, exist_ok=True)
    suffix = "" if label == "default" else f"_{label}"
    obj = out_dir / f"chip_smoke_e2e{suffix}.obj"
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    timer = StageTimer()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = cli.main([TRACK, "--synthetic", "sphere", "--seed", "3", "-o",
                   str(obj), "--device", "cuda", "-v", *flags], timer=timer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    print(f"e2e {label} {flags}: cli.main rc {rc}, wall {wall:.2f} s, "
          f"launches {launches}")
    print(f"e2e {label} stages (card-synchronized wall seconds):")
    for line in timer.report().splitlines():
        print(f"  {line}")
    missing = [k.name for k in path if launches[k.name] == 0]
    if rc != 0 or missing:
        raise AssertionError(f"e2e {label}: rc {rc}, kernels not launched "
                             f"{missing}")
    mesh = read_mesh(str(obj))
    track = load_tracks(TRACK)
    center, radius = fit_sphere(track.bundles)
    v3 = mesh.vertices[:, :3] / mesh.vertices[:, 3:4]
    err = np.abs(np.linalg.norm(v3 - center, axis=1) - radius) / radius
    med, p90 = float(np.median(err)), float(np.percentile(err, 90))
    bound_med, bound_p90 = E2E_BOUNDS[label]
    print(f"e2e {label}: {len(mesh.faces)} faces, {len(mesh.vertices)} "
          f"vertices; |r - R| / R median {med:.4f} (bound {bound_med}), "
          f"p90 {p90:.4f} (bound {bound_p90})")
    if not len(mesh.faces) or not np.isfinite(v3).all():
        raise AssertionError(f"e2e {label}: empty or non-finite mesh")
    if not (med <= bound_med and p90 <= bound_p90):
        raise AssertionError(f"e2e {label}: mesh off the sphere (median "
                             f"{med}, p90 {p90})")
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU",
              file=sys.stderr)
        return 1
    try:
        import meshrecon_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run it from the root of a meshrecon checkout",
              file=sys.stderr)
        return 1
    from meshrecon_torch import problems, state
    from meshrecon_torch.flow import jacobi, tile_warp
    from meshrecon_torch.kernels import all_kernels, library
    from meshrecon_torch.meshing import native
    from meshrecon_torch.raster import binned
    from meshrecon_torch.tools import roofline
    # the wrappers own the Kernel objects: import them before listing
    import meshrecon_torch.pipeline.fused  # noqa: F401
    import meshrecon_torch.pipeline.reconstruct  # noqa: F401

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: off (matmul and cuDNN)")
    _device_lines(torch)
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    lib = library()
    print(f"build: {lib.build_seconds:.1f} s -> {lib.path.name}")
    for line in lib.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"ptxas: {line.strip()}")
    t0 = time.perf_counter()
    native.library()  # the host meshing library, outside the timed phases
    print(f"build: native meshing library {time.perf_counter() - t0:.1f} s")

    K1, K2, K3, K3B, K3C, K4, K6 = (
        binned.K1, tile_warp.K2, tile_warp.K3, tile_warp.K3B, tile_warp.K3C,
        jacobi.K4, jacobi.K6)
    args_np = list(problems.fused_problem(B, K, H, W, seed=SEED))
    args_np[0], args_np[1] = state.pack_soup(problems.sphere_soup(64, 128))
    res = Results()
    kernel_phases(torch, dev, res, state.from_numpy(args_np, dev))
    raster_launches = raster_phase(torch, dev, res,
                                   state.from_numpy(args_np, dev))
    roof, roof_launches = roofline_phase(torch, dev, res)
    breakdown_phase(torch, dev, roof["launch_graph_us"])
    k3b_phase(torch, dev, res)
    k6_phase(torch, dev, res)
    torch.cuda.synchronize()
    solver_launches = solver_check(torch, dev)

    run_slice(torch, dev, args_np, "flow update", UPDATES,
              (K1, K2, K3, K4))
    for label, path, options in (
            ("flow update rewarp", (K1, K2, K3, K4, K3B),
             dict(variance="rewarp")),
            ("flow update farneback", (K1, K2, K3, K3B),
             dict(use_farneback=True)),
            ("flow update mg", (K1, K2, K3), dict(flow_solver="mg")),
            ("flow update shadow bilinear", (K1, K2, K3, K4),
             dict(shadow_sample="bilinear"))):
        run_slice(torch, dev, args_np, label, VARIANT_UPDATES, path,
                  **options)

    sweep_args = sweep_problem(torch, dev)
    k3c_phase(torch, dev, res, state.from_numpy(sweep_args, dev))
    run_sweep(torch, dev, sweep_args)
    default = run_e2e(torch, dev, "default", [], (K1, K2, K3, K3C, K4))
    rewarp = run_e2e(torch, dev, "rewarp", ["--variance-mode", "rewarp"],
                     (K1, K2, K3, K3C, K4, K3B))
    run_e2e(torch, dev, "farneback", ["-f"], (K1, K2, K3, K3C, K3B))

    # each kernel's launches on the path it serves
    path_launches = {k.name: default[k.name] for k in (K1, K2, K3, K3C, K4)}
    path_launches[K3B.name] = rewarp[K3B.name]
    path_launches[K6.name] = solver_launches[K6.name]
    for k in (binned.K5A, binned.K5B):
        path_launches[k.name] = raster_launches[k.name]
    for k in (roofline.R1, roofline.R2, roofline.R3, roofline.R4):
        path_launches[k.name] = roof_launches[k.name]
    print("launches: K1, K2, K3, K3c, K4 from the default reconstruction, "
          "K3b from the rewarp reconstruction, K6 from the solver check, "
          "K5a and K5b from the raster sweep tool, R1-R4 from the roofline "
          "tool (R3 and R4 with its graph replays)")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s after the "
          f"device check")
    kernels = [dict(
        name=k.name, route="cuda", source=k.source, replaces=k.replaces,
        launches=path_launches[k.name], max_abs_err=res.err[k.name],
        **res.main[k.name]) for k in all_kernels()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
