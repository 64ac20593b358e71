#!/usr/bin/env python3
"""Chip check of meshrecon_torch, the PyTorch / CUDA port, on one GPU.

Run from the root of a checkout:  python3 chip_smoke.py

1. Prints the device (``torch.cuda.get_device_name`` and nvidia-smi's name
   and power limit); exits non-zero without a CUDA device.
2. Builds the hand-written kernels (meshrecon_torch/csrc) and the native
   host meshing library, and prints the build times and the compiler's
   register report.
3. Kernel phases: K1-K4 against their plain PyTorch versions on the card,
   at the shapes of the fused update at 640x480, K=3 sides, B=4: max
   difference against a stated bound, kernel and plain times (CUDA events
   after a warm-up). A missed bound raises.
4. The flow update: 3 fused updates (``FusedMainUpdate``) at that size on
   a 16,384-triangle sphere, with launch counters reset just before; every
   kernel must have launched, outputs must be finite where valid, and
   batch item 0 must agree with the port's plain run of the same inputs on
   the CPU within meshrecon_torch/parity.py's bounds.
5. K3c (the plane sweep's masked bilinear sample) against its plain
   version at the sweep's shapes: koule-tr's cameras at 640x480, B=4 main
   cameras x K=4 sides and the K=8 bucket, depth planes' coordinate
   fields, so that off-frame and behind-camera pixels are invalid.
6. The sweep update (``FusedSweepUpdate``, 64 depths) on those cameras,
   synthetic frames and a 16,384-triangle sphere fitted to the scene's
   bundles: K1, K2 and K3c must launch, the valid share must pass a floor,
   and batch item 0 must agree with the port's plain CPU run.
7. End to end: ``meshrecon_torch.cli.main`` on koule-tr at the defaults
   (640x480, -n 2, hybrid, 64 depths, Poisson grid 128, trim 2), seed 3:
   every kernel must launch, the OBJ must have faces, and its vertices
   must lie on the scene's fitted sphere (median |r - R| / R <= 0.20, p90
   <= 0.50). Prints the wall seconds of the run and of each stage.
8. Prints one JSON line of per-kernel results (launch counts from the end
   to end run), then the device line ``{"ok": true, "device": {...}}``
   last.

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
SEED = 0

TRACK = "tracks/koule-tr.yaml"
SWEEP_K = 4
SWEEP_DEPTHS = 64
SWEEP_MAINS = (6, 12, 18, 24)    # each with sides m-6, m-3, m+3, m+6
SWEEP_SEED = 3
VALID_FLOOR = 0.05
E2E_MEDIAN, E2E_P90 = 0.20, 0.50


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
    """Per-kernel max error and the times at its first (main) shape."""

    def __init__(self):
        self.err = {}
        self.ms = {}

    def add(self, kernel, label, err, bound, ms, plain_ms):
        print(f"{kernel.name} [{label}]: max_abs_err {err:.3e} (bound "
              f"{bound:.1e}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        if not err <= bound:
            raise AssertionError(f"{kernel.name} [{label}]: max abs error "
                                 f"{err} exceeds {bound}")
        self.err[kernel.name] = max(self.err.get(kernel.name, 0.0), err)
        self.ms.setdefault(kernel.name, (ms, plain_ms))


def _smooth_field(torch, gen, shape, scale, device):
    """Smooth random field: noise box-blurred twice (torch ops only)."""
    x = torch.randn(shape, generator=gen).to(device)
    for _ in range(2):
        x = torch.nn.functional.avg_pool2d(x[:, None], 9, 1, 4,
                                           count_include_pad=False)[:, 0]
    return x * (scale / x.abs().amax().clamp(min=1e-6))


def kernel_phases(torch, dev, res, slice_args):
    from meshrecon_torch import problems, state
    from meshrecon_torch.flow import jacobi, tile_warp
    from meshrecon_torch.flow.remap import bilinear_warp
    from meshrecon_torch.flow.variational import _hs_sweeps_cheb
    from meshrecon_torch.raster import binned, rasterizer
    from meshrecon_torch.raster.fragment import (bilinear_sample,
                                                 dilate3x3_max,
                                                 nearest_sample)

    gen = torch.Generator().manual_seed(SEED)
    cams = torch.cat([slice_args[2][:, None], slice_args[4]], 1).reshape(
        B * (K + 1), 4, 4)

    # K1: 16 cameras, the 16k main-path soup and the 65k face cap; bitwise
    depth_sides = None
    for nt, nph in ((64, 128), (128, 256)):
        label = f"{B * (K + 1)}x{H}x{W}, {2 * nt * nph} tris"
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
        res.add(binned.K1, label, err, 0.0, ms, plain_ms)
        if depth_sides is None:
            depth_sides = out.reshape(B, K + 1, H, W)[:, 1:].reshape(
                B * K, H, W)

    # K2: the side shadow maps and frames at a perturbed reprojection field
    n = B * K
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
    # nearest is a pure index pick; bilinear repeats the plain order of
    # operations (-fmad=false), 1e-4 on the 0..255 scale absorbs nothing
    # but a changed rounding
    res.add(tile_warp.K2, f"{n}x{H}x{W} nearest", err_a, 0.0, ms, plain_ms)
    res.add(tile_warp.K2, f"{n}x{H}x{W} bilinear", err_b, 1e-4, ms, plain_ms)

    # K3 and K4 at both pyramid levels of the flow solve
    for h, w in ((H, W), (H // 2, W // 2)):
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
        res.add(tile_warp.K3, f"{n}x{h}x{w}", err, 1e-4, ms, plain_ms)

        prev = (127.5 + _smooth_field(torch, gen, (n, h, w), 120.0,
                                      dev)).contiguous()
        warped = (prev + _smooth_field(torch, gen, (n, h, w), 6.0,
                                       dev)).contiguous()
        uk, vk = jacobi.hs_level_fused(prev, warped, u, v, 144.0, iters=14,
                                       solver="cheb")
        up, vp = _hs_sweeps_cheb(prev, warped, u, v, 144.0, 14)
        torch.cuda.synchronize()
        err = max((uk - up).abs().max().item(), (vk - vp).abs().max().item())
        ms = _cuda_ms(torch, lambda: jacobi.hs_level_fused(
            prev, warped, u, v, 144.0, iters=14, solver="cheb"), 20)
        plain_ms = _cuda_ms(torch, lambda: _hs_sweeps_cheb(
            prev, warped, u, v, 144.0, 14), 5)
        # the kernel folds the data term into cc and 1/denom
        # (pallas_jacobi.py's form), the plain version does not: 1e-4 px
        res.add(jacobi.K4, f"{n}x{h}x{w}, 14 cheb sweeps", err, 1e-4, ms,
                plain_ms)


def run_slice(torch, dev, args_np):
    from meshrecon_torch import parity, state
    from meshrecon_torch.flow import jacobi, tile_warp
    from meshrecon_torch.pipeline.fused import (FusedMainUpdate,
                                                fused_main_update_batched)
    from meshrecon_torch.raster import binned

    args = state.from_numpy(args_np, dev)
    model = FusedMainUpdate(H, W).to(dev)
    kernels = (binned.K1, tile_warp.K2, tile_warp.K3, jacobi.K4)
    for k in kernels:
        k.launches = 0
    times = []
    for _ in range(UPDATES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model(*args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = {k.name: k.launches for k in kernels}
    print(f"flow update: B={B} K={K} {W}x{H}, {int(args_np[1].sum())} "
          f"tris, "
          f"ms/update {[round(t, 3) for t in times]}, "
          f"GN sweeps {model.last_gn_sweeps}, launches {launches}")
    missing = [name for name, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched by the flow update: "
                             f"{missing}")

    out = state.to_numpy(out)
    valid = out["valid"]
    share = float(valid.mean())
    print(f"flow update: valid share {share:.4f} (floor 0.05)")
    if share < 0.05:
        raise AssertionError(f"valid share {share} below 0.05")
    for key in ("point4", "normals", "pdf"):
        if not np.isfinite(out[key][valid]).all():
            raise AssertionError(f"non-finite {key} on valid pixels")

    # batch item 0 against the plain versions on the CPU, at B=1
    t0 = time.perf_counter()
    cpu = state.to_numpy(fused_main_update_batched(
        *state.from_numpy([a[:1] if i > 1 else a
                           for i, a in enumerate(args_np)], "cpu"), H, W))
    print(f"flow update: CPU plain run of item 0 took "
          f"{time.perf_counter() - t0:.1f} s")
    metrics = parity.check_slice(
        {k: v[:1] for k, v in out.items()}, cpu)
    print("flow update vs CPU (meshrecon_torch/parity.py bounds): "
          + ", ".join(f"{k} {v:.3e}" for k, v in metrics.items()))


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
        # the same arithmetic in the same order (-fmad=false): 1e-4 on 0..255
        res.add(tile_warp.K3C, label, err, 1e-4, ms, plain_ms)


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


def run_e2e(torch, dev):
    """The default reconstruction through the CLI, in-process."""
    from meshrecon_torch import cli
    from meshrecon_torch.io.obj import read_mesh
    from meshrecon_torch.io.synthetic import fit_sphere
    from meshrecon_torch.io.tracks import load_tracks
    from meshrecon_torch.kernels import all_kernels
    from meshrecon_torch.utils.profiling import StageTimer

    out_dir = Path("build") / "chip_smoke"  # git-ignored
    out_dir.mkdir(parents=True, exist_ok=True)
    obj = out_dir / "chip_smoke_e2e.obj"
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    timer = StageTimer()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = cli.main([TRACK, "--synthetic", "sphere", "--seed", "3", "-o",
                   str(obj), "--device", "cuda", "-v"], timer=timer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    print(f"e2e: cli.main rc {rc}, wall {wall:.2f} s, launches {launches}")
    print("e2e stages (card-synchronized wall seconds):")
    for line in timer.report().splitlines():
        print(f"  {line}")
    missing = [name for name, n in launches.items() if n == 0]
    if rc != 0 or missing:
        raise AssertionError(f"e2e: rc {rc}, kernels not launched {missing}")
    mesh = read_mesh(str(obj))
    track = load_tracks(TRACK)
    center, radius = fit_sphere(track.bundles)
    v3 = mesh.vertices[:, :3] / mesh.vertices[:, 3:4]
    err = np.abs(np.linalg.norm(v3 - center, axis=1) - radius) / radius
    med, p90 = float(np.median(err)), float(np.percentile(err, 90))
    print(f"e2e: {len(mesh.faces)} faces, {len(mesh.vertices)} vertices; "
          f"|r - R| / R median {med:.4f} (bound {E2E_MEDIAN}), p90 "
          f"{p90:.4f} (bound {E2E_P90})")
    if not len(mesh.faces) or not np.isfinite(v3).all():
        raise AssertionError("e2e: empty or non-finite mesh")
    if not (med <= E2E_MEDIAN and p90 <= E2E_P90):
        raise AssertionError(f"e2e: mesh off the sphere (median {med}, "
                             f"p90 {p90})")
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
    from meshrecon_torch.kernels import all_kernels, library
    from meshrecon_torch.meshing import native
    # the wrappers own the Kernel objects: import them before listing
    import meshrecon_torch.pipeline.fused  # noqa: F401
    import meshrecon_torch.pipeline.reconstruct  # noqa: F401

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: off (matmul and cuDNN)")
    _device_lines(torch)
    dev = torch.device("cuda", 0)

    lib = library()
    print(f"build: {lib.build_seconds:.1f} s -> {lib.path.name}")
    for line in lib.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"ptxas: {line.strip()}")
    t0 = time.perf_counter()
    native.library()  # the host meshing library, outside the timed phases
    print(f"build: native meshing library {time.perf_counter() - t0:.1f} s")

    args_np = list(problems.fused_problem(B, K, H, W, seed=SEED))
    args_np[0], args_np[1] = state.pack_soup(problems.sphere_soup(64, 128))
    res = Results()
    kernel_phases(torch, dev, res, state.from_numpy(args_np, dev))
    torch.cuda.synchronize()
    run_slice(torch, dev, args_np)

    sweep_args = sweep_problem(torch, dev)
    k3c_phase(torch, dev, res, state.from_numpy(sweep_args, dev))
    run_sweep(torch, dev, sweep_args)
    launches = run_e2e(torch, dev)

    kernels = [{
        "name": k.name, "route": "cuda", "source": k.source,
        "replaces": k.replaces, "launches": launches[k.name],
        "max_abs_err": res.err[k.name], "ms": res.ms[k.name][0],
        "plain_ms": res.ms[k.name][1],
    } for k in all_kernels()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
