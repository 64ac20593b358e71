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
   12x480x640, 60 sweeps. A missed bound raises. K3 at both pyramid sizes
   also gives its device time and ``grid_sample``'s from a CUDA graph of
   100 calls beside the eager times. K4 (at both pyramid sizes) and K6 run
   several sweeps a launch; each must equal the same sweeps run one a
   launch bit for bit, and is timed against them in turns, eager and from
   CUDA graphs, with its launch geometry (sweeps a launch, tile, shared
   memory a CTA) printed; K6 also at 6-24 sweeps a launch. K3's eager
   and graph times and ``grid_sample``'s are the medians of 7 alternating
   rounds.
   After the kernel phases: the binning phase. K1's binning is two
   kernels: SETUP (the triangle setup) bitwise against ``pack_records``
   (NaN-aware) and BIN (the tile lists) against ``bin_chunks`` at chunks 8
   and 16 and ``bin_superchunks`` at chunk 8 (counts and list prefixes
   equal), at 16 cameras on the 16,384- and 65,536-triangle spheres (six
   shapes); the launch geometry (threads, resident CTAs an SM, clusters)
   printed. At each shape both kernels are timed in 7 alternating rounds:
   the wrapper eager, the C entry (the binding's function of the entry)
   eager and from a CUDA graph of 20 calls (the kernel alone), BIN also
   against its library call, the ``torch.sort`` of the tile keys plus the
   ``sum`` of their activity that the JAX package bins with
   (binned.py:597-598, 612-613). The phase prints its wall seconds.
   Then the raster phase. K5 (the two-level raster, one kernel for
   the TPU's K5a and K5b) bitwise against ``render_depth`` through
   ``render_depth_binned(two_level=True)`` at one camera (K5a) and
   ``render_depth_binned_batched`` at 4 and 16 cameras (K5b), on the
   16,384- and 65,536-triangle spheres and the fused problem's soup at
   640x480, with the binning's and the kernel's ms apart; K1's wrapper as
   setup + bin + kernel alone and the peak memory of both binnings and of
   the plain one at 16 cameras. For each of these cases (K5 at 1, 4 and 16
   cameras, K1 at 16) the coverage walk's counts (the sweep tool's
   ``walk_counts``: candidate records, tile and warp hits, coverage tests
   against the first design's, the longest tile and warp walks) and
   the kernel alone (its C entry) from a CUDA graph of 20 calls in 7
   rounds, bitwise against ``render_depth``. Then the raster sweep tool
   (``meshrecon_torch.tools.raster_sweep``) at its defaults with chunks 8
   and 16.
   Then the roofline phase: R1-R4 (the roofline probes) against their
   plain versions at the roofline tool's shapes (R1 4096x4096, R2 one
   256x512 block of 2,048 FMAs, R3 8x128 in one CTA, R4 512x128 in 64 and
   in 1 CTAs; R1, R3, R4 bitwise, R2 1e-6 relative), R2 eager and from a
   CUDA graph in 7 alternating rounds, with its geometry and nvidia-smi's
   SM clock sampled while its graph replays, R1, R3 and R4 timed
   against ``torch.mul`` / ``torch.add``, their library yardsticks, eager
   and from CUDA graphs in 7 alternating rounds (median and min-max
   spread), and R3's launch path split the same way (the C entry alone
   through ctypes and through the binding, the binding's ``launch``,
   ``Kernel.launch``, ``add_one``, ``torch.add``); then the roofline tool
   (``meshrecon_torch.tools.roofline``) in-process, counters reset just
   before. Then the breakdown phase: the breakdown tool
   (``meshrecon_torch.tools.fused_breakdown``) at 640x480, K=3, B=1 and
   B=4, its bound taking the tool's graph launch floor; its ``depth0``
   stage must fire at most 20 device events; its ``all`` stage
   against ``FusedMainUpdate`` on the same inputs within
   meshrecon_torch/parity.py's bounds. Then the bands phase (the tile
   axis's forms of the kernels, ``band_phase``): K1's row window at 16
   cameras on the 16k sphere (bands of 120 rows, rows not aligned to the
   16-row tile, one row, the whole frame), K2's band output (a band's
   coordinates, whole sources) and K3's and K3b's bands (flows reaching
   past the next band), each bitwise against the whole frame's rows and
   against its plain version (K2's bilinear and K3b 1e-4), with its ms.
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
   Then the bench: ``meshrecon_torch.bench.run`` in-process at 640x480,
   K=3 on the 512-triangle problem, its default 50 reps and 3 rounds, at
   B=1 and B=4 (counters reset before each; SETUP, BIN, K1, K2, K3 and K4
   must launch; every number of its line finite and positive, the carry
   finite, ``busy_share`` in (0, 1]), each line printed as ``bench B=n``;
   then ``python -m meshrecon_torch.bench`` in a fresh process at
   ``MESHRECON_BENCH_REPS=5``: exit 0 and exactly one JSON line on stdout
   with the same keys.
6. K3c (the plane sweep's masked bilinear sample) against its plain
   version at the sweep's shapes: koule-tr's cameras at 640x480, B=4 main
   cameras x K=4 sides and the K=8 bucket, depth planes' coordinate
   fields, so that off-frame and behind-camera pixels are invalid.
7. The sweep update (``FusedSweepUpdate``, 64 depths) on those cameras,
   synthetic frames and a 16,384-triangle sphere fitted to the scene's
   bundles: SETUP, BIN, K1, K2 and K3c must launch, the valid share must
   pass a floor,
   and batch item 0 must agree with the port's plain CPU run.
8. End to end, three times: ``meshrecon_torch.cli.main`` on koule-tr at
   the defaults (640x480, -n 2, hybrid, 64 depths, Poisson grid 128, trim
   2), seed 3; then with ``--variance-mode rewarp``; then with ``-f``.
   Every kernel of each run's path must launch, the OBJ must have faces,
   and its vertices must lie on the scene's fitted sphere within the run's
   bounds. Prints the wall seconds of each run and of each stage. The
   flow updates' paths (here, in step 5 and in the bench) include GN's
   four kernels (GN_SOBEL, GN_WALK, GN_EXIT, GN_FINISH). After the default
   run, the GN phase (``gn_phase``) on the inputs of its largest
   triangulation (iteration 2's B=4, K=8, 480x640), taylor then exact:
   ``triangulate_pixels_batched`` on the card bit for bit against the
   eager sweeps on the same card inputs (``GaussNewtonBand``,
   ``gauss_newton``, ``result``), the sweep count equal, both timed; then
   each GN kernel against its share of the eager path (GN_SOBEL against
   ``sobel_gradient``, GN_WALK's z against the eager z, GN_EXIT against
   ``gn_exit_plain``, GN_FINISH against ``result``), bound 0, with its ms,
   the eager share's ms and its bound (the walk's operations from the
   pixel-steps it took). Then the sweep phase (``sweep_phase``) at c4's
   shape (1x32x1080x1920, 64 planes) and on the inputs of the default
   reconstruction's largest iteration-1 sweep (B=4, K=8, vote weights,
   padded slots): the sweep on the card (K3c and SWEEP_PROJ, SWEEP_COST,
   SWEEP_BEST a plane) bit for bit against the eager planes on the same
   card inputs, both timed, then each SWEEP kernel at the middle plane
   against its plain version (``SweepWindow.fields``, ``sums``,
   ``take_plane``), bound 0, with its ms, the plain version's and its
   bytes bound, and a whole plane's ms.
9. The video entry points, three phases, each with its wall seconds:
   ``video``: a 640x480 MJPG (koule-tr's 31 frames) whose B, G and R
   planes are the synthetic sphere frames of seeds 3, 4 and 5 made on
   the card, each times a per-frame, per-channel gain 1 + 0.2 sin(f + 2c),
   through ``cli.main`` with ``-e --ensemble-seeds 3,13``: SETUP, BIN,
   K1, K2, K3, K3c and K4 must launch, the exposure solve must run on the
   card (its rounds and ms printed, with the decode seconds and the
   spread of the gains times the injected ones) and equal the plain CPU
   solve of the same samples (the same rounds, gains within 1e-4 of the
   largest), the mesh must hold the default's bound. ``scenes -V``: two YAMLs of one gray clip (the seed-3
   frames) with ``-V -n 1 --depth-mode flow``, run from a dumps folder:
   SETUP, BIN, K1, K2, K3, K3b and K4 must launch, both meshes must be
   written and finite, the PNG dumps must be those the printed bundles
   imply, and ``torch.cuda.memory_allocated`` must fall by the clip's
   bytes at the first scene's ``release_frames`` (both readings
   printed). ``drivers``: the flow driver (K3 and K3b must launch) and
   the raster driver (SETUP, BIN and K1) in a scratch folder, the raster
   driver's depth against ``raster.reference.render_depth_reference``
   (coverage disagreement under 1%, 99% of depths within 1e-2 NDC:
   tests/test_raster.py's golden-scene bounds).
10. The quality tools and the meshing backends, two phases, each with its
   wall seconds. ``quality``, on the card: the quality harness on
   koule-tr and zatisi at 640x480 and koberec- at 320x240 (``default``;
   exit code 0 by its own bounds, a row a scene; SETUP, BIN, K1, K2, K3
   and K4 must launch), the seed study on koule at ``trim2``, seed 3
   (K3c must launch; its row beside the recorded one, within the
   default's mesh bound), error_attrib
   at seed 3 and 320x240 with ``--dump`` (sections A, B and D printed, one
   provenance code per point) and remesh_lab on that dump; each with its
   wall seconds and StageTimer split. ``meshing``: the meshing driver's
   alpha, Poisson and greedy modes on its torus (faces, seconds), and
   ``rbf_surface`` on
   that torus at grid 64 and 1,500 points with TF32 switched on around the
   call: its field at 16,384 grid points against the same fit evaluated in
   float64 on the host (within 1e-5 of max|f|), its mesh on the torus
   (median |tube distance - 0.4| under 0.02), the host fit seconds, the
   grid evaluation's ms (CUDA events), faces and peak memory.
11. The last JAX tools, three phases, each with its wall seconds, the
   counters reset just before each. ``micro``: the six timing tools
   (``meshrecon_torch.tools.{perf_breakdown,flow_levels,flow_trans,
   flow_micro,warp_micro,proj_micro}``) in-process at their defaults, the
   JAX tools' 640x480, K=3 and reps; each prints its rows (CUDA events),
   every row a finite ms or n/a where it names the TPU package's second
   engine or a TPU layout flag, and SETUP, BIN, K1, K2, K3, K3b and K4
   must launch. ``studies``: flow_e2e_quality's three one-iteration flow
   runs at 640x480 (each mesh within the default's bound) and iters_study
   at 14 and 12 sweeps, seed 3, at 320x240 (both meshes finite with
   faces, and different: the sweep count reaches the run); SETUP, BIN,
   K1, K2, K3, K3c and K4 must launch. ``config4``: baseline_configs c4,
   the 32-frame, 64-plane sweep at 1080p (ms a solve, Mpix/s, the peak
   memory the solve allocates), one solve's K3c launches (one a plane),
   the depth finite where valid, and K3c alone at the middle plane's
   inputs, 1x32x1080x1920, against its plain version (1e-4), its bound
   and ``grid_sample``.
12. The sharding phase (``sharding_phase``, meshrecon_torch/sharding on
   one card, shards of a mesh that names cuda:0 more than once in threads
   of their own): the camera-sharded update on 1 and 2 shards and the
   scene-sharded update at config 5's shape on 1 and 2, each bit for bit
   against the unsharded update, and its scene 0 against the plain
   versions on the CPU (parity.py's bounds, the pdf's from a witness as
   in the bench phase); the window-sharded plane sweep (8 sides, 640x480,
   64 depths) on 1 and 4 shards against ``plane_sweep_depth``; koule-tr
   as two scenes through ``reconstruct_scenes`` at once (``scene_devices
   =2``: a thread a scene) and one after another, each mesh within the
   default's bound, walls and stage splits printed; ``baseline_configs
   c5``; ``--mesh-devices 2`` refused on one GPU. After the camera axis,
   the tile axis (``tile_runs``): ``sharded_fused_update`` on ``[cuda:0] *
   4`` as (camera, tile) (2, 2) and (1, 4) at 640x480, K=3, B=4, and (1, 4)
   at 1080x1920, K=3, B=1, each bitwise against the unsharded update on
   the card, SETUP, BIN, K1, K2, K3 and K4 launched, the ms of two calls
   (one card: the exchanges' cost, no speedup) and the MB its exchanges
   copied between bands a call. Its figures are one JSON line
   ``{"sharding": ...}``.
13. Prints one JSON line of per-kernel results, then the device line
   ``{"ok": true, "device": {...}}`` last. Each kernel's ``launches`` is
   the count of the path it serves, read just after that path's run with
   the counters reset just before: SETUP, BIN, K1, K2, K3, K3c, K4 and
   GN's four kernels from the default reconstruction, K3b from the rewarp reconstruction, K6 from
   the solver check, K5a and K5b from the raster sweep tool's run, R1-R4
   from the
   roofline tool's run (R3's and R4's eager launches plus its CUDA-graph
   replays x the launches captured, since a replay does not pass through
   ``Kernel.launch``).

TF32 is switched off for matmuls and cuDNN: the reference computes in full
float32 (``Precision.HIGHEST``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
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
# config 5 (tools/baseline_configs.py c5): scenes x main cameras, sides,
# frame size
C5 = dict(s=8, b=2, k=2, h=240, w=320)
TILE_HD = (1080, 1920)  # the tile axis's 1080p run: (rows, columns)
GRAPH_CALLS = 100  # calls in the CUDA graph that gives a device time
ROUNDS = 7  # alternating rounds of a kernel against its yardstick
DEPTH0_EVENTS = 20  # the breakdown's depth0: cameras, binning, K1

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


def _graph_timer(torch, fn, calls=None, replays=5):
    """A function that returns milliseconds a call on the device: ``calls``
    calls of ``fn`` captured once in a CUDA graph (after an eager
    warm-up), the mean over ``replays`` replays after one untimed
    replay."""
    calls = calls or GRAPH_CALLS
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    return lambda: _cuda_ms(torch, graph.replay, replays,
                            warm_up=False) / calls


def _graph_ms(torch, fn, calls=None, replays=5):
    """Milliseconds a call on the device (:func:`_graph_timer`, once)."""
    return _graph_timer(torch, fn, calls, replays)()


def _interleaved(label, timers, rounds=ROUNDS):
    """Run ``timers`` (name -> a function that returns ms) in ``rounds``
    alternating rounds (A B A B ...), since the host moves eager times
    ~2x between calls; print each one's median and min-max spread in us
    and return the medians in ms."""
    got = {name: [] for name in timers}
    for _ in range(rounds):
        for name, fn in timers.items():
            got[name].append(fn())
    print(f"{label}, us a call, median [min-max] of {rounds} alternating "
          "rounds: " + "; ".join(
              f"{name} {statistics.median(v) * 1e3:.3f} "
              f"[{min(v) * 1e3:.3f}-{max(v) * 1e3:.3f}]"
              for name, v in got.items()))
    return {name: statistics.median(v) for name, v in got.items()}


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

    # K1 at the bench's inputs: the 512-triangle soup of fused_problem and
    # the cameras of each of BENCH_BATCHES (4 and 16); bitwise
    from meshrecon_torch import bench
    for b in BENCH_BATCHES:
        soup, valid, mains, _, sides = bench.problem(b, K, H, W, dev)[:5]
        bcams = torch.cat([mains[:, None], sides], 1).reshape(
            b * (K + 1), 4, 4)
        label = f"{b * (K + 1)}x{H}x{W}, bench soup, {int(valid.sum())} tris"
        out = binned.render_depth_binned(bcams, soup, valid, H, W)
        ref = rasterizer.render_depth(bcams, soup, valid, H, W)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        covered = (ref < 1.0).float().mean().item()
        print(f"raster_tiles [{label}]: covered share {covered:.4f}")
        if covered < 0.05:
            raise AssertionError("the sphere is not on screen")
        ms = _cuda_ms(torch, lambda: binned.render_depth_binned(
            bcams, soup, valid, H, W), 10)
        plain_ms = _cuda_ms(torch, lambda: rasterizer.render_depth(
            bcams, soup, valid, H, W), 1, warm_up=False)
        res.add(binned.K1, label, err, 0.0, ms, plain_ms)

    # K1 at config 5's inputs (the sharding phase's scene axis): a scene's
    # 512-triangle soup and its 6 cameras (2 main, 2 sides each) at
    # C5_H x C5_W; bitwise
    soup, valid, mains, _, sides = (torch.from_numpy(np.asarray(a)).to(dev)
                                    for a in problems.fused_problem(
                                        C5["b"], C5["k"], C5["h"], C5["w"],
                                        seed=0)[:5])
    c5cams = torch.cat([mains[:, None], sides], 1).reshape(
        C5["b"] * (C5["k"] + 1), 4, 4)
    label = (f"{len(c5cams)}x{C5['h']}x{C5['w']}, config 5 soup, "
             f"{int(valid.sum())} tris")
    out = binned.render_depth_binned(c5cams, soup, valid, C5["h"], C5["w"])
    ref = rasterizer.render_depth(c5cams, soup, valid, C5["h"], C5["w"])
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    covered = (ref < 1.0).float().mean().item()
    print(f"raster_tiles [{label}]: covered share {covered:.4f}")
    if covered < 0.05:
        raise AssertionError("the sphere is not on screen")
    ms = _cuda_ms(torch, lambda: binned.render_depth_binned(
        c5cams, soup, valid, C5["h"], C5["w"]), 10)
    plain_ms = _cuda_ms(torch, lambda: rasterizer.render_depth(
        c5cams, soup, valid, C5["h"], C5["w"]), 1, warm_up=False)
    res.add(binned.K1, label, err, 0.0, ms, plain_ms)

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
        plain_ms = _cuda_ms(torch, lambda: bilinear_warp(
            img, torch.stack([u, v], -1)), 10)
        ccols = torch.arange(w, dtype=torch.float32, device=dev)
        crows = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
        grid = _grid(torch, ccols + u, crows + v)
        lib_in = img[:, None]

        def k3():
            return tile_warp.tile_warp_flow_batched(img, u, v)

        def lib():
            return _library_sample(torch, lib_in, grid, "bilinear")
        t = _interleaved(
            f"warp_bilinear [{n}x{h}x{w}] against grid_sample, eager (50 "
            f"calls) and device (a CUDA graph of {GRAPH_CALLS} calls)",
            {"K3 eager": lambda: _cuda_ms(torch, k3, 50),
             "grid_sample eager": lambda: _cuda_ms(torch, lib, 50),
             "K3 graph": _graph_timer(torch, k3),
             "grid_sample graph": _graph_timer(torch, lib)})
        ms, lib_ms = t["K3 eager"], t["grid_sample eager"]
        # bytes: image, u, v in, one float out; ~22 operations a pixel
        res.add(tile_warp.K3, f"{n}x{h}x{w}", err, 1e-4, ms, plain_ms,
                work=(16 * npx, fb.K3_OPS * npx), library_ms=lib_ms)

        prev = (127.5 + _smooth_field(torch, gen, (n, h, w), 120.0,
                                      dev)).contiguous()
        warped = (prev + _smooth_field(torch, gen, (n, h, w), 6.0,
                                       dev)).contiguous()

        def k4(per_launch=jacobi.MAX_SWEEPS_PER_LAUNCH):
            return jacobi.hs_level_fused(prev, warped, u, v, ALPHA2,
                                         iters=14, solver="cheb",
                                         _sweeps_per_launch=per_launch)

        up, vp = _hs_sweeps_cheb(prev, warped, u, v, ALPHA2, 14)
        label = f"{n}x{h}x{w}, 14 cheb sweeps"
        err, ms = _blocked_phase(torch, "hs_sweep", label, k4, (up, vp),
                                 14, h, w)
        plain_ms = _cuda_ms(torch, lambda: _hs_sweeps_cheb(
            prev, warped, u, v, ALPHA2, 14), 5)
        # the kernel folds the data term into cc and 1/denom
        # (pallas_jacobi.py's form), the plain version does not: 1e-4 px.
        # bytes: prev, warped, u0, v0 in, u, v out; operations: 22 for the
        # linearization, 33 a Chebyshev sweep
        res.add(jacobi.K4, label, err, 1e-4, ms,
                plain_ms, work=(24 * npx, (fb.K4_LIN_OPS
                                           + 14 * fb.K4_SWEEP_OPS) * npx))


def band_phase(torch, dev, res, slice_args):
    """The tile axis's band forms of the kernels (sharding/tiles.py), at
    the flow update's shapes (640x480, B=4, K=3) and 4 bands of 120 rows:
    K1's row window (16 cameras, the 16k sphere; bands, rows not aligned
    to the 16-row tile, one row, the whole frame) bitwise against the
    whole render's rows and the plain render's window; K2's band output
    (a band's coordinates, whole sources) bitwise against the whole
    frame's rows and against its plain version (nearest bitwise, bilinear
    1e-4); K3 and K3b on a band from the source rows its samples reach,
    flows reaching past the next band, bitwise against the whole frame's
    rows (K3 also against ``bilinear_warp``'s band, K3b within 1e-4 of
    ``flow_remap``'s). Each window's kernel ms beside the whole frame's."""
    from meshrecon_torch import problems, state
    from meshrecon_torch.flow import tile_warp
    from meshrecon_torch.flow.remap import bilinear_warp, flow_remap
    from meshrecon_torch.raster import binned, rasterizer
    from meshrecon_torch.raster.fragment import (bilinear_sample,
                                                 dilate3x3_max,
                                                 nearest_sample)

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 18)
    cams = torch.cat([slice_args[2][:, None], slice_args[4]], 1).reshape(
        B * (K + 1), 4, 4)
    soup, valid = (torch.from_numpy(a).to(dev) for a in
                   state.pack_soup(problems.sphere_soup(64, 128)))
    whole = binned.render_depth_binned(cams, soup, valid, H, W)
    whole_ms = _cuda_ms(torch, lambda: binned.render_depth_binned(
        cams, soup, valid, H, W), 10)
    # the plain render takes seconds a frame: held on three windows
    for rows in ((0, 120), (120, 240), (360, 480), (5, 37), (100, 101),
                 (0, H)):
        out = binned.render_depth_binned(cams, soup, valid, H, W, rows=rows)
        torch.cuda.synchronize()
        same = torch.equal(out, whole[:, rows[0]:rows[1]])
        ms = _cuda_ms(torch, lambda: binned.render_depth_binned(
            cams, soup, valid, H, W, rows=rows), 10)
        print(f"raster_tiles rows {rows} [{len(cams)}x{H}x{W}, 16k tris]: "
              f"{ms:.4f} ms (whole frame {whole_ms:.4f} ms), the whole "
              f"render's rows bit for bit: {same}")
        if not same:
            raise AssertionError(f"K1's window {rows} differs from the whole "
                                 "render's rows")
        if rows in ((120, 240), (5, 37), (100, 101)):
            t_plain = time.perf_counter()
            plain = rasterizer.render_depth(cams, soup, valid, H, W,
                                            rows=rows)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t_plain) * 1e3
            res.add(binned.K1, f"rows {rows}",
                    (out - plain).abs().max().item(), 0.0, ms, plain_ms)

    n = B * K
    depth_sides = whole.reshape(B, K + 1, H, W)[:, 1:].reshape(n, H, W)
    shadow = dilate3x3_max(depth_sides).contiguous()
    frames = slice_args[5].reshape(n, H, W).contiguous()
    cols = torch.arange(W, dtype=torch.float32, device=dev)
    rows_f = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    scol = (cols + 1.3 + _smooth_field(torch, gen, (n, H, W), 40.0,
                                       dev)).contiguous()
    srow = (rows_f - 0.7 + _smooth_field(torch, gen, (n, H, W), 30.0,
                                         dev)).contiguous()
    for bilinear_a in (False, True):
        full = tile_warp.tile_warp_sample2_batched(shadow, frames, scol, srow,
                                                   bilinear_a)
        for r0, r1 in ((120, 240), (7, 41)):
            bc = scol[:, r0:r1].contiguous()
            br = srow[:, r0:r1].contiguous()
            a_k, b_k = tile_warp.tile_warp_sample2_batched(
                shadow, frames, bc, br, bilinear_a)
            a_p = (bilinear_sample if bilinear_a else nearest_sample)(
                shadow, bc, br)
            b_p = bilinear_sample(frames, bc, br)
            torch.cuda.synchronize()
            same = (torch.equal(a_k, full[0][:, r0:r1])
                    and torch.equal(b_k, full[1][:, r0:r1]))
            ms = _cuda_ms(torch, lambda: tile_warp.tile_warp_sample2_batched(
                shadow, frames, bc, br, bilinear_a), 50)
            plain_ms = _cuda_ms(torch, lambda: (
                (bilinear_sample if bilinear_a else nearest_sample)(
                    shadow, bc, br), bilinear_sample(frames, bc, br)), 5)
            mode = "bilinear shadow" if bilinear_a else "nearest"
            print(f"sample_shadow_frame band [{r0}, {r1}) {mode}: {ms:.4f} "
                  f"ms, the whole frame's rows bit for bit: {same}")
            if not same:
                raise AssertionError(f"K2's band [{r0}, {r1}) differs from "
                                     "the whole frame's rows")
            res.add(tile_warp.K2, f"band [{r0}, {r1}) {mode}, A",
                    (a_k - a_p).abs().max().item(), 1e-4 if bilinear_a else 0,
                    ms, plain_ms)
            res.add(tile_warp.K2, f"band [{r0}, {r1}) {mode}, B",
                    (b_k - b_p).abs().max().item(), 1e-4, ms, plain_ms)

    img = (127.5 + _smooth_field(torch, gen, (n, H, W), 120.0,
                                 dev)).contiguous()
    u = _smooth_field(torch, gen, (n, H, W), 3.0, dev).contiguous()
    v = (_smooth_field(torch, gen, (n, H, W), 3.0, dev) + 127.3).contiguous()
    for taps, kernel in ((2, tile_warp.K3), (4, tile_warp.K3B)):
        full = tile_warp.tile_warp_flow_batched(img, u, v, taps)
        lo, hi = 120, 240
        reach = int(np.ceil(v.abs().max().item())) + taps // 2
        w0, w1 = max(lo - reach, 0), min(hi + reach, H)
        band = dict(row0=lo, height=H, src_row0=w0)
        args = (img[:, w0:w1].contiguous(), u[:, lo:hi].contiguous(),
                v[:, lo:hi].contiguous())
        out = tile_warp.tile_warp_flow_batched(*args, taps, **band)
        flow = torch.stack(args[1:], -1)
        plain = (bilinear_warp(args[0], flow, **band) if taps == 2
                 else flow_remap(flow, args[0], **band))
        torch.cuda.synchronize()
        same = torch.equal(out, full[:, lo:hi])
        ms = _cuda_ms(torch, lambda: tile_warp.tile_warp_flow_batched(
            *args, taps, **band), 50)
        plain_ms = _cuda_ms(torch, lambda: bilinear_warp(
            args[0], flow, **band) if taps == 2 else flow_remap(
                flow, args[0], **band), 5)
        print(f"{kernel.name} band [{lo}, {hi}) from rows [{w0}, {w1}) "
              f"(|v| to {v.abs().max().item():.1f} px): {ms:.4f} ms, the "
              f"whole frame's rows bit for bit: {same}")
        if not same:
            raise AssertionError(f"{kernel.name}'s band differs from the "
                                 "whole frame's rows")
        res.add(kernel, f"band [{lo}, {hi})", (out - plain).abs().max().item(),
                0.0 if taps == 2 else 1e-4, ms, plain_ms)
    print(f"phase bands: {time.perf_counter() - t0:.1f} s")


def _blocked_phase(torch, name, label, call, plain, iters, h, w,
                   graph_calls=20):
    """A blocked Horn-Schunck kernel (``call()``: its default sweeps a
    launch) against the same sweeps one a launch (``call(1)``): bitwise
    equal, both against ``plain`` (u, v); times in turns (one, blocked,
    blocked, one), eager and from CUDA graphs of ``graph_calls`` calls.
    Prints the launch geometry; returns (max error against the plain
    version, the blocked call's eager ms)."""
    from meshrecon_torch.flow import jacobi

    kernel = jacobi.K4 if name == "hs_sweep" else jacobi.K6
    n0 = kernel.launches
    blocked = call()
    n1 = kernel.launches
    one = call(1)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(blocked, one)):
        raise AssertionError(f"{name} [{label}]: the blocked sweeps differ "
                             "from one sweep a launch")
    err = max((a - b).abs().max().item() for a, b in zip(blocked, plain))
    err_one = max((a - b).abs().max().item() for a, b in zip(one, plain))
    per_launch = -(-iters // (n1 - n0))
    shape = jacobi.block_shape(per_launch, h, w)
    one_a = _cuda_ms(torch, lambda: call(1), 5)
    ms_a = _cuda_ms(torch, call, 20)
    ms_b = _cuda_ms(torch, call, 20, warm_up=False)
    one_b = _cuda_ms(torch, lambda: call(1), 5, warm_up=False)
    ms, one_ms = (ms_a + ms_b) / 2, (one_a + one_b) / 2
    graph_ms = _graph_ms(torch, call, calls=graph_calls)
    one_graph_ms = _graph_ms(torch, lambda: call(1), calls=graph_calls)
    print(f"{name} [{label}]: {n1 - n0} launch(es) of <= {per_launch} "
          f"sweeps, tile {shape['tile'][0]}x{shape['tile'][1]} (rows x "
          f"columns), {shape['ctas_per_image']} CTAs an image, "
          f"{shape['smem_bytes']} B dynamic shared memory a CTA; bitwise "
          f"equal to {iters} launches of one sweep; max error against the "
          f"plain version {err:.3e} (one a launch {err_one:.3e}); eager "
          f"{ms:.4f} ms ({ms_a:.4f}, {ms_b:.4f}) against {one_ms:.4f} "
          f"({one_a:.4f}, {one_b:.4f}) one sweep a launch, x{one_ms / ms:.2f}"
          f"; device (CUDA graph of {graph_calls} calls) {graph_ms:.4f} ms "
          f"against {one_graph_ms:.4f}, x{one_graph_ms / graph_ms:.2f}")
    return max(err, err_one), ms


def _peak_mb(torch, fn):
    """Peak device memory of one call of ``fn`` above what was allocated
    before it, in MB."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 1e6


def _bits_err(torch, a, b):
    """Max |a - b|, NaN where both are NaN counting 0; inf when the bits
    differ anywhere else (a signed zero, a NaN on one side)."""
    both_nan = a.isnan() & b.isnan()
    if not bool(((a.view(torch.int32) == b.view(torch.int32))
                 | both_nan).all()):
        diff = torch.where(both_nan, 0.0, (a - b).abs())
        return max(diff.nan_to_num(nan=float("inf")).max().item(), 1e-30)
    return 0.0


def _setup_entry(torch, cams, soup, valid, group, chunk):
    """A call of the ``mr_raster_setup`` entry (:func:`_c_entry`) into
    outputs made once. Returns (call, packed, cbox)."""
    n, t = cams.shape[0], soup.shape[0]
    n_rec = -(-2 * t // group) * group
    packed = torch.empty((n, 16, n_rec), dtype=torch.float32,
                         device=cams.device)
    cbox = torch.empty((n, 4, n_rec // chunk), dtype=torch.float32,
                       device=cams.device)
    args = [cams.data_ptr(), soup.data_ptr(), valid.data_ptr(),
            packed.data_ptr(), cbox.data_ptr(), n, t, n_rec, chunk]
    entry = _c_entry("mr_raster_setup")

    def call():
        entry(*args, torch.cuda.current_stream().cuda_stream)

    return call, packed, cbox


def _bin_entry(torch, cbox, supers):
    """A call of the ``mr_raster_bin`` entry (:func:`_c_entry`) on the chunk
    boxes ``cbox`` at H x W into outputs made once. Returns (call, lists,
    counts)."""
    from meshrecon_torch.raster import binned

    n, nch = cbox.shape[0], cbox.shape[2]
    ntx, nty = -(-W // binned.TILE), -(-H // binned.TILE)
    lists = torch.empty((n, nty * ntx, nch // supers), dtype=torch.int32,
                        device=cbox.device)
    counts = torch.empty((n, nty * ntx), dtype=torch.int32,
                         device=cbox.device)
    tiles = binned._screen(H, W, cbox.device)[1]
    args = [cbox.data_ptr(), *(t.data_ptr() for t in tiles),
            lists.data_ptr(), counts.data_ptr(), n, nch, supers, ntx, nty]
    entry = _c_entry("mr_raster_bin")

    def call():
        entry(*args, torch.cuda.current_stream().cuda_stream)

    return call, lists, counts


def _same_lists(torch, lists, counts, want_lists, want_counts):
    """Equal counts, and equal list entries before each count."""
    live = (torch.arange(lists.shape[-1], device=lists.device)
            < want_counts[..., None])
    return (torch.equal(counts, want_counts) and torch.equal(
        torch.where(live, lists, 0), torch.where(live, want_lists, 0)))


def _entry_timers(torch, call):
    """``entry eager`` (CUDA events around 20 back-to-back calls) and
    ``entry graph`` (a CUDA graph of 20 calls) timers of an entry call."""
    return {"entry eager": lambda: _cuda_ms(torch, call, 20),
            "entry graph": _graph_timer(torch, call, 20, 3)}


def binning_phase(torch, dev, res, slice_args):
    """The binning's two kernels against their plain versions at the flow
    update's 16 cameras, on the 16,384- and 65,536-triangle spheres at
    640x480, at chunk 8, chunk 16 and superchunks of 8 chunks of 8: SETUP's
    records and chunk boxes against ``pack_records`` bit for bit
    (NaN-aware), and BIN's counts and list prefixes against ``bin_chunks``
    / ``bin_superchunks``, fed the plain version's chunk boxes. Each kernel
    is timed in 7 alternating rounds: its wrapper eager, its C entry
    eager and from a CUDA graph of 20 calls (the kernel alone), BIN also
    against its library call."""
    from meshrecon_torch import problems, state
    from meshrecon_torch.kernels import library
    from meshrecon_torch.raster import binned
    from meshrecon_torch.tools import fused_breakdown as fb

    t0 = time.perf_counter()
    lib = library().cdll
    shape = (ctypes.c_int * 6)()
    if lib.mr_raster_setup_shape(shape):
        raise RuntimeError("mr_raster_setup_shape failed")
    print(f"binning geometry: SETUP {shape[0]} threads a CTA, {shape[1]} "
          f"resident CTAs an SM; BIN {shape[2]} threads a CTA, {shape[3]} "
          f"resident CTAs an SM, clusters of up to {shape[4]} CTAs, "
          f"{shape[5]} of them resident at once")
    cams = torch.cat([slice_args[2][:, None], slice_args[4]], 1).reshape(
        B * (K + 1), 4, 4)
    ncam = cams.shape[0]
    ntiles = -(-H // binned.TILE) * -(-W // binned.TILE)
    for nt, nph in ((64, 128), (128, 256)):
        soup, valid = (torch.from_numpy(a).to(dev) for a in
                       state.pack_soup(problems.sphere_soup(nt, nph)))
        label = f"{ncam}x{H}x{W}, {2 * nt * nph} tris"
        plain_ms = None
        for chunk, supers in ((8, 1), (16, 1), (8, binned.SUPERS)):
            group = chunk * supers
            shape_label = f"{label}, chunk {chunk}" + (
                f", {supers} chunks a superchunk" if supers > 1 else "")
            packed, cbox = binned.setup_records(cams, soup, valid, group,
                                                chunk)
            plain = binned.pack_records(cams, soup, valid, group)
            boxes = plain[:, 12], plain[:, 13], plain[:, 14], plain[:, 15]
            plain_cbox = torch.stack(binned._group_boxes(*boxes, chunk),
                                     1).contiguous()
            torch.cuda.synchronize()
            err = max(_bits_err(torch, packed, plain),
                      _bits_err(torch, cbox, plain_cbox))
            if plain_ms is None:
                plain_ms = _cuda_ms(torch, lambda: binned.pack_records(
                    cams, soup, valid, group), 5)
            # the C entry's outputs live as long as its graph's replays
            call, p_out, c_out = _setup_entry(torch, cams, soup, valid,
                                              group, chunk)
            call()
            torch.cuda.synchronize()
            if _bits_err(torch, p_out, packed) or _bits_err(torch, c_out,
                                                             cbox):
                raise AssertionError(f"raster_setup [{shape_label}]: the "
                                     "entry differs from the wrapper's "
                                     "records")
            # the wrapper: CUDA events around 20 back-to-back calls
            ms = _interleaved(f"raster_setup [{shape_label}]", {
                "wrapper eager": lambda: _cuda_ms(
                    torch, lambda: binned.setup_records(
                        cams, soup, valid, group, chunk), 20),
                **_entry_timers(torch, call)})
            # bytes: cameras, soup, validity in; records and chunk boxes
            # out; operations: ~360 a (camera, triangle), float32 and
            # float64 alike (fb.SETUP_OPS)
            res.add(binned.SETUP, shape_label, err, 0.0, ms["wrapper eager"],
                    plain_ms,
                    work=(ncam * 64 + soup.numel() * 4 + valid.numel()
                          + (packed.numel() + cbox.numel()) * 4,
                          fb.SETUP_OPS * ncam * soup.shape[0]))
            del packed, cbox, plain, p_out, c_out

            def plain_bin():
                if supers == 1:
                    return binned.bin_chunks(*boxes, H, W, chunk=chunk)
                return binned.bin_superchunks(*boxes, H, W, chunk=chunk,
                                              supers=supers)[1:]

            lists, counts = binned.tile_lists(plain_cbox, H, W, supers)
            want_lists, want_counts = plain_bin()
            torch.cuda.synchronize()
            same = _same_lists(torch, lists, counts, want_lists, want_counts)
            entries_n = int(want_counts.sum().item())
            call, l_out, c_out = _bin_entry(torch, plain_cbox, supers)
            call()
            torch.cuda.synchronize()
            if not _same_lists(torch, l_out, c_out, lists, counts):
                raise AssertionError(f"raster_bin [{shape_label}]: the "
                                     "entry's lists differ from the "
                                     "wrapper's")
            timers = {"wrapper eager": lambda: _cuda_ms(
                torch, lambda: binned.tile_lists(plain_cbox, H, W, supers),
                20), **_entry_timers(torch, call)}
            del lists, want_lists
            # the tile keys the JAX package sorts (binned.py:590-598)
            keys, active = binned._tile_keys(
                *binned._group_boxes(*plain_cbox.unbind(1), supers), H, W,
                binned.TILE, binned.TILE)

            def library_bin():
                # the two calls that make the lists and counts from the
                # tile keys (binned.py:597-598, 612-613 in the JAX package)
                return (torch.sort(keys, dim=-1).values,
                        active.sum(-1, dtype=torch.int32))

            if not torch.equal(library_bin()[1], want_counts):
                raise AssertionError("BIN's library call: counts differ")
            timers["torch.sort"] = lambda: _cuda_ms(torch, library_bin, 20)
            ms = _interleaved(f"raster_bin [{shape_label}] against torch.sort "
                              "+ sum of its tile keys", timers)
            del keys, active, l_out, c_out
            bin_plain_ms = _cuda_ms(torch, plain_bin, 3)
            # bytes: chunk boxes in, the listed ids and the counts out;
            # operations: the four comparisons of each listed group (the
            # least any binning does; the rest is skipped by unions)
            res.add(binned.BIN, shape_label,
                    0.0 if same else float("inf"), 0.0, ms["wrapper eager"],
                    bin_plain_ms,
                    work=(plain_cbox.numel() * 4
                          + (entries_n + ncam * ntiles) * 4, 4 * entries_n),
                    library_ms=ms["torch.sort"])
            slots = want_counts.numel() * (plain_cbox.shape[-1] // supers)
            print(f"raster_bin [{shape_label}]: counts and list prefixes "
                  f"equal: {same}; {entries_n} list entries of {slots}")
            del plain_cbox
    print(f"binning phase: {time.perf_counter() - t0:.1f} s")


RASTER_GRAPH_CALLS = 20  # raster calls in a CUDA graph of the raster phase


def _c_entry(name):
    """The binding's own function of launch entry ``name``, which takes the
    stream last: what the kernel alone costs, with no wrapper and no count.
    A non-zero CUDA status raises."""
    from meshrecon_torch.kernels import library

    fn = getattr(library().ext, name)

    def call(*args):
        code = fn(*args)
        if code:
            raise RuntimeError(f"{name}: CUDA error {code}")
    return call


def _raster_entry(torch, bins):
    """A call of the K1 (one-level ``bins``) or K5 entry on ``bins``
    (:func:`_c_entry`), into an output made once. Returns (call, out)."""
    from meshrecon_torch.raster import binned

    packed, lists, counts = bins["packed"], bins["lists"], bins["counts"]
    n, n_rec = packed.shape[0], packed.shape[-1]
    h, w = bins["height"], bins["width"]
    out = torch.empty((n, h, w), dtype=torch.float32, device=packed.device)
    ptrs = [t.data_ptr() for t in (*bins["grid"], *bins["tiles"], out)]
    name = "mr_raster_tiles" if bins["cbox"] is None else "mr_raster_tiles2"
    fn = _c_entry(name)
    if bins["cbox"] is None:
        # the whole frame's rows
        args = [packed.data_ptr(), lists.data_ptr(), counts.data_ptr(), *ptrs,
                n, n_rec, lists.shape[-1], h, w, binned.TILE, bins["chunk"],
                0, h]
    else:
        args = [packed.data_ptr(), bins["cbox"].data_ptr(), lists.data_ptr(),
                counts.data_ptr(), *ptrs, n, n_rec, lists.shape[-1], h, w,
                binned.TILE, bins["chunk"], bins["supers"]]

    def call():
        fn(*args, torch.cuda.current_stream().cuda_stream)

    return call, out


def _walk_line(label, bins):
    """Print the coverage walk's counts on ``bins`` (raster_sweep's
    ``walk_counts``, torch ops on the card)."""
    from meshrecon_torch.tools.raster_sweep import walk_counts

    c = walk_counts(bins)
    print(f"walk [{label}]: records {c['records']}, tile hits "
          f"{c['tile_hits']}, warp hits {c['warp_hits']}, coverage tests "
          f"{c['coverage_tests']} (first design {c['first_design_tests']}, "
          f"x{c['first_design_tests'] / max(c['coverage_tests'], 1):.2f} "
          f"fewer), longest tile walk {c['longest_walk']}, longest warp "
          f"walk {c['longest_warp']}")


def _kernel_rounds(torch, label, bins, ref):
    """The kernel alone on ``bins`` (its C entry), from a CUDA graph of
    RASTER_GRAPH_CALLS calls, in 7 rounds; its output must equal ``ref``
    bit for bit."""
    call, out = _raster_entry(torch, bins)  # out lives as long as the graph
    call()
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        raise AssertionError(f"{label}: the kernel differs from "
                             "render_depth")
    _interleaved(f"kernel alone, graph [{label}]", {
        "kernel": _graph_timer(torch, call, RASTER_GRAPH_CALLS, 3)})


def raster_phase(torch, dev, res, slice_args):
    """K5 (the two-level raster) against ``render_depth``, bitwise, through
    both of its wrappers: K5a at one camera, K5b at 4 and at the flow
    update's 16 cameras, on the 16,384- and 65,536-triangle spheres and the
    fused problem's soup at 640x480; each with its wrapper, binning and
    kernel ms, and K1's split and both binnings' peak memory at 16 cameras.
    For each case (and K1 at 16 cameras) the coverage walk's counts, and
    the kernel alone from a CUDA graph in 7 rounds. Then the raster sweep
    tool at its defaults with chunks 8 and 16, its launch counts reset just
    before: returns them (K5a's and K5b's path)."""
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
            _walk_line(f"{kernel.name}, {label}", bins)
            _kernel_rounds(torch, f"{kernel.name}, {label}", bins, ref)
            if ncam == len(cams16):
                ref16 = ref
            del bins
            res.add(kernel, label, err, 0.0, ms, plain_ms,
                    work=_raster_work(ncam, soup, valid, covered))

        # K1 at 16 cameras: the wrapper as setup + bin + kernel alone, and
        # the peak memory of each binning
        cams = cams16
        bins = binned.bin_soup(cams, soup, valid, H, W)
        k1_ms = _cuda_ms(torch, lambda: binned.render_depth_binned(
            cams, soup, valid, H, W), 10)
        k1_bin = _cuda_ms(torch, lambda: binned.bin_soup(
            cams, soup, valid, H, W), 10)
        k1_setup = _cuda_ms(torch, lambda: binned.setup_records(
            cams, soup, valid), 10)
        cbox = binned.setup_records(cams, soup, valid)[1]
        k1_lists = _cuda_ms(torch, lambda: binned.tile_lists(cbox, H, W), 10)
        k1_kern = _cuda_ms(torch, lambda: binned.raster_binned(binned.K1,
                                                               bins), 10)
        label = f"{binned.K1.name}, {len(cams)}x{H}x{W}, {soup_label}"
        _walk_line(label, bins)
        _kernel_rounds(torch, label, bins, ref16)
        del bins, cbox
        mem1 = _peak_mb(torch, lambda: binned.bin_soup(cams, soup, valid, H,
                                                       W))
        mem2 = _peak_mb(torch, lambda: binned.bin_soup(
            cams, soup, valid, H, W, two_level=True))
        mem_plain = _peak_mb(torch, lambda: binned.bin_chunks(
            *binned.pack_records(cams, soup, valid)[:, 12:16].unbind(1), H,
            W))
        print(f"raster_tiles [{len(cams)}x{H}x{W}, {soup_label}]: wrapper "
              f"{k1_ms:.4f} ms = setup {k1_setup:.4f} ms + bin "
              f"{k1_lists:.4f} ms + kernel alone {k1_kern:.4f} ms (the "
              f"binning in one call {k1_bin:.4f} ms); binning peak memory: "
              f"one level (K1) {mem1:.1f} MB, two levels (K5b) {mem2:.1f} "
              f"MB, the plain one level (pack_records + bin_chunks) "
              f"{mem_plain:.1f} MB")

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


def _r2_clocks(torch, call):
    """nvidia-smi's SM clock and its maximum, sampled every 100 ms while a
    CUDA graph of ``GRAPH_CALLS`` calls of ``call`` (R2) replays for about
    a second; the sampler is stopped before this returns."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_CALLS):
            call()
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        t_end = time.perf_counter() + 1.2
        while time.perf_counter() < t_end:
            for _ in range(20):
                graph.replay()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=30)
    samples = [line.strip() for line in out.splitlines() if line.strip()]
    print("nvidia-smi --query-gpu=clocks.sm,clocks.max.sm while R2's graph "
          f"replays (every 100 ms): {samples}")


def roofline_phase(torch, dev, res):
    """R1-R4 against their plain versions at the roofline tool's shapes:
    R1, R3 and R4 bitwise, R2 to 1e-6 relative (the plain version's float64
    sum can round before its float32 rounding). R2 eager (50 calls) and
    from a CUDA graph of 100 calls in 7 alternating rounds, with its
    geometry and the SM clock while it runs. Then the roofline tool
    (``meshrecon_torch.tools.roofline``) in-process, its launch counts reset
    just before. Returns (the tool's numbers, its launches); R3's and R4's
    launches add the tool's CUDA-graph replays x the launches captured."""
    from meshrecon_torch.kernels import all_kernels, library
    from meshrecon_torch.kernels._build import entry_kinds
    from meshrecon_torch.tools import roofline as rl

    gen = torch.Generator().manual_seed(SEED + 4)
    x = torch.rand(rl.COPY_SHAPE, generator=gen).to(dev)
    y = torch.empty_like(x)
    err = (rl.copy_scale(x) - rl.copy_scale_plain(x)).abs().max().item()
    plain_ms = _cuda_ms(torch, lambda: rl.copy_scale_plain(x), 50)

    def r1():
        rl.copy_scale(x, out=y)

    def mul():
        torch.mul(x, rl.COPY_SCALE, out=y)
    t = _interleaved(
        "R1 copy_scale 4096x4096 against torch.mul, eager (50 calls) and "
        f"device (a CUDA graph of {GRAPH_CALLS} calls)",
        {"R1 eager": lambda: _cuda_ms(torch, r1, 50),
         "torch.mul eager": lambda: _cuda_ms(torch, mul, 50),
         "R1 graph": _graph_timer(torch, r1),
         "torch.mul graph": _graph_timer(torch, mul)})
    # bytes: one float in, one out; one multiply an element
    res.add(rl.R1, "4096x4096", err, 0.0, t["R1 eager"], plain_ms,
            work=(8 * x.numel(), x.numel()), library_ms=t["torch.mul eager"])
    del x, y

    b = (0.999 + 0.002 * torch.rand(rl.FMA_SHAPE, generator=gen)).to(dev)
    o = torch.empty_like(b)
    out, ref = rl.fma_chain(b), rl.fma_chain_plain(b)
    rel = ((out - ref).abs() / ref.abs()).max().item()
    print(f"{rl.R2.name}: max relative error {rel:.3e} (bound 1e-6)")
    if not rel <= 1e-6:
        raise AssertionError(f"{rl.R2.name}: relative error {rel}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shape = (ctypes.c_int * 3)()
    if library().cdll.mr_roofline_fma_shape(b.numel(), sms, shape) != 0:
        raise AssertionError("mr_roofline_fma_shape refused the tool's block")
    if tuple(shape) != rl.fma_shape(b.numel(), sms):
        raise AssertionError(f"R2's geometry {tuple(shape)} differs from "
                             f"its mirror {rl.fma_shape(b.numel(), sms)}")
    print(f"{rl.R2.name}: {shape[0]} CTAs of {shape[1]} threads, "
          f"{shape[2]} chains a thread, on {sms} SMs")

    def r2():
        rl.fma_chain(b, out=o)
    t = _interleaved(
        f"R2 fma_chain 256x512, {rl.INNER} FMAs, eager (50 calls) and "
        f"device (a CUDA graph of {GRAPH_CALLS} calls)",
        {"R2 eager": lambda: _cuda_ms(torch, r2, 50),
         "R2 graph": _graph_timer(torch, r2)})
    flops = 2 * rl.INNER * b.numel()
    print(f"{rl.R2.name}: " + "; ".join(
        f"{name} {flops / (t[name] * 1e-3) / 1e12:.2f} TFLOP/s"
        for name in t if name.endswith("graph")))
    _r2_clocks(torch, r2)
    plain_ms = _cuda_ms(torch, lambda: rl.fma_chain_plain(b), 2)
    # bytes: one float in, one out; operations: 2 an FMA
    res.add(rl.R2, f"256x512, {rl.INNER} FMAs", (out - ref).abs().max().item(),
            1e-6 * ref.abs().max().item(), t["R2 eager"], plain_ms,
            work=(8 * b.numel(), flops))

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
        plain_ms = _cuda_ms(torch, lambda: rl.add_one_plain(c), 1000)

        def add():
            torch.add(c, 1.0, out=o)
        label = f"{rows}x{rl.TINY_COLS}, {nblocks} CTA(s)"
        t = _interleaved(
            f"{kernel.name} [{label}] against torch.add, eager (1,000 "
            f"calls) and device (a CUDA graph of {GRAPH_CALLS} calls)",
            {"kernel eager": lambda: _cuda_ms(torch, lambda: fn(o), 1000),
             "torch.add eager": lambda: _cuda_ms(torch, add, 1000),
             "kernel graph": _graph_timer(torch, lambda: fn(o)),
             "torch.add graph": _graph_timer(torch, add)})
        res.add(kernel, label, err, 0.0, t["kernel eager"], plain_ms,
                work=(8 * c.numel(), c.numel()),
                library_ms=t["torch.add eager"])

    # R3's launch path, split: host-bound eager loops on one (8, 128) pair
    c = torch.zeros((rl.TINY_ROWS, rl.TINY_COLS), device=dev)
    o = torch.empty_like(c)
    lib = library()
    # the C entry through ctypes, as launches went before the binding, its
    # argument types from bind.cpp's declaration
    entry = ctypes.CDLL(str(lib.path))[rl.R3.entry]
    entry.argtypes = [{"P": ctypes.c_void_p, "I": ctypes.c_int}[kind]
                      for kind in entry_kinds()[rl.R3.entry]]
    bound = getattr(lib.ext, rl.R3.entry)
    args = (c.data_ptr(), o.data_ptr(), rl.TINY_ROWS, 1,
            torch.cuda.current_stream(dev).cuda_stream)
    _interleaved("R3 launch path (5,000 eager calls a round)", {
        "C entry alone through ctypes (the CUDA launch inside)":
        lambda: _cuda_ms(torch, lambda: entry(*args), 5000),
        "C entry alone through the binding":
        lambda: _cuda_ms(torch, lambda: bound(*args), 5000),
        "the binding's launch (device, stream, entry, capture state)":
        lambda: _cuda_ms(torch, lambda: lib.ext.launch(bound, c, o,
                                                       rl.TINY_ROWS, 1),
                         5000),
        "Kernel.launch":
        lambda: _cuda_ms(torch, lambda: rl.R3.launch(c, o, rl.TINY_ROWS, 1),
                         5000),
        "add_one (the wrapper's checks, then Kernel.launch)":
        lambda: _cuda_ms(torch, lambda: rl.add_one(c, out=o), 5000),
        "torch.add(out=)":
        lambda: _cuda_ms(torch, lambda: torch.add(c, 1.0, out=o), 5000)})

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
        depth0 = out["stages"][0]
        print(f"breakdown B={b}: depth0 {depth0['d_ms']:.4f} ms, "
              f"{depth0['d_events']} device events (bound 20: the binning "
              "is two kernels)")
        if not depth0["d_events"] <= DEPTH0_EVENTS:
            raise AssertionError(f"depth0 fires {depth0['d_events']} device "
                                 f"events, above {DEPTH0_EVENTS}")
        args = state.from_numpy(problems.fused_problem(b, K, H, W, seed=0),
                                dev)
        ref = FusedMainUpdate(H, W).to(dev)(*args)
        metrics = parity.check_slice(state.to_numpy(out["all"]),
                                     state.to_numpy(ref))
        print(f"breakdown B={b}: {time.perf_counter() - t0:.1f} s; all "
              f"stage vs FusedMainUpdate (meshrecon_torch/parity.py "
              "bounds): " + ", ".join(f"{k} {v:.3e}"
                                     for k, v in metrics.items()))


def _rewarp_flows(torch, dev, args_np):
    """The (images, u, v) that K3b meets in the rewarp update: the fused
    update with ``variance="rewarp"`` on ``args_np`` (640x480, K=3, B=4),
    its call of ``tile_warp_flow_batched`` recorded: the mixed side frames
    and the flows ``variational_flow`` returns on the (main, mixed)
    pairs."""
    from meshrecon_torch import state
    from meshrecon_torch.pipeline import fused

    seen = []
    warp = fused.tile_warp_flow_batched

    def record(images, u, v, taps=2):
        seen.append((images.clone(), u.clone(), v.clone()))
        return warp(images, u, v, taps=taps)
    fused.tile_warp_flow_batched = record
    try:
        fused.fused_main_update_batched(*state.from_numpy(args_np, dev), H,
                                        W, variance="rewarp")
    finally:
        fused.tile_warp_flow_batched = warp
    if len(seen) != 1:
        raise AssertionError(f"the rewarp update warped {len(seen)} times")
    return seen[0]


def k3b_phase(torch, dev, res, args_np):
    """K3b against flow_remap (1e-4) on three fields: the e2e re-warp's
    B*K=12 stack and the K=8 bucket, a smooth flow of a few px pushed 20 px
    off the left border on its first 16 columns and off the bottom on its
    last 8 rows, so that every tap there clamps; and the flows of the
    rewarp update on the fused problem (4x3x480x640). For each: the warps
    that read their taps unclamped, counted by the kernel and by the
    Python mirror (equal); K3b eager (50 calls) and from a CUDA graph of
    100 calls in 7 alternating rounds with ``grid_sample`` bicubic."""
    from meshrecon_torch.flow import tile_warp
    from meshrecon_torch.flow.remap import flow_remap

    gen = torch.Generator().manual_seed(SEED + 1)
    cases = []
    for shape in ((B * K, H, W), (B, 8, H, W)):
        img = (127.5 + _smooth_field(torch, gen, shape, 120.0,
                                     dev)).contiguous()
        u = _smooth_field(torch, gen, shape, 3.0, dev)
        v = _smooth_field(torch, gen, shape, 3.0, dev)
        u[..., :16] -= 20.0
        v[..., -8:, :] += 20.0
        cases.append(("x".join(map(str, shape)), img, u.contiguous(),
                      v.contiguous()))
    img, u, v = _rewarp_flows(torch, dev, args_np)
    print(f"rewarp update flows: |u| max {u.abs().max().item():.3f} px, "
          f"|v| max {v.abs().max().item():.3f} px")
    cases.append((f"{B}x{K}x{H}x{W} rewarp flows", img, u, v))
    for label, img, u, v in cases:
        shape = tuple(img.shape)
        px = int(np.prod(shape))
        n = px // (H * W)
        out = tile_warp.tile_warp_flow_batched(img, u, v, taps=4)
        ref = flow_remap(torch.stack([u, v], -1), img)
        cols = torch.arange(W, dtype=torch.float32, device=dev)
        rows = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
        grid = _grid(torch, cols + u, rows + v)
        lib_in = img.reshape(-1, 1, H, W)
        lib = _library_sample(torch, lib_in, grid, "bicubic")
        counted, unclamped = tile_warp.warp_bicubic_paths(img, u, v)
        mirror = int(tile_warp.bicubic_warp_paths(u, v).sum().item())
        warps = n * H * -(-W // (tile_warp.K3B_COLS * tile_warp.K3B_PIX))
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        lib_err = (lib.reshape(shape) - ref).abs().max().item()
        print(f"warp_bicubic [{label}]: {unclamped} of {warps} warps "
              f"({unclamped / warps:.4f}) read their taps unclamped, the "
              f"rest clamp each tap (the mirror: {mirror}); "
              f"grid_sample(bicubic, border) differs from flow_remap by "
              f"{lib_err:.3e} at most (its normalized grid)")
        if unclamped != mirror or not torch.equal(counted, out):
            raise AssertionError(f"K3b [{label}]: the kernel's path split "
                                 f"({unclamped}) or output differs from "
                                 f"the mirror's ({mirror})")

        def k3b():
            return tile_warp.tile_warp_flow_batched(img, u, v, taps=4)

        def grid_sample():
            return _library_sample(torch, lib_in, grid, "bicubic")
        t = _interleaved(
            f"K3b [{label}] against grid_sample bicubic, eager (50 calls) "
            f"and device (a CUDA graph of {GRAPH_CALLS} calls)",
            {"K3b eager": lambda: _cuda_ms(torch, k3b, 50),
             "K3b graph": _graph_timer(torch, k3b),
             "grid_sample eager": lambda: _cuda_ms(torch, grid_sample, 50),
             "grid_sample graph": _graph_timer(torch, grid_sample)})
        plain_ms = _cuda_ms(torch, lambda: flow_remap(
            torch.stack([u, v], -1), img), 5)
        # the twin's weights and tap order, -fmad=false: 1e-4 on 0..255.
        # bytes: image, u, v in, one float out; operations: 34 for the
        # 4 + 4 weights, 32 for the 16 taps, 8 for the row sums, 6 for the
        # coordinates
        res.add(tile_warp.K3B, label, err, 1e-4, t["K3b eager"], plain_ms,
                work=(16 * px, 80 * px), library_ms=t["grid_sample eager"])


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

    def k6(per_launch=jacobi.K6_SWEEPS_PER_LAUNCH):
        return jacobi.hs_jacobi(ix, iy, c, u0, v0, ALPHA2, iters=60,
                                _sweeps_per_launch=per_launch)

    plain = jacobi.hs_jacobi_plain(ix, iy, c, u0, v0, ALPHA2, iters=60)
    label = f"{n}x{H}x{W}, 60 sweeps"
    err, ms = _blocked_phase(torch, "hs_jacobi_fields", label, k6, plain, 60,
                             H, W, graph_calls=10)
    # the sweeps a launch that K6_SWEEPS_PER_LAUNCH takes: device times of
    # the candidates (CUDA graphs of 10 calls)
    sweep = {s: _graph_ms(torch, lambda s=s: k6(s), calls=10)
             for s in (6, 10, 12, 15, 20, 24)}
    print(f"hs_jacobi_fields [{label}]: device ms by sweeps a launch "
          + ", ".join(f"{s}: {t:.4f}" for s, t in sweep.items())
          + f" (K6_SWEEPS_PER_LAUNCH = {jacobi.K6_SWEEPS_PER_LAUNCH})")
    plain_ms = _cuda_ms(torch, lambda: jacobi.hs_jacobi_plain(
        ix, iy, c, u0, v0, ALPHA2, iters=60), 3)
    # the plain version's arithmetic in its order (-fmad=false); 1e-3 px is
    # the JAX package's bound for hs_jacobi (tests/test_pallas_jacobi.py).
    # bytes: ix, iy, c, u0, v0 in, u, v out; operations: 5 for 1/denom,
    # 27 a sweep (two 9-operation averages, the data term, the update)
    res.add(jacobi.K6, label, err, 1e-3, ms, plain_ms,
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


BENCH_BATCHES = (1, 4)
BENCH_FRESH_REPS = 5


def _bench_line_bad(torch, line):
    """The fields of a bench line that break its check (see bench_phase)."""
    import math

    numbers = [(k, v) for k, v in line.items()
               if isinstance(v, (int, float)) and k != "busy_share"]
    numbers += [(f"rounds_ms[{i}]", v) for i, v in enumerate(
        line["rounds_ms"])]
    bad = [k for k, v in numbers if not (math.isfinite(v) and v > 0)]
    if not 0 < line["busy_share"] <= 1:
        bad.append("busy_share")
    if line["device"] != torch.cuda.get_device_name(0):
        bad.append("device")
    if line["power_limit"] in (None, "not read"):
        bad.append("power_limit")
    return bad


BENCH_PDF_METRICS = ("pdf_within_1e-3", "log_pdf_diff", "normal_len_rel")


def _witness_parity(out, args_np, h, w, label):
    """``out`` (numpy), the card's fused update of ``args_np`` (the ten
    update inputs, numpy) at ``h`` x ``w``, against FusedMainUpdate's plain
    run of the same inputs on the CPU, every main camera, within
    ``parity.check_slice``.

    On the 512-triangle soup of ``problems.fused_problem`` the pdf is
    ill-conditioned: the plain version run again on the CPU with the side
    cameras one ulp up (the witness) misses parity.py's bounds on the
    three metrics of BENCH_PDF_METRICS (pixels at the +-30 log-pdf clamp
    flip ends, and where log pdf is near -17 the last bits of the
    reprojection move the pdf by over 1e-3). The card's 4x4 camera inverse
    and matmul differ from the CPU's in the last bits, which is such a
    change. So those three bounds are the witness's where it is looser
    than parity.py's (a maximum with float32 rounding's slack: at the
    clamp the card and the witness both reach e^60 in pdf, e^20 in normal
    length, computed apart); the other six keep parity.py's. Both sets of
    metrics are printed."""
    from meshrecon_torch import parity, state
    from meshrecon_torch.pipeline.fused import FusedMainUpdate

    t0 = time.perf_counter()
    args_np = list(args_np)
    cpu = state.to_numpy(FusedMainUpdate(h, w)(*state.from_numpy(args_np,
                                                                 "cpu")))
    args_np[4] = np.nextafter(args_np[4], np.float32(np.inf))
    witness = parity.slice_agreement(state.to_numpy(FusedMainUpdate(h, w)(
        *state.from_numpy(args_np, "cpu"))), cpu)
    print(f"{label}: CPU plain runs took {time.perf_counter() - t0:.1f} s")
    metrics = parity.slice_agreement(out, cpu)
    for name, m in (("card vs CPU", metrics),
                    ("witness (CPU, side cameras +1 ulp) vs CPU", witness)):
        print(f"{label} {name}: "
              + ", ".join(f"{k} {v:.4e}" for k, v in m.items()))
    bounds = {}
    for name in BENCH_PDF_METRICS:
        kind, bound = parity.SLICE_BOUNDS[name]
        if kind == "min":
            bounds[name] = min(bound, witness[name])
        else:  # a float32 maximum: the clamp's range, up to its rounding
            bounds[name] = max(bound, witness[name] * (1 + 2.0 ** -20))
    print(f"{label}: bounds from the witness {bounds}")
    return parity.check_slice(out, cpu, bounds)


def _bench_parity(torch, b):
    """One rep of the bench's update (``bench.reduced`` at a zero carry) on
    the card, on ``bench.problem(b, ...)``, against the plain run of the
    same inputs on the CPU (``_witness_parity``)."""
    from meshrecon_torch import bench, problems

    args = bench.problem(b, K, H, W, "cuda")
    eps = torch.zeros((), dtype=torch.float32, device=args[0].device)
    _, out = bench.reduced(eps, args, H, W)
    out = _check_update(out, f"bench B={b} update")
    _witness_parity(out, problems.fused_problem(b, K, H, W, seed=0), H, W,
                    f"bench B={b}")


def bench_phase(torch, path):
    """The port's bench (``meshrecon_torch.bench``) at 640x480, K=3, its
    default reps and rounds: in-process at each of BENCH_BATCHES, counters
    reset just before, every kernel of ``path`` launched, every number of
    its line finite and positive, the carry finite, busy_share in (0, 1];
    after each, one rep of its update on the card against the plain
    versions on the CPU at the same inputs (``_bench_parity``); then ``python -m meshrecon_torch.bench`` in a fresh process at
    ``MESHRECON_BENCH_REPS=5``: exit 0, exactly one JSON line on stdout,
    with the in-process line's keys."""
    import math
    import os

    from meshrecon_torch import bench
    from meshrecon_torch.kernels import all_kernels

    t_phase = time.perf_counter()
    kernels = all_kernels()
    for b in BENCH_BATCHES:
        _reset(kernels)
        t0 = time.perf_counter()
        line = bench.run(b, K, H, W, bench.REPS, bench.ROUNDS, "cuda")
        print(f"bench B={b}: {json.dumps(line)} "
              f"({time.perf_counter() - t0:.1f} s)")
        _launched(kernels, path, f"bench B={b}")
        carry = line.pop("carry")
        bad = _bench_line_bad(torch, line)
        if bad or not math.isfinite(carry):
            raise AssertionError(f"bench B={b}: fields {bad}, carry {carry}")
        _bench_parity(torch, b)

    env = dict(os.environ, MESHRECON_BENCH_REPS=str(BENCH_FRESH_REPS))
    env.pop("MESHRECON_BENCH_B", None)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "meshrecon_torch.bench"],
                          capture_output=True, text=True, timeout=600,
                          env=env)
    lines = proc.stdout.splitlines()
    print(f"bench fresh process (MESHRECON_BENCH_REPS={BENCH_FRESH_REPS}): "
          f"rc {proc.returncode}, {time.perf_counter() - t0:.1f} s, "
          f"stdout {proc.stdout.strip()}")
    if proc.returncode != 0 or len(lines) != 1:
        raise AssertionError(f"bench fresh process: rc {proc.returncode}, "
                             f"{len(lines)} lines; stderr "
                             f"{proc.stderr[-2000:]}")
    fresh = json.loads(lines[0])
    bad = _bench_line_bad(torch, fresh)
    if list(fresh) != list(line) or fresh["reps"] != BENCH_FRESH_REPS or bad:
        raise AssertionError(f"bench fresh process: keys {list(fresh)}, "
                             f"fields {bad}")
    print(f"phase bench: {time.perf_counter() - t_phase:.1f} s")


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


def _k3c_work(px, share):
    """(bytes, operations) of K3c on ``px`` pixels of which ``share`` are
    valid, as this data needs them: every pixel's mask byte read and float
    written; a valid pixel's two coordinates and, at most, one image float
    read, and ~22 operations (an invalid pixel reads nothing more)."""
    valid = share * px
    return 5 * px + 12 * valid, 22 * valid


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
        # 0..255
        res.add(tile_warp.K3C, label, err, 1e-4, ms, plain_ms,
                work=_k3c_work(px, share), library_ms=lib_ms)


# GN's float32 operations (depth/triangulate.py, counted from the eager
# ops, a division, log or exp counted as one): a valid side's terms at a
# pixel (the taylor form; the exact mode's three bilinear taps add
# GN_TAP_OPS), a valid side's share of a step, a pixel's share of a step,
# a valid side's share of the result, a pixel's share of the result
GN_TERM_OPS, GN_TAP_OPS = 90, 35
GN_STEP_SIDE_OPS, GN_STEP_OPS = 27, 13
GN_RESULT_SIDE_OPS, GN_RESULT_OPS = 27, 41


def _keep_largest(torch, store):
    """``make`` for :func:`_wrap`: the triangulation whose flows are the
    largest is kept in ``store`` (its inputs copied, the flows' two
    channels as one (..., 2) tensor, as the update hands them over)."""

    def make(original):
        def call(flx, fly, var, *rest, **kwargs):
            if not store or flx.numel() > store["args"][0].numel():
                flows = torch.stack([flx, fly], -1)
                store["args"] = (flows[..., 0], flows[..., 1], var.clone(),
                                 *(t.clone() for t in rest))
                store["sampling"] = kwargs.get("sampling", "taylor")
            return original(flx, fly, var, *rest, **kwargs)
        return call

    return make


def _gn_work(kind, args, hist, stop, exact):
    """(bytes, float32 operations) of one GN kernel on a triangulation's
    inputs ``args``, from its step-count histogram ``hist`` (B, G + 1) and
    stop sweeps ``stop`` (B,): the least of each, the walk's steps as the
    pixels took them (a warp walks while any of its pixels does)."""
    flx, sv, depth = args[0], args[5], args[6]
    b, _, h, w = flx.shape
    if kind == "sobel":
        return (depth.numel() * 12, depth.numel() * 12)
    bins = hist.shape[1]
    if kind == "exit":
        return (bins * b * 4 + b * 8 + 24, bins * b * 3)
    px = h * w
    kv = sv.sum(1).tolist()  # valid sides of each item
    hist = hist.cpu().tolist()
    stop = stop.cpu().tolist()
    terms = GN_TERM_OPS + (GN_TAP_OPS if exact else 0)
    planes_in = sum(kv) * px * 12 + b * px * 12  # flows, var; depth, grads
    if kind == "walk":
        ops = sum(px * k * terms + sum(t * c for t, c in enumerate(hh))
                  * (k * GN_STEP_SIDE_OPS + GN_STEP_OPS)
                  for k, hh in zip(kv, hist))
        return (planes_in + b * px * 8 + bins * b * 4, ops)
    # finish: the terms again, the steps past the walk's, the result
    replay = [sum(c * s for t, c in enumerate(hh) if t > s)
              for hh, s in zip(hist, stop)]
    ops = sum(px * k * (terms + GN_RESULT_SIDE_OPS) + px * GN_RESULT_OPS
              + r * (k * GN_STEP_SIDE_OPS + GN_STEP_OPS)
              for k, r in zip(kv, replay))
    return (planes_in + b * px * (8 + 21) + b * 64, ops)


def gn_phase(torch, dev, res, captured):
    """GN (the Gauss-Newton triangulation, csrc/triangulate.cu) at the
    shape of the default reconstruction's largest flow update (koule-tr's
    iteration 2: B=4, K=8, 480x640), on its own inputs, taylor (the
    update's sampling) then exact: ``triangulate_pixels_batched`` (the
    card's path: GN_SOBEL, GN_WALK, GN_EXIT, GN_FINISH) bit for bit
    against the eager sweeps on the same card inputs
    (``GaussNewtonBand`` + ``gauss_newton`` + ``result``), the sweep
    count equal, and each kernel against its share of the eager path
    (GN_SOBEL against ``sobel_gradient``, GN_WALK's z against the eager
    z wherever a pixel stopped by its item's stop sweep, GN_EXIT against
    ``gn_exit_plain``, GN_FINISH against ``result``), with its bound."""
    from meshrecon_torch.depth import triangulate as tri

    if "args" not in captured:
        raise AssertionError("GN: the default reconstruction triangulated "
                             "nothing")
    args = captured["args"]
    b, k, h, w = args[0].shape
    print(f"GN: the default reconstruction's largest triangulation: "
          f"B={b} K={k} {h}x{w}, valid sides {args[5].sum(1).tolist()}, "
          f"flows read in place: {tri._flow_planes(*args[:2])[2] == 2}")
    samplings = [captured["sampling"]]
    samplings += [s for s in ("taylor", "exact") if s not in samplings]
    for sampling in samplings:
        exact = sampling == "exact"
        label = f"{b}x{k}x{h}x{w} {sampling}"
        out = tri.triangulate_pixels_batched(*args, sampling=sampling)
        eager = tri.GaussNewtonBand(*args, sampling)
        sweeps = tri.gauss_newton([eager], 50)
        ref = eager.result(sweeps)
        torch.cuda.synchronize()
        errs = [_bits_err(torch, out[key], ref[key])
                for key in ("point4", "pdf")]
        mismatch = int((out["valid"] != ref["valid"]).sum())
        if out["gn_sweeps"] != sweeps or mismatch or max(errs):
            raise AssertionError(
                f"GN [{label}]: sweeps {out['gn_sweeps']} against {sweeps}, "
                f"point4 / pdf errors {errs}, valid mismatch {mismatch}")
        path_ms = _cuda_ms(torch, lambda: tri.triangulate_pixels_batched(
            *args, sampling=sampling), 10)

        def eager_call():
            band = tri.GaussNewtonBand(*args, sampling)
            return band.result(tri.gauss_newton([band], 50))

        eager_ms = _cuda_ms(torch, eager_call, 2)
        print(f"GN [{label}]: bitwise the eager loop (sweeps {sweeps}, "
              f"valid share {float(out['valid'].float().mean()):.4f}); "
              f"triangulation {path_ms:.4f} ms, eager {eager_ms:.4f} ms")

        # each kernel on the same inputs, against its share of the eager
        # path
        band = tri.KernelBand(*args, sampling)
        depth = band.depth
        gx, gy = tri.gn_sobel(depth)
        ref_g = tri.sobel_gradient(depth)
        err = max(_bits_err(torch, gx, ref_g[0]),
                  _bits_err(torch, gy, ref_g[1]))
        res.add(tri.GN_SOBEL, label, err, 0.0,
                _cuda_ms(torch, lambda: tri.gn_sobel(depth), 50),
                _cuda_ms(torch, lambda: tri.sobel_gradient(depth), 20),
                work=_gn_work("sobel", args, None, None, exact))
        hist = band.walk(50)
        stop, info = tri.gn_exit(hist, band.inv_status)
        plain_stop, plain_sweeps, plain_steps = tri.gn_exit_plain(hist.cpu())
        got = info.tolist()
        err = float(max(abs(x - y) for x, y in zip(
            stop.tolist() + got[:2], plain_stop + [plain_sweeps, plain_steps])))
        # the walk's z where a pixel stopped by its item's stop sweep is
        # the eager z after the item's sweeps
        done = band.t <= stop[:, None, None]
        err_walk = _bits_err(torch, torch.where(done, band.z, 0.0),
                             torch.where(done, eager.z, 0.0))
        if got[0] != sweeps or got[2]:
            raise AssertionError(f"GN [{label}]: GN_EXIT gives {got}, the "
                                 f"eager loop {sweeps} sweeps")
        print(f"GN [{label}]: stop sweeps {stop.tolist()}, pixel-steps "
              f"{got[1]} of {b * h * w * sweeps} the sweeps allow "
              f"({got[1] / max(b * h * w * sweeps, 1) * 100:.2f}%), pixels "
              f"that stopped by their item's sweep "
              f"{float(done.float().mean()):.4f}")
        res.add(tri.GN_WALK, label, err_walk, 0.0,
                _cuda_ms(torch, lambda: band.walk(50), 20),
                _cuda_ms(torch, lambda: tri.gauss_newton(
                    [tri.GaussNewtonBand(*args, sampling)], 50), 2),
                work=_gn_work("walk", args, hist, stop, exact))
        band.walk(50)  # the z and t that finish reads
        res.add(tri.GN_EXIT, label, err, 0.0,
                _cuda_ms(torch, lambda: tri.gn_exit(hist, band.inv_status),
                         50),
                _cuda_ms(torch, lambda: tri.gn_exit_plain(hist.cpu()), 5),
                work=_gn_work("exit", args, hist, stop, exact))
        fin = band.finish(stop)
        err = max(_bits_err(torch, fin[key], ref[key])
                  for key in ("point4", "pdf"))
        if not torch.equal(fin["valid"], ref["valid"]):
            err = float("inf")
        res.add(tri.GN_FINISH, label, err, 0.0,
                _cuda_ms(torch, lambda: band.finish(stop), 20),
                _cuda_ms(torch, lambda: eager.result(sweeps), 5),
                work=_gn_work("finish", args, hist, stop, exact))


# The plane sweep's float32 operations a plane (depth/plane_sweep.py,
# counted from the eager ops, a division counted as one): SWEEP_PROJ's a
# pixel of a valid side slot (three camera rows, the w guard, two
# divisions, the frame test) and its coordinates where the mask is set;
# SWEEP_COST's a side pixel whose mask is set and its combine a main pixel;
# SWEEP_BEST's a main pixel (nine taps of the cost, the box sum, the update)
SWEEP_PROJ_OPS, SWEEP_COORD_OPS = 26, 6
SWEEP_COST_OPS, SWEEP_COMBINE_OPS = 5, 6
SWEEP_BEST_OPS = 30


def _keep_largest_sweep(store):
    """``make`` for :func:`_wrap`: the sweep whose side window is the
    largest is kept in ``store`` (its inputs, as the update hands them
    over)."""

    def make(original):
        def call(*args, **kwargs):
            if not store or args[1].numel() > store["args"][1].numel():
                store["args"] = args
                store["kwargs"] = kwargs
            return original(*args, **kwargs)
        return call

    return make


def _sweep_work(kind, win, n_ok):
    """(bytes, float32 operations) of one SWEEP kernel on a plane of the
    window ``win`` whose K3c mask has ``n_ok`` pixels set: each input read
    once, each output written once, a padded slot's pixels only their mask
    byte, a side pixel outside its frame nothing more."""
    b, k, h, w = win.fs.shape
    px = h * w
    kv = int(win.side_valid.sum())  # valid side slots
    if kind == "proj":
        return (b * k * px + 8 * n_ok,
                kv * px * SWEEP_PROJ_OPS + n_ok * SWEEP_COORD_OPS)
    if kind == "cost":
        per_ok = 8 if win.swt is not None else 4  # the sample (and weight)
        return (kv * px + per_ok * n_ok + 12 * b * px,
                n_ok * SWEEP_COST_OPS + b * px * SWEEP_COMBINE_OPS)
    # best: num and den read, six float planes and pending read and
    # written
    return (b * px * (8 + 2 * 25), b * px * SWEEP_BEST_OPS)


def sweep_phase(torch, dev, res, captured):
    """The plane sweep's kernels (csrc/sweep.cu) at c4's shape (1x32x
    1080x1920, ``baseline_configs``' window, 64 planes) and at the default
    reconstruction's largest iteration-1 sweep (B=4, K=8 with padded slots
    and vote weights, 480x640, its own inputs): the sweep on the card
    (SWEEP_PROJ, K3c, SWEEP_COST, SWEEP_BEST a plane) bit for bit against
    the eager planes on the same card inputs (``SweepWindow`` and
    ``take_plane``), both timed; then at the middle plane each kernel
    against its plain version (``fields``, ``sums``, ``take_plane`` from
    the eager state of the planes before), bound 0, with its ms, the
    plain version's ms and its bytes bound, and the plane's four launches
    together."""
    from meshrecon_torch.depth import plane_sweep as ps
    from meshrecon_torch.flow.tile_warp import tile_warp_sample_batched
    from meshrecon_torch.tools import baseline_configs

    t_phase = time.perf_counter()
    if "args" not in captured:
        raise AssertionError("sweep: the default reconstruction swept "
                             "nothing")
    h, w, k, d = C4["h"], C4["w"], C4["k"], C4["d"]
    fm, fs, cam, cams, sv = (torch.from_numpy(np.ascontiguousarray(a)).to(
        dev) for a in baseline_configs.window(h, w, k))
    c4 = ((fm[None], fs[None], cam[None], cams[None], sv[None],
           torch.tensor([baseline_configs.Z_MIN], device=dev),
           torch.tensor([baseline_configs.Z_MAX], device=dev)),
          dict(num_depths=d))
    for args, kwargs in (c4, (captured["args"], captured["kwargs"])):
        fm, fs, cm, cs, sv, z0, z1 = args[:7]
        depths = kwargs.get("num_depths", 64)
        swt = kwargs.get("side_weight")
        b, k, h, w = fs.shape
        label = (f"{b}x{k}x{h}x{w}, valid sides {sv.sum(1).tolist()}, "
                 f"{'weighted' if swt is not None else 'unweighted'}")
        z_min, z_max, zs = ps.sweep_planes(z0, z1, depths, dev)

        def card():
            return ps.plane_sweep_depth_batched(fm, fs, cm, cs, sv, z0, z1,
                                                depths, side_weight=swt)

        def eager():
            return ps.sweep_windows([ps.SweepWindow(
                fm, fs, cm, cs, sv, zs, swt)], z_min, z_max, depths)

        out, ref = card(), eager()
        torch.cuda.synchronize()
        errs = [_bits_err(torch, out[key], ref[key])
                for key in ("depth", "cost")]
        mismatch = int((out["valid"] != ref["valid"]).sum())
        if mismatch or max(errs):
            raise AssertionError(f"sweep [{label}]: depth / cost errors "
                                 f"{errs}, valid mismatch {mismatch}")
        card_ms = _cuda_ms(torch, card, 3)
        eager_ms = _cuda_ms(torch, eager, 1)
        print(f"sweep [{label}]: bitwise the eager planes ({depths} planes, "
              f"valid share {float(out['valid'].float().mean()):.4f}); "
              f"sweep {card_ms:.3f} ms, eager {eager_ms:.3f} ms")
        del out, ref

        # each kernel at the middle plane, against its plain version
        mid = depths // 2
        win = ps.KernelWindow(fm, fs, cm, cs, sv, zs, swt)
        plain = ps.SweepWindow(fm, fs, cm, cs, sv, zs, swt)
        b_sv = win.side_valid[:, :, None, None]

        def proj():
            ps.SWEEP_PROJ.launch(win.cm, win.zs, win.side_valid, win.cols,
                                 win.rows, win.ok, win.scol, win.srow, mid,
                                 b, k, h, w)

        proj()
        ok, scol, srow = plain.fields(mid)
        torch.cuda.synchronize()
        n_ok = int(win.ok.sum())
        err = 0.0 if torch.equal(win.ok, ok & b_sv) else float("inf")
        err = max(err, _bits_err(torch, torch.where(win.ok, win.scol, 0.0),
                                 torch.where(win.ok, scol, 0.0)),
                  _bits_err(torch, torch.where(win.ok, win.srow, 0.0),
                            torch.where(win.ok, srow, 0.0)))
        print(f"sweep [{label}]: plane {mid}, K3c's mask set on "
              f"{n_ok / win.ok.numel():.4f} of the side pixels, "
              f"{float(ok.float().mean()):.4f} before the padded slots' "
              "are cleared")
        res.add(ps.SWEEP_PROJ, label, err, 0.0, _cuda_ms(torch, proj, 20),
                _cuda_ms(torch, lambda: plain.fields(mid), 5),
                work=_sweep_work("proj", win, n_ok))
        samp = tile_warp_sample_batched(plain.fs, scol.contiguous(),
                                        srow.contiguous(), ok.contiguous())
        want = plain.sums(samp, ok)
        tile_warp_sample_batched(win.fs, win.scol, win.srow, win.ok,
                                 out=win.samp)

        def cost():
            ps.SWEEP_COST.launch(win.samp, win.ok, win.side_valid, win.fm,
                                 win.swt, win.num, win.den, b, k, h, w)

        cost()
        torch.cuda.synchronize()
        err = max(_bits_err(torch, win.num, want[0]),
                  _bits_err(torch, win.den, want[1]))
        res.add(ps.SWEEP_COST, label, err, 0.0, _cuda_ms(torch, cost, 20),
                _cuda_ms(torch, lambda: plain.sums(samp, ok), 5),
                work=_sweep_work("cost", win, n_ok))
        del samp

        # the eager state after the planes before the middle one
        big = torch.full((b, h, w), 1e30, device=dev)
        best = {"best_c": big, "best_prev": big, "best_next": big,
                "last_c": big, "best_z": z_max[:, None, None].expand(
                    b, h, w),
                "support": torch.zeros((b, h, w), device=dev),
                "pending": torch.zeros((b, h, w), dtype=torch.bool,
                                       device=dev)}
        for j in range(mid):
            best = ps.take_plane(best, *plain.evidence(j), zs[j])
        keys = ("best_c", "best_prev", "best_next", "last_c", "best_z",
                "support")
        state0 = torch.stack([best[key] for key in keys]).contiguous()
        state = state0.clone()
        pending = best["pending"].clone()
        num, den = plain.evidence(mid)
        after = ps.take_plane(best, num, den, zs[mid])
        ps.sweep_best(num, den, zs, mid, state, pending)
        torch.cuda.synchronize()
        err = max(_bits_err(torch, state[i], after[key])
                  for i, key in enumerate(keys))
        if not torch.equal(pending, after["pending"]):
            err = float("inf")
        res.add(ps.SWEEP_BEST, label, err, 0.0, _cuda_ms(
            torch, lambda: ps.sweep_best(num, den, zs, mid, state, pending),
            20), _cuda_ms(torch, lambda: ps.take_plane(best, num, den,
                                                       zs[mid]), 5),
            work=_sweep_work("best", win, n_ok))

        def plane():
            ps.sweep_best(*win.evidence(mid), zs, mid, state, pending)

        plane_ms = _cuda_ms(torch, plane, 20)
        plane_eager = _cuda_ms(torch, lambda: ps.take_plane(
            best, *plain.evidence(mid), zs[mid]), 5)
        print(f"sweep [{label}]: a plane (SWEEP_PROJ, K3c, SWEEP_COST, "
              f"SWEEP_BEST) {plane_ms:.4f} ms, eager {plane_eager:.4f} ms")
        del win, plain, best, state0, state, num, den, after
    print(f"phase sweep: {time.perf_counter() - t_phase:.1f} s")


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
    kernels = (binned.SETUP, binned.BIN, binned.K1, tile_warp.K2,
               tile_warp.K3C)
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
    _check_sphere_mesh(obj, f"e2e {label}", E2E_BOUNDS[label])
    return launches


def _check_sphere_mesh(obj, label, bounds=None):
    """The OBJ must have faces and finite vertices, and with ``bounds``
    (median, p90 of |r - R| / R) lie on koule-tr's fitted sphere within
    them; the figures are printed either way and returned (faces, med,
    p90)."""
    from meshrecon_torch.io.obj import read_mesh
    from meshrecon_torch.io.synthetic import fit_sphere
    from meshrecon_torch.io.tracks import load_tracks

    mesh = read_mesh(str(obj))
    center, radius = fit_sphere(load_tracks(TRACK).bundles)
    v3 = mesh.vertices[:, :3] / mesh.vertices[:, 3:4]
    err = np.abs(np.linalg.norm(v3 - center, axis=1) - radius) / radius
    med, p90 = float(np.median(err)), float(np.percentile(err, 90))
    bound_med, bound_p90 = bounds or (None, None)
    print(f"{label}: {len(mesh.faces)} faces, {len(mesh.vertices)} "
          f"vertices; |r - R| / R median {med:.4f} (bound {bound_med}), "
          f"p90 {p90:.4f} (bound {bound_p90})")
    if not len(mesh.faces) or not np.isfinite(v3).all():
        raise AssertionError(f"{label}: empty or non-finite mesh")
    if bounds and not (med <= bound_med and p90 <= bound_p90):
        raise AssertionError(f"{label}: mesh off the sphere (median {med}, "
                             f"p90 {p90})")
    return dict(faces=len(mesh.faces), med=med, p90=p90)


OUT_DIR = Path("build") / "chip_smoke"  # git-ignored
VIDEO_SEEDS = "3,13"  # the video phase's ensemble
RASTER_REF_BOUNDS = (0.01, 0.99, 1e-2)  # tests/test_raster.py golden scene


def _write_clip(path, planes):
    """An MJPG AVI at 24 fps of (F, H, W, 3) uint8 BGR frames."""
    import cv2

    f_count, h, w, _ = planes.shape
    wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 24,
                         (w, h))
    if not wr.isOpened():
        raise RuntimeError(f"cv2 cannot write {path}")
    for f in range(f_count):
        wr.write(planes[f])
    wr.release()


def _scene_yaml(clip_name, name):
    """A copy of koule-tr's YAML beside its clip, naming ``clip_name``."""
    text = Path(TRACK).read_text()
    if "koule-perlin.mkv" not in text:
        raise RuntimeError(f"{TRACK} no longer names koule-perlin.mkv")
    yaml = OUT_DIR / name
    yaml.write_text(text.replace("koule-perlin.mkv", clip_name))
    return yaml


def _reset(kernels):
    for k in kernels:
        k.launches = 0


def _launched(kernels, path, label):
    launches = {k.name: k.launches for k in kernels}
    missing = [k.name for k in path if launches[k.name] == 0]
    print(f"{label}: launches {launches}")
    if missing:
        raise AssertionError(f"{label}: kernels not launched: {missing}")
    return launches


def _wrap(owner, name, make):
    """``owner.name`` replaced by ``make(original)`` inside a with block."""
    from unittest import mock

    return mock.patch.object(owner, name, make(getattr(owner, name)))


def video_phase(torch, dev, path):
    """A color clip through the CLI with -e and a two-seed ensemble: the
    clip decode, the exposure solve on the card, the ensemble's union and
    every kernel of the default reconstruction."""
    from meshrecon_torch import cli
    from meshrecon_torch.io.synthetic import synthetic_frames
    from meshrecon_torch.io.tracks import load_tracks
    from meshrecon_torch.kernels import all_kernels
    from meshrecon_torch.pipeline import config as config_mod
    from meshrecon_torch.pipeline import exposure
    from meshrecon_torch.utils.profiling import StageTimer

    t_phase = time.perf_counter()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    track = load_tracks(TRACK)
    # three surface-attached textures as B, G, R (a full-rank solve), each
    # times its own per-frame gain 1 + 0.2 sin(f + 2c)
    f_idx = torch.arange(track.frame_count, device=dev,
                         dtype=torch.float64)[:, None]
    gain = 1 + 0.2 * torch.sin(f_idx + 2 * torch.arange(3, device=dev))
    planes = torch.stack([
        (synthetic_frames(track, W, H, "sphere", seed=seed, device=dev)
         * gain[:, c, None, None]).clamp(1, 254)
        for c, seed in enumerate((3, 4, 5))], dim=-1).to(torch.uint8)
    _write_clip(OUT_DIR / "koule_color.avi", planes.cpu().numpy())
    yaml = _scene_yaml("koule_color.avi", "koule_color.yaml")
    gain = gain.cpu().numpy()
    print(f"video: wrote {W}x{H}, {track.frame_count} frames, MJPG "
          f"({time.perf_counter() - t_phase:.2f} s)")

    decode_s, solves = [], []

    def timed_decode(orig):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = orig(*args, **kwargs)
            decode_s.append(time.perf_counter() - t0)
            return out
        return call

    def kept_solve(orig):
        def call(sampled, valid, device):
            out = orig(sampled, valid, device)
            solves.append((sampled, valid, out))
            return out
        return call

    kernels = all_kernels()
    obj = OUT_DIR / "chip_smoke_video.obj"
    timer = StageTimer()
    _reset(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _wrap(config_mod, "_decode_clip", timed_decode), \
            _wrap(exposure, "_solve_exposure_device", kept_solve):
        rc = cli.main([str(yaml), "-e", "--ensemble-seeds", VIDEO_SEEDS,
                       "-o", str(obj), "--device", "cuda", "-v"],
                      timer=timer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"video: cli.main rc {rc}")
    _launched(kernels, path, "video")
    sampled, valid, (e, _, solve) = solves[0]
    print(f"video: decode {decode_s[0]:.3f} s; exposure solve on "
          f"{solve['device']}, {solve['rounds']} rounds, mean residual "
          f"{solve['err']:.4f}, {solve['ms']:.3f} ms")
    if not solve["device"].startswith("cuda"):
        raise AssertionError(f"video: exposure solved on {solve['device']}")
    # the card's solve against the plain CPU one on the same samples, at
    # tests/test_torch_exposure.py's full-rank bound (1e-4 of the largest
    # gain, the same round count)
    e_cpu, _, solve_cpu = exposure._solve_exposure_device(sampled, valid,
                                                          "cpu")
    gain_err = float(np.abs(e - e_cpu).max() / np.abs(e_cpu).max())
    print(f"video: exposure on the CPU, same samples: {solve_cpu['rounds']} "
          f"rounds, mean residual {solve_cpu['err']:.4f}; largest gain "
          f"difference {gain_err:.3e} of the largest gain (bound 1e-4); "
          f"singular values of frame 0's samples "
          + ", ".join(f"{v:.1f}" for v in np.linalg.svd(
              np.where(valid[0, :, None], sampled[0], 0.0),
              compute_uv=False)))
    if solve_cpu["rounds"] != solve["rounds"] or gain_err > 1e-4:
        raise AssertionError("video: the card's exposure solve disagrees "
                             "with the CPU's")
    total = e.sum(0) * gain.mean(1)
    per_c = [float(np.std(e[c] * gain[:, c]) / abs(np.mean(e[c] * gain[:, c])))
             for c in range(3)]
    print(f"video: spread (std / mean over frames) of exposure.sum(0) x "
          f"mean gain {float(total.std() / total.mean()):.4f}; of "
          f"exposure[c] x gain[c] (B, G, R) "
          + ", ".join(f"{v:.4f}" for v in per_c))
    print(f"video: cli.main wall {wall:.2f} s, ensemble seeds {VIDEO_SEEDS}; "
          "stages (card-synchronized wall seconds):")
    for line in timer.report().splitlines():
        print(f"  {line}")
    _check_sphere_mesh(obj, "video", E2E_BOUNDS["default"])
    print(f"phase video: {time.perf_counter() - t_phase:.1f} s")


def scenes_phase(torch, dev, path):
    """Two YAMLs of one gray clip with -V -n 1 --depth-mode flow: the lazy
    decode, the per-camera path's kernels and dumps, and the first scene's
    frames leaving the card."""
    import contextlib
    import io
    import os
    import re

    from meshrecon_torch import cli
    from meshrecon_torch.io.synthetic import synthetic_frames
    from meshrecon_torch.io.tracks import load_tracks
    from meshrecon_torch.kernels import all_kernels
    from meshrecon_torch.pipeline.config import Config
    from meshrecon_torch.utils.profiling import StageTimer

    t_phase = time.perf_counter()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    track = load_tracks(TRACK)
    gray = synthetic_frames(track, W, H, "sphere", seed=3, device=dev)
    gray = gray.clamp(0, 255).to(torch.uint8)[..., None].expand(
        -1, -1, -1, 3).contiguous()
    _write_clip(OUT_DIR / "koule_gray.avi", gray.cpu().numpy())
    yamls = [_scene_yaml("koule_gray.avi", f"koule_gray{i}.yaml")
             for i in range(2)]
    dumps = (OUT_DIR / "dumps_V").resolve()
    if dumps.exists():
        for f in dumps.iterdir():
            f.unlink()
    dumps.mkdir(parents=True, exist_ok=True)
    clip_bytes = track.frame_count * H * W * 4

    readings = []

    def measured_release(orig):
        def call(self):
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            orig(self)
            readings.append((before, torch.cuda.memory_allocated()))
        return call

    class _Tee(io.TextIOBase):
        def __init__(self, out):
            self.out, self.buf = out, io.StringIO()

        def write(self, text):
            self.buf.write(text)
            return self.out.write(text)

        def flush(self):
            self.out.flush()

    kernels = all_kernels()
    timer = StageTimer()
    tee = _Tee(sys.stdout)
    argv = [*(str(y.resolve()) for y in yamls), "-V", "-n", "1",
            "--depth-mode", "flow", "-o", str(dumps / "scene{}.obj"),
            "--device", "cuda"]
    _reset(kernels)
    cwd = os.getcwd()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        os.chdir(dumps)
        with _wrap(Config, "release_frames", measured_release), \
                contextlib.redirect_stdout(tee):
            rc = cli.main(argv, timer=timer)
    finally:
        os.chdir(cwd)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"scenes -V: cli.main rc {rc}")
    _launched(kernels, path, "scenes -V")
    # -n 1 flow from the alpha shape is the crude first pass: its surface
    # error is printed, not bounded; the meshes must be written and finite
    for i in range(2):
        _check_sphere_mesh(dumps / f"scene{i}.obj", f"scenes -V scene {i}")

    # the dumps the chosen bundles imply: per main camera its frame and
    # depth, per side four images; the scenes write the same names
    expected = set()
    for fa, sides in re.findall(r"main camera (\d+), side cameras ([\d, ]+),",
                                tee.buf.getvalue()):
        expected |= {f"frame{fa}.png", f"depth-frame{fa}.png"}
        for fb in re.findall(r"\d+", sides):
            expected |= {f"project-frame{fa}from{fb}.png",
                         f"flow-frame{fa}from{fb}.png",
                         f"frame{fa}from{fb}-remapped.png",
                         f"frame{fa}from{fb}-remap-error.png"}
    pngs = {f.name for f in dumps.glob("*.png")}
    objs = {f.name for f in dumps.glob("*.obj")}
    print(f"scenes -V: {len(pngs)} PNG dumps (the bundles imply "
          f"{len(expected)}), OBJ files {sorted(objs)}")
    if not expected or pngs != expected:
        raise AssertionError(f"scenes -V: dumps {sorted(pngs ^ expected)} "
                             "differ from the bundles'")
    if not {"recon_orig.obj", "purepoints.obj", "filteredpoints.obj"} <= objs:
        raise AssertionError(f"scenes -V: OBJ dumps missing: {objs}")

    print("scenes -V: torch.cuda.memory_allocated around each scene's "
          "release_frames (before, after; bytes): "
          + "; ".join(f"{b}, {a}" for b, a in readings)
          + f"; the clip holds {clip_bytes}")
    if len(readings) != 2 or readings[0][0] - readings[0][1] < clip_bytes:
        raise AssertionError("scenes -V: the first scene's frames stayed "
                             "on the card after release_frames")
    print(f"scenes -V: cli.main wall {wall:.2f} s; stages "
          "(card-synchronized wall seconds):")
    for line in timer.report().splitlines():
        print(f"  {line}")
    print(f"phase scenes -V: {time.perf_counter() - t_phase:.1f} s")


def drivers_phase(torch, dev, flow_path, raster_path):
    """The standalone flow and raster drivers in a scratch directory; the
    raster driver's depth against the NumPy reference rasterizer."""
    import os

    from meshrecon_torch.flow import driver as flow_driver
    from meshrecon_torch.kernels import all_kernels
    from meshrecon_torch.raster import driver as raster_driver
    from meshrecon_torch.raster.reference import render_depth_reference

    t_phase = time.perf_counter()
    work = (OUT_DIR / "drivers").resolve()
    work.mkdir(parents=True, exist_ok=True)
    kernels = all_kernels()
    cwd = os.getcwd()
    try:
        os.chdir(work)
        _reset(kernels)
        t0 = time.perf_counter()
        if flow_driver.main([]) != 0:
            raise AssertionError("flow driver: nonzero exit")
        torch.cuda.synchronize()
        print(f"flow driver: {time.perf_counter() - t0:.2f} s")
        _launched(kernels, flow_path, "flow driver")
        _reset(kernels)
        t0 = time.perf_counter()
        if raster_driver.main([]) != 0:
            raise AssertionError("raster driver: nonzero exit")
        torch.cuda.synchronize()
        print(f"raster driver: {time.perf_counter() - t0:.2f} s")
        _launched(kernels, raster_path, "raster driver")
        for name in ("flow.png", "remap.png", "diff.png",
                     "test/out-depth.png", "test/out-projected.png"):
            if not (work / name).stat().st_size:
                raise AssertionError(f"drivers: {name} is empty")
    finally:
        os.chdir(cwd)

    depth = raster_driver.render(dev)[0].cpu().numpy()
    t0 = time.perf_counter()
    ref = render_depth_reference(raster_driver.GLX_MVP,
                                 raster_driver.golden_soup(),
                                 raster_driver.HEIGHT, raster_driver.WIDTH)
    cover, cover_ref = depth < 1.0, ref < 1.0
    disagree = float(np.mean(cover != cover_ref))
    both = cover & cover_ref
    err = np.abs(depth[both] - ref[both])
    share = float(np.mean(err < RASTER_REF_BOUNDS[2]))
    ref_s = time.perf_counter() - t0
    print(f"raster driver vs render_depth_reference ({ref_s:.2f} s): "
          f"coverage disagreement {disagree:.6f} (bound "
          f"{RASTER_REF_BOUNDS[0]}), share of |dz| < {RASTER_REF_BOUNDS[2]} "
          f"{share:.6f} (bound {RASTER_REF_BOUNDS[1]}), max |dz| "
          f"{float(err.max()):.3e}, covered {float(cover.mean()):.4f}")
    if not (cover.mean() > 0.05 and disagree < RASTER_REF_BOUNDS[0]
            and share > RASTER_REF_BOUNDS[1]):
        raise AssertionError("raster driver disagrees with the reference")
    print(f"phase drivers: {time.perf_counter() - t_phase:.1f} s")


# the harness's runs: (scenes, scale). koberec- at 320x240 (at 640x480 it
# took 119.0 s of the harness's 193.99 on an H100 80GB HBM3 at 700 W), the
# other two at 640x480
QUALITY_RUNS = (("koule-tr,zatisi", 1), ("koberec-", 2))
# the seed study's koule row at trim2, seed 3, 640x480 as PERF.md records
# it from an earlier run on an H100 80GB HBM3 at 700 W (median, p90 of
# |r - R| / R)
SEED_STUDY_RECORDED = (0.0174, 0.2035)
PROGRESS = {"Meshing...", "Choosing cameras...", "Tracking the whole clip...",
            "Calculating final mesh..."}
# error_attrib's and remesh_lab's scale: 320x240 (at 640x480 the two took
# 66.5 s of the phase's 226.0 on an H100 80GB HBM3 at 700 W; the harness
# and the seed study stay at full size)
ATTRIB_SCALE = 2
RBF_GRID, RBF_POINTS = 64, 1500
RBF_SAMPLES = 16384  # grid points held against the float64 host evaluation
TORUS_TUBE = 0.4  # the meshing driver's torus: R 1, r 0.4


def _tool(torch, label, main, argv, timer=None):
    """``main(argv)`` of a tool in-process, its output captured and printed
    (less the refinement's progress lines); with ``timer`` its StageTimer
    split too. Returns (exit code, output)."""
    import contextlib
    import io

    out = io.StringIO()
    kwargs = {} if timer is None else {"timer": timer}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = main(argv, **kwargs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    text = out.getvalue()
    for line in text.splitlines():
        if line not in PROGRESS:
            print(f"  {line}")
    print(f"{label} {' '.join(argv)}: rc {rc}, wall {wall:.2f} s")
    if timer is not None:
        print(f"{label} stages (card-synchronized wall seconds):")
        for line in timer.report().splitlines():
            print(f"  {line}")
    return rc, text


def quality_phase(torch, path, sweep_path):
    """The quality tools on the card: the harness on koule-tr and zatisi
    at 640x480 and on koberec- at 320x240 (QUALITY_RUNS), by its own
    bounds (SETUP, BIN, K1, K2, K3, K4 must launch in each run), the
    seed study on Queue C's inputs (K3c must launch), error_attrib with a
    dump at 320x240 and remesh_lab on that dump."""
    import re

    from meshrecon_torch.kernels import all_kernels
    from meshrecon_torch.tools import (error_attrib, quality_harness,
                                       remesh_lab, seed_study)
    from meshrecon_torch.utils.profiling import StageTimer

    t_phase = time.perf_counter()
    kernels = all_kernels()
    OUT_DIR.mkdir(parents=True, exist_ok=True)

    for scenes, scale in QUALITY_RUNS:
        _reset(kernels)
        rc, text = _tool(torch, "quality_harness", quality_harness.main, [
            "--scale", str(scale), "--scenes", scenes, "--configs",
            "default", "--device", "cuda"], StageTimer())
        rows = re.findall(
            r"^default\s+\d+\s+[\d.]+\s+[\d.]+\s+[\d.]+$", text, re.M)
        _launched(kernels, path, f"quality_harness {scenes}")
        count = scenes.count(",") + 1
        if rc != 0 or len(rows) != count:
            raise AssertionError(f"quality_harness {scenes}: rc {rc}, "
                                 f"{len(rows)} rows ({count} expected)")

    _reset(kernels)
    rc, text = _tool(torch, "seed_study", seed_study.main, [
        "--scale", "1", "--seeds", "3", "--configs", "trim2", "--device",
        "cuda"], StageTimer())
    _launched(kernels, sweep_path, "seed_study")
    row = re.search(r"^trim2\s+3\s+(\d+)\s+([\d.]+)\s+([\d.]+)", text,
                    re.M)
    if rc != 0 or row is None:
        raise AssertionError(f"seed_study: rc {rc}, no trim2 row")
    med, p90 = float(row.group(2)), float(row.group(3))
    print(f"seed_study trim2 seed 3 at 640x480: {row.group(1)} faces, "
          f"median {med:.4f}, p90 {p90:.4f} |r - R| / R (recorded: "
          f"{SEED_STUDY_RECORDED[0]} / {SEED_STUDY_RECORDED[1]})")
    bound_med, bound_p90 = E2E_BOUNDS["default"]
    if not (med <= bound_med and p90 <= bound_p90):
        raise AssertionError(f"seed_study: off the default's bound ({med}, "
                             f"{p90})")

    dump = OUT_DIR / "attrib_{seed}.npz"
    rc, text = _tool(torch, "error_attrib", error_attrib.main, [
        "--scale", str(ATTRIB_SCALE), "--seeds", "3", "--dump", str(dump),
        "--device", "cuda"], StageTimer())
    missing = [s_ for s_ in ("A  cloud", "B  bundle", "D  oracle")
               if s_ not in text]
    dumped = np.load(str(dump).format(seed=3))
    prov, points = dumped["prov"], dumped["points"]
    print(f"error_attrib dump: {len(points)} points, {len(prov)} provenance "
          f"codes ({len(np.unique(prov))} distinct), keys {dumped.files}")
    if rc != 0 or missing or len(prov) != len(points) or not len(points):
        raise AssertionError(f"error_attrib: rc {rc}, sections missing "
                             f"{missing}, {len(prov)} codes for "
                             f"{len(points)} points")

    rc, text = _tool(torch, "remesh_lab", remesh_lab.main, [
        str(dump).format(seed=3), "--device", "cuda"])
    if rc != 0 or not re.search(r"^baseline\s+\d+", text, re.M):
        raise AssertionError(f"remesh_lab: rc {rc}, no baseline row")
    print(f"phase quality: {time.perf_counter() - t_phase:.1f} s")


def _tube_error(v3):
    """| distance to the torus' core circle - r | of (N, 3) points."""
    ring = np.hypot(np.hypot(v3[:, 0], v3[:, 1]) - 1.0, v3[:, 2])
    return np.abs(ring - TORUS_TUBE)


def _rbf_f64(centers, w, c, pts):
    """The fitted RBF at (M, 3) points, float64 NumPy on the host."""
    out = np.empty(len(pts))
    for s_ in range(0, len(pts), 256):
        p = pts[s_:s_ + 256]
        d = p[:, None, :] - centers[None]
        r = np.sqrt(np.maximum((d * d).sum(-1), 1e-20))
        out[s_:s_ + 256] = (r ** 3) @ w + c[0] + p @ c[1:]
    return out


def meshing_phase(torch, dev):
    """The meshing driver's three modes on the card's machine, and the RBF
    surface of the driver's torus with TF32 switched on around the call:
    its field against the same fit in float64 on the host, its mesh
    against the torus."""
    import os

    from meshrecon_torch.io.obj import read_mesh
    from meshrecon_torch.meshing import driver, rbf

    t_phase = time.perf_counter()
    work = (OUT_DIR / "meshing").resolve()
    work.mkdir(parents=True, exist_ok=True)
    cwd = os.getcwd()
    try:
        os.chdir(work)
        for mode in ("alpha", "poisson", "greedy"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rc = driver.main([mode, "--device", "cuda"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            mesh = read_mesh(f"test/torus_{mode}.obj")
            v3 = mesh.vertices[:, :3] / mesh.vertices[:, 3:4]
            print(f"meshing driver {mode}: rc {rc}, {len(mesh.faces)} faces, "
                  f"{wall:.2f} s, median |tube distance - 0.4| "
                  f"{float(np.median(_tube_error(v3))):.5f}")
            if rc != 0 or not len(mesh.faces):
                raise AssertionError(f"meshing driver {mode}: rc {rc}, "
                                     f"{len(mesh.faces)} faces")
    finally:
        os.chdir(cwd)

    pts, nrm = driver.fixture_points()
    seen = {}

    def timed_fit(inner):
        def fit(*args):
            t0 = time.perf_counter()
            out = inner(*args)
            seen["fit_s"] = time.perf_counter() - t0
            return out
        return fit

    def recorded_eval(inner):
        def ev(*args, **kwargs):
            seen["args"] = args
            seen["field"] = inner(*args, **kwargs)
            return seen["field"]
        return ev

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with _wrap(rbf, "_rbf_fit_host", timed_fit), \
                _wrap(rbf, "rbf_eval_grid", recorded_eval):
            mesh = rbf.rbf_surface(pts, nrm, grid=RBF_GRID,
                                   max_points=RBF_POINTS, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak_mb = (torch.cuda.max_memory_allocated() - base) / 1e6
        print(f"tf32 around rbf_surface: "
              f"{torch.backends.cuda.matmul.allow_tf32}")
        centers, w, c, lo, scale, grid = seen["args"][:6]
        eval_ms = _cuda_ms(torch, lambda: rbf.rbf_eval_grid(
            centers, w, c, lo, scale, grid, dev), 3)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    field = seen["field"].reshape(-1).cpu().numpy()
    pick = np.random.default_rng(0).choice(len(field), RBF_SAMPLES,
                                           replace=False)
    grid_pts = rbf.grid_points(lo, scale, grid, "cpu").double().numpy()
    want = _rbf_f64(centers, w, c, grid_pts[pick])
    fmax = float(np.abs(field).max())
    err = float(np.abs(field[pick] - want).max())
    v3 = mesh.vertices[:, :3] / mesh.vertices[:, 3:4]
    tube = float(np.median(_tube_error(v3)))
    print(f"rbf_surface [torus, grid {grid}, {len(centers)} centres]: host "
          f"fit {seen['fit_s']:.2f} s, grid evaluation {eval_ms:.3f} ms "
          f"(CUDA events, mean of 3 after the call's own), the call "
          f"{wall:.2f} s, {len(mesh.faces)} faces, peak "
          f"{peak_mb:.1f} MB above the call's start; field at "
          f"{RBF_SAMPLES} grid points against float64 on the host: max "
          f"|diff| {err:.3e} (bound 1e-5 x max|f| = {1e-5 * fmax:.3e}); "
          f"median |tube distance - 0.4| {tube:.5f} (bound 0.02)")
    if not (err <= 1e-5 * fmax and tube < 0.02 and len(mesh.faces)):
        raise AssertionError("rbf_surface: field or mesh off its bound")
    print(f"phase meshing: {time.perf_counter() - t_phase:.1f} s")


# the micro tools' rows that name what the port does not have (the TPU
# package's second engine, a TPU layout flag): printed n/a with the reason
MICRO_TOOLS = ("perf_breakdown", "flow_levels", "flow_trans", "flow_micro",
               "warp_micro", "proj_micro")
MICRO_NA = {"perf_breakdown": {"variational_flow(xla)"},
            "flow_micro": {"flowK3 xla engine lv3", "flowK3 prod minpx5e5"},
            "proj_micro": {"proj1 real depth xla"}}
STUDY_ITERS = "14,12"  # the solver's default, and 12
# iters_study's scale: 320x240 (at 640x480 its two runs took 68.8 s of the
# studies phase's 111.9 on an H100 80GB HBM3 at 700 W)
STUDY_SCALE = 2
C4 = dict(h=1080, w=1920, k=32, d=64)  # BASELINE.json configuration 4


def micro_phase(torch, path):
    """The six timing tools in-process at their defaults, the JAX tools'
    shapes (640x480, K=3, their reps): every row a finite ms or n/a where
    the port lacks what the row names (MICRO_NA), and every kernel of
    ``path`` launched."""
    import importlib
    import math

    from meshrecon_torch.kernels import all_kernels

    t_phase = time.perf_counter()
    kernels = all_kernels()
    _reset(kernels)
    for name in MICRO_TOOLS:
        tool = importlib.import_module(f"meshrecon_torch.tools.{name}")
        t0 = time.perf_counter()
        print(f"micro {name}:")
        rows = tool.main([])
        quality = rows.pop("quality", {})
        na = {row for row, ms in rows.items() if ms is None}
        bad = [row for row, ms in rows.items() if ms is not None
               and not (math.isfinite(ms) and ms > 0)]
        bad += [row for row, v in quality.items() if v is not None
                and not (math.isfinite(v) and v > 0)]
        print(f"micro {name}: {len(rows)} rows, n/a {sorted(na)}, "
              f"{time.perf_counter() - t0:.1f} s")
        if bad or na != MICRO_NA.get(name, set()):
            raise AssertionError(f"micro {name}: rows not finite {bad}, "
                                 f"n/a {sorted(na)}")
    _launched(kernels, path, "micro")
    print(f"phase micro: {time.perf_counter() - t_phase:.1f} s")


def studies_phase(torch, path):
    """The study tools on the card: flow_e2e_quality's three
    one-iteration flow runs at 640x480, each mesh within the default's
    bound, and iters_study at 14 and 12 sweeps (seed 3) at 1/STUDY_SCALE
    size, whose two meshes must differ: the sweep count reaches the run.
    Every kernel of ``path`` must launch."""
    import tempfile
    from unittest import mock

    from meshrecon_torch.io.obj import read_mesh
    from meshrecon_torch.kernels import all_kernels
    from meshrecon_torch.tools import flow_e2e_quality, iters_study
    from meshrecon_torch.utils.profiling import StageTimer

    t_phase = time.perf_counter()
    kernels = all_kernels()
    work = (OUT_DIR / "studies").resolve()
    work.mkdir(parents=True, exist_ok=True)
    _reset(kernels)
    bound_med, bound_p90 = E2E_BOUNDS["default"]
    with mock.patch.object(tempfile, "tempdir", str(work)):
        timer = StageTimer()
        t0 = time.perf_counter()
        rows = flow_e2e_quality.main(["1", "--device", "cuda"], timer=timer)
        print(f"flow_e2e_quality 1: {time.perf_counter() - t0:.1f} s; stages "
              "(card-synchronized wall seconds):")
        for line in timer.report().splitlines():
            print(f"  {line}")
        for name, row in rows.items():
            _check_sphere_mesh(work / f"fq_{name}.obj",
                               f"flow_e2e_quality {name}",
                               E2E_BOUNDS["default"])

        timer = StageTimer()
        t0 = time.perf_counter()
        rows = iters_study.main(["--iters", STUDY_ITERS, "--seeds", "3",
                                 "--scale", str(STUDY_SCALE), "--device",
                                 "cuda"], timer=timer)
        print(f"iters_study --iters {STUDY_ITERS} --seeds 3: "
              f"{time.perf_counter() - t0:.1f} s; stages "
              "(card-synchronized wall seconds):")
        for line in timer.report().splitlines():
            print(f"  {line}")
    meshes = []
    for row in rows:
        obj = work / f"iters_{row['iters']}_{row['seed']}.obj"
        _check_sphere_mesh(obj, f"iters_study {row['iters']}")
        meshes.append(read_mesh(str(obj)))
    same = (meshes[0].vertices.shape == meshes[1].vertices.shape
            and np.array_equal(meshes[0].vertices, meshes[1].vertices))
    print(f"iters_study: {STUDY_ITERS} sweeps give "
          f"{[len(m.faces) for m in meshes]} faces, "
          f"{[round(r['med'], 4) for r in rows]} median |r - R| / R; the "
          f"meshes {'are equal' if same else 'differ'}")
    if same:
        raise AssertionError("iters_study: the sweep count did not reach "
                             "the run (equal meshes)")
    _launched(kernels, path, "studies")
    print(f"phase studies: {time.perf_counter() - t_phase:.1f} s")


def config4_phase(torch, dev, res):
    """baseline_configs c4 at 1080p, 32 sides, 64 planes: one solve's K3c
    and SWEEP launches (one each a plane), the depth finite where valid,
    the tool's ms,
    Mpix/s and peak memory; then K3c alone at the middle plane's inputs
    (1x32x1080x1920) against its plain version, its bound and
    ``grid_sample``."""
    from meshrecon_torch.depth import plane_sweep
    from meshrecon_torch.flow import tile_warp
    from meshrecon_torch.kernels import all_kernels
    from meshrecon_torch.tools import baseline_configs

    t_phase = time.perf_counter()
    kernels = all_kernels()
    h, w, k, d = C4["h"], C4["w"], C4["k"], C4["d"]
    res_c4 = baseline_configs.config4(h, w, k, d, 3, dev)
    depth, valid = res_c4["out"]["depth"], res_c4["out"]["valid"]
    share = valid.float().mean().item()
    print(f"config4: valid share {share:.4f}, peak {res_c4['peak_mb']:.0f} "
          f"MB, {res_c4['ms']:.3f} ms a solve, {res_c4['mpix']:.2f} Mpix/s")
    if not (share > 0.05 and torch.isfinite(depth[valid]).all()):
        raise AssertionError("config4: depth not finite where valid, or no "
                             "valid pixel")

    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in baseline_configs.window(h, w, k)]
    seen = []

    def recorded(inner):
        def sample(*a, **kw):
            if len(seen) == d // 2:  # the window's buffers: copied
                srcs, scol, srow, ok = a
                seen.append((srcs, torch.where(ok, scol, 0.0),
                             torch.where(ok, srow, 0.0), ok.clone()))
            else:
                seen.append(None)
            return inner(*a, **kw)
        return sample

    _reset(kernels)
    with _wrap(plane_sweep, "tile_warp_sample_batched", recorded):
        plane_sweep.plane_sweep_depth(*args, baseline_configs.Z_MIN,
                                      baseline_configs.Z_MAX, num_depths=d)
    torch.cuda.synchronize()
    launches = {kern.name: kern.launches for kern in (
        tile_warp.K3C, plane_sweep.SWEEP_PROJ, plane_sweep.SWEEP_COST,
        plane_sweep.SWEEP_BEST)}
    print(f"config4: one solve's launches {launches} ({d} planes)")
    if set(launches.values()) != {d}:
        raise AssertionError(f"config4: launches {launches}, not once a "
                             f"plane ({d})")
    srcs, scol, srow, ok = seen[d // 2]
    seen.clear()
    px = srcs.numel()
    share = ok.float().mean().item()
    label = f"1x{k}x{h}x{w} (config4, plane {d // 2})"
    out = tile_warp.tile_warp_sample_batched(srcs, scol, srow, ok)
    ref = tile_warp.sample_bilinear_masked_plain(srcs, scol, srow, ok)
    torch.cuda.synchronize()
    if (out[~ok] != 0).any():
        raise AssertionError("K3c: invalid pixels are not exactly 0")
    err = (out - ref)[ok].abs().max().item() if share > 0 else 0.0
    del out, ref
    ms = _cuda_ms(torch, lambda: tile_warp.tile_warp_sample_batched(
        srcs, scol, srow, ok), 20)
    plain_ms = _cuda_ms(torch, lambda: tile_warp.sample_bilinear_masked_plain(
        srcs, scol, srow, ok), 5)
    grid = _grid(torch, scol, srow)
    lib_in = srcs.reshape(-1, 1, h, w)
    lib_ms = _cuda_ms(torch, lambda: _library_sample(
        torch, lib_in, grid, "bilinear"), 20)
    print(f"sample_bilinear_masked [{label}]: valid share {share:.4f}")
    # k3c_phase's bound and work
    res.add(tile_warp.K3C, label, err, 1e-4, ms, plain_ms,
            work=_k3c_work(px, share), library_ms=lib_ms)
    print(f"phase config4: {time.perf_counter() - t_phase:.1f} s")


SHARD_CAMERAS = (1, 2)  # camera-axis shards of cuda:0 (sharding phase)
SHARD_WINDOWS = (1, 4)  # window-axis shards of cuda:0
SHARD_SWEEP_K = 8
SHARD_SCENE_SEEDS = (3, 4)  # the two scenes: frames and draws
# at once against one-after-another meshes: faces (relative), median and
# p90 of |r - R| / R. On the card the Poisson splat's index_put_ adds in
# no fixed order, so two runs of one scene differ in the last bits from
# iteration 2 on; the bounds are the port's two-iteration closeness bounds
# (tests/test_torch_pipeline.py::test_end_to_end_hybrid_two_iterations).
SHARD_SCENE_CLOSE = (0.1, 0.02, 0.05)


def _equal_outputs(torch, ours, ref, keys):
    return all(torch.equal(ours[k], ref[k]) for k in keys)


def tile_runs(torch, dev, args_np, kernels, render, k2_k4, twice):
    """The tile axis (sharding/tiles.py) on one card: the tile-sharded
    ``sharded_fused_update`` at 640x480, K=3, B=4 on ``[cuda:0] * 4`` as
    (camera, tile) = (2, 2) and (1, 4), and at 1080x1920, K=3, B=1 as (1,
    4), each call timed twice, bitwise against the unsharded update on the
    card (its ms beside); SETUP, BIN, K1, K2, K3 and K4 must launch. One
    card is one GPU: these times show the exchanges' cost, no speedup.
    Prints the MB the exchanges copied between bands a call and the runs'
    seconds; returns their figures."""
    from meshrecon_torch import problems, state
    from meshrecon_torch.pipeline.fused import fused_main_update_batched
    from meshrecon_torch.sharding import make_device_mesh, sharded_fused_update

    t0 = time.perf_counter()
    keys = ("point4", "normals", "pdf", "valid", "depth")
    big = list(problems.fused_problem(1, K, TILE_HD[0], TILE_HD[1],
                                      seed=SEED))
    big[0], big[1] = args_np[0], args_np[1]
    out_runs = {}
    for b, (h, w), meshes, inputs in (
            (B, (H, W), ((2, 2), (1, 4)), args_np),
            (1, TILE_HD, ((1, 4),), big)):
        args = state.from_numpy(inputs, dev)
        ref, ref_ms = twice(lambda *a: fused_main_update_batched(*a, h, w),
                            *args)
        print(f"tile axis: unsharded update B={b} K={K} {w}x{h}: ms {ref_ms}")
        for n_camera, n_tile in meshes:
            label = f"tile ({n_camera}, {n_tile}) B={b} K={K} {w}x{h}"
            step = sharded_fused_update(make_device_mesh(
                n_camera, n_tile, devices=[dev] * (n_camera * n_tile)), h, w)
            out, ms = twice(step, *args)
            _launched(kernels, (*render, *k2_k4), label)
            equal = _equal_outputs(torch, out, ref, keys)
            mb = sum(g.exchanged for g in step.tile_groups) / 2 / 1e6
            starts = step.tile_groups[0].starts
            print(f"{label} [{n_camera * n_tile} x {dev}, bands {starts}]: "
                  f"ms {ms} (unsharded {ref_ms}), exchanges {mb:.3f} MB a "
                  f"call, bitwise equal to the unsharded update: {equal}")
            out_runs[f"{n_camera}x{n_tile}_{w}x{h}_b{b}"] = dict(
                ms=ms, unsharded_ms=ref_ms, exchanged_mb=mb, bitwise=equal)
            if not equal:
                raise AssertionError(f"{label} differs from "
                                     "fused_main_update_batched")
        del ref, out, args
    out_runs["seconds"] = time.perf_counter() - t0
    print(f"tile axis runs: {out_runs['seconds']:.1f} s")
    return out_runs


def sharding_phase(torch, dev, args_np, render, k2_k4, k3c):
    """The sharded paths on one card (meshrecon_torch/sharding), each shard
    of a mesh that names cuda:0 more than once running in a thread of its own:
    ``sharded_fused_update`` at 640x480, K=3, B=4 on ``[cuda:0] * n`` (n in
    SHARD_CAMERAS) against ``fused_main_update_batched`` on the card, bit
    for bit (tests/test_torch_sharding.py: the camera shards run the plain
    code on independent items); ``sharded_multi_scene_fused`` at config 5's
    shape (C5: 8 scenes x 2 cameras, 240x320, K=2) on one and two shards
    against a per-scene loop, bit for bit, and its scene 0 against the
    plain versions on the CPU (``_witness_parity``);
    ``sharded_plane_sweep`` with 8 sides at 640x480 and 64 depths on
    ``[cuda:0] * n`` (n in SHARD_WINDOWS) against ``plane_sweep_depth`` at
    the CPU test's bounds (depth atol 1e-5; cost rtol 1e-5, atol 1e-4;
    valid equal); the tile axis (:func:`tile_runs`); each sharded call
    timed twice (the first starts its threads); koule-tr as two synthetic scenes (each the CLI's at its seed
    of SHARD_SCENE_SEEDS: its frames and camera draw; 640x480, -n 2,
    hybrid) through ``reconstruct_scenes`` with ``scene_devices=2`` (both
    scenes at once, a thread each, on the one device here) and 1 (one after
    another): each mesh within the default's sphere bound, each mesh of the
    first run close to the other run's (SHARD_SCENE_CLOSE; bitwise equality
    printed), both walls and stage splits printed (the first run's stage
    totals add the two threads' overlapping times); ``baseline_configs
    c5``; and the CLI's ``--mesh-devices 2`` refused with fewer GPUs. Every
    kernel of each path must launch. Prints one JSON line ``{"sharding":
    ...}``."""
    from meshrecon_torch import problems, state
    from meshrecon_torch.depth.plane_sweep import plane_sweep_depth
    from meshrecon_torch.io.obj import read_mesh
    from meshrecon_torch.kernels import all_kernels
    from meshrecon_torch.pipeline.config import (config_from_args,
                                                 configs_from_args)
    from meshrecon_torch.pipeline.fused import fused_main_update_batched
    from meshrecon_torch.pipeline.reconstruct import reconstruct_scenes
    from meshrecon_torch.sharding import (make_device_mesh, make_scene_mesh,
                                          make_window_mesh,
                                          sharded_fused_update,
                                          sharded_multi_scene_fused,
                                          sharded_plane_sweep)
    from meshrecon_torch.tools import baseline_configs
    from meshrecon_torch.utils.profiling import StageTimer

    t_phase = time.perf_counter()
    kernels = all_kernels()
    keys = ("point4", "normals", "pdf", "valid", "depth")
    summary = {}

    def twice(step, *call_args):
        """The output of two calls and each call's ms, the counters
        reset before the first."""
        _reset(kernels)
        ms = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(*call_args)
            torch.cuda.synchronize()
            ms.append(round((time.perf_counter() - t0) * 1e3, 3))
        return out, ms

    # the camera axis
    args = state.from_numpy(args_np, dev)
    ref = fused_main_update_batched(*args, H, W)
    for n in SHARD_CAMERAS:
        step = sharded_fused_update(make_device_mesh(n, 1, devices=[dev] * n),
                                    H, W)
        out, ms = twice(step, *args)
        _launched(kernels, (*render, *k2_k4), f"sharded_fused_update n={n}")
        equal = _equal_outputs(torch, out, ref, keys)
        print(f"sharded_fused_update [{n} x {dev}] B={B} K={K} {W}x{H}: "
              f"ms {ms}, bitwise equal to the unsharded update: {equal}")
        summary[f"fused_camera_{n}"] = dict(ms=ms, bitwise=equal)
        if not equal:
            raise AssertionError(f"sharded_fused_update n={n} differs from "
                                 "fused_main_update_batched")
    del ref, out
    summary["tile"] = tile_runs(torch, dev, args_np, kernels, render, k2_k4,
                                twice)

    # the scene axis at config 5's shape
    c5 = C5
    one = problems.fused_problem(c5["b"], c5["k"], c5["h"], c5["w"], seed=0)
    per_scene = [state.from_numpy(one, dev) for _ in range(c5["s"])]
    loop = [fused_main_update_batched(*a, c5["h"], c5["w"])
            for a in per_scene]
    stacked = [torch.stack(list(a)) for a in zip(*per_scene)]
    for n in (1, 2):
        step = sharded_multi_scene_fused(
            make_scene_mesh(n, 1, 1, devices=[dev] * n), c5["h"], c5["w"])
        _reset(kernels)
        out = step(*stacked)
        torch.cuda.synchronize()
        _launched(kernels, (*render, *k2_k4),
                  f"sharded_multi_scene_fused n={n}")
        equal = all(_equal_outputs(torch, {k: v[i] for k, v in out.items()},
                                   loop[i], keys) for i in range(c5["s"]))
        print(f"sharded_multi_scene_fused [{n} x {dev}] {c5['s']} scenes x "
              f"{c5['b']} cams {c5['w']}x{c5['h']} K={c5['k']}: bitwise "
              f"equal to a per-scene loop: {equal}")
        summary[f"multi_scene_{n}"] = dict(bitwise=equal)
        if not equal:
            raise AssertionError(f"sharded_multi_scene_fused n={n} differs "
                                 "from the per-scene loop")
    # scene 0 against the plain versions on the CPU (the loop above holds
    # the card against itself)
    scene0 = _check_update({k: v[0] for k, v in out.items()},
                           "sharded_multi_scene_fused scene 0")
    metrics = _witness_parity(scene0, one, c5["h"], c5["w"],
                              "sharded_multi_scene_fused scene 0")
    summary["multi_scene_cpu_parity"] = metrics
    del loop, stacked, per_scene, out

    # the window axis
    rng = np.random.default_rng(4)
    main = problems.make_camera(eye=(0, 0, 0), near=1.0, far=30.0)
    cams = np.stack([problems.make_camera(
        eye=(0.5 + 0.2 * j, 0.3 * (j % 3), 0), near=1.0, far=30.0)
        for j in range(SHARD_SWEEP_K)]).astype(np.float32)
    fm = rng.uniform(0, 255, size=(H, W)).astype(np.float32)
    fs = (fm[None] + rng.normal(scale=5.0, size=(SHARD_SWEEP_K, H, W))
          ).astype(np.float32)
    sweep_in = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in
                (fm, fs, main.astype(np.float32), cams,
                 np.ones(SHARD_SWEEP_K, bool))]
    ref, ms = twice(lambda *a: plane_sweep_depth(
        *a, -0.8, 0.6, num_depths=SWEEP_DEPTHS), *sweep_in)
    print(f"plane_sweep_depth K={SHARD_SWEEP_K} {W}x{H} {SWEEP_DEPTHS} "
          f"depths: ms {ms}")
    summary["sweep_unsharded_ms"] = ms
    for n in SHARD_WINDOWS:
        step = sharded_plane_sweep(make_window_mesh(n, devices=[dev] * n),
                                   num_depths=SWEEP_DEPTHS)
        out, ms = twice(step, *sweep_in, -0.8, 0.6)
        launches = _launched(kernels, k3c, f"sharded_plane_sweep n={n}")
        d_err = (out["depth"] - ref["depth"]).abs().max().item()
        c_excess = ((out["cost"] - ref["cost"]).abs()
                    - (1e-4 + 1e-5 * ref["cost"].abs())).max().item()
        valid_eq = torch.equal(out["valid"], ref["valid"])
        share = out["valid"].float().mean().item()
        print(f"sharded_plane_sweep [{n} x {dev}] K={SHARD_SWEEP_K} "
              f"{W}x{H} {SWEEP_DEPTHS} depths: ms {ms}, K3c launches "
              f"{launches[k3c[0].name]}, valid share {share:.4f}, depth "
              f"max err {d_err:.3e} (bound 1e-5), cost over its bound by "
              f"{c_excess:.3e} (<= 0), valid equal {valid_eq}")
        summary[f"sweep_window_{n}"] = dict(
            ms=ms, depth_err=d_err, cost_excess=c_excess, valid_equal=valid_eq)
        if not (d_err <= 1e-5 and c_excess <= 0 and valid_eq and share > 0.05):
            raise AssertionError(f"sharded_plane_sweep n={n} off the "
                                 "unsharded sweep")
    del ref, out, sweep_in

    # koule-tr as two scenes: at once and one after another
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    walls, meshes = {}, {}
    for scene_devices in (2, 1):
        name = f"sharding_sd{scene_devices}_scene{{}}.obj"
        configs = [config_from_args(
            [TRACK, "--synthetic", "sphere", "--seed", str(seed), "-o",
             str(OUT_DIR / name.format(i)), "--device", "cuda",
             "--scene-devices", str(scene_devices)])
            for i, seed in enumerate(SHARD_SCENE_SEEDS)]
        timer = StageTimer()
        _reset(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reconstruct_scenes(configs, scene_devices=configs[0].scene_devices,
                           timer=timer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        label = f"scenes scene_devices={scene_devices}"
        _launched(kernels, (*render, *k2_k4, *k3c), label)
        meshes[scene_devices] = [
            (read_mesh(str(OUT_DIR / name.format(i))),
             _check_sphere_mesh(OUT_DIR / name.format(i),
                                f"{label} scene {i} (seed {seed})",
                                E2E_BOUNDS["default"]))
            for i, seed in enumerate(SHARD_SCENE_SEEDS)]
        print(f"{label}: wall {wall:.2f} s; stages (card-synchronized wall "
              "seconds):")
        for line in timer.report().splitlines():
            print(f"  {line}")
        walls[scene_devices] = wall
        summary[f"scenes_{scene_devices}"] = dict(
            wall_s=wall, meshes=[m[1] for m in meshes[scene_devices]],
            stages={k: round(v, 3) for k, v in timer.times.items()})
    print(f"scenes: at-once wall {walls[2]:.2f} s against {walls[1]:.2f} s "
          f"one after another ({walls[2] / walls[1]:.3f})")
    faces_rel, med_abs, p90_abs = SHARD_SCENE_CLOSE
    for i, ((a, fa), (b, fb)) in enumerate(zip(meshes[2], meshes[1])):
        same = (np.array_equal(a.vertices, b.vertices)
                and np.array_equal(a.faces, b.faces))
        print(f"scenes scene {i}: at once against one after another: faces "
              f"{fa['faces']} / {fb['faces']}, median {fa['med']:.4f} / "
              f"{fb['med']:.4f}, p90 {fa['p90']:.4f} / {fb['p90']:.4f}; "
              f"bitwise equal {same}")
        summary[f"scenes_bitwise_{i}"] = same
        if not (abs(fa["faces"] - fb["faces"]) <= faces_rel * fb["faces"]
                and abs(fa["med"] - fb["med"]) <= med_abs
                and abs(fa["p90"] - fb["p90"]) <= p90_abs):
            raise AssertionError(f"scenes scene {i}: the at-once mesh is "
                                 "off the one made one after another")

    # baseline_configs c5, as a user runs it
    _reset(kernels)
    res_c5 = baseline_configs.main(["c5"])
    print(f"config5: {res_c5['ms']:.3f} ms a call, {res_c5['mpix']:.3f} "
          f"Mpix/s aggregate on {res_c5['n_dev']} device(s)")
    summary["config5"] = dict(ms=res_c5["ms"], mpix=res_c5["mpix"],
                              n_dev=res_c5["n_dev"])

    # --mesh-devices above the GPU count is refused before any work
    count = torch.cuda.device_count()
    if count < 2:
        try:
            configs_from_args([TRACK, "--synthetic", "sphere", "--device",
                               "cuda", "--mesh-devices", "2"])
        except ValueError as exc:
            refusal = str(exc)
        else:
            raise AssertionError("--mesh-devices 2 on one GPU was accepted")
        if refusal != f"need 2 devices, have {count}":
            raise AssertionError(f"--mesh-devices 2: {refusal!r}")
        print(f"--mesh-devices 2 on {count} GPU: ValueError {refusal!r}")
        summary["mesh_devices_2"] = refusal
    summary["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({"sharding": summary}))
    print(f"phase sharding: {summary['phase_s']:.1f} s")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Chip check of meshrecon_torch on one GPU.")
    parser.parse_args(argv)
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
    from meshrecon_torch.depth import plane_sweep, triangulate
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
    SETUP, BIN = binned.SETUP, binned.BIN  # K1's binning
    GN = (triangulate.GN_SOBEL, triangulate.GN_WALK, triangulate.GN_EXIT,
          triangulate.GN_FINISH)  # every flow update's triangulation
    SWEEP = (plane_sweep.SWEEP_PROJ, plane_sweep.SWEEP_COST,
             plane_sweep.SWEEP_BEST)  # every plane of the sweep, with K3c
    args_np = list(problems.fused_problem(B, K, H, W, seed=SEED))
    args_np[0], args_np[1] = state.pack_soup(problems.sphere_soup(64, 128))
    res = Results()
    kernel_phases(torch, dev, res, state.from_numpy(args_np, dev))
    binning_phase(torch, dev, res, state.from_numpy(args_np, dev))
    raster_launches = raster_phase(torch, dev, res,
                                   state.from_numpy(args_np, dev))
    roof, roof_launches = roofline_phase(torch, dev, res)
    breakdown_phase(torch, dev, roof["launch_graph_us"])
    k3b_phase(torch, dev, res, args_np)
    k6_phase(torch, dev, res)
    band_phase(torch, dev, res, state.from_numpy(args_np, dev))
    torch.cuda.synchronize()
    solver_launches = solver_check(torch, dev)

    render = (SETUP, BIN, K1)
    run_slice(torch, dev, args_np, "flow update", UPDATES,
              (*render, K2, K3, K4, *GN))
    for label, path, options in (
            ("flow update rewarp", (*render, K2, K3, K4, K3B, *GN),
             dict(variance="rewarp")),
            ("flow update farneback", (*render, K2, K3, K3B, *GN),
             dict(use_farneback=True)),
            ("flow update mg", (*render, K2, K3, *GN),
             dict(flow_solver="mg")),
            ("flow update shadow bilinear", (*render, K2, K3, K4, *GN),
             dict(shadow_sample="bilinear"))):
        run_slice(torch, dev, args_np, label, VARIANT_UPDATES, path,
                  **options)

    bench_phase(torch, (*render, K2, K3, K4, *GN))

    sweep_args = sweep_problem(torch, dev)
    k3c_phase(torch, dev, res, state.from_numpy(sweep_args, dev))
    run_sweep(torch, dev, sweep_args)
    captured, swept = {}, {}
    fused = meshrecon_torch.pipeline.fused
    with _wrap(fused, "triangulate_pixels_batched",
               _keep_largest(torch, captured)), _wrap(
                   fused, "plane_sweep_depth_batched",
                   _keep_largest_sweep(swept)):
        default = run_e2e(torch, dev, "default", [],
                          (*render, K2, K3, K3C, *SWEEP, K4, *GN))
    gn_phase(torch, dev, res, captured)
    del captured
    sweep_phase(torch, dev, res, swept)
    del swept
    rewarp = run_e2e(torch, dev, "rewarp", ["--variance-mode", "rewarp"],
                     (*render, K2, K3, K3C, *SWEEP, K4, K3B, *GN))
    run_e2e(torch, dev, "farneback", ["-f"],
            (*render, K2, K3, K3C, *SWEEP, K3B, *GN))
    video_phase(torch, dev, (*render, K2, K3, K3C, *SWEEP, K4))
    scenes_phase(torch, dev, (*render, K2, K3, K3B, K4))
    drivers_phase(torch, dev, (K3, K3B), render)
    quality_phase(torch, (*render, K2, K3, K4), (K3C, *SWEEP))
    meshing_phase(torch, dev)
    micro_phase(torch, (*render, K2, K3, K3B, K4))
    studies_phase(torch, (*render, K2, K3, K3C, *SWEEP, K4))
    config4_phase(torch, dev, res)
    sharding_phase(torch, dev, args_np, render, (K2, K3, K4),
                   (K3C, *SWEEP))

    # each kernel's launches on the path it serves
    path_launches = {k.name: default[k.name]
                     for k in (*render, K2, K3, K3C, *SWEEP, K4, *GN)}
    path_launches[K3B.name] = rewarp[K3B.name]
    path_launches[K6.name] = solver_launches[K6.name]
    for k in (binned.K5A, binned.K5B):
        path_launches[k.name] = raster_launches[k.name]
    for k in (roofline.R1, roofline.R2, roofline.R3, roofline.R4):
        path_launches[k.name] = roof_launches[k.name]
    print("launches: SETUP, BIN, K1, K2, K3, K3c, SWEEP_PROJ, SWEEP_COST, "
          "SWEEP_BEST, K4, GN_SOBEL, GN_WALK, GN_EXIT, GN_FINISH from the "
          "default reconstruction, "
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
