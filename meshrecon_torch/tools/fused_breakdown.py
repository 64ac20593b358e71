"""Cumulative-stage split of the flow update on the card.

Port of tools/fused_breakdown.py:

    python -m meshrecon_torch.tools.fused_breakdown [H W K reps B solver]
        [--device cuda|cpu] [--cost-only] [--launch-us US]

Defaults 480 640 3 10 1 cheb. It times the prefixes ``depth0, scan, flow,
rewarp, var, tri, all`` of the flow update (:func:`run_prefix`), composed of
the public functions that ``pipeline/fused.fused_main_update_batched``
calls, in its order and with its defaults (2 pyramid levels, 1 warp a
level, taylor variance), on ``problems.fused_problem(B, K, H, W, seed=0)``.
The ``all`` prefix is that function's output bit for bit.

Per stage it prints the cumulative and marginal ms (CUDA events over
``reps`` calls after a warm-up, best of 3 passes that take the prefixes in
turn); the marginal count of device events (kernels, copies, memsets) and
device-busy ms, from one ``torch.profiler`` pass over one call of each
prefix after all the timings (``utils/profiling.device_busy``); the
marginal minimal HBM MB (:func:`stage_work`: each tensor the stage reads
from the inputs or from earlier stages counted once, each tensor it hands
on once); the marginal float32 operations where a ported kernel carries
the stage (K1, K2, K3, K4; "-" elsewhere: PyTorch has no cost model); and
the stage's bound, ``max(bytes / 3.35 TB/s, operations / 67 TFLOP/s)``
and, with ``--launch-us``, ``device events x US`` (the roofline tool's
measured launch floor), with the measured time over it.

Under the taylor variance the re-warp is the solver's last linearization:
the ``flow`` prefix solves without it, and the ``rewarp`` stage adds only
its first-order residual, a few elementwise ops and no gather.

``--cost-only`` prints the bytes, the operations and the hand-written
kernels' launches of each stage from one untimed call of each prefix. The
JAX tool's input perturbation (against XLA's loop-invariant hoisting) and
its measured dispatch floor (a remote TPU's) are not carried over. With
``--device cpu`` every wrapper takes its plain version, the times are one
call on the host clock and nothing of the device is measured; without it a
missing CUDA device raises.
"""

from __future__ import annotations

import argparse
import json
import re
import tempfile
import time

import torch

from meshrecon_torch import BACKGROUND_DEPTH, problems, state
from meshrecon_torch.depth.normals import estimate_normals_batched
from meshrecon_torch.depth.triangulate import triangulate_pixels_batched
from meshrecon_torch.flow.pyramid import compare
from meshrecon_torch.flow.variational import variational_flow
from meshrecon_torch.kernels._build import BUILD_DIR, all_kernels
from meshrecon_torch.pipeline.config import resolve_device
from meshrecon_torch.raster.binned import render_depth_binned
from meshrecon_torch.raster.fragment import (mix_background,
                                             projected_image_batched)
from meshrecon_torch.tools.roofline import bound
from meshrecon_torch.utils.profiling import best_ms, device_busy, device_line

STAGES = ("depth0", "scan", "flow", "rewarp", "var", "tri", "all")
LEVELS = 2  # the update's default pyramid

# float32 operations of the ported kernels (chip_smoke.py's counts): K2 a
# pixel (bilinear weights and taps, the nearest pick), K3 a pixel (the
# bilinear warp), K4 a pixel (22 for the linearization, 33 a sweep)
K2_OPS = 24
K3_OPS = 22
K4_LIN_OPS = 22
K4_SWEEP_OPS = 33
# the binning's setup (SETUP) a (camera, triangle): the clip transform
# (72), three near-plane intersections (45), and two records of the divide,
# area, edge coefficients and float64 corners and pads (~120 each)
SETUP_OPS = 360


def raster_ops(ncam: int, ntri: int, covered: float, h: int, w: int):
    """K1's operations for ``ncam`` renders of ``ntri`` valid triangles:
    each vertex projected by each camera (4x4 x 4: 28) and, at least, one
    fragment a covered pixel (3 edge functions + the depth plane, 4
    each)."""
    return ncam * ntri * 3 * 28 + covered * ncam * h * w * 16


def run_prefix(upto: str, inputs, height: int, width: int,
               solver: str = "cheb") -> dict:
    """The flow update's stages up to and including ``upto`` (one of
    STAGES) on the ten update inputs, as ``fused_main_update_batched``
    runs them at its defaults; returns what the prefix hands on."""
    if upto not in STAGES:
        raise ValueError(f"stage must be one of {STAGES}: {upto!r}")
    (soup, soup_valid, cam_mains, frames_main, side_cams, side_frames,
     side_valid, centers, centers_valid, n_side) = inputs
    frames_main = frames_main.to(torch.float32)
    side_cams = side_cams.to(torch.float32)
    side_frames = side_frames.to(torch.float32)
    cam_mains = cam_mains.to(torch.float32)
    side_valid = side_valid.to(torch.bool)
    b, k = side_frames.shape[:2]

    all_cams = torch.cat([cam_mains[:, None], side_cams], dim=1)
    all_depths = render_depth_binned(
        all_cams.reshape(b * (k + 1), 4, 4), soup, soup_valid, height, width
    ).reshape(b, k + 1, height, width)
    if upto == "depth0":
        return {"all_depths": all_depths}
    depth0 = all_depths[:, 0]

    intens, masks = projected_image_batched(cam_mains, depth0, side_frames,
                                            side_cams, all_depths[:, 1:])
    depth = depth0
    mixed_list = []
    for i in range(k):
        mixed, new_depth = mix_background(intens[:, i], masks[:, i],
                                          frames_main, depth)
        depth = torch.where(side_valid[:, i, None, None], new_depth, depth)
        mixed_list.append(mixed)
    depth_final = depth
    mixed_all = torch.stack(mixed_list, dim=1)
    if upto == "scan":
        return {"depth": depth_final, "mixed": mixed_all}

    flows2 = variational_flow(frames_main[:, None], mixed_all, levels=LEVELS,
                              warps=1, solver=solver,
                              want_residual=upto != "flow")
    if upto == "flow":
        return {"depth": depth_final, "flows": flows2}
    flows2, rewarped = flows2
    if upto == "rewarp":
        return {"depth": depth_final, "flows": flows2, "rewarped": rewarped}

    var = compare(frames_main[:, None], rewarped)
    if upto == "var":
        return {"depth": depth_final, "flows": flows2, "var": var}

    out = triangulate_pixels_batched(flows2[..., 0], flows2[..., 1], var,
                                     cam_mains, side_cams, side_valid,
                                     depth_final, sampling="taylor")
    if upto == "tri":
        return dict(out, depth=depth_final)
    normals = estimate_normals_batched(out["point4"], out["valid"],
                                       out["pdf"], centers, centers_valid,
                                       n_side)
    return {"point4": out["point4"], "normals": normals, "pdf": out["pdf"],
            "valid": out["valid"], "depth": depth_final,
            "gn_sweeps": out["gn_sweeps"]}


def stage_work(inputs, height: int, width: int, covered: float,
               solver: str = "cheb") -> dict:
    """Per stage, (minimal HBM bytes, float32 operations of the ported
    kernels or None) of its marginal work. Bytes: each tensor the stage
    reads from the inputs or earlier stages once, each it hands on once
    (the flow stage hands the rewarp its last warped image and
    linearization point). ``covered``: the share of rendered pixels the
    soup covers."""
    soup, soup_valid, _, _, _, _, _, centers = inputs[:8]
    b, k = inputs[5].shape[:2]
    n, ncam, px = b * k, b * (k + 1), height * width
    plane = px * 4
    mat = 64
    ntri = int(soup_valid.sum().item())
    work = {
        "depth0": (ncam * mat + soup.numel() * 4 + soup_valid.numel()
                   + ncam * plane, raster_ops(ncam, ntri, covered, height,
                                              width)),
        # cameras, depth0, side depths, side frames, main frames, side
        # validity in; final depth, mixed frames out
        "scan": (ncam * mat + (2 * b + 2 * n) * plane + n
                 + (b + n) * plane, K2_OPS * n * px),
        # main and mixed frames in; flow, warped image and linearization
        # point out
        "flow": ((b + n) * plane + 5 * n * plane, None),
        # main frames, warped image, flow, linearization point in;
        # re-warped image out
        "rewarp": ((b + 6 * n) * plane, None),
        # main frames, re-warped image in; variance out
        "var": ((b + 2 * n) * plane, None),
        # flow, variance, cameras, side validity, depth in; point4, pdf,
        # valid out
        "tri": (3 * n * plane + ncam * mat + n + b * plane
                + 5 * b * plane + b * px, None),
        # point4, valid, pdf, centers in; normals out
        "all": (5 * b * plane + b * px + centers.numel() * 4
                + inputs[8].numel() + b * 4 + 3 * b * plane, None),
    }
    if solver in ("cheb", "jacobi"):
        sweeps = 14 if solver == "cheb" else 60
        h, w, ops = height, width, 0
        for _ in range(LEVELS):
            ops += n * h * w * (K3_OPS + K4_LIN_OPS + sweeps * K4_SWEEP_OPS)
            if min(h, w) <= 12:
                break
            h, w = (h + 1) // 2, (w + 1) // 2
        work["flow"] = (work["flow"][0], ops)
    return work


def _device_events(fn, device):
    """(device events, device-busy ms) of one call of ``fn``, from a
    torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(device)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        path = f"{tmp}/trace.json"
        prof.export_chrome_trace(path)
        with open(path) as f:
            busy_s, events = device_busy(json.load(f))
    return events, busy_s * 1e3


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m meshrecon_torch.tools.fused_breakdown",
        description="Time the flow update's cumulative stage prefixes.")
    p.add_argument("H", type=int, nargs="?", default=480)
    p.add_argument("W", type=int, nargs="?", default=640)
    p.add_argument("K", type=int, nargs="?", default=3)
    p.add_argument("reps", type=int, nargs="?", default=10)
    p.add_argument("B", type=int, nargs="?", default=1)
    p.add_argument("solver", nargs="?", default="cheb",
                   choices=("cheb", "jacobi", "mg"))
    p.add_argument("--device", default="cuda")
    p.add_argument("--cost-only", action="store_true",
                   help="print bytes, operations and kernel launches "
                        "without timing")
    p.add_argument("--launch-us", type=float, default=None,
                   help="a launch's device floor in us (the roofline "
                        "tool's graph figure): adds launches x US to the "
                        "bound")
    return p


def _fmt(v, spec):
    """``v`` formatted by ``spec``, or "-" at the width of ``spec``."""
    if v is not None:
        return format(v, spec)
    return format("-", ">" + re.match(r"\D*(\d*)", spec).group(1))


def main(argv=None) -> dict:
    """Run the split; print one line a stage and return ``stages`` (one
    dict a stage) and ``all`` (the last output of the whole update)."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    h, w = args.H, args.W
    print(f"{device_line(device)}; {h}x{w} K={args.K} B={args.B} "
          f"reps={args.reps} solver={args.solver} levels={LEVELS}",
          flush=True)
    inputs = state.from_numpy(
        problems.fused_problem(args.B, args.K, h, w, seed=0), device)

    def prefix(name):
        return lambda: run_prefix(name, inputs, h, w, args.solver)

    depth = run_prefix("depth0", inputs, h, w)["all_depths"]
    covered = (depth < BACKGROUND_DEPTH).float().mean().item()
    work = stage_work(inputs, h, w, covered, args.solver)

    if args.cost_only:
        print(f"{'stage':<7} {'MB':>9} {'Gop':>8}  hand-written kernel "
              "launches", flush=True)
        prev = {}
        rows = []
        for name in STAGES:
            for kern in all_kernels():
                kern.launches = 0
            prefix(name)()
            launches = {kern.name: kern.launches for kern in all_kernels()}
            delta = {key: n - prev.get(key, 0) for key, n in launches.items()
                     if n - prev.get(key, 0)}
            prev = launches
            nbytes, ops = work[name]
            rows.append(dict(stage=name, bytes=nbytes, ops=ops,
                             launches=delta))
            text = (", ".join(f"{key} {n}" for key, n in delta.items())
                    or ("none" if on_card else "none (plain versions)"))
            print(f"{name:<7} {nbytes / 1e6:>9.1f} "
                  f"{_fmt(ops and ops / 1e9, '>8.3f')}  {text}", flush=True)
        return {"stages": rows, "all": None}

    print(f"{'stage':<7} {'ms':>9} {'+ms':>8} {'+events':>8} "
          f"{'+busy ms':>9} {'+MB':>8} {'+Gop':>7} {'bound ms':>9} "
          f"{'by':<10} {'x bound':>8}", flush=True)
    # every prefix timed first, then each profiled: no timing runs after a
    # profiler session. The three passes take the prefixes in turn, so that
    # a slow spell of the host falls on all of them alike.
    if on_card:
        times = dict.fromkeys(STAGES, float("inf"))
        for _ in range(3):
            for name in STAGES:
                times[name] = min(times[name], best_ms(
                    prefix(name), args.reps, device))
        traced = {name: _device_events(prefix(name), device)
                  for name in STAGES}
    else:
        times, traced = {}, {}
        for name in STAGES:
            t0 = time.perf_counter()
            prefix(name)()
            times[name] = (time.perf_counter() - t0) * 1e3
            traced[name] = (None, None)
    rows = []
    prev_ms, prev_events, prev_busy = 0.0, 0, 0.0
    for name in STAGES:
        ms = times[name]
        events, busy = traced[name]
        d_ms = ms - prev_ms
        d_events = None if events is None else events - prev_events
        d_busy = None if busy is None else busy - prev_busy
        nbytes, ops = work[name]
        bound_ms, by = bound(nbytes, ops or 0)
        if args.launch_us is not None and d_events is not None:
            t_launch = max(d_events, 0) * args.launch_us * 1e-3
            if t_launch > bound_ms:
                bound_ms, by = t_launch, "launches"
        off = d_ms / bound_ms if on_card else None
        rows.append(dict(stage=name, ms=ms, d_ms=d_ms, d_events=d_events,
                         d_busy_ms=d_busy, bytes=nbytes, ops=ops,
                         bound_ms=bound_ms, bound_by=by, x_bound=off))
        print(f"{name:<7} {ms:>9.3f} {d_ms:>+8.3f} "
              f"{_fmt(d_events, '>+8d')} {_fmt(d_busy, '>+9.3f')} "
              f"{nbytes / 1e6:>8.1f} {_fmt(ops and ops / 1e9, '>7.3f')} "
              f"{bound_ms:>9.4f} {by:<10} {_fmt(off, '>8.1f')}", flush=True)
        prev_ms, prev_events, prev_busy = ms, events or 0, busy or 0.0
    print("rewarp: under the taylor variance the re-warp is the solver's "
          "last linearization; the stage adds only its first-order "
          "residual (a few elementwise ops, no gather)", flush=True)
    if not on_card:
        print("cpu: plain versions, one call a prefix, host clock; no "
              "kernel ran and nothing of the device was measured",
              flush=True)
    return {"stages": rows, "all": prefix("all")()}


if __name__ == "__main__":
    main()
