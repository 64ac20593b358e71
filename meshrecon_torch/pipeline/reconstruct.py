"""The outer refinement loop, the functional equivalent of recon.cpp:12-141.

Port of meshrecon/pipeline/reconstruct.py for one scene on one device.
Per iteration: tessellate -> load the mesh -> choose camera bundles -> for
every main camera render its depth, reproject the side frames, estimate
dense depth (plane sweep on the hybrid default's first iteration, flow +
Gauss-Newton after), estimate normals -> accumulate points -> filter. The
dense stages run in batches of B=4 main cameras with side counts padded to
a bucket (4 or 8), as in the reference package; the JAX package's compile
workarounds (prewarming, cached jitted steps) have no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

from meshrecon_torch.geometry.camera import np_extract_camera_center
from meshrecon_torch.io.obj import Mesh, save_mesh
from meshrecon_torch.meshing.decimate import decimate_vertex_clustering
from meshrecon_torch.pipeline.checkpoint import (load_checkpoint,
                                                 save_checkpoint)
from meshrecon_torch.pipeline.fused import FusedMainUpdate, FusedSweepUpdate
from meshrecon_torch.pipeline.heuristic import Heuristic
from meshrecon_torch.points.filter import filter_points
from meshrecon_torch.raster.rasterizer import Renderer
from meshrecon_torch.utils.profiling import StageTimer

# main cameras per dense update (the reference package's single-chip batch)
BATCH = 4


def _bucket(k: int) -> int:
    b = 1
    while b < k:
        b *= 2
    return b


def _k_bucket(config, klen: int) -> int:
    """Side-count bucket: floor 4, capped at ``config.max_sides`` (default
    8; 0 = uncapped), so bundles pad to K in {4, 8}."""
    cap = int(config.max_sides)
    if cap > 0:
        klen = min(klen, cap)
    lo = min(4, cap) if cap > 0 else 4
    return _bucket(max(klen, lo))


def _effective_depth_mode(config, iteration: int) -> str:
    """The dense-depth estimator of an iteration: "hybrid" runs the plane
    sweep on the first iteration (the alpha-shape mesh is too crude for
    flow against its reprojection) and flow refinement after."""
    mode = config.depth_mode
    if mode == "hybrid":
        return "plane-sweep" if iteration <= 1 else "flow"
    return mode


def main_update(config) -> FusedMainUpdate:
    """The flow update with the configuration's flow knobs (0 = default)."""
    return FusedMainUpdate(
        config.height, config.width, levels=config.flow_levels or 2,
        warps=config.flow_warps or 1, iters=config.flow_iters or None,
        sampling=config.sampling, flow_solver=config.flow_solver,
        fine_warps=config.flow_fine_warps or 1,
        use_farneback=config.use_farneback, variance=config.variance_mode,
        variance_taps=config.variance_taps,
        shadow_sample=config.shadow_sample)


def sweep_update(config) -> FusedSweepUpdate:
    return FusedSweepUpdate(config.height, config.width,
                            num_depths=config.sweep_depths,
                            passes=config.sweep_passes,
                            shadow_sample=config.shadow_sample)


def _centers3(config, fa: int, sides) -> np.ndarray:
    """Cartesian centers of the main camera and its sides, (1 + K, 3)."""
    centers = [np_extract_camera_center(config.camera(fa))] + [
        np_extract_camera_center(config.camera(fb)) for fb in sides]
    return np.stack([c[:3] / c[3] for c in centers]).astype(np.float32)


def _batch_inputs(config, renderer, group, kb: int, cb: int):
    """The ten update inputs for a group of (main, sides) bundles, sides
    padded to ``kb`` (identity cameras, zero frames, invalid) and centers
    to ``cb``; tensors on the configuration's device."""
    dev = torch.device(config.device)
    h, w = config.height, config.width
    b = len(group)
    mains = np.zeros((b, 4, 4), np.float32)
    scs = np.tile(np.eye(4, dtype=np.float32), (b, kb, 1, 1))
    svs = np.zeros((b, kb), bool)
    ctrs = np.zeros((b, cb, 3), np.float32)
    cvs = np.zeros((b, cb), bool)
    ks = np.zeros(b, np.int32)
    fms = torch.stack([config.frame(fa) for fa, _ in group]).to(dev)
    sfs = torch.zeros((b, kb, h, w), dtype=torch.float32, device=dev)
    for i, (fa, sides) in enumerate(group):
        mains[i] = config.camera(fa)
        for j, fb in enumerate(sides):
            scs[i, j] = config.camera(fb)
            sfs[i, j] = config.frame(fb)
            svs[i, j] = True
        c3 = _centers3(config, fa, sides)
        ctrs[i, : len(c3)] = c3
        cvs[i, : len(c3)] = True
        ks[i] = len(sides)
    host = [torch.from_numpy(a).to(dev) for a in (mains, scs, svs, ctrs, cvs,
                                                  ks)]
    mains_t, scs_t, svs_t, ctrs_t, cvs_t, ks_t = host
    return (renderer.soup, renderer.soup_valid, mains_t, fms, scs_t, sfs,
            svs_t, ctrs_t, cvs_t, ks_t)


def _update(config, mode: str):
    """The dense update of a depth mode and its StageTimer stage."""
    if mode == "plane-sweep":
        return sweep_update(config), "fused_sweep_update"
    return main_update(config), "fused_main_update"


def _results(out, real: int):
    """(points4 (n, 4), normals (n, 3), n) of the first ``real`` batch
    items' valid pixels, numpy float32."""
    valid = out["valid"].cpu().numpy()
    p4 = out["point4"].cpu().numpy()
    nrm = out["normals"].cpu().numpy()
    return [(p4[b][valid[b]].astype(np.float32),
             nrm[b][valid[b]].astype(np.float32), int(valid[b].sum()))
            for b in range(real)]


def _process_bundles_batched(config, renderer, bundles, timer,
                             mode: str = "flow"):
    """Dense updates for all bundles, ``BATCH`` main cameras per call.

    mode: "flow" (the flow update) or "plane-sweep" (the sweep update). Side
    lists pad to one K bucket; the last batch pads by repeating its last
    bundle, and the padding entries' outputs are dropped. Returns one
    (points4 (n, 4), normals (n, 3), n) per bundle, numpy float32.
    """
    update, stage = _update(config, mode)
    npix = config.height * config.width
    kb = _k_bucket(config, max(len(s) for _, s in bundles))
    cb = _bucket(kb + 1)
    results = []
    for start in range(0, len(bundles), BATCH):
        group = list(bundles[start:start + BATCH])
        real = len(group)
        group += [group[-1]] * (BATCH - real)
        with timer.stage(stage, npix * BATCH) as done:
            out = done(update(*_batch_inputs(config, renderer, group, kb,
                                             cb)))
        results += _results(out, real)
    return results


def _process_main_fused(config, renderer, fa: int, sides, timer,
                        mode: str = "flow"):
    """One main camera through the flow or the sweep update (B=1)."""
    npix = config.height * config.width
    k = len(sides)
    if k == 0:
        return np.zeros((0, 4), np.float32), np.zeros((0, 3), np.float32), 0
    update, stage = _update(config, mode)
    kb = _k_bucket(config, k)
    with timer.stage(stage, npix * k) as done:
        out = done(update(*_batch_inputs(config, renderer, [(fa, sides)], kb,
                                         _bucket(k + 1))))
    return _results(out, 1)[0]


def process_main_camera(config, renderer, fa: int, sides: list[int],
                        timer=None, depth_mode: str | None = None):
    """Dense update for one main camera: (points4, normals, count).

    "flow" (and an unresolved "hybrid") takes the flow update,
    "plane-sweep" the sweep update, each on a batch of one.
    """
    timer = timer or StageTimer(enabled=False)
    mode = depth_mode or config.depth_mode
    if mode == "hybrid":  # unresolved (direct caller): refinement semantics
        mode = "flow"
    return _process_main_fused(config, renderer, fa, sides, timer, mode)


def reconstruct(config, timer=None) -> Mesh:
    """Full video -> mesh reconstruction (the main() flow of recon.cpp).

    ``timer``: a StageTimer to fill (by default one that is enabled at
    verbosity >= 2)."""
    timer = timer or StageTimer(enabled=config.verbosity >= 2)
    points, normals, hint = _refine_cloud(config, timer)
    config.log(1, "Calculating final mesh...")
    with timer.stage("final_mesh"):
        mesh = hint.tessellate(points, normals, final=True)
    config.log(2, f" {len(mesh.faces)} faces")
    save_mesh(mesh, config.out_file_name)
    config.log(2, " Saved, done.")
    return mesh


def _refine_cloud(config, timer):
    """The iterative dense-refinement loop (recon.cpp:12-139) up to, not
    including, the final meshing; returns (points, normals, hint)."""
    hint = Heuristic(config)
    renderer = Renderer(config.width, config.height, device=config.device)

    points = np.asarray(config.reconstructed_points(), np.float32)
    normals = np.zeros((len(points), 3), np.float32)
    config.log(2, f" Loaded {len(points)} points")

    if config.resume and config.checkpoint_dir:
        state = load_checkpoint(config.checkpoint_dir)
        if state is not None:
            points, normals, hint.alpha_vals, hint.iteration, rng_state = state
            hint.rng.bit_generator.state = rng_state
            config.log(1, f"Resumed at iteration {hint.iteration}")

    while hint.not_happy(points):
        config.log(1, "Meshing...")
        with timer.stage("tessellate"):
            mesh = hint.tessellate(points, normals)
        config.log(2, f" {len(mesh.faces)} faces.")

        # the renderer and camera policy use a decimated proxy of a huge
        # mesh; the saved output mesh stays full resolution
        render_mesh = mesh
        cap = config.max_render_faces
        if cap and len(mesh.faces) > cap:
            render_mesh = decimate_vertex_clustering(mesh, cap)
            config.log(2, f" render proxy decimated to "
                          f"{len(render_mesh.faces)} faces")
        renderer.load_mesh(render_mesh)

        config.log(1, "Choosing cameras...")
        with timer.stage("choose_cameras"):
            count = hint.choose_cameras(render_mesh, config.cameras, renderer)
        if count == 0:
            # the reference exits here unconditionally (recon.cpp:47-50);
            # fail only when no dense update ever succeeded
            if hint.iteration <= 1:
                raise RuntimeError(
                    "Heuristic has chosen no cameras, which is an error.")
            config.log(1, "Heuristic chose no cameras; finishing with the "
                          "current point cloud.")
            break
        if config.verbosity >= 2:
            for fa, sides in hint.camera_bundles():
                print(f"  main camera {fa}, side cameras "
                      + ", ".join(map(str, sides)) + ",")

        config.log(1, "Tracking the whole clip...")
        new_pts, new_nrm = [points], [normals]
        bundles = hint.camera_bundles()
        depth_mode = _effective_depth_mode(config, hint.iteration)
        if len(bundles) > 1:
            results = _process_bundles_batched(config, renderer, bundles,
                                               timer, mode=depth_mode)
        else:
            results = [process_main_camera(config, renderer, fa, sides,
                                           timer=timer,
                                           depth_mode=depth_mode)
                       for fa, sides in bundles]
        for (fa, _), (pts, nrm, _) in zip(bundles, results):
            new_pts.append(pts)
            new_nrm.append(nrm)
            config.log(2, f" After processing main frame {fa}: "
                          f"{sum(len(p) for p in new_pts)} points")
        points = np.concatenate(new_pts)
        normals = np.concatenate(new_nrm)

        with timer.stage("filter_points"):
            points, normals, _ = filter_points(
                points, normals, hint.filter_radius_sq(), device=config.device)
        config.log(2, f" {len(points)} filtered points")
        if timer.enabled:
            config.log(2, timer.report())

        if config.checkpoint_dir:
            save_checkpoint(config.checkpoint_dir, points, normals,
                            hint.alpha_vals, hint.iteration,
                            hint.rng.bit_generator.state)

    return points, normals, hint
