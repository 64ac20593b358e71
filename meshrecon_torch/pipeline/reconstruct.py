"""The outer refinement loop, the functional equivalent of recon.cpp:12-141.

Port of meshrecon/pipeline/reconstruct.py on one device. Per iteration:
tessellate -> load the mesh -> choose camera bundles -> for every main
camera render its depth, reproject the side frames, estimate dense depth
(plane sweep on the hybrid default's first iteration, flow + Gauss-Newton
after), estimate normals -> accumulate points -> filter. The dense stages
run in batches of B=4 main cameras with side counts padded to a bucket (4
or 8), as in the reference package; at verbosity >= 3 (``-V``) each main
camera of a flow iteration takes the stage-by-stage path instead and dumps
its images. A seed ensemble refines the cloud once per seed and meshes the
union; several scenes run one after another. With ``mesh_devices`` > 1 a
flow iteration's batches hold one main camera per device
(``sharding.sharded_fused_update``). With ``scene_devices`` > 1 several
scenes, or an ensemble's seeds, run at once, each its own single-scene
run in a thread of its own on its home device, so that one scene's host
stages (the point filter above all) overlap the others' device work; the
JAX package runs them in lockstep instead (ROADMAP Queue C). The JAX
package's compile workarounds (prewarming, cached jitted steps) have no
counterpart here.
"""

from __future__ import annotations

import dataclasses
import os.path
import sys
import types

import numpy as np
import torch

from meshrecon_torch import BACKGROUND_DEPTH
from meshrecon_torch.depth.normals import estimate_normals
from meshrecon_torch.depth.triangulate import triangulate_pixels
from meshrecon_torch.flow.api import calculate_flow
from meshrecon_torch.flow.pyramid import compare
from meshrecon_torch.flow.tile_warp import tile_warp_flow_batched
from meshrecon_torch.geometry.camera import np_extract_camera_center
from meshrecon_torch.io.images import save_image
from meshrecon_torch.io.obj import Mesh, save_mesh
from meshrecon_torch.meshing.decimate import decimate_vertex_clustering
from meshrecon_torch.pipeline.checkpoint import (load_checkpoint,
                                                 save_checkpoint)
from meshrecon_torch.pipeline.fused import FusedMainUpdate, FusedSweepUpdate
from meshrecon_torch.pipeline.heuristic import Heuristic
from meshrecon_torch.points.filter import filter_points
from meshrecon_torch.raster.fragment import mix_background
from meshrecon_torch.raster.rasterizer import Renderer
from meshrecon_torch.sharding.meshes import (cuda_devices, make_device_mesh,
                                             parallel_shards,
                                             sharded_fused_update)
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


def _flow_knobs(config) -> dict:
    """The configuration's variational-flow knobs (0 = the pipeline
    default: 2 levels, 1 warp a level, the solver's default sweeps)."""
    return dict(levels=config.flow_levels or 2, warps=config.flow_warps or 1,
                iters=config.flow_iters or None,
                fine_warps=config.flow_fine_warps or 1)


def _update_options(config) -> dict:
    """The flow update's options of the configuration: its flow knobs,
    sampling, solver, Farneback, variance and shadow sampler."""
    return dict(**_flow_knobs(config), sampling=config.sampling,
                flow_solver=config.flow_solver,
                use_farneback=config.use_farneback,
                variance=config.variance_mode,
                variance_taps=config.variance_taps,
                shadow_sample=config.shadow_sample)


def main_update(config) -> FusedMainUpdate:
    """The flow update with the configuration's flow knobs."""
    return FusedMainUpdate(config.height, config.width,
                           **_update_options(config))


def _shard_devices(config, n: int) -> list:
    """``n`` devices for a sharded path: the configuration's CPU device
    repeated on a CPU run, else ``n`` distinct CUDA devices (too few
    raise ValueError)."""
    device = torch.device(config.device)
    if device.type == "cpu":
        return [device] * n
    return cuda_devices(n)


def _scene_homes(config, scene_devices: int, n: int) -> list:
    """The home device of each of ``n`` scenes: the scenes in contiguous
    parts over min(scene_devices, n, GPUs) devices (the CPU repeated on a
    CPU run), as the JAX package's scene axis takes them."""
    have = (scene_devices if torch.device(config.device).type == "cpu"
            else torch.cuda.device_count())
    n_dev = max(1, min(scene_devices, n, have))
    devices = _shard_devices(config, n_dev)
    return [devices[j] for j, part in enumerate(
        np.array_split(np.arange(n), n_dev)) for _ in part]


def _at_home(config, device):
    """``config`` with its device and its decoded frames on ``device``."""
    config.ensure_frames()
    return dataclasses.replace(config, device=str(device),
                               frames=config.frames.to(device))


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
    bundle, and the padding entries' outputs are dropped. A flow iteration
    with ``mesh_devices`` > 1 runs batches of one main camera per device
    through ``sharded_fused_update``. Returns one (points4 (n, 4), normals
    (n, 3), n) per bundle, numpy float32.
    """
    batch = BATCH
    if mode == "flow" and config.mesh_devices > 1:
        batch = config.mesh_devices
        mesh = make_device_mesh(batch, 1,
                                devices=_shard_devices(config, batch))
        update = sharded_fused_update(mesh, config.height, config.width,
                                      **_update_options(config))
        stage = "sharded_fused_update"
    else:
        update, stage = _update(config, mode)
    npix = config.height * config.width
    kb = _k_bucket(config, max(len(s) for _, s in bundles))
    cb = _bucket(kb + 1)
    results = []
    for start in range(0, len(bundles), batch):
        group = list(bundles[start:start + batch])
        real = len(group)
        group += [group[-1]] * (batch - real)
        with timer.stage(stage, npix * batch) as done:
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


def _process_main_unfused(config, renderer, fa: int, sides, timer):
    """One main camera of a flow iteration stage by stage (the -V path),
    its image dumps written to the working directory (recon.cpp:65-119):
    the main depth; per side the projection against the pristine depth,
    the background mix (which masks the depth progressively, as the
    reference mutates it, util.cpp:366-387) and calculate_flow with the
    flow update's knobs and solver; then the triangulation (exact
    sampling) and the normals."""
    npix = config.height * config.width
    cam_main = config.camera(fa)
    original = config.frame(fa).to(torch.float32)
    with timer.stage("render.depth", npix) as done:
        depth0 = done(renderer.depth(cam_main))
    depth = depth0
    save_image(original, f"frame{fa}.png")
    save_image(depth, f"depth-frame{fa}.png", normalize=True)

    flows, side_cams = [], []
    for fb in sides:
        with timer.stage("render.projected", npix) as done:
            inten, mask = renderer.projected(
                cam_main, config.frame(fb), config.camera(fb),
                depth_main=depth0, shadow_sample=config.shadow_sample)
            mixed, depth = mix_background(inten, mask, original, depth)
            done(mixed)
        with timer.stage("flow", npix) as done:
            flow = done(calculate_flow(original, mixed, config.use_farneback,
                                       solver=config.flow_solver,
                                       **_flow_knobs(config)))
        save_image(torch.where(depth == BACKGROUND_DEPTH, 0.0, mixed),
                   f"project-frame{fa}from{fb}.png")
        save_image(flow[..., :3], f"flow-frame{fa}from{fb}.png",
                   normalize=True)
        remapped = tile_warp_flow_batched(
            mixed[None], flow[None, ..., 0].contiguous(),
            flow[None, ..., 1].contiguous(), taps=4)[0]
        save_image(remapped, f"frame{fa}from{fb}-remapped.png")
        save_image(compare(original, remapped),
                   f"frame{fa}from{fb}-remap-error.png", normalize=True)
        flows.append(flow)
        side_cams.append(config.camera(fb))

    k = len(flows)
    if k == 0:
        return np.zeros((0, 4), np.float32), np.zeros((0, 3), np.float32), 0
    dev = torch.device(config.device)
    h, w = config.height, config.width
    kb = _k_bucket(config, k)
    flows_t = torch.zeros((kb, h, w, 4), dtype=torch.float32, device=dev)
    flows_t[:k] = torch.stack(flows)
    cams = np.tile(np.eye(4, dtype=np.float32), (kb, 1, 1))
    cams[:k] = np.stack(side_cams)
    side_valid = np.zeros(kb, bool)
    side_valid[:k] = True
    with timer.stage("triangulate", npix) as done:
        out = triangulate_pixels(
            flows_t, torch.as_tensor(cam_main, device=dev),
            torch.from_numpy(cams).to(dev), torch.from_numpy(side_valid).to(
                dev), depth)
        done(out["point4"])

    c3 = _centers3(config, fa, sides)
    cb = _bucket(len(c3))
    centers = np.zeros((cb, 3), np.float32)
    centers[: len(c3)] = c3
    cvalid = np.zeros(cb, bool)
    cvalid[: len(c3)] = True
    with timer.stage("normals", npix) as done:
        normals = done(estimate_normals(
            out["point4"], out["valid"], out["pdf"],
            torch.from_numpy(centers).to(dev),
            torch.from_numpy(cvalid).to(dev), k))
    valid = out["valid"].cpu().numpy()
    pts = out["point4"].cpu().numpy()[valid]
    nrm = normals.cpu().numpy()[valid]
    return pts.astype(np.float32), nrm.astype(np.float32), int(valid.sum())


def process_main_camera(config, renderer, fa: int, sides: list[int],
                        timer=None, depth_mode: str | None = None):
    """Dense update for one main camera: (points4, normals, count).

    "flow" (and an unresolved "hybrid") takes the flow update, or at
    verbosity >= 3 the stage-by-stage path with its dumps; "plane-sweep"
    the sweep update; each update on a batch of one.
    """
    timer = timer or StageTimer(enabled=False)
    mode = depth_mode or config.depth_mode
    if mode == "hybrid":  # unresolved (direct caller): refinement semantics
        mode = "flow"
    if mode == "flow" and config.verbosity >= 3:
        return _process_main_unfused(config, renderer, fa, sides, timer)
    return _process_main_fused(config, renderer, fa, sides, timer, mode)


def _seed_config(config, seed: int):
    """``config`` for one draw of an ensemble: ``seed``, no ensemble, and
    its own ``seed<s>`` checkpoint and profile subdirectories (a shared
    checkpoint would let --resume load another draw's state)."""
    ck = (os.path.join(config.checkpoint_dir, f"seed{seed}")
          if config.checkpoint_dir else None)
    pd = (os.path.join(config.profile_dir, f"seed{seed}")
          if config.profile_dir else None)
    return dataclasses.replace(config, seed=int(seed), ensemble_seeds=(),
                               checkpoint_dir=ck, profile_dir=pd)


def _points_obj(points, name: str) -> None:
    """A point cloud as an OBJ of vertices only (the -V dumps)."""
    save_mesh(Mesh(points, np.zeros((0, 3), np.int32)), name)


def _finish(config, hint, points, normals, timer) -> Mesh:
    config.log(1, "Calculating final mesh...")
    with timer.stage("final_mesh"):
        mesh = hint.tessellate(points, normals, final=True)
    config.log(2, f" {len(mesh.faces)} faces")
    save_mesh(mesh, config.out_file_name)
    config.log(2, " Saved, done.")
    return mesh


def reconstruct(config, timer=None) -> Mesh:
    """Full video -> mesh reconstruction (the main() flow of recon.cpp).

    ``timer``: a StageTimer to fill (by default one that is enabled at
    verbosity >= 2). Several ``ensemble_seeds`` run
    :func:`reconstruct_ensemble`; exactly one is the draw to use."""
    timer = timer or StageTimer(enabled=config.verbosity >= 2)
    seeds = tuple(config.ensemble_seeds)
    if len(seeds) > 1:
        return reconstruct_ensemble(config, timer=timer)
    if len(seeds) == 1:
        config = _seed_config(config, seeds[0])
    points, normals, hint = _refine_cloud(config, timer)
    if config.verbosity >= 3:
        _points_obj(points, "filteredpoints.obj")
    return _finish(config, hint, points, normals, timer)


def reconstruct_ensemble(config, timer=None) -> Mesh:
    """Refine the cloud under each seed of ``config.ensemble_seeds`` (one
    independent camera draw each), filter the union and mesh it once. The
    clip decodes once; the seeds' configurations share its tensor. With
    ``scene_devices`` > 1 (and no ``-V`` dumps) the seeds refine at once,
    each in a thread of its own on its home device (:func:`_scene_homes`)."""
    timer = timer or StageTimer(enabled=config.verbosity >= 2)
    config.ensure_frames()
    cfgs = [_seed_config(config, s) for s in config.ensemble_seeds]
    if config.scene_devices > 1 and config.verbosity < 3:
        homes = _scene_homes(config, config.scene_devices, len(cfgs))
        clouds = parallel_shards(lambda c: _refine_cloud(c, timer), homes,
                                 [(_at_home(c, d),)
                                  for c, d in zip(cfgs, homes)])
    else:
        clouds = [_refine_cloud(c, timer) for c in cfgs]
    pts_l, nrm_l, hints = zip(*clouds)
    hint = hints[0]
    with timer.stage("filter_points"):
        points, normals, _ = filter_points(
            np.concatenate(pts_l), np.concatenate(nrm_l),
            hint.filter_radius_sq(), device=config.device)
    config.log(2, f" ensemble union: {len(points)} filtered points from "
                  f"{len(hints)} seeds")
    if config.verbosity >= 3:
        _points_obj(points, "filteredpoints.obj")
    return _finish(config, hint, points, normals, timer)


def reconstruct_scenes(configs, scene_devices: int = 1, timer=None) -> list:
    """Reconstruct several scenes; returns the meshes in order.

    One after another by default: each lazy scene's frames leave the
    device when it is done, so the device holds one clip at a time. With
    ``scene_devices`` > 1 every scene's clip is resident and each scene
    runs its single-scene :func:`reconstruct` at once, in a thread of its
    own on its home device (:func:`_scene_homes`; one card holds them
    all), so that one scene's host stages overlap the others' device
    work. A scene's ensemble seeds run one after another in its thread.
    ``-V`` dumps name their files alike for every scene, so scenes that
    dump run one after another."""
    configs = list(configs)
    if (scene_devices <= 1 or len(configs) <= 1
            or any(c.verbosity >= 3 for c in configs)):
        meshes = []
        for cfg in configs:
            meshes.append(reconstruct(cfg, timer=timer))
            cfg.release_frames()
        return meshes
    homes = _scene_homes(configs[0], scene_devices, len(configs))
    scenes = [dataclasses.replace(_at_home(c, d), scene_devices=1)
              for c, d in zip(configs, homes)]
    meshes = parallel_shards(lambda c: reconstruct(c, timer=timer), homes,
                             [(c,) for c in scenes])
    for cfg in configs:
        cfg.release_frames()
    return meshes


def _refine_cloud(config, timer):
    """The iterative dense-refinement loop (recon.cpp:12-139) up to, not
    including, the final meshing; returns (points, normals, hint).

    ``hint.point_provenance`` holds a code per returned point:
    ``iteration * 1000 + main camera`` of the update that made it, -1 for
    the sparse bundles and for every point of a resumed checkpoint."""
    config.ensure_frames()
    hint = Heuristic(config)
    renderer = Renderer(config.width, config.height, device=config.device)

    points = np.asarray(config.reconstructed_points(), np.float32)
    normals = np.zeros((len(points), 3), np.float32)
    prov = np.full(len(points), -1, np.int32)
    config.log(2, f" Loaded {len(points)} points")

    if config.resume and config.checkpoint_dir:
        state = load_checkpoint(config.checkpoint_dir)
        if state is not None:
            points, normals, hint.alpha_vals, hint.iteration, rng_state = state
            hint.rng.bit_generator.state = rng_state
            prov = np.full(len(points), -1, np.int32)
            config.log(1, f"Resumed at iteration {hint.iteration}")

    while hint.not_happy(points):
        config.log(1, "Meshing...")
        with timer.stage("tessellate"):
            mesh = hint.tessellate(points, normals)
        config.log(2, f" {len(mesh.faces)} faces.")
        if config.verbosity >= 3:
            save_mesh(mesh, "recon_orig.obj")

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
        new_pts, new_nrm, new_prov = [points], [normals], [prov]
        bundles = hint.camera_bundles()
        depth_mode = _effective_depth_mode(config, hint.iteration)
        if len(bundles) > 1 and config.verbosity < 3:
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
            new_prov.append(np.full(len(pts), hint.iteration * 1000 + fa,
                                    np.int32))
            config.log(2, f" After processing main frame {fa}: "
                          f"{sum(len(p) for p in new_pts)} points")
        points = np.concatenate(new_pts)
        normals = np.concatenate(new_nrm)
        prov = np.concatenate(new_prov)

        if config.verbosity >= 3:
            _points_obj(points, "purepoints.obj")
        with timer.stage("filter_points"):
            points, normals, kept = filter_points(
                points, normals, hint.filter_radius_sq(), device=config.device)
        prov = prov[kept]
        config.log(2, f" {len(points)} filtered points")
        if timer.enabled:
            config.log(2, timer.report())

        if config.checkpoint_dir:
            save_checkpoint(config.checkpoint_dir, points, normals,
                            hint.alpha_vals, hint.iteration,
                            hint.rng.bit_generator.state)

    hint.point_provenance = prov
    return points, normals, hint


class _CallableModule(types.ModuleType):
    """This module, callable as :func:`reconstruct`. ``from
    meshrecon_torch.pipeline import reconstruct`` gives the module (the
    import system binds a loaded submodule to its package's attribute),
    where the JAX package's ``from meshrecon.pipeline import reconstruct``
    gives the function (meshrecon/pipeline/__init__.py): both are called as
    ``reconstruct(config)``, and the module's other names stay reachable.

    Why the module's class is swapped: the import system sets the package's
    attribute ``reconstruct`` to this module whenever the module loads,
    over any function bound there before. The JAX package rebinds the
    function after that by importing it in its ``__init__``; here that
    import would close a cycle (nearly every module imports
    ``pipeline.config``, whose package would then load this module and all
    that it imports, the importer among them, half-initialized). So the
    one object under that name must be both the module and the
    function."""

    def __call__(self, config, timer=None) -> Mesh:
        return reconstruct(config, timer)


sys.modules[__name__].__class__ = _CallableModule
