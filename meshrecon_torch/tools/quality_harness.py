"""Mesh-quality harness: ground-truth error metrics on synthetic scenes.

Port of tools/quality_harness.py. Runs the whole reconstruction on scenes
whose geometry is known analytically (the synthetic fixtures are
ray-traced from fitted primitives, meshrecon_torch/io/synthetic.py, so the
primitive IS the ground truth) and reports each configuration's surface
error on three geometries: koule-tr (sphere), koberec- (bounded plane) and
zatisi (a still life fitted by a sphere). The metric follows the fixture's
auto-resolved mode:

  sphere: | |v - center| - radius | / radius      (all vertices)
  plane:  | (v - pc) . n | / radius               (vertices within the
          rendered extent; outside is background, not surface)

Exits nonzero when a scene's default-config median exceeds its regression
bound, or the ``quality`` config's median or p90 its own (--tolerance
scales all bounds). The bound tables are the JAX package's.

    python -m meshrecon_torch.tools.quality_harness
        [--scenes koule-tr,koberec-,zatisi] [--scale 8]
        [--configs default,trim-ens2] [--tolerance 1.0] [--device cuda|cpu]

Runs on the card unless ``--device cpu`` is given (and raises without
CUDA). The meshes are written to ``quality_<scene>_<config>.obj`` under
``tempfile.gettempdir()``.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np

from meshrecon_torch.io.synthetic import fit_plane, fit_sphere
from meshrecon_torch.pipeline.config import resolve_device


def scene_truth(track):
    """(mode, params) for the fixture synthetic_frames(mode='auto') renders."""
    center, radius = fit_sphere(track.bundles)
    pc, pn, resid = fit_plane(track.bundles)
    if resid < 0.2 * radius:
        p3 = track.bundles[:, :3] / track.bundles[:, 3:4]
        extent = 1.3 * float(np.max(np.linalg.norm(p3 - pc, axis=1)))
        return "plane", (pc, pn, extent, radius)
    return "sphere", (center, radius)


def surface_error(mesh, mode, params):
    """(median, p90) relative surface error of mesh vertices vs the truth."""
    v3 = mesh.vertices[:, :3] / mesh.vertices[:, 3:4]
    if mode == "plane":
        pc, pn, extent, radius = params
        inside = np.linalg.norm(v3 - pc, axis=1) < extent
        if not inside.any():
            return float("inf"), float("inf")
        err = np.abs((v3[inside] - pc) @ pn) / radius
    else:
        center, radius = params
        err = np.abs(np.linalg.norm(v3 - center, axis=1) - radius) / radius
    return float(np.median(err)), float(np.percentile(err, 90))


# Copies of tools/quality_harness.py's tables, whose comments say where
# each configuration and bound comes from: the configurations, the
# default config's median bound at --scale 8, the ``quality`` config's
# (median, p90) bounds, and the per-scene config adjustments.
CONFIGS = {
    "default": {},
    "exact": {"sampling": "exact"},
    "plane-sweep": {"depth_mode": "plane-sweep", "sweep_depths": 48},
    "farneback": {"use_farneback": True},
    "n3": {"iteration_count": 3},
    "n2": {"iteration_count": 2},
    "smooth": {"poisson_sigma": 2.5},
    "grid96": {"poisson_grid": 96},
    "hybrid": {"depth_mode": "hybrid", "iteration_count": 2,
               "sweep_depths": 48},
    "hybrid-n3": {"depth_mode": "hybrid", "iteration_count": 3,
                  "sweep_depths": 48},
    "trim": {"depth_mode": "hybrid", "iteration_count": 2,
             "sweep_depths": 48, "poisson_trim": 2.0},
    "trim-sp2": {"depth_mode": "hybrid", "iteration_count": 2,
                 "sweep_depths": 48, "poisson_trim": 2.0,
                 "sweep_passes": 2},
    "trim-ens2": {"depth_mode": "hybrid", "iteration_count": 2,
                  "sweep_depths": 48, "poisson_trim": 2.0,
                  "ensemble_seeds": (3, 13)},
    "quality": {"depth_mode": "hybrid", "iteration_count": 2,
                "sweep_depths": 48, "poisson_trim": 2.0,
                "consensus_rounds": 3, "ensemble_seeds": (3, 13, 23)},
    "lv3w2": {"flow_levels": 3, "flow_warps": 2},
    "shbl": {"shadow_sample": "bilinear"},
    "taylor": {"variance_mode": "taylor"},
    "rewarp": {"variance_mode": "rewarp"},
    "quality-rewarp": {"depth_mode": "hybrid", "iteration_count": 2,
                       "sweep_depths": 48, "poisson_trim": 2.0,
                       "consensus_rounds": 3, "ensemble_seeds": (3, 13, 23),
                       "variance_mode": "rewarp"},
    "quality-taylor": {"depth_mode": "hybrid", "iteration_count": 2,
                       "sweep_depths": 48, "poisson_trim": 2.0,
                       "consensus_rounds": 3, "ensemble_seeds": (3, 13, 23),
                       "variance_mode": "taylor"},
}

SCENE_BOUNDS = {
    "koule-tr": 0.22,
    "koberec-": 0.12,
    "zatisi": 0.20,
}

QUALITY_BOUNDS = {
    "koule-tr": (0.097, 0.28),
    "koberec-": (0.020, 0.060),
    "zatisi": (0.13, 0.43),
}

SCENE_KW = {
    "koberec-": {"min_bundles": 4},
    "zatisi": {"min_bundles": 4},
}


def main(argv=None, timer=None):
    """Run the harness; returns the exit code. ``timer``: a StageTimer that
    every reconstruction fills (by default none is kept)."""
    ap = argparse.ArgumentParser(
        prog="python -m meshrecon_torch.tools.quality_harness")
    ap.add_argument("--scenes", default="koule-tr,koberec-,zatisi")
    ap.add_argument("--scene", default=None,
                    help="single scene YAML path (legacy form)")
    ap.add_argument("--scale", type=int, default=8)
    ap.add_argument("--configs", default="default")
    ap.add_argument("--tolerance", type=float, default=1.0,
                    help="multiplier on the per-scene regression bounds")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    from meshrecon_torch.io.synthetic import synthetic_frames
    from meshrecon_torch.io.tracks import load_tracks
    from meshrecon_torch.pipeline.config import Config
    from meshrecon_torch.pipeline.reconstruct import reconstruct

    scenes = ([args.scene.split("/")[-1].removesuffix(".yaml")]
              if args.scene else args.scenes.split(","))
    failed = []
    for scene in scenes:
        track = load_tracks(f"tracks/{scene}.yaml")
        w = track.width // args.scale
        h = track.height // args.scale
        frames = synthetic_frames(track, w, h, mode="auto", seed=0,
                                  device=device)
        mode, params = scene_truth(track)
        print(f"scene={scene} {w}x{h} mode={mode}", flush=True)
        print(f"{'config':<14}{'faces':>8}{'med_err/r':>11}{'p90_err/r':>11}"
              f"{'seconds':>9}", flush=True)
        for name in args.configs.split(","):
            # small-scale runs pin a coarse Poisson grid + single iteration
            # for CI speed; full/half-res runs use production defaults so
            # the numbers are comparable with seed_study rows
            kw = (dict(iteration_count=1, poisson_grid=64)
                  if args.scale >= 4 else {})
            kw.update(SCENE_KW.get(scene, {}))
            kw.update(CONFIGS[name])
            cfg = Config(track=track, frames=frames, device=str(device),
                         out_file_name=os.path.join(
                             tempfile.gettempdir(),
                             f"quality_{scene}_{name}.obj"),
                         seed=3, **kw)
            t0 = time.perf_counter()
            mesh = reconstruct(cfg, timer=timer)
            dt = time.perf_counter() - t0
            med, p90 = surface_error(mesh, mode, params)
            print(f"{name:<14}{len(mesh.faces):>8}{med:>11.4f}{p90:>11.4f}"
                  f"{dt:>9.1f}", flush=True)
            bound = SCENE_BOUNDS.get(scene, 0.3) * args.tolerance
            if name == "default" and med > bound:
                failed.append(f"{scene}: default med {med:.4f} > {bound}")
            if name == "quality":
                mb, pb = QUALITY_BOUNDS.get(scene, (0.3, 0.6))
                mb *= args.tolerance
                pb *= args.tolerance
                if med > mb:
                    failed.append(
                        f"{scene}: quality med {med:.4f} > {mb:.4f}")
                if p90 > pb:
                    failed.append(
                        f"{scene}: quality p90 {p90:.4f} > {pb:.4f}")
    for f in failed:
        print(f"FAIL {f}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
