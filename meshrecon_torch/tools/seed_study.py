"""Camera-policy quality study: koule error across seeds x configs.

Port of tools/seed_study.py. Each row reconstructs koule-tr from synthetic
sphere frames (seed 0) at ``--scale``, ``-n 2`` hybrid, under one policy
seed and one configuration of ``CONFIGS`` (a copy of the JAX tool's
table), and prints the faces, the median and p90 of | |v - c| - R | / R
against the fitted sphere, and the wall seconds; then the worst seed's
median of each configuration. ``_ensemble_pair`` / ``_ensemble_triple``
configurations refine under the draws (s, s + 10[, s + 20]) and mesh their
union once.

    python -m meshrecon_torch.tools.seed_study [--scale 1] [--seeds 3,4,5]
        [--configs base,cov,covprune] [--device cuda|cpu]

Runs on the card unless ``--device cpu`` is given (and raises without
CUDA). The meshes are written to ``seed_<config>_<seed>.obj`` under
``tempfile.gettempdir()``.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np

from meshrecon_torch.pipeline.config import resolve_device

# a copy of tools/seed_study.py's table, where each configuration's
# comment says what it tests
CONFIGS = {
    "base": {"poisson_trim": 0.0},
    "cov": {"poisson_trim": 0.0, "camera_coverage": 0.9,
            "baseline_diversity": 3.0},
    "covprune": {"poisson_trim": 0.0, "camera_coverage": 0.9,
                 "baseline_diversity": 3.0, "confidence_prune": 0.25},
    "prune": {"poisson_trim": 0.0, "confidence_prune": 0.25},
    "sp2": {"poisson_trim": 0.0, "sweep_passes": 2},
    "sp2cov": {"poisson_trim": 0.0, "sweep_passes": 2,
               "camera_coverage": 0.9, "baseline_diversity": 3.0},
    "sp2prune": {"poisson_trim": 0.0, "sweep_passes": 2,
                 "confidence_prune": 0.25},
    "trim2": {"poisson_trim": 2.0},
    "trim2div": {"poisson_trim": 2.0, "baseline_diversity": 2.0},
    "trim2sp2": {"poisson_trim": 2.0, "sweep_passes": 2},
    "jac": {"poisson_trim": 0.0, "flow_solver": "jacobi"},
    "trim2jac": {"poisson_trim": 2.0, "flow_solver": "jacobi"},
    "rf16k": {"poisson_trim": 0.0, "max_render_faces": 16384},
    "trim2rf16k": {"poisson_trim": 2.0, "max_render_faces": 16384},
    "trim2ens2": {"poisson_trim": 2.0, "_ensemble_pair": True},
    "trim2mb8": {"poisson_trim": 2.0, "min_bundles": 8},
    "trim2mb12": {"poisson_trim": 2.0, "min_bundles": 12},
    "trim2divens2": {"poisson_trim": 2.0, "baseline_diversity": 2.0,
                     "_ensemble_pair": True},
    "trim2cons3": {"poisson_trim": 2.0, "consensus_rounds": 3},
    "trim2fw1": {"poisson_trim": 2.0, "flow_fine_warps": 1},
    "trim2it14": {"poisson_trim": 2.0, "flow_iters": 14},
    "trim2fw1it14": {"poisson_trim": 2.0, "flow_fine_warps": 1,
                     "flow_iters": 14},
    "trim2it12": {"poisson_trim": 2.0, "flow_iters": 12},
    "cons3g192": {"poisson_trim": 2.0, "consensus_rounds": 3,
                  "poisson_grid": 192},
    "trim2cons3ens2": {"poisson_trim": 2.0, "consensus_rounds": 3,
                       "_ensemble_pair": True},
    "trim2tay": {"poisson_trim": 2.0, "variance_mode": "taylor"},
    "trim2cons3tay": {"poisson_trim": 2.0, "consensus_rounds": 3,
                      "variance_mode": "taylor"},
    "trim2lv4": {"poisson_trim": 2.0, "flow_levels": 4},
    "trim2lv3": {"poisson_trim": 2.0, "flow_levels": 3},
    "trim2cons3ens3": {"poisson_trim": 2.0, "consensus_rounds": 3,
                       "_ensemble_triple": True},
    "trim2cons3ens2mb8": {"poisson_trim": 2.0, "consensus_rounds": 3,
                          "min_bundles": 8, "_ensemble_pair": True},
    "trim2vt2": {"poisson_trim": 2.0, "variance_taps": 2},
    "trim2shb": {"poisson_trim": 2.0, "shadow_sample": "bilinear"},
    "trim2cons3ens3lv3": {"poisson_trim": 2.0, "consensus_rounds": 3,
                          "flow_levels": 3, "_ensemble_triple": True},
    "trim2cons3ens3mb8": {"poisson_trim": 2.0, "consensus_rounds": 3,
                          "min_bundles": 8, "_ensemble_triple": True},
    "trim2lv2": {"poisson_trim": 2.0, "flow_levels": 2},
    "trim2lv2w1": {"poisson_trim": 2.0, "flow_levels": 2, "flow_warps": 1},
    "trim2lv3w2": {"poisson_trim": 2.0, "flow_levels": 3, "flow_warps": 2},
    "trim2shbl": {"poisson_trim": 2.0, "shadow_sample": "bilinear"},
    "trim2taylor": {"poisson_trim": 2.0, "variance_mode": "taylor"},
    "trim2rewarp": {"poisson_trim": 2.0, "variance_mode": "rewarp"},
    "trim2cons3ens3rw": {"poisson_trim": 2.0, "consensus_rounds": 3,
                         "_ensemble_triple": True,
                         "variance_mode": "rewarp"},
}


def main(argv=None, timer=None):
    """Run the study; returns 0. ``timer``: a StageTimer that every
    reconstruction fills (by default none is kept)."""
    ap = argparse.ArgumentParser(
        prog="python -m meshrecon_torch.tools.seed_study")
    ap.add_argument("--scale", type=int, default=1)
    ap.add_argument("--seeds", default="3,4,5")
    ap.add_argument("--configs", default="base,cov,covprune")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    from meshrecon_torch.io.synthetic import fit_sphere, synthetic_frames
    from meshrecon_torch.io.tracks import load_tracks
    from meshrecon_torch.pipeline.config import Config
    from meshrecon_torch.pipeline.reconstruct import reconstruct

    track = load_tracks("tracks/koule-tr.yaml")
    w = track.width // args.scale
    h = track.height // args.scale
    frames = synthetic_frames(track, w, h, mode="sphere", seed=0,
                              device=device)
    center, radius = fit_sphere(track.bundles)

    print(f"# koule {w}x{h}, n=2 hybrid, radius {radius:.3f}", flush=True)
    print(f"{'config':<10}{'seed':>5}{'faces':>9}{'med/r':>9}{'p90/r':>9}"
          f"{'wall s':>8}", flush=True)
    worst = {}
    for name in args.configs.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            overrides = dict(CONFIGS[name])
            if overrides.pop("_ensemble_pair", False):
                overrides["ensemble_seeds"] = (seed, seed + 10)
            if overrides.pop("_ensemble_triple", False):
                overrides["ensemble_seeds"] = (seed, seed + 10, seed + 20)
            cfg = Config(track=track, frames=frames, device=str(device),
                         seed=seed, iteration_count=2, depth_mode="hybrid",
                         verbosity=1,  # stage progress
                         out_file_name=os.path.join(
                             tempfile.gettempdir(),
                             f"seed_{name}_{seed}.obj"),
                         **overrides)
            t0 = time.perf_counter()
            mesh = reconstruct(cfg, timer=timer)
            dt = time.perf_counter() - t0
            v3 = mesh.vertices[:, :3] / mesh.vertices[:, 3:4]
            err = np.abs(np.linalg.norm(v3 - center, axis=1) - radius)
            med, p90 = np.median(err) / radius, np.percentile(err, 90) / radius
            worst[name] = max(worst.get(name, 0.0), med)
            print(f"{name:<10}{seed:>5}{len(mesh.faces):>9}{med:>9.4f}"
                  f"{p90:>9.4f}{dt:>8.1f}", flush=True)
    for name, m in worst.items():
        print(f"# worst-seed med {name}: {m:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
