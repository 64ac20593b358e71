"""End-to-end mesh quality against the flow solver's sweep count, koule.

Port of tools/flow_e2e_quality.py:

    python -m meshrecon_torch.tools.flow_e2e_quality [scale]
        [--device cuda|cpu]

Each variant reconstructs koule-tr from synthetic sphere frames (seed 0)
at 1/``scale`` resolution (default 1: 640x480), one flow iteration,
Poisson grid 96, policy seed 3, and prints the faces, the median and p90
of | |v - c| - R | / R against the fitted sphere, and the wall seconds, in
the JAX tool's format, after the device line (on the card the kernels are
built before the first run). The meshes are written to
``fq_<variant>.obj`` under ``tempfile.gettempdir()``.

Divergence by design: the JAX tool monkeypatches the fused update's flow
call with ``functools.partial(variational_flow, iters=N, warps=1)``, and
its run stops at ``R._vmapped_step.cache_clear()``: its ``R`` is the
``reconstruct`` function that ``meshrecon/pipeline/__init__.py``
re-exports, not the module. The fused call site passes ``warps=1`` itself,
so each variant changes the sweep count alone. Here each variant sets
``Config.flow_iters`` (0: the solver's default of 14 Chebyshev sweeps),
which the reconstruction routes to the update; the names stay the JAX
tool's. Runs on the card unless ``--device cpu`` is given (and raises
without CUDA).
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

from meshrecon_torch.tools import start
from meshrecon_torch.tools.quality_harness import surface_error

# variant -> Config.flow_iters (the JAX tool's names)
VARIANTS = {"base_i60_w2": 0, "i30_w1": 30, "i45_w1": 45}


def koule(scale: int, device):
    """(track, frames, center, radius): koule-tr's synthetic sphere frames
    (seed 0) at 1/``scale`` and its fitted sphere."""
    from meshrecon_torch.io.synthetic import fit_sphere, synthetic_frames
    from meshrecon_torch.io.tracks import load_tracks

    track = load_tracks("tracks/koule-tr.yaml")
    frames = synthetic_frames(track, track.width // scale,
                              track.height // scale, mode="sphere", seed=0,
                              device=device)
    return (track, frames, *fit_sphere(track.bundles))


def run_variant(name, track, frames, center, radius, device, timer=None):
    """One variant's reconstruction; prints and returns its row,
    dict(faces, med, p90, wall)."""
    from meshrecon_torch.pipeline.config import Config
    from meshrecon_torch.pipeline.reconstruct import reconstruct

    cfg = Config(track=track, frames=frames, device=str(device),
                 iteration_count=1, depth_mode="flow", poisson_grid=96,
                 out_file_name=os.path.join(tempfile.gettempdir(),
                                            f"fq_{name}.obj"),
                 seed=3, flow_iters=VARIANTS[name])
    t0 = time.perf_counter()
    mesh = reconstruct(cfg, timer=timer)
    dt = time.perf_counter() - t0
    med, p90 = surface_error(mesh, "sphere", (center, radius))
    print(f"{name:<14} faces={len(mesh.faces):>7} med={med:.4f} "
          f"p90={p90:.4f} {dt:7.1f}s", flush=True)
    return dict(faces=len(mesh.faces), med=med, p90=p90, wall=dt)


def main(argv=None, timer=None) -> dict:
    """Run the variants; returns {variant: its row}. ``timer``: a
    StageTimer that every reconstruction fills."""
    ap = argparse.ArgumentParser(
        prog="python -m meshrecon_torch.tools.flow_e2e_quality")
    ap.add_argument("scale", nargs="?", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = start(args.device)
    scene = koule(args.scale, device)
    return {name: run_variant(name, *scene, device, timer)
            for name in VARIANTS}


if __name__ == "__main__":
    main()
