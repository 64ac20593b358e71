"""End-to-end quality cost of the flow solver's sweep count.

Port of tools/iters_study.py:

    python -m meshrecon_torch.tools.iters_study [--iters 20,14,12]
        [--seeds 3,4,5] [--scale 8] [--device cuda|cpu]

Each row reconstructs koule-tr from synthetic sphere frames (seed 0) at
1/``scale`` resolution (default 8: 80x60), ``-n 2`` hybrid, Poisson trim
2 and grid 64, under one policy seed and one sweep count
(``Config.flow_iters``), and prints the median and p90 of
| |v - c| - R | / R against the fitted sphere and the wall seconds, in the
JAX tool's format, after the device line (on the card the kernels are
built before the first run). The meshes are written to
``iters_<iters>_<seed>.obj`` under ``tempfile.gettempdir()``.

Divergence by design: the JAX tool sets ``variational._FLOW_ITERS`` and
clears JAX's caches, but ``reconstruct`` then calls
``apply_kernel_knobs(config)``, which sets the knob back to its
import-time default because the Config's ``flow_iters`` is 0
(meshrecon/pipeline/config.py:414-427): every JAX row measures the
default sweep count. Here each row's count goes through
``Config.flow_iters``, which reaches the update. Runs on the card unless
``--device cpu`` is given (and raises without CUDA).
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

from meshrecon_torch.tools import start
from meshrecon_torch.tools.flow_e2e_quality import koule
from meshrecon_torch.tools.quality_harness import surface_error


def main(argv=None, timer=None) -> list:
    """Run the study; returns one dict(iters, seed, faces, med, p90,
    wall) a row. ``timer``: a StageTimer that every reconstruction
    fills."""
    ap = argparse.ArgumentParser(
        prog="python -m meshrecon_torch.tools.iters_study")
    ap.add_argument("--iters", default="20,14,12")
    ap.add_argument("--seeds", default="3,4,5")
    ap.add_argument("--scale", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = start(args.device)

    from meshrecon_torch.pipeline.config import Config
    from meshrecon_torch.pipeline.reconstruct import reconstruct

    track, frames, center, radius = koule(args.scale, device)
    w, h = track.width // args.scale, track.height // args.scale

    print(f"# koule {w}x{h}, n=2 hybrid trim2, radius {radius:.3f}",
          flush=True)
    print(f"{'iters':<7}{'seed':>5}{'med/r':>9}{'p90/r':>9}{'wall s':>8}",
          flush=True)
    rows = []
    for iters in (int(s) for s in args.iters.split(",")):
        for seed in (int(s) for s in args.seeds.split(",")):
            cfg = Config(track=track, frames=frames, device=str(device),
                         seed=seed, iteration_count=2, depth_mode="hybrid",
                         poisson_trim=2.0, poisson_grid=64, flow_iters=iters,
                         out_file_name=os.path.join(
                             tempfile.gettempdir(),
                             f"iters_{iters}_{seed}.obj"))
            t0 = time.perf_counter()
            mesh = reconstruct(cfg, timer=timer)
            dt = time.perf_counter() - t0
            med, p90 = surface_error(mesh, "sphere", (center, radius))
            rows.append(dict(iters=iters, seed=seed, faces=len(mesh.faces),
                             med=med, p90=p90, wall=dt))
            print(f"{iters:<7}{seed:>5}{med:>9.4f}{p90:>9.4f}{dt:>8.1f}",
                  flush=True)
    return rows


if __name__ == "__main__":
    main()
