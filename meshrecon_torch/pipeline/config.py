"""Runtime configuration: the command line, scene ingestion, frames.

Port of meshrecon/pipeline/config.py for one scene. The reference CLI
(configuration.cpp:37-123) and the JAX package's algorithmic extensions
keep their names and defaults; ``--device`` (default ``cuda``) picks the
torch device that holds the frames and runs every dense stage. The TPU
layout knobs of the JAX package (``--raster-tile-h/w``,
``--hs-fused-min-px``, ``--warp-narrow``, ``--warp-narrow-cols``,
``--warp-guard-cols``) have no counterpart here and are not accepted. A flag
whose path is not ported yet raises NotImplementedError naming its ROADMAP
item; no flag is ignored. The flow options that the JAX package sets as
module globals (``apply_kernel_knobs``: ``--variance-mode``,
``--variance-taps``, ``--shadow-sample``) are fields of :class:`Config`
here, handed to the updates as arguments.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Optional

import numpy as np
import torch

from meshrecon_torch.io.tracks import TrackFile, load_tracks


@dataclasses.dataclass
class Config:
    track: TrackFile
    frames: torch.Tensor  # (F, H, W) float32 grayscale 0..255 on ``device``
    device: str = "cuda"
    iteration_count: int = 2
    verbosity: int = 0
    camera_threshold: float = 10.0
    out_file_name: str = "output.obj"
    in_mesh_file: Optional[str] = None
    seed: int = 0
    # dense-depth estimator: "flow", "plane-sweep", or "hybrid" (plane
    # sweep on iteration 1, flow refinement after)
    depth_mode: str = "flow"
    sampling: str = "taylor"  # flow-displaced depth sampling: taylor | exact
    flow_solver: str = "cheb"  # cheb | jacobi | mg
    use_farneback: bool = False  # -f: Farneback flow instead of variational
    # the flow variance's re-warp: taylor (first order) | rewarp (the
    # reference's remap-then-compare), with 4 (bicubic) or 2 (bilinear) taps
    variance_mode: str = "taylor"
    variance_taps: int = 4
    shadow_sample: str = "nearest"  # shadow map sampler: nearest | bilinear
    sweep_depths: int = 64
    sweep_passes: int = 1
    poisson_grid: int = 128
    poisson_sigma: float = 1.5
    confidence_prune: float = 0.0
    poisson_trim: float = 2.0
    camera_coverage: float = 0.0
    coverage_quality: float = 0.25
    baseline_diversity: float = 0.0
    min_bundles: int = 0
    consensus_rounds: int = 0
    consensus_tau: float = 3.0
    max_sides: int = 8
    max_render_faces: int = 65536
    # flow knobs (0 = the pipeline default: 14 Chebyshev / 60 Jacobi
    # sweeps, 2 levels, 1 warp per level)
    flow_iters: int = 0
    flow_fine_warps: int = 0
    flow_levels: int = 0
    flow_warps: int = 0
    checkpoint_dir: Optional[str] = None
    profile_dir: Optional[str] = None
    resume: bool = False

    @property
    def width(self) -> int:
        return int(self.frames.shape[2])

    @property
    def height(self) -> int:
        return int(self.frames.shape[1])

    @property
    def cameras(self) -> np.ndarray:
        return self.track.cameras

    def camera(self, i: int) -> np.ndarray:
        return self.track.cameras[i]

    def frame(self, i: int) -> torch.Tensor:
        return self.frames[i]

    def reconstructed_points(self) -> np.ndarray:
        return self.track.bundles

    def log(self, level: int, msg: str) -> None:
        if self.verbosity >= level:
            print(msg, flush=True)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m meshrecon_torch.cli",
        description="Reconstructs dense geometry from given YAML scene "
        "calibration and video (PyTorch / CUDA)",
    )
    p.add_argument("input_pos", nargs="*", help="input YAML scene file")
    p.add_argument("-i", "--input", dest="input")
    p.add_argument("-m", "--initial-mesh", dest="initial_mesh")
    p.add_argument("-o", "--output", default="output.obj")
    p.add_argument("-c", "--camera-threshold", type=float, default=10.0)
    p.add_argument("-e", "--estimate-exposure", action="store_true")
    p.add_argument("-n", "--iterations", type=int, default=2)
    p.add_argument("-s", "--scale", type=float, default=1.0)
    p.add_argument("-k", "--skip-frames", type=int, default=1)
    p.add_argument("-f", "--farneback", action="store_true")
    p.add_argument("-v", "--verbose", action="count", default=0)
    p.add_argument("-V", "--hyper-verbose", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device of every dense stage (default cuda; "
                        "'cpu' runs the kernels' plain versions)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--synthetic", choices=["sphere", "plane", "auto"],
                   default=None,
                   help="render fixture frames instead of decoding the clip")
    p.add_argument("--depth-mode", choices=["flow", "plane-sweep", "hybrid"],
                   default="hybrid",
                   help="dense depth estimator (hybrid: plane sweep on "
                        "iteration 1, flow refinement after)")
    p.add_argument("--sweep-depths", type=int, default=64)
    p.add_argument("--flow-solver", choices=["cheb", "mg", "jacobi"],
                   default="cheb")
    p.add_argument("--sweep-passes", type=int, default=1)
    p.add_argument("--sampling", choices=["taylor", "exact"], default="taylor")
    p.add_argument("--poisson-grid", type=int, default=128)
    p.add_argument("--poisson-sigma", type=float, default=1.5)
    p.add_argument("--confidence-prune", type=float, default=0.0)
    p.add_argument("--poisson-trim", type=float, default=2.0)
    p.add_argument("--preset", choices=("quality",), default=None)
    p.add_argument("--ensemble-seeds", default=None, metavar="S1,S2,...")
    p.add_argument("--camera-coverage", type=float, default=0.0)
    p.add_argument("--coverage-quality", type=float, default=0.25)
    p.add_argument("--baseline-diversity", type=float, default=0.0)
    p.add_argument("--min-bundles", type=int, default=0)
    p.add_argument("--consensus-rounds", type=int, default=0)
    p.add_argument("--consensus-tau", type=float, default=3.0)
    p.add_argument("--max-sides", type=int, default=8)
    p.add_argument("--max-render-faces", type=int, default=65536)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--mesh-devices", type=int, default=1)
    p.add_argument("--scene-devices", type=int, default=1)
    p.add_argument("--profile", default=None, metavar="LOG_DIR",
                   help="write a torch.profiler trace of the run to LOG_DIR")
    p.add_argument("--flow-iters", type=int, default=0)
    p.add_argument("--flow-fine-warps", type=int, default=0)
    p.add_argument("--flow-levels", type=int, default=0)
    p.add_argument("--flow-warps", type=int, default=0)
    p.add_argument("--variance-mode", choices=("rewarp", "taylor"),
                   default="")
    p.add_argument("--variance-taps", type=int, choices=(0, 2, 4), default=0)
    p.add_argument("--shadow-sample", choices=("nearest", "bilinear"),
                   default="")
    return p


def _unported(args) -> list[str]:
    """The flags given whose path the port does not have yet, each with
    its ROADMAP item."""
    missing = []
    if args.estimate_exposure:
        missing.append("-e/--estimate-exposure (ROADMAP Queue A, A13)")
    if not args.synthetic:
        missing.append("video decode without --synthetic (ROADMAP Queue A, "
                       "A13)")
    if args.mesh_devices > 1 or args.scene_devices > 1:
        missing.append("--mesh-devices/--scene-devices > 1 (ROADMAP Queue "
                       "A, A12)")
    if args.ensemble_seeds or args.preset:
        missing.append("--ensemble-seeds/--preset (ROADMAP Queue A, A14)")
    if args.hyper_verbose:
        missing.append("-V/--hyper-verbose (ROADMAP Queue A, A14)")
    return missing


def resolve_device(name) -> torch.device:
    """The torch device for ``--device`` or an entry point's ``device``
    argument; a CUDA device that is missing raises rather than running on
    the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(name)!r}: CUDA is not available (pass --device "
            "cpu, or device='cpu', to run the plain versions on the CPU)")
    return device


def configs_from_args(argv=None) -> list:
    """One Config per input YAML (the port takes exactly one)."""
    args = build_parser().parse_args(argv)
    in_files = ([args.input] if args.input else []) + list(args.input_pos)
    if not in_files:
        print("No configuration YAML file given, exiting.", file=sys.stderr)
        raise SystemExit(1)
    missing = _unported(args)
    if len(in_files) > 1:
        missing.append("several input YAMLs (multi-scene; ROADMAP Queue A, "
                       "A14)")
    if missing:
        raise NotImplementedError("not ported yet: " + "; ".join(missing))
    return [_config_for_file(args, in_files[0], args.output)]


def config_from_args(argv=None) -> Config:
    """Single-scene form: exactly one input YAML (the reference CLI)."""
    return configs_from_args(argv)[0]


def _config_for_file(args, in_file: str, out_file: str) -> Config:
    from meshrecon_torch.io.synthetic import synthetic_frames

    device = resolve_device(args.device)
    skip = max(1, args.skip_frames)
    track = load_tracks(in_file, skip_frames=skip)

    scale = args.scale if args.scale and args.scale > 1 else 1.0
    width = int(track.width / scale)
    height = int(track.height / scale)
    if track.width % max(scale, 1) or track.height % max(scale, 1):
        print("Warning: downscale factor does not divide the frame size "
              "(configuration.cpp:149-151 warns here too)", file=sys.stderr)
    frames = synthetic_frames(track, width, height, mode=args.synthetic,
                              seed=args.seed, device=device)
    return Config(
        track=track,
        frames=frames,
        device=str(device),
        iteration_count=args.iterations,
        verbosity=2 if args.verbose else 0,
        camera_threshold=args.camera_threshold,
        out_file_name=out_file,
        in_mesh_file=args.initial_mesh,
        seed=args.seed,
        depth_mode=args.depth_mode,
        sampling=args.sampling,
        flow_solver=args.flow_solver,
        use_farneback=args.farneback,
        # an empty value is the JAX package's default
        variance_mode=args.variance_mode or "taylor",
        variance_taps=args.variance_taps or 4,
        shadow_sample=args.shadow_sample or "nearest",
        sweep_depths=args.sweep_depths,
        sweep_passes=args.sweep_passes,
        poisson_grid=args.poisson_grid,
        poisson_sigma=args.poisson_sigma,
        confidence_prune=args.confidence_prune,
        poisson_trim=args.poisson_trim,
        camera_coverage=args.camera_coverage,
        coverage_quality=args.coverage_quality,
        baseline_diversity=args.baseline_diversity,
        min_bundles=args.min_bundles,
        consensus_rounds=args.consensus_rounds,
        consensus_tau=args.consensus_tau,
        max_sides=args.max_sides,
        max_render_faces=args.max_render_faces,
        flow_iters=args.flow_iters,
        flow_fine_warps=args.flow_fine_warps,
        flow_levels=args.flow_levels,
        flow_warps=args.flow_warps,
        checkpoint_dir=args.checkpoint_dir,
        profile_dir=args.profile,
        resume=args.resume,
    )
