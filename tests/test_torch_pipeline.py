"""The whole reconstruction of meshrecon_torch against meshrecon on the CPU:
koule-tr at 80x60 (frames made by the JAX package, so both packages see
the same pixels), the hybrid default at seed 3; the CLI; checkpoints; the
flags the port does not have yet.

Bounds: the JAX package's own end-to-end bounds (tests/test_pipeline.py:
median radius error < 0.13 R and median |error| < 0.14 R untrimmed; median
< 0.05 R and p90 < 0.20 R trimmed), and closeness to the JAX run of the
same configuration. Measured: with one iteration both packages give the
same face count (35,532 untrimmed, 16,248 trimmed) and figures equal to
1e-6 R; with two iterations (the flow update on the Poisson mesh) JAX
15,155 faces, median |error| 0.0345 R, p90 0.156 R, the port 15,717,
0.0321 R, 0.149 R. Bounds of closeness: 2e-3 R with one iteration, 0.02 R
(median) and 0.05 R (p90) with two, faces within 1% and 10%.
"""

import json

import numpy as np
import pytest
import torch

from meshrecon.io.synthetic import fit_sphere
from meshrecon.io.synthetic import synthetic_frames as j_frames
from meshrecon.io.tracks import load_tracks
from meshrecon.pipeline.checkpoint import load_checkpoint as j_load_ckpt
from meshrecon.pipeline.checkpoint import save_checkpoint as j_save_ckpt
from meshrecon.pipeline.config import Config as JConfig
from meshrecon.pipeline.reconstruct import reconstruct as j_reconstruct
from meshrecon_torch import cli
from meshrecon_torch.io.obj import read_mesh
from meshrecon_torch.pipeline import checkpoint, reconstruct
from meshrecon_torch.pipeline.config import Config, config_from_args
from meshrecon_torch.utils.profiling import StageTimer, device_busy

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def koule_small():
    track = load_tracks("tracks/koule-tr.yaml")
    frames = j_frames(track, 80, 60, mode="sphere", seed=0)
    return track, frames


def _errors(mesh, track):
    center, radius = fit_sphere(track.bundles)
    v3 = mesh.vertices[:, :3] / mesh.vertices[:, 3:4]
    r = np.linalg.norm(v3 - center, axis=1)
    err = np.abs(r - radius) / radius
    return {"faces": len(mesh.faces),
            "med": abs(np.median(r) - radius) / radius,
            "med_abs": float(np.median(err)), "p90": np.percentile(err, 90)}


def _both(koule_small, tmp_path, **kw):
    track, frames = koule_small
    kw = dict(seed=3, depth_mode="hybrid", **kw)
    ours = reconstruct.reconstruct(Config(
        track=track, frames=torch.from_numpy(frames), device="cpu",
        out_file_name=str(tmp_path / "ours.obj"), **kw))
    ref = j_reconstruct(JConfig(track=track, frames=frames,
                                out_file_name=str(tmp_path / "ref.obj"), **kw))
    assert (tmp_path / "ours.obj").exists()
    return _errors(ours, track), _errors(ref, track)


def test_end_to_end_sphere(koule_small, tmp_path):
    """One iteration, untrimmed, checkpointed."""
    ours, ref = _both(koule_small, tmp_path, iteration_count=1,
                      poisson_grid=64, poisson_trim=0.0,
                      checkpoint_dir=str(tmp_path / "ckpt"))
    assert ours["faces"] > 50
    assert ours["med"] < 0.13 and ours["med_abs"] < 0.14, ours
    assert abs(ours["faces"] - ref["faces"]) <= 0.01 * ref["faces"]
    for key in ("med", "med_abs", "p90"):
        assert abs(ours[key] - ref[key]) <= 2e-3, (key, ours, ref)
    pts, nrm, alphas, it, _ = checkpoint.load_checkpoint(
        str(tmp_path / "ckpt"))
    assert len(pts) == len(nrm) > 0 and it == 1 and len(alphas) >= 1


def test_end_to_end_sphere_trimmed(koule_small, tmp_path):
    ours, ref = _both(koule_small, tmp_path, iteration_count=1,
                      poisson_grid=64, poisson_trim=2.0)
    assert ours["med_abs"] < 0.05 and ours["p90"] < 0.20, ours
    assert abs(ours["faces"] - ref["faces"]) <= 0.01 * ref["faces"]
    for key in ("med_abs", "p90"):
        assert abs(ours[key] - ref[key]) <= 2e-3, (key, ours, ref)


def test_end_to_end_hybrid_two_iterations(koule_small, tmp_path):
    """The default: plane sweep, then the flow update on the Poisson mesh."""
    ours, ref = _both(koule_small, tmp_path, iteration_count=2,
                      poisson_grid=64, poisson_trim=2.0)
    assert ours["med_abs"] < 0.05 and ours["p90"] < 0.20, ours
    assert abs(ours["faces"] - ref["faces"]) <= 0.1 * ref["faces"]
    assert abs(ours["med_abs"] - ref["med_abs"]) <= 0.02, (ours, ref)
    assert abs(ours["p90"] - ref["p90"]) <= 0.05, (ours, ref)


@pytest.mark.parametrize("mode", ["plane-sweep", "flow"])
def test_single_bundle_path_matches_jax(koule_small, mode):
    """process_main_camera, the path of an iteration with one bundle."""
    from meshrecon.pipeline.reconstruct import process_main_camera as j_pmc
    from meshrecon.pipeline.heuristic import Heuristic as JHeuristic
    from meshrecon.raster import Renderer as JRenderer
    from meshrecon_torch.pipeline.heuristic import Heuristic
    from meshrecon_torch.raster.rasterizer import Renderer

    track, frames = koule_small
    kw = dict(seed=3, sweep_depths=16)
    cfg = Config(track=track, frames=torch.from_numpy(frames), device="cpu",
                 **kw)
    jcfg = JConfig(track=track, frames=frames, **kw)
    out = []
    for c, hint, rend, process in (
            (cfg, Heuristic(cfg), Renderer(80, 60, device="cpu"),
             reconstruct.process_main_camera),
            (jcfg, JHeuristic(jcfg), JRenderer(80, 60),
             j_pmc)):
        hint.not_happy(track.bundles)
        rend.load_mesh(hint.tessellate(track.bundles,
                                       np.zeros((len(track.bundles), 3))))
        out.append(process(c, rend, 8, [2, 14, 20], depth_mode=mode))
    (pts, nrm, n), (rpts, rnrm, rn) = out
    assert n > 100 and abs(n - rn) <= 0.01 * rn, (n, rn)
    assert len(pts) == len(nrm) == n
    np.testing.assert_allclose(np.median(pts[:, :3] / pts[:, 3:], 0),
                               np.median(rpts[:, :3] / rpts[:, 3:], 0),
                               rtol=0, atol=1e-3)


def test_cli_smoke(tmp_path):
    out = str(tmp_path / "cli.obj")
    timer = StageTimer()
    rc = cli.main(["tracks/koule-tr.yaml", "--synthetic", "sphere", "-s",
                   "8", "-n", "1", "-o", out, "--seed", "3",
                   "--poisson-grid", "48", "--device", "cpu"], timer=timer)
    assert rc == 0
    assert len(read_mesh(out).faces) > 0
    for stage in ("tessellate", "choose_cameras", "fused_sweep_update",
                  "filter_points", "final_mesh"):
        assert timer.counts[stage] >= 1, stage


def test_cli_profile_trace(tmp_path, koule_small):
    """--profile writes a torch.profiler trace of a single-bundle run."""
    cli.main(["tracks/koule-tr.yaml", "--synthetic", "sphere", "-s", "16",
              "-n", "1", "-o", str(tmp_path / "p.obj"), "--poisson-grid",
              "24", "--sweep-depths", "8", "--device", "cpu", "--profile",
              str(tmp_path / "prof")])
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    summary = json.loads((tmp_path / "prof" / "device_busy.json").read_text())
    assert summary["wall_s"] > 0
    assert summary["device_busy_s"] == summary["device_events"] == 0


def test_device_busy_merges_device_events_only():
    events = [{"ph": "X", "cat": "kernel", "ts": 0.0, "dur": 10.0},
              {"ph": "X", "cat": "kernel", "ts": 5.0, "dur": 10.0},
              {"ph": "X", "cat": "gpu_memcpy", "ts": 12.0, "dur": 1.0},
              {"ph": "X", "cat": "gpu_memset", "ts": 30.0, "dur": 2.0},
              {"ph": "X", "cat": "cpu_op", "ts": 0.0, "dur": 100.0},
              {"ph": "X", "cat": "cuda_runtime", "ts": 40.0, "dur": 5.0},
              {"ph": "X", "cat": "gpu_user_annotation", "ts": 0, "dur": 90},
              {"ph": "i", "cat": "kernel", "ts": 50.0}]
    busy, n = device_busy({"traceEvents": events})
    assert n == 4 and busy == pytest.approx(17e-6)


@pytest.mark.parametrize("flag", [
    ["-e"], ["--mesh-devices", "2"], ["--scene-devices", "2"],
    ["--ensemble-seeds", "1,2"], ["--preset", "quality"], ["-V"], [],
    ["tracks/koberec.yaml"]])
def test_unported_flags_raise(flag):
    # [] leaves out --synthetic: video decode is the unported path
    synthetic = ["--synthetic", "sphere"] if flag else []
    argv = ["tracks/koule-tr.yaml"] + flag + ["--device", "cpu"] + synthetic
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        config_from_args(argv)


@pytest.mark.parametrize("flag,field,value,attr", [
    (["-f"], "use_farneback", True, "use_farneback"),
    (["--flow-solver", "mg"], "flow_solver", "mg", "flow_solver"),
    (["--variance-mode", "rewarp"], "variance_mode", "rewarp", "variance"),
    (["--variance-taps", "2"], "variance_taps", 2, "variance_taps"),
    (["--shadow-sample", "bilinear"], "shadow_sample", "bilinear",
     "shadow_sample")], ids=["f", "mg", "rewarp", "taps", "shadow"])
def test_ported_flags_reach_the_update(flag, field, value, attr):
    """Each flow option lands in Config and in the update module; the
    shadow sampler also in the sweep update. Without the flag, the JAX
    package's default."""
    argv = ["tracks/koule-tr.yaml", "--synthetic", "sphere", "-s", "16",
            "--device", "cpu"]
    cfg = config_from_args(argv + flag)
    assert getattr(cfg, field) == value
    assert getattr(reconstruct.main_update(cfg), attr) == value
    if field == "shadow_sample":
        assert reconstruct.sweep_update(cfg).shadow_sample == value
    default = config_from_args(argv)
    assert (default.use_farneback, default.flow_solver,
            default.variance_mode, default.variance_taps,
            default.shadow_sample) == (False, "cheb", "taylor", 4, "nearest")


@pytest.mark.parametrize("entry", ["Renderer", "synthetic_frames",
                                   "poisson_surface", "density_scores",
                                   "filter_points"])
def test_entry_points_default_to_the_card(monkeypatch, entry):
    """Without CUDA, an entry point called without ``device`` raises (its
    default is the card); with device="cpu" it runs."""
    from meshrecon_torch.io.synthetic import synthetic_frames
    from meshrecon_torch.io.tracks import load_tracks as t_load_tracks
    from meshrecon_torch.meshing.poisson import poisson_surface
    from meshrecon_torch.points.filter import density_scores, filter_points
    from meshrecon_torch.raster.rasterizer import Renderer

    rng = np.random.default_rng(0)
    pts = rng.normal(size=(200, 3)).astype(np.float32)
    pts4 = np.concatenate([pts, np.ones((200, 1), np.float32)], 1)
    nrm = pts / np.linalg.norm(pts, axis=1, keepdims=True)
    calls = {
        "Renderer": lambda **kw: Renderer(16, 12, **kw),
        "synthetic_frames": lambda **kw: synthetic_frames(
            t_load_tracks("tracks/koule-tr.yaml"), 16, 12, **kw),
        "poisson_surface": lambda **kw: poisson_surface(pts4, nrm, grid=16,
                                                        **kw),
        "density_scores": lambda **kw: density_scores(pts, 0.1, **kw),
        "filter_points": lambda **kw: filter_points(pts4, nrm, 0.1, **kw),
    }
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()
    calls[entry](device="cpu")


@pytest.mark.parametrize("flag", ["--raster-tile-h", "--hs-fused-min-px",
                                  "--warp-narrow", "--warp-guard-cols"])
def test_tpu_layout_knobs_are_not_accepted(flag):
    with pytest.raises(SystemExit):
        config_from_args(["tracks/koule-tr.yaml", "--synthetic", "sphere",
                          "--device", "cpu", flag, "8"])


def test_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        config_from_args(["tracks/koule-tr.yaml", "--synthetic", "sphere"])


def test_config_passes_flow_knobs():
    cfg = config_from_args(["tracks/koule-tr.yaml", "--synthetic", "sphere",
                            "-s", "16", "--device", "cpu", "--flow-iters",
                            "20", "--flow-levels", "3", "--flow-warps", "2",
                            "--flow-fine-warps", "2", "--flow-solver",
                            "jacobi", "--sampling", "exact"])
    assert cfg.frames.shape == (31, 30, 40) and cfg.device == "cpu"
    m = reconstruct.main_update(cfg)
    assert (m.iters, m.levels, m.warps, m.fine_warps) == (20, 3, 2, 2)
    assert (m.flow_solver, m.sampling) == ("jacobi", "exact")
    d = reconstruct.main_update(config_from_args(
        ["tracks/koule-tr.yaml", "--synthetic", "sphere", "-s", "16",
         "--device", "cpu"]))
    assert (d.iters, d.levels, d.warps, d.fine_warps) == (None, 2, 1, 1)


def test_k_bucket_and_effective_mode(koule_small):
    track, frames = koule_small
    cfg = Config(track=track, frames=torch.from_numpy(frames), device="cpu",
                 depth_mode="hybrid")
    assert [reconstruct._k_bucket(cfg, k) for k in (1, 4, 5, 8, 12)] == [
        4, 4, 8, 8, 8]
    assert reconstruct._effective_depth_mode(cfg, 1) == "plane-sweep"
    assert reconstruct._effective_depth_mode(cfg, 2) == "flow"


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoints_cross_between_packages(tmp_path, direction):
    rng = np.random.default_rng(9)
    pts = rng.normal(size=(50, 4)).astype(np.float32)
    nrm = rng.normal(size=(50, 3)).astype(np.float32)
    gen = np.random.default_rng(4)
    gen.random(7)
    state = gen.bit_generator.state
    save, load = ((j_save_ckpt, checkpoint.load_checkpoint)
                  if direction == "jax_to_port"
                  else (checkpoint.save_checkpoint, j_load_ckpt))
    save(str(tmp_path), pts, nrm, [0.5, 0.25], 2, state)
    p, n, alphas, it, rng_state = load(str(tmp_path))
    np.testing.assert_array_equal(p, pts)
    np.testing.assert_array_equal(n, nrm)
    assert alphas == [0.5, 0.25] and it == 2
    resumed = np.random.default_rng(0)
    resumed.bit_generator.state = rng_state
    assert resumed.random() == gen.random()


def test_stage_timer_counts_and_reports():
    t = StageTimer()
    with t.stage("a", pixels=1000) as done:
        done({"x": [torch.ones(3)]})
    with t.stage("b"):
        pass
    assert t.counts["a"] == 1 and t.times["a"] > 0 and t.pixels["a"] == 1000
    assert "a" in t.report() and "b" in t.report()
    off = StageTimer(enabled=False)
    with off.stage("a") as done:
        assert done(5) == 5
    assert not off.counts
