"""The port's baseline_configs tool (meshrecon_torch/tools/
baseline_configs.py) against tools/baseline_configs.py on the CPU.

- ``c4`` at a small window (56x96, K=4, 8 depths) against JAX's
  ``plane_sweep_depth`` on the same window: valid masks within
  meshrecon_torch/parity.py's ``valid_agree`` and depths within its
  ``depth_within_1e-3``, costs within 1e-3 everywhere. The window's
  texture is 8x8 blocks, so in a flat block the sampled values of
  neighbouring planes are equal up to the bilinear weights' rounding and
  the best plane can flip between the packages at a tie (measured: valid
  equal, 99.68% of depths within 1e-3, costs within 2.1e-4).
- The window is the JAX tool's: the same texture, rolls and cameras
  (``problems.make_camera`` equals ``__graft_entry__._make_camera``).
- ``c4`` through ``main`` prints its row, with no peak memory on the CPU;
  ``c5`` at 48x64 (8 scenes x 2 cameras, K=2, the CPU as one device)
  prints JAX's line, its outputs those of the fused update of each
  scene's problem bit for bit; without CUDA and without ``--device cpu``
  the tool raises.
"""

import ast
import contextlib
import io
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import __graft_entry__ as g
from meshrecon.depth.plane_sweep import plane_sweep_depth as j_sweep
from meshrecon_torch import parity
from meshrecon_torch.depth.plane_sweep import plane_sweep_depth
from meshrecon_torch.tools import baseline_configs as bc

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
H, W, K, D = 56, 96, 4, 8


def _jax_config4():
    tree = ast.parse((ROOT / "tools" / "baseline_configs.py").read_text())
    return next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "config4")


def test_window_is_the_jax_tools():
    """The sizes, sweep range and texture recipe of tools/baseline_configs
    .py's config4, and its cameras."""
    src = ast.unparse(_jax_config4())
    assert "H, W, K, D = (1080, 1920, 32, 64)" in src
    assert "-0.8, 0.6, num_depths=D" in src
    assert (bc.Z_MIN, bc.Z_MAX) == (-0.8, 0.6)
    assert "np.roll(fm, (i % 7, 3 * i % 11), axis=(0, 1))" in src
    fm, fs, main, cams, sv = bc.window(H, W, K)
    rng = np.random.default_rng(0)
    base = rng.uniform(0, 255, size=(H // 8, W // 8)).astype(np.float32)
    np.testing.assert_array_equal(fm, np.kron(base, np.ones((8, 8))))
    np.testing.assert_array_equal(fs[3], np.roll(fm, (3, 9), axis=(0, 1)))
    np.testing.assert_array_equal(main, g._make_camera(aspect=H / W))
    np.testing.assert_array_equal(
        cams[1], g._make_camera(eye=(0.3, 0.1, 0), aspect=H / W))
    assert sv.all() and cams.shape == (K, 4, 4)
    with pytest.raises(ValueError, match="multiple of 8"):
        bc.window(54, 96, K)


def test_c4_matches_jax():
    window = bc.window(H, W, K)
    ref = {k: np.asarray(v) for k, v in j_sweep(
        *window, bc.Z_MIN, bc.Z_MAX, num_depths=D, engine="xla").items()}
    ours = plane_sweep_depth(*(torch.from_numpy(np.ascontiguousarray(a))
                               for a in window), bc.Z_MIN, bc.Z_MAX,
                             num_depths=D)
    ours = {k: v.numpy() for k, v in ours.items()}
    assert ref["valid"].mean() > 0.5
    assert np.mean(ours["valid"] == ref["valid"]) >= \
        parity.SLICE_BOUNDS["valid_agree"][1]
    assert np.mean(np.abs(ours["depth"] - ref["depth"]) <= 1e-3) >= \
        parity.SLICE_BOUNDS["depth_within_1e-3"][1]
    np.testing.assert_allclose(ours["cost"], ref["cost"], rtol=0, atol=1e-3)


def test_c4_main_prints_its_row():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = bc.main(["c4", "--height", str(H), "--width", str(W), "--k",
                       str(K), "--depths", str(D), "--reps", "1",
                       "--device", "cpu"])
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("# device: cpu")
    assert re.fullmatch(
        rf"config4: [\d.]+ ms per {K}-frame/{D}-depth window solve at "
        rf"{H}p  = [\d.]+ Mpix/s dense depth \(warm-up [\d.]+s\); peak "
        r"allocated by the solve not read on the CPU", lines[-1]), lines[-1]
    assert res["ms"] > 0 and res["peak_mb"] is None
    depth = res["out"]["depth"]
    assert depth.shape == (H, W)
    assert torch.isfinite(depth[res["out"]["valid"]]).all()


def test_c5_prints_its_row():
    """JAX's config5 line (``ms per 8-scene x 2-camera sharded FUSED dense
    update = Mpix/s aggregate``; the warm-up seconds where JAX prints its
    compile time) and its outputs."""
    from meshrecon_torch import problems, state
    from meshrecon_torch.pipeline.fused import fused_main_update_batched

    h, w = 48, 64
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = bc.main(["c5", "--height", str(h), "--width", str(w),
                       "--device", "cpu"])
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("# device: cpu")
    assert lines[1] == (f"# config5: 8 scenes x 2 cams, {h}x{w}, K=2, "
                        "1 device(s), fused")
    assert re.fullmatch(
        r"config5: [\d.]+ ms per 8-scene x 2-camera sharded FUSED dense "
        r"update = [\d.]+ Mpix/s aggregate \(warm-up [\d.]+s\)",
        lines[-1]), lines[-1]
    assert res["ms"] > 0 and res["n_dev"] == 1
    one = fused_main_update_batched(*state.from_numpy(
        problems.fused_problem(2, 2, h, w, seed=0), "cpu"), h, w)
    assert res["out"]["point4"].shape == (8, 2, h, w, 4)
    for s in (0, 7):
        for key in ("point4", "normals", "pdf", "valid", "depth"):
            assert torch.equal(res["out"][key][s], one[key]), key


def test_c4_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bc.main(["c4", "--height", str(H)])
