"""The ported slice end to end: meshrecon_torch.pipeline.fused against
meshrecon.pipeline.fused on the CPU, plus the port's state, problem generator
and import hygiene.

Tolerances for the slice (B=2, K=2, 48x64): meshrecon_torch/parity.py,
whose docstring gives each bound's reason. Measured here against JAX
(whose CPU backend contracts multiply-adds into FMAs): depth and valid
agree everywhere, point4 to 6.5e-5 of its length, pdf within 1e-3 on
99.1% of pixels and 0.12 in log, normals' axis to 2.3e-4 with no flip.

The flow options against the JAX update on the same inputs: the same
bounds, except pdf within 1e-3 where the flow or the variance is more
sensitive to last bits on these noise frames. The bicubic re-warp's
variance on noise gives pdf within 1e-3 on 97.3% of pixels (bound 0.95);
Farneback's 2x2 solves amplify XLA's FMA contraction to 4.7e-4 px of flow
(measured at 48x64), pdf within 1e-3 on 89.1% of pixels (bound 0.85).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import __graft_entry__ as g
from meshrecon.pipeline.fused import fused_main_update_batched as j_fused
from meshrecon_torch import parity, problems, state
from meshrecon_torch.kernels import _build
from meshrecon_torch.pipeline.fused import (FusedMainUpdate,
                                            fused_main_update,
                                            fused_main_update_batched)

torch.set_num_threads(1)

H, W = 48, 64


@pytest.fixture(scope="module")
def slice_outputs():
    args = g._fused_problem(2, 2, H, W, seed=3)
    ref = {k: np.asarray(v) for k, v in j_fused(
        *args, height=H, width=W, use_pallas=False, variance="taylor").items()}
    ours = state.to_numpy(fused_main_update_batched(
        *state.from_numpy(args, "cpu"), H, W))
    return args, ref, ours


def test_slice_matches_jax(slice_outputs):
    _, ref, ours = slice_outputs
    for key in ("point4", "normals", "pdf", "valid", "depth"):
        assert ours[key].shape == ref[key].shape, key
    assert ref["valid"].mean() > 0.05
    parity.check_slice(ours, ref)
    for key in ("point4", "normals", "pdf"):
        assert np.isfinite(ours[key][ours["valid"]]).all(), key


def test_single_camera_form_and_module_agree(slice_outputs):
    args, _, ours = slice_outputs
    t = state.from_numpy(args, "cpu")
    one = fused_main_update(t[0], t[1], *(a[0] for a in t[2:]), H, W)
    for key in ("point4", "normals", "pdf", "valid", "depth"):
        np.testing.assert_array_equal(one[key].numpy(), ours[key][0])
    module = FusedMainUpdate(H, W)
    out = module(*t)
    assert module.last_gn_sweeps >= 1
    for key in ("point4", "normals", "pdf", "valid", "depth"):
        np.testing.assert_array_equal(out[key].numpy(), ours[key])


@pytest.mark.parametrize("kwargs,bounds", [
    ({"variance": "rewarp"}, {"pdf_within_1e-3": 0.95}),
    ({"use_farneback": True}, {"pdf_within_1e-3": 0.85}),
    ({"flow_solver": "mg"}, {})], ids=["rewarp", "farneback", "mg"])
def test_options_match_jax(kwargs, bounds):
    """The flow update's options against the JAX update (its CPU path:
    bicubic flow_remap for the re-warp)."""
    args = g._fused_problem(2, 2, H, W, seed=3)
    jkw = dict(variance="taylor", use_farneback=False, flow_solver="cheb")
    jkw.update(kwargs)
    ref = {k: np.asarray(v) for k, v in j_fused(
        *args, height=H, width=W, use_pallas=False, **jkw).items()}
    ours = state.to_numpy(fused_main_update_batched(
        *state.from_numpy(args, "cpu"), H, W, **kwargs))
    assert ref["valid"].mean() > 0.05
    parity.check_slice(ours, ref, bounds)
    for key in ("point4", "normals", "pdf"):
        assert np.isfinite(ours[key][ours["valid"]]).all(), key


@pytest.mark.parametrize("kwargs", [{"variance": "exact"},
                                    {"variance_taps": 3},
                                    {"shadow_sample": "linear"}])
def test_unported_options_raise(kwargs):
    """Every option of the JAX update is ported; a value outside them
    raises."""
    t = state.from_numpy(problems.fused_problem(1, 1, 16, 16), "cpu")
    with pytest.raises(ValueError):
        fused_main_update_batched(*t, 16, 16, **kwargs)


def test_module_iters_follow_the_solver():
    """FusedMainUpdate(iters=None) runs the solver's default sweeps: 60
    for Jacobi, as fused_main_update_batched(flow_solver="jacobi") and the
    JAX package (variational.py:420)."""
    t = state.from_numpy(problems.fused_problem(1, 2, 24, 32, seed=4),
                         "cpu")
    module = FusedMainUpdate(24, 32, flow_solver="jacobi")
    assert module.iters is None
    out = module(*t)
    ref = fused_main_update_batched(*t, 24, 32, flow_solver="jacobi",
                                    iters=60)
    for key in ("point4", "normals", "pdf", "valid", "depth"):
        assert torch.equal(out[key], ref[key]), key
    fewer = fused_main_update_batched(*t, 24, 32, flow_solver="jacobi",
                                      iters=14)
    assert not torch.equal(out["pdf"], fewer["pdf"])


def test_problems_reproduce_graft_entry():
    for ours, ref in zip(problems.fused_problem(2, 3, 24, 32, seed=5),
                         g._fused_problem(2, 3, 24, 32, seed=5)):
        assert ours.dtype == ref.dtype
        np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(problems.sphere_soup(8, 12),
                                  g._sphere_soup(8, 12))
    np.testing.assert_array_equal(problems.make_camera(eye=(1, 2, 3)),
                                  g._make_camera(eye=(1, 2, 3)))


def test_state_round_trip():
    args = problems.fused_problem(2, 2, 8, 12)
    t = state.from_numpy(args, "cpu")
    expect = (torch.float32, torch.bool, torch.float32, torch.float32,
              torch.float32, torch.float32, torch.bool, torch.float32,
              torch.bool, torch.int32)
    assert tuple(x.dtype for x in t) == expect
    back = state.to_numpy(dict(zip(state.INPUT_NAMES, t)))
    for name, a in zip(state.INPUT_NAMES, args):
        np.testing.assert_array_equal(back[name], a)
    with pytest.raises(ValueError):
        state.from_numpy(args[:9], "cpu")


def test_port_never_imports_jax():
    """Every module of the port, found by walking the package, imports
    neither jax nor the JAX package (``meshrecon``, ``tools``,
    ``__graft_entry__``)."""
    code = "\n".join([
        "import importlib, pkgutil, sys",
        "import meshrecon_torch",
        "names = [m.name for m in pkgutil.walk_packages(",
        "    meshrecon_torch.__path__, 'meshrecon_torch.')]",
        "for name in names:",
        "    importlib.import_module(name)",
        "assert {'meshrecon_torch.parity', 'meshrecon_torch.meshing.alpha',",
        "        'meshrecon_torch.raster.binned',",
        "        'meshrecon_torch.pipeline.exposure',",
        "        'meshrecon_torch.io.images', 'meshrecon_torch.flow.driver',",
        "        'meshrecon_torch.flow.shiftwarp',",
        "        'meshrecon_torch.raster.reference',",
        "        'meshrecon_torch.raster.driver',",
        "        'meshrecon_torch.meshing.rbf', 'meshrecon_torch.meshing.greedy',",
        "        'meshrecon_torch.meshing.driver',",
        "        'meshrecon_torch.io.blender_export_tracks',",
        "        'meshrecon_torch.utils.debug',",
        "        'meshrecon_torch.tools.quality_harness',",
        "        'meshrecon_torch.tools.seed_study',",
        "        'meshrecon_torch.tools.error_attrib',",
        "        'meshrecon_torch.tools.remesh_lab',",
        "        'meshrecon_torch.tools.perf_breakdown',",
        "        'meshrecon_torch.tools.flow_levels',",
        "        'meshrecon_torch.tools.flow_trans',",
        "        'meshrecon_torch.tools.flow_micro',",
        "        'meshrecon_torch.tools.warp_micro',",
        "        'meshrecon_torch.tools.proj_micro',",
        "        'meshrecon_torch.tools.flow_e2e_quality',",
        "        'meshrecon_torch.tools.iters_study',",
        "        'meshrecon_torch.tools.baseline_configs',",
        "        'meshrecon_torch.bench'} <= set(names), names",
        "sys.exit(any(m in sys.modules for m in",
        "             ('jax', 'meshrecon', 'tools', '__graft_entry__')))"])
    root = Path(__file__).resolve().parent.parent
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=root)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No toolkit: the build raises; nothing falls back."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()
