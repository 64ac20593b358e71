"""The ported slice end to end: meshrecon_torch.pipeline.fused against
meshrecon.pipeline.fused on the CPU, plus the port's state, problem generator
and import hygiene.

Tolerances for the slice (B=2, K=2, 48x64): meshrecon_torch/parity.py,
whose docstring gives each bound's reason. Measured here against JAX
(whose CPU backend contracts multiply-adds into FMAs): depth and valid
agree everywhere, point4 to 6.5e-5 of its length, pdf within 1e-3 on
99.1% of pixels and 0.12 in log, normals' axis to 2.3e-4 with no flip.
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


@pytest.mark.parametrize("kwargs", [{"use_farneback": True},
                                    {"variance": "rewarp"},
                                    {"flow_solver": "mg"}])
def test_unported_options_raise(kwargs):
    t = state.from_numpy(problems.fused_problem(1, 1, 16, 16), "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fused_main_update_batched(*t, 16, 16, **kwargs)


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
    modules = ("meshrecon_torch.pipeline.fused", "meshrecon_torch.state",
               "meshrecon_torch.problems", "meshrecon_torch.cli",
               "meshrecon_torch.pipeline.reconstruct",
               "meshrecon_torch.pipeline.config",
               "meshrecon_torch.pipeline.heuristic",
               "meshrecon_torch.pipeline.checkpoint",
               "meshrecon_torch.depth.plane_sweep",
               "meshrecon_torch.io.synthetic", "meshrecon_torch.io.tracks",
               "meshrecon_torch.meshing.poisson",
               "meshrecon_torch.meshing.native",
               "meshrecon_torch.points.filter",
               "meshrecon_torch.utils.profiling")
    code = (f"import sys, {', '.join(modules)}; "
            "sys.exit('jax' in sys.modules or 'meshrecon' in sys.modules)")
    root = Path(__file__).resolve().parent.parent
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=root)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No toolkit: the build raises; nothing falls back."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()
