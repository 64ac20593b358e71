"""The port's study tools (meshrecon_torch/tools/{flow_e2e_quality,
iters_study}.py) against the JAX package on the CPU, and the two faults
of the JAX tools that the port's divergence by design avoids.

- The variants and the printed columns are the JAX tools' (tools/<name>.py
  read with ``ast``).
- One ``flow_e2e_quality`` variant (``i30_w1``: 30 sweeps) and one
  ``iters_study`` row (12 sweeps, seed 3), at ``--scale 8`` (80x60) on the
  JAX package's frames (seed 0; the port's own renders differ in the last
  bits, and the camera policy's draw follows them), each held against
  JAX's ``reconstruct(Config(..., flow_iters=N))`` on the same frames:
  median and p90 of |r - R| / R within 0.02 and 0.05
  (tests/test_torch_e2e_options.py's bounds), faces within 10%.
- The JAX tools' faults, shown with no reconstruction:
  ``tools/iters_study.py`` sets ``variational._FLOW_ITERS``, which
  ``apply_kernel_knobs`` (called by ``reconstruct``) sets back to the
  default when the Config's ``flow_iters`` is 0; ``tools/flow_e2e_quality
  .py`` imports ``reconstruct`` from ``meshrecon.pipeline``, which is the
  function (re-exported by the package), so its ``_vmapped_step`` lookup
  raises.
"""

import ast
import contextlib
import importlib
import io
import re
import tempfile
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from meshrecon.io.synthetic import synthetic_frames as j_frames
from meshrecon.io.tracks import load_tracks as j_load_tracks
from meshrecon_torch.io.obj import read_mesh
from meshrecon_torch.tools import flow_e2e_quality, iters_study
from meshrecon_torch.tools.quality_harness import surface_error

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
E2E_MED, E2E_P90 = 0.02, 0.05  # tests/test_torch_e2e_options.py::compare
SCALE = 8
TRACK = "tracks/koule-tr.yaml"


def _jax_main(tool):
    tree = ast.parse((ROOT / "tools" / f"{tool}.py").read_text())
    return next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")


def _constant_fstrings(fn):
    """The f-strings of constants in ``fn``, evaluated, in order."""
    return [eval(compile(ast.Expression(n), "<jax tool>", "eval"))
            for n in ast.walk(fn) if isinstance(n, ast.JoinedStr)
            and all(isinstance(v, ast.Constant)
                    or isinstance(v.value, ast.Constant)
                    for v in n.values)]


@pytest.fixture
def jax_frames(monkeypatch):
    """koule-tr's JAX-made frames at 80x60, in place of the port's."""
    track = j_load_tracks(TRACK)
    w, h = track.width // SCALE, track.height // SCALE
    frames = np.array(j_frames(track, w, h, mode="sphere", seed=0))
    monkeypatch.setattr(
        "meshrecon_torch.io.synthetic.synthetic_frames",
        lambda *a, device="cuda", **k: torch.from_numpy(frames).to(device))
    return track, frames


def _jax_reconstruct(track, frames, path, **kw):
    """JAX's reconstruct with ``kw``; its kernel knobs set back to their
    defaults afterwards, so that later tests of this worker see them."""
    import jax.numpy as jnp

    from meshrecon.pipeline.config import Config as JConfig
    from meshrecon.pipeline.config import apply_kernel_knobs
    from meshrecon.pipeline.reconstruct import reconstruct as j_reconstruct

    try:
        return j_reconstruct(JConfig(track=track, frames=jnp.asarray(frames),
                                     out_file_name=str(path), **kw))
    finally:
        apply_kernel_knobs(types.SimpleNamespace())


def _close(ours, theirs_mesh, center, radius):
    med, p90 = surface_error(theirs_mesh, "sphere", (center, radius))
    assert abs(ours["med"] - med) <= E2E_MED
    assert abs(ours["p90"] - p90) <= E2E_P90
    assert abs(ours["faces"] - len(theirs_mesh.faces)) <= \
        0.1 * len(theirs_mesh.faces)


def test_variants_are_the_jax_tools():
    fn = _jax_main("flow_e2e_quality")
    table = next(n.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
                 and getattr(n.targets[0], "id", None) == "variants")
    names = [k.value for k in table.keys]
    assert list(flow_e2e_quality.VARIANTS) == names
    # sweeps: the solver default (0), then the JAX labels' 30 and 45
    assert list(flow_e2e_quality.VARIANTS.values()) == [0, 30, 45]


def test_flow_e2e_quality_matches_jax(jax_frames, monkeypatch, tmp_path):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    track, frames = jax_frames
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        scene = flow_e2e_quality.koule(SCALE, torch.device("cpu"))
        row = flow_e2e_quality.run_variant("i30_w1", *scene, "cpu")
    line = out.getvalue().strip()
    assert re.fullmatch(r"i30_w1\s+faces=\s*\d+ med=[\d.]+ p90=[\d.]+\s+"
                        r"[\d.]+s", line), line
    assert len(read_mesh(str(tmp_path / "fq_i30_w1.obj")).faces) == \
        row["faces"]
    theirs = _jax_reconstruct(track, frames, tmp_path / "j.obj", seed=3,
                              iteration_count=1, depth_mode="flow",
                              poisson_grid=96, flow_iters=30)
    _close(row, theirs, *scene[2:])


def test_iters_study_matches_jax(jax_frames, monkeypatch, tmp_path):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    track, frames = jax_frames
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rows = iters_study.main(["--iters", "12", "--seeds", "3", "--scale",
                                 str(SCALE), "--device", "cpu"])
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("# device: cpu")
    assert lines[1] == "# koule 80x60, n=2 hybrid trim2, radius 0.390"
    assert lines[2] in _constant_fstrings(_jax_main("iters_study"))
    (row,) = rows
    assert (row["iters"], row["seed"]) == (12, 3)
    assert lines[3] == (f"{12:<7}{3:>5}{row['med']:>9.4f}"
                        f"{row['p90']:>9.4f}{row['wall']:>8.1f}")
    assert read_mesh(str(tmp_path / "iters_12_3.obj")).faces.shape[0] == \
        row["faces"]
    from meshrecon_torch.io.synthetic import fit_sphere

    theirs = _jax_reconstruct(track, frames, tmp_path / "j.obj", seed=3,
                              iteration_count=2, depth_mode="hybrid",
                              poisson_trim=2.0, poisson_grid=64,
                              flow_iters=12)
    _close(row, theirs, *fit_sphere(track.bundles))


def test_jax_iters_override_does_not_reach_the_run(monkeypatch):
    """tools/iters_study.py:52 sets the knob; reconstruct's
    apply_kernel_knobs (meshrecon/pipeline/reconstruct.py:497) sets it
    back from a Config whose flow_iters is 0."""
    from meshrecon.flow import variational
    from meshrecon.pipeline.config import apply_kernel_knobs

    monkeypatch.setattr(variational, "_FLOW_ITERS", 12)
    apply_kernel_knobs(types.SimpleNamespace(flow_iters=0))
    assert variational._FLOW_ITERS == variational._DEFAULTS[0] == 0


def test_jax_flow_e2e_quality_binds_the_function():
    """tools/flow_e2e_quality.py:46-48: ``R`` is the reconstruct function,
    which has no ``_vmapped_step`` to clear."""
    from meshrecon.pipeline import reconstruct as R

    module = importlib.import_module("meshrecon.pipeline.reconstruct")
    assert R is module.reconstruct and callable(R)
    assert not hasattr(R, "_vmapped_step")
    assert hasattr(module, "_vmapped_step")


@pytest.mark.parametrize("tool", ["flow_e2e_quality", "iters_study"])
def test_tool_without_cuda_raises(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = {"flow_e2e_quality": flow_e2e_quality.main,
            "iters_study": iters_study.main}[tool]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main([])
