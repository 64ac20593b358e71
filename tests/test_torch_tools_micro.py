"""The port's micro-benchmark tools (meshrecon_torch/tools/{perf_breakdown,
flow_levels,flow_trans,flow_micro,warp_micro,proj_micro}.py) and the
single-camera functions they call, against the JAX package on the CPU.

- Each tool's row names, in order, are the JAX tool's (tools/<name>.py,
  read with ``ast``: the first argument of every ``timeit`` call, loops
  and f-strings expanded). Each tool runs at 48x64, K=2, one call a pass
  with ``--device cpu``; its rows are finite, and the rows that print n/a
  are exactly those that select the TPU package's second engine or set a
  TPU layout flag.
- ``projected_image`` and ``plane_sweep_depth`` equal their batched forms'
  B=1 slice bit for bit, and match JAX's ``projected_image(engine="xla")``
  and ``plane_sweep_depth`` on the same NumPy inputs within
  meshrecon_torch/parity.py's bounds (``valid_agree`` for the masks,
  ``depth_within_1e-3`` for the depths and, at 1e-3 on the 0..255 scale,
  the intensities where both masks are set).
- flow_micro's ``diff_sum`` equals the same sum from JAX's
  ``variational_flow`` and ``flow_remap`` within 1e-3 relative: the
  flows agree to float32 rounding, and the sum of |prev - remap| over the
  frame is dominated by the pixels the flow does not explain (measured:
  within 2e-5).
- ``problems.plane_depth`` equals ``__graft_entry__._plane_depth`` bit for
  bit.
"""

import ast
import contextlib
import io
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import __graft_entry__ as g
from meshrecon.depth.plane_sweep import plane_sweep_depth as j_sweep
from meshrecon.flow.remap import flow_remap as j_remap
from meshrecon.flow.variational import variational_flow as j_flow
from meshrecon.raster.fragment import projected_image as j_projected
from meshrecon.raster.rasterizer import render_depth as j_render
from meshrecon_torch import parity, problems
from meshrecon_torch.depth import plane_sweep
from meshrecon_torch.raster import fragment
from meshrecon_torch.tools import (flow_levels, flow_micro, flow_trans,
                                   perf_breakdown, proj_micro, warp_micro)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
H, W, K = 48, 64, 2
SMALL = ["--height", str(H), "--width", str(W), "--k", str(K), "--reps", "1",
         "--device", "cpu"]
TOOLS = {"perf_breakdown": perf_breakdown, "flow_levels": flow_levels,
         "flow_trans": flow_trans, "flow_micro": flow_micro,
         "warp_micro": warp_micro, "proj_micro": proj_micro}
# the rows that select the TPU package's second engine or set a TPU layout
# flag: the port prints them n/a
NA_ROWS = {"perf_breakdown": {"variational_flow(xla)"},
           "flow_micro": {"flowK3 xla engine lv3", "flowK3 prod minpx5e5"},
           "proj_micro": {"proj1 real depth xla"}}
VALID_AGREE = parity.SLICE_BOUNDS["valid_agree"][1]
DEPTH_WITHIN = parity.SLICE_BOUNDS["depth_within_1e-3"][1]


def _eval(node, env):
    """A row name's value: constants, tuples and lists, names bound by
    the walk, ``dict(...)`` of those, and f-strings."""
    if isinstance(node, ast.Constant):
        return node.value
    if isinstance(node, (ast.Tuple, ast.List)):
        return [_eval(e, env) for e in node.elts]
    if isinstance(node, ast.Name):
        return env[node.id]
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id == "dict" and not node.args):
        return {kw.arg: _eval(kw.value, env) for kw in node.keywords}
    if isinstance(node, ast.JoinedStr):
        out = ""
        for part in node.values:
            if isinstance(part, ast.Constant):
                out += part.value
            else:
                spec = (_eval(part.format_spec, env) if part.format_spec
                        else "")
                out += format(_eval(part.value, env), spec)
        return out
    raise ValueError(ast.dump(node))


def _bind(target, value):
    if isinstance(target, ast.Name):
        return {target.id: value}
    out = {}
    for t, v in zip(target.elts, value):
        out.update(_bind(t, v))
    return out


def jax_rows(tool):
    """(row names of every ``timeit`` call of the JAX tool's ``main`` in
    order, the names its assignments bound)."""
    tree = ast.parse((ROOT / "tools" / f"{tool}.py").read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "main")
    rows, env = [], {}

    def walk(stmts, env):
        for st in stmts:
            if isinstance(st, ast.FunctionDef):
                continue
            if isinstance(st, ast.For):
                if not any(isinstance(n, ast.Call)
                           and getattr(n.func, "id", None) == "timeit"
                           for n in ast.walk(st)):
                    continue  # a loop of no row: the dispatch floor's
                for item in _eval(st.iter, env):
                    walk(st.body, {**env, **_bind(st.target, item)})
                continue
            if (isinstance(st, ast.Assign) and len(st.targets) == 1
                    and isinstance(st.targets[0], ast.Name)):
                with contextlib.suppress(ValueError, KeyError):
                    env[st.targets[0].id] = _eval(st.value, env)
            for node in ast.walk(st):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Name)
                        and node.func.id == "timeit"):
                    rows.append(_eval(node.args[0], env))

    walk(fn.body, env)
    return rows, env


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rows = main(argv)
    return rows, out.getvalue()


@pytest.mark.parametrize("tool", list(TOOLS))
def test_rows_are_the_jax_tools(tool):
    argv = ([str(H), str(W), str(K), "1", "--device", "cpu"]
            if tool == "perf_breakdown" else SMALL)
    rows, text = _run(TOOLS[tool].main, argv)
    quality = rows.pop("quality", None)
    want, env = jax_rows(tool)
    assert len(want) >= 4 and list(rows) == want
    assert text.splitlines()[0].startswith("# device: cpu")
    assert {name for name, ms in rows.items() if ms is None} == \
        NA_ROWS.get(tool, set())
    assert all(math.isfinite(ms) and ms > 0 for ms in rows.values()
               if ms is not None)
    for name in rows:
        assert any(line.startswith(name) for line in text.splitlines())
    if tool == "flow_micro":
        assert list(quality) == [name for name, _ in env["variants"]]
        assert [n for n, v in quality.items() if v is None] == \
            ["xla engine lv3"]
        assert all(v > 0 for v in quality.values() if v is not None)


@pytest.mark.parametrize("tool", list(TOOLS))
def test_tool_without_cuda_raises(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TOOLS[tool].main([] if tool == "perf_breakdown"
                         else ["--height", str(H)])


def test_plane_depth_equals_jax():
    cam = problems.make_camera(eye=(0.3, -0.1, 0.2))
    np.testing.assert_array_equal(problems.plane_depth(cam, -5.0, H, W),
                                  g._plane_depth(cam, -5.0, H, W))


def _t(a):
    return torch.from_numpy(np.array(a))


def _projection_inputs(seed):
    soup, valid, mains, _, sides, frames, *_ = g._fused_problem(
        1, 1, H, W, seed=seed)
    dm = np.asarray(j_render(mains[0], soup, valid, H, W))
    ds = np.asarray(j_render(sides[0, 0], soup, valid, H, W))
    return mains[0], dm, frames[0, 0], sides[0, 0], ds


@pytest.mark.parametrize("shadow", ["nearest", "bilinear"])
def test_projected_image_is_the_batched_slice(shadow):
    cam, dm, frame, side, ds = (_t(a) for a in _projection_inputs(3))
    inten, mask = fragment.projected_image(cam, dm, frame, side, ds,
                                           shadow_sample=shadow)
    b_int, b_mask = fragment.projected_image_batched(
        cam[None], dm[None], frame[None, None], side[None, None],
        ds[None, None], shadow_sample=shadow)
    assert inten.shape == (H, W) and mask.dtype == torch.bool
    assert torch.equal(inten, b_int[0, 0]) and torch.equal(mask,
                                                           b_mask[0, 0])


@pytest.mark.parametrize("seed", [0, 3])
def test_projected_image_matches_jax(seed):
    inputs = _projection_inputs(seed)
    j_int, j_mask = (np.asarray(a) for a in j_projected(*inputs,
                                                        engine="xla"))
    inten, mask = (a.numpy() for a in fragment.projected_image(
        *(_t(a) for a in inputs)))
    assert j_mask.mean() > 0.05
    assert np.mean(mask == j_mask) >= VALID_AGREE
    both = mask & j_mask
    assert np.mean(np.abs(inten[both] - j_int[both]) <= 1e-3) >= DEPTH_WITHIN


def _sweep_inputs(k=3):
    import cv2

    rng = np.random.default_rng(5)
    base = rng.uniform(0, 255, size=(H // 4, W // 4)).astype(np.float32)
    fm = cv2.resize(base, (W, H), interpolation=cv2.INTER_CUBIC)
    fs = np.stack([np.roll(fm, (i, 2 * i), axis=(0, 1)) for i in range(k)])
    main = problems.make_camera(eye=(0, 0, 0), aspect=H / W)
    cams = np.stack([problems.make_camera(eye=(0.1 * (i + 1), 0.05 * i, 0),
                                          aspect=H / W) for i in range(k)])
    valid = np.array([True] * (k - 1) + [False])
    weight = (rng.uniform(size=(k, H, W)) > 0.2).astype(np.float32)
    return fm, fs, main, cams, valid, weight


@pytest.mark.parametrize("weighted", [False, True])
def test_plane_sweep_depth_is_the_batched_slice(weighted):
    fm, fs, main, cams, valid, weight = (_t(a) for a in _sweep_inputs())
    wt = weight if weighted else None
    one = plane_sweep.plane_sweep_depth(fm, fs, main, cams, valid, -0.9, 0.7,
                                        num_depths=12, side_weight=wt)
    batch = plane_sweep.plane_sweep_depth_batched(
        fm[None], fs[None], main[None], cams[None], valid[None],
        torch.tensor([-0.9]), torch.tensor([0.7]), num_depths=12,
        side_weight=None if wt is None else wt[None])
    assert set(one) == {"depth", "cost", "valid"}
    for key, value in one.items():
        assert value.shape == (H, W)
        assert torch.equal(value, batch[key][0]), key


@pytest.mark.parametrize("weighted", [False, True])
def test_plane_sweep_depth_matches_jax(weighted):
    fm, fs, main, cams, valid, weight = _sweep_inputs()
    wt = weight if weighted else None
    ref = {k: np.asarray(v) for k, v in j_sweep(
        fm, fs, main, cams, valid, -0.9, 0.7, num_depths=12, engine="xla",
        side_weight=wt).items()}
    ours = {k: v.numpy() for k, v in plane_sweep.plane_sweep_depth(
        _t(fm), _t(fs), _t(main), _t(cams), _t(valid), -0.9, 0.7,
        num_depths=12, side_weight=None if wt is None else _t(wt)).items()}
    assert ref["valid"].mean() > 0.5
    assert np.mean(ours["valid"] == ref["valid"]) >= VALID_AGREE
    assert np.mean(np.abs(ours["depth"] - ref["depth"]) <= 1e-3) \
        >= DEPTH_WITHIN


@pytest.mark.parametrize("name", ["prod lv2 w1", "lv3 w2 (r4 default)"])
def test_flow_micro_diff_sum_matches_jax(name):
    _, _, _, fm, _, fs, *_ = g._fused_problem(1, K, H, W, seed=0)
    kw = dict(flow_micro.VARIANTS)[name]
    a, b = fm[0], fs[0][0]
    fl = np.asarray(j_flow(a[None, None], b[None, None], **kw))[0, 0]
    want = float(np.sum(np.abs(a - np.asarray(j_remap(fl, b))))) \
        * np.sqrt(3.0)
    got = flow_micro.diff_sum(_t(a), _t(b), **kw)
    assert abs(got - want) <= 1e-3 * want
