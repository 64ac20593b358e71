"""The port's fused-update breakdown tool on the CPU: its ``all`` prefix is
``fused_main_update_batched`` bit for bit (the same functions in the same
order on the same inputs), its stages are the JAX tool's in its order, and
both of its modes run and print every stage."""

import ast
from pathlib import Path

import pytest
import torch

from meshrecon_torch import problems, state
from meshrecon_torch.pipeline.fused import fused_main_update_batched
from meshrecon_torch.tools import fused_breakdown as fb

torch.set_num_threads(1)

H, W = 48, 64
REFERENCE = (Path(__file__).resolve().parent.parent / "tools"
             / "fused_breakdown.py")


@pytest.mark.parametrize("b,k,solver", [(1, 2, "cheb"), (2, 2, "jacobi")])
def test_all_prefix_is_the_update(b, k, solver):
    t = state.from_numpy(problems.fused_problem(b, k, H, W, seed=0), "cpu")
    ours = fb.run_prefix("all", t, H, W, solver)
    ref = fused_main_update_batched(*t, H, W, flow_solver=solver)
    assert ours.keys() == ref.keys()
    for key, value in ref.items():
        if isinstance(value, torch.Tensor):
            assert torch.equal(ours[key], value), key
        else:
            assert ours[key] == value, key
    assert ref["valid"].float().mean() > 0.05


def test_stages_are_the_jax_tools():
    """The names and order of the prefixes in tools/fused_breakdown.py."""
    tree = ast.parse(REFERENCE.read_text())
    lists = {tuple(e.value for e in n.elts) for n in ast.walk(tree)
             if isinstance(n, ast.List) and n.elts
             and all(isinstance(e, ast.Constant) for e in n.elts)}
    assert lists == {fb.STAGES}


def test_prefixes_hand_on_their_stage():
    t = state.from_numpy(problems.fused_problem(1, 2, H, W, seed=1), "cpu")
    out = {name: fb.run_prefix(name, t, H, W) for name in fb.STAGES[:-1]}
    assert out["depth0"]["all_depths"].shape == (1, 3, H, W)
    assert out["scan"]["mixed"].shape == (1, 2, H, W)
    assert out["flow"]["flows"].shape == (1, 2, H, W, 2)
    # the taylor re-warp does not change the flow it re-warps through
    assert torch.equal(out["rewarp"]["flows"], out["flow"]["flows"])
    assert out["var"]["var"].shape == (1, 2, H, W)
    assert out["tri"]["point4"].shape == (1, H, W, 4)
    with pytest.raises(ValueError):
        fb.run_prefix("normals", t, H, W)


def test_stage_work_counts():
    """Bytes and operations from the shapes: the flow stage's kernel
    operations at its two levels, none where torch ops carry a stage."""
    t = state.from_numpy(problems.fused_problem(2, 3, H, W, seed=0), "cpu")
    work = fb.stage_work(t, H, W, covered=0.5)
    assert tuple(work) == fb.STAGES
    n, px = 2 * 3, H * W
    per_px = fb.K3_OPS + fb.K4_LIN_OPS + 14 * fb.K4_SWEEP_OPS
    assert work["flow"][1] == n * px * per_px + n * (px // 4) * per_px
    assert work["scan"][1] == fb.K2_OPS * n * px
    assert work["depth0"][1] == fb.raster_ops(8, 512, 0.5, H, W)
    assert all(work[s][1] is None for s in ("rewarp", "var", "tri", "all"))
    assert fb.stage_work(t, H, W, 0.5, solver="mg")["flow"][1] is None
    assert all(nbytes > 0 for nbytes, _ in work.values())


def test_main_on_cpu(capsys):
    out = fb.main([str(H), str(W), "2", "1", "1", "--device", "cpu"])
    text = capsys.readouterr().out
    lines = [ln.split()[0] for ln in text.splitlines()
             if ln.split() and ln.split()[0] in fb.STAGES]
    assert tuple(lines) == fb.STAGES
    assert "no kernel ran" in text
    assert [r["stage"] for r in out["stages"]] == list(fb.STAGES)
    assert all(r["d_events"] is None for r in out["stages"])
    ref = fused_main_update_batched(*state.from_numpy(
        problems.fused_problem(1, 2, H, W, seed=0), "cpu"), H, W)
    assert torch.equal(out["all"]["point4"], ref["point4"])


def test_cost_only_prints_seven_stages(capsys):
    out = fb.main([str(H), str(W), "2", "1", "1", "--device", "cpu",
                   "--cost-only"])
    text = capsys.readouterr().out
    rows = [ln for ln in text.splitlines()
            if ln.split() and ln.split()[0] in fb.STAGES]
    assert len(rows) == 7
    assert all("plain versions" in ln for ln in rows)
    assert [r["stage"] for r in out["stages"]] == list(fb.STAGES)


def test_main_needs_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fb.main(["16", "16", "1", "1", "1"])
