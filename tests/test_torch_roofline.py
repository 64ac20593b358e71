"""The roofline probes' plain versions (R1-R4) against the Pallas kernels of
tools/roofline.py, and the port's roofline tool on the CPU.

The reference kernels are closures inside ``tools/roofline.py::main``; the
test takes their bodies from the source (the ``copy_kernel``,
``fma_kernel`` and ``tiny_kernel`` definitions under ``main``) and runs
them through ``pl.pallas_call(..., interpret=True)`` at small blocks, on
the same numpy inputs as the plain versions. Bound: bit for bit. R1 and R3
are one float32 operation each; R2's plain version adds in float64 and
rounds once, which equals the fused multiply-add that XLA's CPU backend
contracts ``acc * x + 1e-7`` into (1e-7 is float32 on both sides).
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from meshrecon_torch.tools import roofline

torch.set_num_threads(1)

REFERENCE = Path(__file__).resolve().parent.parent / "tools" / "roofline.py"


def _reference_kernels():
    """The Pallas kernel bodies defined inside tools/roofline.py's main."""
    tree = ast.parse(REFERENCE.read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    wanted = ("copy_kernel", "fma_kernel", "tiny_kernel")
    defs = [n for n in main.body
            if isinstance(n, ast.FunctionDef) and n.name in wanted]
    assert sorted(d.name for d in defs) == sorted(wanted)
    scope = {"jax": jax, "jnp": jnp, "inner": roofline.INNER}
    exec(compile(ast.Module(body=defs, type_ignores=[]), str(REFERENCE),
                 "exec"), scope)
    return {name: scope[name] for name in wanted}


@pytest.fixture(scope="module")
def kernels():
    return _reference_kernels()


def _call(kernel, x, grid=None, block=None):
    kw = {}
    if grid is not None:
        spec = pl.BlockSpec(block, lambda i: (i, 0))
        kw = dict(grid=grid, in_specs=[spec], out_specs=spec)
    fn = pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct(
        x.shape, jnp.float32), interpret=True, **kw)
    return np.asarray(fn(jnp.asarray(x)))


def _input(seed, shape, low=0.0, high=1.0):
    return np.random.default_rng(seed).uniform(
        low, high, size=shape).astype(np.float32)


@pytest.mark.parametrize("rows", [8, 64])
def test_copy_plain_equals_reference(kernels, rows):
    x = _input(0, (rows, 128))
    want = _call(kernels["copy_kernel"], x)
    got = roofline.copy_scale(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        roofline.copy_scale_plain(torch.from_numpy(x)).numpy(), want)
    assert not np.array_equal(want, x)


@pytest.mark.parametrize("rows", [8, 64])
def test_fma_plain_equals_reference(kernels, rows):
    """2,048 dependent FMAs from the reference's input range."""
    x = _input(1, (rows, 128), 0.999, 1.001)
    want = _call(kernels["fma_kernel"], x)
    got = roofline.fma_chain(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)
    # the unfused float32 chain is another function
    acc = torch.from_numpy(x)
    for _ in range(roofline.INNER):
        acc = acc * torch.from_numpy(x) + 1e-7
    assert not np.array_equal(acc.numpy(), want)


@pytest.mark.parametrize("rows,nblocks", [(8, 1), (64, 1), (64, 8)])
def test_tiny_plain_equals_reference(kernels, rows, nblocks):
    """R3 (one block) and R4 (a grid of ``nblocks`` steps)."""
    x = _input(2, (rows, 128), -3.0, 3.0)
    want = _call(kernels["tiny_kernel"], x, grid=(nblocks,),
                 block=(rows // nblocks, 128))
    t = torch.from_numpy(x)
    got = (roofline.add_one(t) if nblocks == 1
           else roofline.add_one_grid(t, nblocks))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(roofline.add_one_plain(t).numpy(), want)


def test_wrappers_write_out():
    x = torch.from_numpy(_input(3, (8, 128)))
    for fn, plain in ((roofline.copy_scale, roofline.copy_scale_plain),
                      (roofline.add_one, roofline.add_one_plain),
                      (lambda t, out: roofline.fma_chain(t, 3, out=out),
                       lambda t: roofline.fma_chain_plain(t, 3))):
        out = torch.empty_like(x)
        assert fn(x, out=out) is out
        assert torch.equal(out, plain(x))


@pytest.mark.parametrize("call", [
    lambda x: roofline.copy_scale(x.double()),
    lambda x: roofline.copy_scale(x, out=torch.empty(8, 64)),
    lambda x: roofline.copy_scale(x, out=torch.empty(8, 128,
                                                      dtype=torch.float64)),
    lambda x: roofline.copy_scale(x.t()),
    lambda x: roofline.copy_scale(x.to("meta")),
    lambda x: roofline.fma_chain(x.half()),
    lambda x: roofline.fma_chain(x, inner=-1),
    lambda x: roofline.fma_chain(x.to("meta")),
    lambda x: roofline.add_one(x[:, :64].contiguous()),
    lambda x: roofline.add_one(x.reshape(8, 2, 64)),
    lambda x: roofline.add_one(x.to(torch.int32)),
    lambda x: roofline.add_one_grid(x, 3),
    lambda x: roofline.add_one_grid(x, 0),
    lambda x: roofline.add_one_grid(x.to("meta"), 2)],
    ids=["copy-f64", "copy-out-shape", "copy-out-f64", "copy-strided",
         "copy-meta", "fma-f16", "fma-negative-depth", "fma-meta",
         "tiny-cols", "tiny-3d", "tiny-int", "grid-uneven", "grid-zero",
         "grid-meta"])
def test_wrappers_refuse(call):
    """Wrong devices, types and shapes raise on any device: no fallback."""
    with pytest.raises(ValueError):
        call(torch.zeros(8, 128))


def test_main_on_cpu(capsys):
    out = roofline.main(["--device", "cpu"])
    text = capsys.readouterr().out
    for head in ("R1 HBM stream", "R2 float32 FMA", "bf16 matmul",
                 "R3 launch floor", "R4 grid-step marginal"):
        assert head in text, head
    assert "no kernel ran" in text
    assert out["copy_gbs"] is None and out["launch_graph_us"] is None
    assert out["copy_ms"] > 0 and out["fma_ms"] > 0 and out["mm_ms"] > 0
    kernels = (roofline.R1, roofline.R2, roofline.R3, roofline.R4)
    assert out["graph_launches"] == {k.name: 0 for k in kernels}
    assert all(k.launches == 0 for k in kernels)


def test_main_needs_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        roofline.main([])


def test_bound_takes_the_larger_time():
    ms, by = roofline.bound(3.35e9, 0)
    assert (ms, by) == (1.0, "bytes")
    ms, by = roofline.bound(0, 2 * 67e9)
    assert (round(ms, 9), by) == (2.0, "operations")
