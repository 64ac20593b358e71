"""The attribution tool of meshrecon_torch (tools/error_attrib.py) against
the JAX package's (tools/error_attrib.py, loaded from its file) on the CPU,
at ``--scale 8`` (80x60), seed 3, with ``--dump``, both packages on the
same frames (made by the JAX package, seed 0; the camera policy's draw at
iteration 2 follows the frames' last bits): section A's cloud and mesh
medians and p90s within 0.02 and 0.05 of JAX's
(tests/test_torch_e2e_options.py's bounds) and the mesh's faces within
10%; section B with the same set of provenance codes; sections C, D and E
printed; the dumps with the same npz keys and one provenance code per
point. Measured: cloud 0.0230 / 0.1175 R against 0.0231 / 0.1174, mesh
0.0166 / 0.0515 R (49,435 faces) against 0.0166 / 0.0523 (49,392), the
same 13 codes.
"""

import re

import numpy as np
import pytest
import torch

from meshrecon_torch.tools import error_attrib
from tests.test_torch_quality_tools import (E2E_MED, E2E_P90,
                                            isolate_jax_tool, jax_made_frames,
                                            jax_tool, run)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def attrib(tmp_path_factory):
    """Both packages' error_attrib runs: (output, dump) each; the JAX
    tool's compile cache setting left out and its files in ``tmp``."""
    import jax

    tmp = tmp_path_factory.mktemp("attrib")
    cache = jax.config.jax_compilation_cache_dir
    argv = ["--scale", "8", "--seeds", "3"]
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr("meshrecon_torch.io.synthetic.synthetic_frames",
                   jax_made_frames)
        isolate_jax_tool(mp, tmp)
        rc, out = run(error_attrib.main, argv + [
            "--device", "cpu", "--dump", str(tmp / "port_{seed}.npz")])
        j_rc, j_out = run(jax_tool("error_attrib").main,
                          argv + ["--dump", str(tmp / "jax_{seed}.npz")])
    finally:
        mp.undo()
    assert rc == j_rc == 0
    assert jax.config.jax_compilation_cache_dir == cache
    assert sorted(p.name for p in tmp.iterdir()) == ["jax_3.npz",
                                                     "port_3.npz"]
    return (out, tmp / "port_3.npz"), (j_out, tmp / "jax_3.npz")


A_LINE = re.compile(r"^A  cloud med/p90 ([\d.]+)/([\d.]+)   mesh med/p90 "
                    r"([\d.]+)/([\d.]+)   \((\d+) faces\)$", re.M)


def test_section_a_matches_jax(attrib):
    (out, _), (j_out, _) = attrib
    a, = A_LINE.findall(out)
    j_a, = A_LINE.findall(j_out)
    for i in (0, 2):  # cloud, mesh
        assert abs(float(a[i]) - float(j_a[i])) <= E2E_MED
        assert abs(float(a[i + 1]) - float(j_a[i + 1])) <= E2E_P90
    assert abs(int(a[4]) - int(j_a[4])) <= 0.1 * int(j_a[4])


def _codes(out):
    lines = out.split("B  bundle")[1].split("\nC  ")[0].splitlines()[1:]
    return sorted(int(ln.split()[0]) for ln in lines)


def test_section_b_codes_match_jax(attrib):
    (out, _), (j_out, _) = attrib
    codes = _codes(out)
    assert codes == _codes(j_out)
    assert -1 in codes and any(c // 1000 == 2 for c in codes)


def test_sections_printed(attrib):
    (out, _), (j_out, _) = attrib
    for section in ("A  cloud", "B  bundle", "C  conf-quartile",
                    "D  oracle drop", "E  "):
        assert (section in out) == (section in j_out) == True  # noqa: E712


def test_dumps_match_jax(attrib):
    (_, path), (_, j_path) = attrib
    d, j_d = np.load(path), np.load(j_path)
    assert sorted(d.files) == sorted(j_d.files)
    for key in d.files:
        assert d[key].dtype.kind == j_d[key].dtype.kind, key
    assert d["prov"].dtype == np.int32
    assert len(d["prov"]) == len(d["points"]) == len(d["normals"])
    for key in ("iteration", "scale", "seed", "poisson_grid",
                "poisson_sigma", "poisson_trim", "radius", "center"):
        np.testing.assert_array_equal(d[key], j_d[key])
