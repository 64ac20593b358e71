"""The point filter of meshrecon_torch against meshrecon on the CPU.

Tolerances: the neighbour graph is the same scipy code (equal). The
density iteration runs in float32 on both sides with scatter-adds in
another order, so density and score agree to 1e-4 (measured 3.6e-7 and
9.5e-7).
The kept sets are equal below 5,000 points (graph + iteration + native
greedy) and above (one native call on both sides).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from meshrecon.points import filter as j_filter
from meshrecon_torch.points import filter as filt

torch.set_num_threads(1)


def _cloud(n, seed, outliers=8):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n - outliers, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pts = np.concatenate([v * (1 + rng.normal(scale=0.02, size=(len(v), 1))),
                          rng.uniform(-4, 4, size=(outliers, 3))])
    pts4 = np.concatenate([pts, np.ones((n, 1))], 1).astype(np.float32)
    return pts4, rng.normal(size=(n, 3)).astype(np.float32)


def test_half_edges_equal_jax():
    pts4, _ = _cloud(600, 0)
    for a, b in zip(filt.build_half_edges(pts4[:, :3], 0.01),
                    j_filter.build_half_edges(pts4[:, :3], 0.01)):
        np.testing.assert_array_equal(a, b)


def test_power_iteration_matches_jax():
    pts4, _ = _cloud(800, 1)
    ei, ej, w = filt.build_half_edges(pts4[:, :3], 0.02)
    d, s = filt._power_iteration(torch.from_numpy(ei), torch.from_numpy(ej),
                                 torch.from_numpy(w), len(pts4))
    dr, sr = j_filter._power_iteration(jnp.asarray(ei), jnp.asarray(ej),
                                       jnp.asarray(w), len(pts4))
    np.testing.assert_allclose(d.numpy(), np.asarray(dr), rtol=0, atol=1e-4)
    np.testing.assert_allclose(s.numpy(), np.asarray(sr), rtol=0, atol=1e-4)


@pytest.mark.parametrize("n,radius_sq", [(1500, 0.01), (4000, 0.004),
                                         (7000, 0.002)])
def test_filter_points_keeps_jax_set(n, radius_sq):
    pts4, nrm = _cloud(n, n)
    p, q, kept = filt.filter_points(pts4, nrm, radius_sq, device="cpu")
    rp, rq, rkept = j_filter.filter_points(pts4, nrm, radius_sq)
    np.testing.assert_array_equal(kept, rkept)
    np.testing.assert_array_equal(p, rp)
    np.testing.assert_array_equal(q, rq)
    assert 0 < len(kept) < n
    assert not np.isin(np.arange(n - 8, n), kept).any()  # outliers cut


def test_filter_points_empty():
    p, q, kept = filt.filter_points(np.zeros((0, 4), np.float32),
                                    np.zeros((0, 3), np.float32), 0.1,
                                    device="cpu")
    assert p.shape == (0, 4) and q.shape == (0, 3) and len(kept) == 0
