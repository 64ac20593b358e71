"""meshrecon_torch.flow against meshrecon.flow on the CPU.

Tolerances: pyramid ops rtol 1e-5 (float32 sums in one order on both
sides; only FMA contraction differs). Relaxation: 1e-4 px against the XLA
twin and the Pallas kernel in interpret mode, whose HS average and data
term are reassociated (pallas_jacobi.py:278-309). The whole flow solve:
flow 1e-3 px, taylor re-warp 1e-2 on a 0..255 scale, the accumulated
last-bit differences of two warps and 28 sweeps.
"""

import numpy as np
import pytest
import torch

from meshrecon.flow import pyramid as jp
from meshrecon.flow import remap as jr
from meshrecon.flow import variational as jv
from meshrecon.flow.pallas_jacobi import hs_level_fused as j_hs_level_fused
from meshrecon_torch.flow import jacobi as tj
from meshrecon_torch.flow import pyramid as tp
from meshrecon_torch.flow import remap as tr
from meshrecon_torch.flow import tile_warp as ttw
from meshrecon_torch.flow import variational as tv

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _smooth(rng, shape, sigma=2.0):
    """Smooth random texture on a 0..255 scale."""
    from scipy.ndimage import gaussian_filter

    x = gaussian_filter(rng.normal(size=shape), sigma=(0,) * (len(shape) - 2)
                        + (sigma, sigma))
    x = (x - x.min()) / (x.max() - x.min())
    return (255.0 * x).astype(np.float32)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 9])
def test_reflect_index_matches_numpy(n):
    ref = np.pad(np.arange(n), 2, mode="reflect")
    np.testing.assert_array_equal(tp.reflect_index(n, 2, "cpu").numpy(), ref)


@pytest.mark.parametrize("shape", [(2, 48, 64), (1, 3, 4), (2, 2, 2),
                                   (1, 1, 1), (6, 7)])
def test_pyramid_ops_match_jax(shape):
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 255, shape).astype(np.float32)
    for jf, tf_ in ((jp.gauss5, tp.gauss5), (jp.pyr_down, tp.pyr_down)):
        np.testing.assert_allclose(tf_(_t(img)).numpy(), np.asarray(jf(img)),
                                   rtol=1e-5, atol=1e-4)
    out = tuple(2 * s for s in shape[-2:])
    np.testing.assert_allclose(tp.pyr_up(_t(img), out).numpy(),
                               np.asarray(jp.pyr_up(img, out)),
                               rtol=1e-5, atol=1e-4)


def test_compare_matches_jax():
    rng = np.random.default_rng(2)
    a = rng.uniform(0, 255, (2, 1, 48, 64)).astype(np.float32)
    b = rng.uniform(0, 255, (2, 3, 48, 64)).astype(np.float32)
    np.testing.assert_allclose(tp.compare(_t(a), _t(b)).numpy(),
                               np.asarray(jp.compare(a, b)), rtol=1e-5)


def test_bilinear_warp_matches_jax():
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 255, (3, 20, 28)).astype(np.float32)
    flow = rng.normal(scale=4.0, size=(3, 20, 28, 2)).astype(np.float32)
    ref = np.stack([np.asarray(jr.bilinear_warp(img[i], flow[i]))
                    for i in range(3)])
    np.testing.assert_allclose(tr.bilinear_warp(_t(img), _t(flow)).numpy(),
                               ref, rtol=0, atol=1e-3)
    # the K3 wrapper on CPU tensors is the plain warp
    out = ttw.tile_warp_flow_batched(_t(img), _t(flow[..., 0]),
                                     _t(flow[..., 1]))
    assert torch.equal(out, tr.bilinear_warp(_t(img), _t(flow)))


def test_cheb_coeffs_match_jax():
    assert tv.cheb_coeffs(14, 0.98) == jv.cheb_coeffs(14, 0.98)


def _hs_problem(seed, shape=(2, 48, 64)):
    rng = np.random.default_rng(seed)
    prev = _smooth(rng, shape)
    warped = (prev + rng.normal(scale=3.0, size=shape)).astype(np.float32)
    u0 = rng.normal(scale=0.5, size=shape).astype(np.float32)
    v0 = rng.normal(scale=0.5, size=shape).astype(np.float32)
    return prev, warped, u0, v0


@pytest.mark.parametrize("solver,iters", [("cheb", 14), ("jacobi", 30)])
def test_hs_sweeps_match_jax(solver, iters):
    prev, warped, u0, v0 = _hs_problem(4)
    if solver == "cheb":
        ju, jv_ = jv._hs_sweeps_cheb(prev, warped, u0, v0, 144.0, iters)
    else:
        ju, jv_ = jv._hs_sweeps(prev, warped, u0, v0, 144.0, iters)
    tu, tv_ = tj.hs_level_fused(_t(prev), _t(warped), _t(u0), _t(v0), 144.0,
                                iters=iters, solver=solver)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tv_.numpy(), np.asarray(jv_), rtol=0,
                               atol=1e-4)


def test_hs_cheb_matches_pallas_kernel_interpret():
    """Against hs_level_fused itself (interpret mode), 14 Chebyshev sweeps:
    one chunk, so the TPU schedule is global like the port's."""
    prev, warped, u0, v0 = _hs_problem(5)
    ju, jv_ = j_hs_level_fused(prev, warped, u0, v0, 144.0, iters=14,
                               solver="cheb", interpret=True)
    tu, tv_ = tj.hs_level_fused(_t(prev), _t(warped), _t(u0), _t(v0), 144.0,
                                iters=14, solver="cheb")
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tv_.numpy(), np.asarray(jv_), rtol=0,
                               atol=1e-4)


def test_variational_flow_matches_jax():
    rng = np.random.default_rng(8)
    h, w = 48, 64
    base = _smooth(rng, (1, 1, h + 8, w + 8), sigma=3.0)
    prev = base[:, :, 4:4 + h, 4:4 + w]
    nxt = np.stack([base[0, 0, 3:3 + h, 5:5 + w],
                    base[0, 0, 5:5 + h, 4:4 + w]])[None]  # (1, 2, H, W)
    jflow, jre = jv.variational_flow(prev, nxt, levels=2, warps=1,
                                     want_residual=True, engine="xla")
    tflow, tre = tv.variational_flow(_t(prev), _t(nxt), levels=2, warps=1,
                                     want_residual=True)
    assert tflow.shape == (1, 2, h, w, 2)
    np.testing.assert_allclose(tflow.numpy(), np.asarray(jflow), rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(tre.numpy(), np.asarray(jre), rtol=0,
                               atol=1e-2)
    # the solve recovers the shifts to within a pixel in the interior
    inner = tflow.numpy()[0, :, 8:-8, 8:-8]
    np.testing.assert_allclose(inner[0].mean((0, 1)), [-1.0, 1.0], atol=0.5)


def test_unported_solver_raises():
    z = torch.zeros(1, 16, 16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tv.variational_flow(z, z, levels=1, solver="mg")
