"""meshrecon_torch.flow against meshrecon.flow on the CPU.

Tolerances: pyramid ops rtol 1e-5 (float32 sums in one order on both
sides; only FMA contraction differs). Relaxation: 1e-4 px against the XLA
twin and the Pallas kernel in interpret mode, whose HS average and data
term are reassociated (pallas_jacobi.py:278-309). The whole flow solve:
flow 1e-3 px, taylor re-warp 1e-2 on a 0..255 scale, the accumulated
last-bit differences of two warps and 28 sweeps. The bicubic re-warp
1e-4 against its XLA twin (the same polynomial weights and tap order) and
1e-2 in the interior against the TPU kernel in interpret mode (its tile
base fit, tests/test_tile_warp.py:111-125). K6's plain version 1e-3 px
against hs_jacobi in interpret mode, that test's own bound
(tests/test_pallas_jacobi.py:41-44).
"""

import numpy as np
import pytest
import torch

from meshrecon.flow import api as ja
from meshrecon.flow import pyramid as jp
from meshrecon.flow import remap as jr
from meshrecon.flow import variational as jv
from meshrecon.flow.pallas_jacobi import hs_jacobi as j_hs_jacobi
from meshrecon.flow.pallas_jacobi import hs_level_fused as j_hs_level_fused
from meshrecon.flow.tile_warp import tile_warp_bicubic as j_tile_warp_bicubic
from meshrecon_torch.flow import api as ta
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


@pytest.mark.parametrize("solver", ["jacobi", "mg"])
def test_variational_flow_solvers_match_jax(solver):
    """The solvers beside the default: the 2-level single-warp solve with
    each agrees with JAX (1e-3 px)."""
    rng = np.random.default_rng(9)
    h, w = 48, 64
    base = _smooth(rng, (1, 1, h + 8, w + 8), sigma=3.0)
    prev = base[:, :, 4:4 + h, 4:4 + w]
    nxt = base[:, :, 3:3 + h, 5:5 + w]
    ref = jv.variational_flow(prev, nxt, levels=2, warps=1, solver=solver,
                              engine="xla")
    ours = tv.variational_flow(_t(prev), _t(nxt), levels=2, warps=1,
                               solver=solver)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-3)


def test_unported_solver_raises():
    """Every solver of the CLI is ported (cheb, jacobi, mg); a name
    outside them raises."""
    z = torch.zeros(1, 16, 16)
    for solver in ("cheb", "jacobi", "mg"):
        assert tv.variational_flow(z, z, levels=1, solver=solver).shape == (
            1, 16, 16, 2)
    with pytest.raises(ValueError, match="solver"):
        tv.variational_flow(z, z, levels=1, solver="sor")


def test_flow_remap_matches_jax():
    """The bicubic re-warp (K3b's plain version) with flows reaching off
    the frame, and the absolute-coordinate sampler."""
    rng = np.random.default_rng(10)
    img = rng.uniform(0, 255, (3, 48, 64)).astype(np.float32)
    flow = rng.normal(scale=5.0, size=(3, 48, 64, 2)).astype(np.float32)
    flow[:, :4] += 9.0  # well off the frame: every tap clamps
    ref = np.stack([np.asarray(jr.flow_remap(flow[i], img[i]))
                    for i in range(3)])
    ours = tr.flow_remap(_t(flow), _t(img))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-4)
    col = rng.uniform(-5, 70, (48, 64)).astype(np.float32)
    row = rng.uniform(-5, 53, (48, 64)).astype(np.float32)
    np.testing.assert_allclose(
        tr.bicubic_sample(_t(img[0]), _t(col), _t(row)).numpy(),
        np.asarray(jr.bicubic_sample(img[0], col, row)), rtol=0, atol=1e-4)
    # the taps=4 wrapper on CPU tensors is flow_remap
    out = ttw.tile_warp_flow_batched(_t(img), _t(flow[..., 0]),
                                     _t(flow[..., 1]), taps=4)
    assert torch.equal(out, ours)


def test_bicubic_matches_tpu_kernel_interpret():
    """taps=4 against the TPU kernel (tile_warp_bicubic, interpret mode)
    on a smooth field: interior within 1e-2."""
    rng = np.random.default_rng(11)
    img = _smooth(rng, (1, 1, 16, 64))[0, 0]
    c, r = np.meshgrid(np.arange(64, dtype=np.float32),
                       np.arange(16, dtype=np.float32))
    scol = (c + 3.3 + 2.0 * np.sin(r / 7.0)).astype(np.float32)
    srow = (r - 1.7 + 1.5 * np.cos(c / 9.0)).astype(np.float32)
    ref = np.asarray(j_tile_warp_bicubic(img, scol, srow, interpret=True))
    ours = ttw.tile_warp_bicubic(_t(img), _t(scol), _t(srow)).numpy()
    np.testing.assert_allclose(ours[2:-2, 2:-2], ref[2:-2, 2:-2], rtol=0,
                               atol=1e-2)


@pytest.mark.parametrize("taps", [2, 4])
def test_rewarp_taps_match_tpu_kernel_interpret(taps):
    """The variance re-warp as the fused update calls it with
    --variance-taps 2 or 4, against the TPU path's call
    (tile_warp_flow_batched(..., r_row=6, r_col=8), interpret mode) on a
    smooth flow: interior within 1e-2. The JAX package's CPU path ignores
    the taps and always re-warps bicubically (fused.py:244-245); the port
    does what the TPU path does on both devices."""
    from meshrecon.flow.tile_warp import tile_warp_flow_batched

    rng = np.random.default_rng(14)
    img = _smooth(rng, (1, 1, 16, 64))[0]
    c, r = np.meshgrid(np.arange(64, dtype=np.float32),
                       np.arange(16, dtype=np.float32))
    flow = np.stack([1.3 + 1.5 * np.sin(r / 5.0), -0.8 + np.cos(c / 11.0)],
                    -1)[None].astype(np.float32)
    ref = np.asarray(tile_warp_flow_batched(img, flow, r_row=6, r_col=8,
                                            taps=taps, interpret=True))
    ours = ttw.tile_warp_flow_batched(_t(img), _t(flow[..., 0]),
                                      _t(flow[..., 1]), taps=taps).numpy()
    np.testing.assert_allclose(ours[:, 2:-2, 2:-2], ref[:, 2:-2, 2:-2],
                               rtol=0, atol=1e-2)


def test_hs_jacobi_plain_matches_pallas_kernel_interpret():
    """K6's plain version against hs_jacobi (interpret mode), 20 sweeps at
    64x128, given the fields."""
    rng = np.random.default_rng(12)
    h, w = 64, 128
    prev = rng.uniform(0, 255, (h, w)).astype(np.float32)
    warped = (prev + rng.normal(scale=4.0, size=(h, w))).astype(np.float32)
    u0 = rng.normal(scale=1.5, size=(h, w)).astype(np.float32)
    v0 = rng.normal(scale=1.5, size=(h, w)).astype(np.float32)
    p = np.pad(0.5 * (prev + warped), 1, mode="edge")
    ix = ((p[1:-1, 2:] - p[1:-1, :-2]) * 0.5).astype(np.float32)
    iy = ((p[2:, 1:-1] - p[:-2, 1:-1]) * 0.5).astype(np.float32)
    c = (warped - prev - ix * u0 - iy * v0).astype(np.float32)
    ju, jv_ = j_hs_jacobi(ix, iy, c, u0, v0, 144.0, iters=20, interpret=True)
    tu, tv_ = tj.hs_jacobi(*(_t(a) for a in (ix, iy, c, u0, v0)), 144.0,
                           iters=20)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=0, atol=1e-3)
    np.testing.assert_allclose(tv_.numpy(), np.asarray(jv_), rtol=0,
                               atol=1e-3)
    # and the Jacobi fixed point of _hs_sweeps, which takes the images
    ru, rv = tv._hs_sweeps(_t(prev), _t(warped), _t(u0), _t(v0), 144.0, 20)
    np.testing.assert_allclose(tu.numpy(), ru.numpy(), rtol=0, atol=1e-3)
    np.testing.assert_allclose(tv_.numpy(), rv.numpy(), rtol=0, atol=1e-3)


def test_calculate_flow_matches_jax():
    """The reference's calculateFlow contract, variational: (fx, fy,
    variance, 0); flow 1e-3 px, variance 1e-3 on 0..255."""
    rng = np.random.default_rng(13)
    base = _smooth(rng, (1, 1, 56, 72), sigma=3.0)[0, 0]
    prev, nxt = base[4:52, 4:68], base[3:51, 5:69]
    ref = np.asarray(ja.calculate_flow(prev, nxt))
    ours = ta.calculate_flow(_t(prev), _t(nxt)).numpy()
    assert ours.shape == (48, 64, 4)
    np.testing.assert_allclose(ours[..., :2], ref[..., :2], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(ours[..., 2], ref[..., 2], rtol=0, atol=1e-3)
    assert np.all(ours[..., 3] == 0.0)
