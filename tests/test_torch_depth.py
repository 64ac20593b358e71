"""meshrecon_torch.depth against meshrecon.depth on the CPU.

Tolerances: the camera inverse and XLA's FMA contraction move inputs by a
few ulp, which can flip a validity test exactly at its threshold: valid
masks agree on >= 99.9% of pixels. On pixels both call valid, point4
agrees to rtol 1e-4 (atol 1e-6 for components near 0) and each normal
vector to 1e-4 of its length. pdf is exp of a sum of K quadratic residual
terms at the solved depth, so the last bits of that solve move log pdf:
rtol 5e-3 (measured 2.3e-3 on 1 of 2784 pixels in exact mode, <= 1e-4
elsewhere).
"""

import numpy as np
import pytest
import torch

import __graft_entry__ as g
from meshrecon.depth import normals as jn
from meshrecon.depth import triangulate as jt
from meshrecon_torch.depth import normals as tn
from meshrecon_torch.depth import triangulate as tt

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _tri_problem(seed=0, k=2, h=48, w=64):
    fm, fp, mains, sides, sv, depths, centers, cvalid, ns = g._problem(
        1, k, h, w, seed=seed)
    rng = np.random.default_rng(seed)
    from scipy.ndimage import gaussian_filter

    flx = gaussian_filter(rng.normal(size=(k, h, w)), (0, 4, 4)) * 6.0
    fly = gaussian_filter(rng.normal(size=(k, h, w)), (0, 4, 4)) * 6.0
    var = rng.uniform(0.5, 50.0, size=(k, h, w))
    depth = depths[0].copy()
    depth[:, :6] = 1.0  # a background band
    planes = tuple(a.astype(np.float32) for a in (flx, fly, var))
    return planes, mains[0], sides[0], sv[0], depth


@pytest.mark.parametrize("sampling", ["taylor", "exact"])
def test_triangulate_pixels_matches_jax(sampling):
    planes, main, sides, sv, depth = _tri_problem()
    ref = jt.triangulate_pixels(planes, main, sides, sv, depth,
                                sampling=sampling)
    ours = tt.triangulate_pixels(tuple(_t(p) for p in planes), _t(main),
                                 _t(sides), _t(sv), _t(depth),
                                 sampling=sampling)
    rv, ov = np.asarray(ref["valid"]), ours["valid"].numpy()
    assert rv.mean() > 0.5
    assert np.mean(rv != ov) <= 1e-3
    both = rv & ov
    np.testing.assert_allclose(ours["point4"].numpy()[both],
                               np.asarray(ref["point4"])[both],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(ours["pdf"].numpy()[both],
                               np.asarray(ref["pdf"])[both], rtol=5e-3)


def test_gn_global_exit_matches_vmapped_while():
    """Batched: each item stops on its own count, as the vmapped
    while_loop does; the sweep count is reported."""
    import jax

    items = [_tri_problem(seed=s) for s in (1, 2)]
    ours = tt.triangulate_pixels_batched(
        *(_t(np.stack([it[0][c] for it in items])) for c in range(3)),
        _t(np.stack([it[1] for it in items])),
        _t(np.stack([it[2] for it in items])),
        _t(np.stack([it[3] for it in items])),
        _t(np.stack([it[4] for it in items])), sampling="taylor")
    ref = jax.vmap(lambda fx, fy, vv, m, s, v, d: jt.triangulate_pixels(
        (fx, fy, vv), m, s, v, d, sampling="taylor"))(
        *(np.stack([it[0][c] for it in items]) for c in range(3)),
        *(np.stack([it[i] for it in items]) for i in (1, 2, 3, 4)))
    assert 1 <= ours["gn_sweeps"] <= 50
    rv, ov = np.asarray(ref["valid"]), ours["valid"].numpy()
    assert np.mean(rv != ov) <= 1e-3
    both = rv & ov
    np.testing.assert_allclose(ours["point4"].numpy()[both],
                               np.asarray(ref["point4"])[both],
                               rtol=1e-4, atol=1e-6)


def test_sobel_matches_jax():
    rng = np.random.default_rng(3)
    img = rng.uniform(-1, 1, (20, 30)).astype(np.float32)
    for o, r in zip(tt.sobel_gradient(_t(img)), jt.sobel_gradient(img)):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-6)


def test_window_sums_match_jax():
    rng = np.random.default_rng(4)
    f = rng.uniform(-2, 2, (3, 30, 40)).astype(np.float32)
    np.testing.assert_allclose(tn._window_sums_chw(_t(f), 10).numpy(),
                               np.asarray(jn._window_sums_chw(f, 10)),
                               rtol=1e-6, atol=1e-4)


def test_estimate_normals_matches_jax():
    planes, main, sides, sv, depth = _tri_problem(seed=5)
    tri = jt.triangulate_pixels(planes, main, sides, sv, depth,
                                sampling="taylor")
    p4 = np.asarray(tri["point4"])
    valid = np.asarray(tri["valid"])
    pdf = np.asarray(tri["pdf"])
    centers = np.array([[0, 0, 0], [1.0, 0, 0], [1.0, 0.3, 0]], np.float32)
    cvalid = np.array([True, True, False])
    ref = np.asarray(jn.estimate_normals(p4, valid, pdf, centers, cvalid,
                                         np.int32(2)))
    ours = tn.estimate_normals(_t(p4), _t(valid), _t(pdf), _t(centers),
                               _t(cvalid), 2).numpy()
    assert np.isfinite(ours).all()
    nz = np.linalg.norm(ref, axis=-1) > 0
    assert nz.mean() > 0.5
    err = np.linalg.norm(ours[valid] - ref[valid], axis=-1)
    assert (err <= 1e-4 * np.linalg.norm(ref[valid], axis=-1) + 1e-9).all()
    np.testing.assert_array_equal(ours[~valid], 0.0)
