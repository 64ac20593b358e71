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


def _step_counts(band, gn_iters):
    """Each pixel's steps under the eager step with no exit: the sweeps it
    began active (0 if never, ``gn_iters`` if it never stopped), and
    whether it is still active after ``gn_iters``."""
    z, active = band.z, band.active
    t = torch.zeros(active.shape, dtype=torch.int64)
    for _ in range(gn_iters):
        t += active
        z, active = band.step(z, active)
    return t, active


@pytest.mark.parametrize("n_bands", [1, 2])
@pytest.mark.parametrize("sampling", ["taylor", "exact"])
def test_gn_exit_from_step_counts_matches_gauss_newton(sampling, n_bands):
    """The exit the GN kernels find afterwards: each pixel's step count
    from the eager step, per-item histograms summed over the bands, each
    item's stop sweep from them (``gn_exit_plain``), then min(stop, steps)
    steps replayed give ``gauss_newton``'s z, active and sweep count bit
    for bit. Item 0 stops after the 6-sweep minimum (at most 64 pixels
    still moving), item 1 at the 50-sweep cap (flows x60: over 64 pixels
    cycle); two bands split the frame's rows."""
    items = [_tri_problem(seed=2), _tri_problem(seed=1)]
    flx, fly = (_t(np.stack([it[0][c] * f for it, f in
                             zip(items, (1.0, 60.0))])) for c in (0, 1))
    var, mains, sides, sv, depth = (
        _t(np.stack([it[0][2] for it in items])),
        *(_t(np.stack([it[i] for it in items])) for i in (1, 2, 3, 4)))
    h = depth.shape[-2]
    cuts = [0, h // 2, h] if n_bands == 2 else [0, h]

    def bands():
        return [tt.GaussNewtonBand(flx[..., lo:hi, :], fly[..., lo:hi, :],
                                   var[..., lo:hi, :], mains, sides, sv,
                                   depth, sampling, row0=lo, height=h)
                for lo, hi in zip(cuts, cuts[1:])]

    ref = bands()
    sweeps = tt.gauss_newton(ref, 50)
    mine = bands()
    counts = [_step_counts(band, 50) for band in mine]
    hist = sum(torch.stack([torch.bincount(t[i].reshape(-1), minlength=51)
                            for i in range(2)]) for t, _ in counts)
    stop, n_sweeps, steps = tt.gn_exit_plain(hist)
    assert stop == [6, 50] and n_sweeps == sweeps == 50
    s = torch.tensor(stop)[:, None, None]
    for band, (t, alive), r in zip(mine, counts, ref):
        n = torch.minimum(t, s)
        z = band.z
        for i in range(50):
            z = band.step(z, i < n)[0]
        active = (t > s) | ((t == 50) & (s == 50) & alive)
        torch.testing.assert_close(z, r.z, rtol=0, atol=0, equal_nan=True)
        assert torch.equal(active, r.active)
    assert steps == sum(int(torch.minimum(t, s).sum()) for t, _ in counts)


def test_flow_planes_read_the_two_channels_in_place():
    """The GN kernels read flx, fly from one contiguous (..., 2) flow
    tensor at element step 2, from contiguous planes at step 1, and from
    any other layout through a contiguous copy."""
    flows = torch.arange(2 * 3 * 4 * 5 * 2, dtype=torch.float32).reshape(
        2, 3, 4, 5, 2)
    flx, fly, step = tt._flow_planes(flows[..., 0], flows[..., 1])
    assert step == 2 and flx.data_ptr() == flows.data_ptr()
    assert fly.data_ptr() == flows.data_ptr() + 4
    planes = flows.movedim(-1, 0).contiguous()
    flx, fly, step = tt._flow_planes(planes[0], planes[1])
    assert step == 1 and flx.data_ptr() == planes.data_ptr()
    flx, fly, step = tt._flow_planes(planes[0].transpose(-1, -2),
                                     planes[1].transpose(-1, -2))
    assert step == 1 and flx.is_contiguous() and fly.is_contiguous()
    assert torch.equal(flx, planes[0].transpose(-1, -2))


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


def _normals_inputs(seed=5):
    planes, main, sides, sv, depth = _tri_problem(seed=seed)
    tri = jt.triangulate_pixels(planes, main, sides, sv, depth,
                                sampling="taylor")
    centers = np.array([[0, 0, 0], [1.0, 0, 0], [1.0, 0.3, 0]], np.float32)
    return [_t(np.asarray(tri[k])[None]) for k in ("point4", "valid", "pdf")
            ] + [_t(centers[None]), _t(np.array([[True, True, False]])),
                 _t(np.array([2], np.int32))]


def test_normals_on_the_cpu_take_the_plain_path(monkeypatch):
    """CPU tensors run the eager ops (``normals_eager``) and launch no
    NORMALS kernel: with the card path patched to raise, the result is
    ``normals_eager``'s and no ``normals_kernel`` is counted."""
    from meshrecon_torch.utils.profiling import StageTimer

    def card(*args, **kwargs):
        raise AssertionError("the NORMALS kernels ran on the CPU")

    monkeypatch.setattr(tn, "normals_on_card", card)
    args = _normals_inputs()
    t = StageTimer()
    with t.stage("normals"):
        out = tn.estimate_normals_batched(*args)
    assert "normals_kernel" not in t.counters
    assert torch.equal(out, tn.normals_eager(*args))
    assert (out != 0).any()


@pytest.mark.parametrize("arg,bad", [
    (0, lambda t: t[..., :3]), (1, lambda t: t.float()),
    (2, lambda t: t.double()), (3, lambda t: t[:, :2]),
    (4, lambda t: t[:, :2]), (5, lambda t: t.repeat(2)),
    (3, lambda t: t.to("meta"))])
def test_normals_on_card_refuses_what_it_does_not_take(arg, bad):
    """The card path's wrapper checks shapes, types and devices before it
    launches anything (so it raises here, with no library built)."""
    args = _normals_inputs()
    args[arg] = bad(args[arg])
    with pytest.raises(ValueError):
        tn.normals_on_card(*args)


@pytest.mark.parametrize("radius", [-1, tn.CARD_MAX_RADIUS + 1])
def test_normals_on_card_refuses_a_radius_it_cannot_hold(radius):
    """The card's kernels take 0 <= radius <= CARD_MAX_RADIUS (NORMALS_COLS
    holds 64 rows of a column in registers): ValueError outside it, before
    any launch."""
    with pytest.raises(ValueError, match="radius"):
        tn.normals_on_card(*_normals_inputs(), radius=radius)


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
