"""meshrecon_torch.raster.fragment against meshrecon.raster.fragment on the
CPU.

Tolerances: the reprojection coordinates differ in the last bits (camera
inverse, FMA contraction in XLA), so a nearest-sample .5 tie or a shadow
test exactly at its bias can fall the other way: masks agree except on at
most 0.1% of pixels. Intensities agree to 1e-3 on a 0..255 scale where
both masks are set (float32 rounding of the bilinear weights).
"""

import numpy as np
import pytest
import torch

import __graft_entry__ as g
from meshrecon.raster import fragment as jf
from meshrecon.raster.rasterizer import render_depth as j_render
from meshrecon_torch.raster import fragment as tf

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _inputs(b, k, h, w, seed):
    soup, valid, mains, _, sides, frames, *_ = g._fused_problem(b, k, h, w,
                                                                seed=seed)
    dm = np.stack([np.asarray(j_render(mains[i], soup, valid, h, w))
                   for i in range(b)])
    ds = np.stack([np.stack([np.asarray(j_render(sides[i, j], soup, valid,
                                                 h, w)) for j in range(k)])
                   for i in range(b)])
    return mains, dm, frames, sides, ds


@pytest.mark.parametrize("b,k,seed", [(1, 2, 0), (2, 2, 1)])
def test_projected_image_batched_matches_jax(b, k, seed):
    h, w = 48, 64
    mains, dm, frames, sides, ds = _inputs(b, k, h, w, seed)
    j_int, j_mask = (np.asarray(a) for a in jf.projected_image_batched(
        mains, dm, frames, sides, ds))
    t_int, t_mask = tf.projected_image_batched(_t(mains), _t(dm), _t(frames),
                                               _t(sides), _t(ds))
    t_int, t_mask = t_int.numpy(), t_mask.numpy()
    assert t_int.shape == (b, k, h, w) and t_mask.dtype == bool
    assert j_mask.mean() > 0.05  # the sphere is visible from the sides
    assert np.mean(t_mask != j_mask) <= 1e-3
    both = t_mask & j_mask
    np.testing.assert_allclose(t_int[both], j_int[both], rtol=0, atol=1e-3)
    assert (t_int[~t_mask] == 0).all()


def test_mix_background_matches_jax():
    rng = np.random.default_rng(4)
    inten = rng.uniform(0, 255, (2, 16, 24)).astype(np.float32)
    mask = rng.uniform(size=(2, 16, 24)) > 0.3
    bg = rng.uniform(0, 255, (2, 16, 24)).astype(np.float32)
    depth = np.where(rng.uniform(size=(2, 16, 24)) > 0.2, 0.5, 1.0).astype(
        np.float32)
    j_mixed, j_depth = jf.mix_background(inten, mask, bg, depth)
    t_mixed, t_depth = tf.mix_background(_t(inten), _t(mask), _t(bg),
                                         _t(depth))
    np.testing.assert_array_equal(t_mixed.numpy(), np.asarray(j_mixed))
    np.testing.assert_array_equal(t_depth.numpy(), np.asarray(j_depth))


def test_dilate3x3_matches_reduce_window():
    import jax

    rng = np.random.default_rng(5)
    d = rng.uniform(-1, 1, (3, 17, 23)).astype(np.float32)
    ref = np.asarray(jax.lax.reduce_window(
        d, -np.inf, jax.lax.max, (1, 3, 3), (1, 1, 1), "SAME"))
    np.testing.assert_array_equal(tf.dilate3x3_max(_t(d)).numpy(), ref)


def test_samplers_match_jax():
    """Plain K2: nearest (half up, exact) and bilinear samples agree with
    the XLA twins, including .5 ties and clamped out-of-range points."""
    rng = np.random.default_rng(6)
    img = rng.uniform(0, 255, (12, 20)).astype(np.float32)
    col = rng.uniform(-3, 23, (12, 20)).astype(np.float32)
    row = rng.uniform(-3, 15, (12, 20)).astype(np.float32)
    col[0, :8] = np.arange(8) + 0.5  # exact ties round up
    n_ref = np.asarray(jf.nearest_sample(img, col, row))
    np.testing.assert_array_equal(
        tf.nearest_sample(_t(img), _t(col), _t(row)).numpy(), n_ref)
    b_ref = np.asarray(jf.bilinear_sample(img, col, row))
    np.testing.assert_allclose(
        tf.bilinear_sample(_t(img), _t(col), _t(row)).numpy(), b_ref,
        rtol=0, atol=1e-3)


def test_projected_image_bilinear_shadow_matches_jax_kernel(monkeypatch):
    """--shadow-sample bilinear against the JAX package's TPU path: its
    projection with the dual-source kernel in interpret mode and
    ``nearest_a=False`` (the JAX CPU path always samples nearest). The
    kernel's tile base fit differs from a plain gather in the last bits,
    so masks agree on all but 0.1% of pixels and intensities to 1e-2."""
    import functools

    from meshrecon.flow.tile_warp import tile_warp_sample2_batched

    monkeypatch.setattr(jf, "tile_warp_sample2_batched", functools.partial(
        tile_warp_sample2_batched, interpret=True))
    h, w = 48, 64
    mains, dm, frames, sides, ds = _inputs(2, 2, h, w, seed=2)
    jf.set_shadow_sample("bilinear")
    try:
        j_int, j_mask = (np.asarray(a) for a in jf.projected_image_batched(
            mains, dm, frames, sides, ds, engine="pallas"))
    finally:
        jf.set_shadow_sample("nearest")
    t_int, t_mask = tf.projected_image_batched(
        _t(mains), _t(dm), _t(frames), _t(sides), _t(ds),
        shadow_sample="bilinear")
    t_int, t_mask = t_int.numpy(), t_mask.numpy()
    assert j_mask.mean() > 0.05
    assert np.mean(t_mask != j_mask) <= 1e-3
    both = t_mask & j_mask
    np.testing.assert_allclose(t_int[both], j_int[both], rtol=0, atol=1e-2)


def test_sample2_modes_are_the_plain_samplers():
    """K2's plain version: source A nearest by default, bilinear with
    ``bilinear_a``, on B's coordinates; source B bilinear either way."""
    from meshrecon_torch.flow.tile_warp import tile_warp_sample2_batched as t2

    rng = np.random.default_rng(7)
    a, b = (_t(rng.uniform(0, 255, (2, 12, 20)).astype(np.float32))
            for _ in range(2))
    col = _t(rng.uniform(-3, 23, (2, 12, 20)).astype(np.float32))
    row = _t(rng.uniform(-3, 15, (2, 12, 20)).astype(np.float32))
    for bilinear_a, sample_a in ((False, tf.nearest_sample),
                                 (True, tf.bilinear_sample)):
        oa, ob = t2(a, b, col, row, bilinear_a=bilinear_a)
        assert torch.equal(oa, sample_a(a, col, row))
        assert torch.equal(ob, tf.bilinear_sample(b, col, row))
