"""meshrecon_torch.flow.farneback and calculate_flow(use_farneback=True)
against meshrecon.flow on the CPU.

Tolerances: the flow 2e-4 px on smooth images. Both sides run the same
separable tap loops in the same order, but XLA's CPU backend contracts
multiply-adds into FMAs and sums G^-1's moment mix in its own order; the
per-pixel 2x2 solve amplifies those last bits where its determinant is
small (measured: 3.1e-5 px at most at 64x80). The variance channel 1e-3
on a 0..255 scale (the bicubic re-warp and the pyramid cascade on top).
"""

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from meshrecon.flow import api as ja
from meshrecon.flow import farneback as jf
from meshrecon_torch.flow import api as ta
from meshrecon_torch.flow import farneback as tf
from test_flow import shift_image, smooth_image

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _smooth(rng, shape, sigma=3.0):
    x = gaussian_filter(rng.normal(size=shape), sigma=sigma)
    x = (x - x.min()) / (x.max() - x.min())
    return (255.0 * x).astype(np.float32)


def _pair(h, w, seed):
    """A smooth image and a copy shifted by (-1, +1) px."""
    base = _smooth(np.random.default_rng(seed), (h + 8, w + 8))
    return base[4:4 + h, 4:4 + w], base[3:3 + h, 5:5 + w]


@pytest.mark.parametrize("h,w", [(48, 64), (64, 80)])
def test_farneback_matches_jax(h, w):
    """With the pipeline's size-dependent parameters (flow/api.py)."""
    a, b = _pair(h, w, seed=h)
    params = ta.farneback_params(h, w)
    ref = np.asarray(jf.farneback_flow(a, b, **params))
    ours = tf.farneback_flow(_t(a), _t(b), **params)
    assert ours.shape == (h, w, 2)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=2e-4)
    # the flow recovers the shift in the interior
    inner = ours.numpy()[8:-8, 8:-8]
    np.testing.assert_allclose(inner.mean((0, 1)), [-1.0, 1.0], atol=0.05)


def test_farneback_batched_matches_single():
    """prev (B, 1, H, W) against next (B, K, H, W), as the fused update
    calls it (JAX vmaps over B and K)."""
    a, b = _pair(48, 64, seed=1)
    a2, b2 = _pair(48, 64, seed=2)
    params = ta.farneback_params(48, 64)
    prev = _t(np.stack([a, a2]))[:, None]
    nxt = _t(np.stack([np.stack([b, a]), np.stack([b2, a2])]))
    out = tf.farneback_flow(prev, nxt, **params)
    assert out.shape == (2, 2, 48, 64, 2)
    for i, (p, n) in enumerate(((a, b), (a, a), (a2, b2), (a2, a2))):
        one = tf.farneback_flow(_t(p), _t(n), **params)
        np.testing.assert_allclose(out.reshape(4, 48, 64, 2)[i].numpy(),
                                   one.numpy(), rtol=0, atol=1e-5)


def test_farneback_recovers_translation():
    """The port's counterpart of tests/test_flow.py::
    test_flow_recovers_translation[farneback]: a (3, -2) px shift of a
    smooth 72x96 image, library defaults."""
    img = smooth_image(72, 96, seed=4)
    moved = shift_image(img, 3, -2)
    flow = tf.farneback_flow(_t(img.astype(np.float32)),
                             _t(moved.astype(np.float32))).numpy()
    interior = flow[12:-12, 12:-12]
    err = np.hypot(interior[..., 0] - 3, interior[..., 1] + 2)
    assert np.median(err) < 0.5, np.median(err)


def test_calculate_flow_farneback_matches_jax():
    a, b = _pair(48, 64, seed=48)
    ref = np.asarray(ja.calculate_flow(a, b, use_farneback=True))
    ours = ta.calculate_flow(_t(a), _t(b), use_farneback=True).numpy()
    assert ours.shape == (48, 64, 4)
    np.testing.assert_allclose(ours[..., :2], ref[..., :2], rtol=0,
                               atol=2e-4)
    np.testing.assert_allclose(ours[..., 2], ref[..., 2], rtol=0, atol=1e-3)
    assert np.all(ours[..., 3] == 0.0)
