"""K3b's tap windows (csrc/warp.cu, ``warp_bicubic_kernel``) modelled in
torch ops on the CPU.

The kernel runs K3's grid (a warp across a row, 8 rows a CTA, images on
the grid's z) with two pixels a thread 32 columns apart, so a warp holds
64 consecutive columns of one row. Each pixel's 4x4 tap window starts at
(c0 - 1, r0 - 1), its origin floor(x) clamped to [-3, n + 2] as a float
before the conversion. A warp whose every window lies inside the image
reads the 16 taps from one corner pointer with no clamp; any other warp
clamps each tap to the border. The model below does the same per warp
(``tile_warp.bicubic_warp_paths`` gives the choice, as the kernel makes
it), checks the kernel's premise that the unclamped index equals the
clamped one wherever a warp reads unclamped, and must equal
``flow_remap`` (K3b's plain version) bit for bit, NaN where it is NaN;
and the JAX package's ``flow_remap`` within tests/test_torch_flow.py's
1e-4 (the same polynomial weights and tap order; XLA's CPU backend
contracts multiply-adds). Cases: ragged shapes (rows not a multiple of 8,
columns not of 64), flows off every border, a field whose warps take both
paths, far-off and NaN coordinates; and the path shares of the flow field
``chip_smoke.py`` times K3b on.
"""

import numpy as np
import pytest
import torch

from meshrecon.flow import remap as jr
from meshrecon_torch.flow import tile_warp
from meshrecon_torch.flow.remap import _cubic_weights, flow_remap

torch.set_num_threads(1)

SPAN = tile_warp.K3B_COLS * tile_warp.K3B_PIX  # columns a warp


def k3b_model(images, u, v):
    """K3b's output, computed per warp as the kernel does: (..., H, W)."""
    h, w = images.shape[-2:]
    cols = torch.arange(w, dtype=torch.float32)
    rows = torch.arange(h, dtype=torch.float32)[:, None]
    col, row = cols + u, rows + v
    wc = _cubic_weights(col - torch.floor(col))
    wr = _cubic_weights(row - torch.floor(row))
    c0 = tile_warp._cubic_origin(col, w)
    r0 = tile_warp._cubic_origin(row, h)
    unclamped = tile_warp.bicubic_warp_paths(u, v).repeat_interleave(
        SPAN, -1)[..., :w]
    flat = images.reshape(*images.shape[:-2], h * w)
    corner = (r0 - 1) * w + (c0 - 1)
    out = torch.zeros_like(col)
    for i in range(4):
        ri = (r0 + (i - 1)).clamp(0, h - 1)
        row_acc = torch.zeros_like(col)
        for j in range(4):
            clamped = ri * w + (c0 + (j - 1)).clamp(0, w - 1)
            free = corner + i * w + j
            # the premise of the unclamped path
            assert torch.equal(free[unclamped], clamped[unclamped])
            idx = torch.where(unclamped, free, clamped)
            tap = torch.gather(flat, -1, idx.reshape(flat.shape)).reshape(
                idx.shape)
            row_acc = row_acc + wc[j] * tap
        out = out + wr[i] * row_acc
    return out


def _same_bits(a, b):
    """Equal bit for bit, NaN where the other is NaN."""
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(
        torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0))


def _smooth(rng, shape, scale):
    """Smooth random field of amplitude ``scale``: numpy noise box-blurred
    twice (9x9), as chip_smoke.py's ``_smooth_field``."""
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    lead = x.shape[:-2]
    x = x.reshape(-1, *x.shape[-2:])
    for _ in range(2):
        x = torch.nn.functional.avg_pool2d(x[:, None], 9, 1, 4,
                                           count_include_pad=False)[:, 0]
    x = x.reshape(*lead, *x.shape[-2:])
    return x * (scale / x.abs().amax().clamp(min=1e-6))


SEEDS = {"ragged": 11, "both paths": 12, "off every border": 13}


def _case(name):
    rng = np.random.default_rng(SEEDS[name])
    if name == "ragged":
        shape = (2, 37, 53)
        img = rng.uniform(0, 255, shape).astype(np.float32)
        u = rng.normal(scale=6.0, size=shape).astype(np.float32)
        v = rng.normal(scale=6.0, size=shape).astype(np.float32)
        return torch.from_numpy(img), torch.from_numpy(u), torch.from_numpy(v)
    if name == "both paths":
        shape = (2, 45, 200)
        img = torch.from_numpy(rng.uniform(0, 255, shape).astype(np.float32))
        return img, _smooth(rng, shape, 1.5), _smooth(rng, shape, 1.5)
    if name == "off every border":
        shape = (1, 26, 130)
        img = torch.from_numpy(rng.uniform(0, 255, shape).astype(np.float32))
        u, v = _smooth(rng, shape, 2.0), _smooth(rng, shape, 2.0)
        u[..., :10] -= 25.0
        u[..., -10:] += 25.0
        v[..., :5, :] -= 25.0
        v[..., -5:, :] += 25.0
        return img, u, v
    raise KeyError(name)


@pytest.mark.parametrize("name", ["ragged", "both paths", "off every border"])
def test_model_equals_flow_remap(name):
    img, u, v = _case(name)
    ours = k3b_model(img, u, v)
    assert _same_bits(ours, flow_remap(torch.stack([u, v], -1), img))
    if name == "both paths":
        paths = tile_warp.bicubic_warp_paths(u, v)
        assert paths.any() and not paths.all()
    if name == "off every border":
        assert not tile_warp.bicubic_warp_paths(u, v).any()


@pytest.mark.parametrize("name", ["ragged", "both paths", "off every border"])
def test_model_matches_jax_flow_remap(name):
    img, u, v = _case(name)
    ours = k3b_model(img, u, v).numpy()
    flow = torch.stack([u, v], -1).numpy()
    ref = np.stack([np.asarray(jr.flow_remap(flow[i], img[i].numpy()))
                    for i in range(img.shape[0])])
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)


def test_far_off_and_nan():
    """NaN coordinates clamp their origin to -3 before the warp's vote, so
    one NaN puts its warp on the clamped path and only its pixel is NaN;
    coordinates a billion pixels off read border taps."""
    rng = np.random.default_rng(5)
    shape = (2, 19, 150)
    img = torch.from_numpy(rng.uniform(0, 255, shape).astype(np.float32))
    u, v = _smooth(rng, shape, 1.0), _smooth(rng, shape, 1.0)
    u[0, 5, 70] = v[1, 10, 20] = u[0, 9, 9] = float("nan")
    u[0, 12, 100] = v[1, 3, 140] = 1e9
    u[1, 15, 66] = v[0, 8, 33] = -1e9
    ours = k3b_model(img, u, v)
    ref = flow_remap(torch.stack([u, v], -1), img)
    assert _same_bits(ours, ref)
    nan_px = u.isnan() | v.isnan()
    assert torch.equal(ours.isnan(), nan_px)
    paths = tile_warp.bicubic_warp_paths(u, v)
    assert paths.any()
    # a warp holding a NaN or far-off pixel clamps
    far = nan_px | (u.abs() > 1e8) | (v.abs() > 1e8)
    hit = torch.nn.functional.pad(far, (0, paths.shape[-1] * SPAN - 150))
    hit = hit.reshape(*far.shape[:-1], -1, SPAN).any(-1)
    assert not paths[hit].any()


@pytest.mark.parametrize("h,w", [(37, 53), (9, 64), (8, 65), (480, 640)])
def test_path_grid_covers_the_image(h, w):
    """The mirror's warps: ceil(W / 64) a row, each of 64 columns, lanes
    past the last column sampling it; a still field at 480x640 reads
    unclamped everywhere but the first and last warp of a row and the
    rows within 1 of the top and 2 of the bottom."""
    z = torch.zeros((1, h, w))
    paths = tile_warp.bicubic_warp_paths(z, z)
    assert paths.shape == (1, h, -(-w // SPAN))
    if (h, w) == (480, 640):
        assert not paths[0, :, 0].any() and not paths[0, :, -1].any()
        assert not paths[0, 0].any() and not paths[0, -2:].any()
        assert paths[0, 1:-2, 1:-1].all()


def test_smoke_field_shares():
    """The field chip_smoke.py times K3b on (12x480x640: a smooth flow of
    up to 3 px, pushed 20 px off the left border on its first 16 columns
    and off the bottom on its last 8 rows): blocks 1-8 of rows 4-471 read
    unclamped, the first warp of every row and the pushed rows clamp, and
    the last warp of a row reads unclamped only where no pixel's flow takes
    it within 2 columns of the right border: 78-88% of the warps."""
    rng = np.random.default_rng(1)
    shape = (12, 480, 640)
    u, v = _smooth(rng, shape, 3.0), _smooth(rng, shape, 3.0)
    u[..., :16] -= 20.0
    v[..., -8:, :] += 20.0
    paths = tile_warp.bicubic_warp_paths(u, v)
    assert paths.shape == (12, 480, 10)
    assert paths[:, 4:472, 1:9].all()
    assert not paths[..., 0].any() and not paths[:, 472:].any()
    share = paths.float().mean().item()
    print(f"smoke field: {share:.4f} of the warps read unclamped")
    assert 0.78 <= share <= 0.88
