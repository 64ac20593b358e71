"""The plane sweep of the hybrid default's first iteration: K3c's plain
version, ``plane_sweep_depth_batched``, ``splat_visibility`` and
``fused_sweep_update_batched`` of meshrecon_torch against meshrecon on the
CPU, at 48x64 with 16 depth planes.

Tolerances, and why: K3c's plain version repeats ``bilinear_sample``'s
arithmetic, so it equals the JAX sampler to float32 rounding (1e-4 on the
0..255 scale) on valid pixels and is exactly 0 elsewhere; against the
TPU kernel itself (interpret mode) 1e-2, since that kernel rounds a tile
base and a residual apart. The sweep keeps
the plane of least cost per pixel; the JAX CPU backend rounds the
per-plane coordinate transform with fused multiply-adds and torch does
not, so at a near tie of two planes' costs the choice can flip. Measured
here: the sweep's valid masks equal, depth within 2.8e-6 NDC and cost
within 1e-3 everywhere (bounds: 99% within 1e-4, 99.5%); the sweep update
at passes 1 and 2: rendered depth within 1.1e-6, valid masks equal, and
point4, pdf and the normals' axis within their bounds on every pixel.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from meshrecon.depth import plane_sweep as j_ps
from meshrecon.flow.tile_warp import tile_warp_sample_batched as j_tws
from meshrecon.io.synthetic import synthetic_frames
from meshrecon.io.tracks import load_tracks
from meshrecon.pipeline import fused as j_fused
from meshrecon.pipeline.config import Config as JConfig
from meshrecon.pipeline.heuristic import Heuristic as JHeuristic
from meshrecon.raster import Renderer as JRenderer
from meshrecon.raster.fragment import bilinear_sample as j_bilinear
from meshrecon_torch import state
from meshrecon_torch.depth import plane_sweep
from meshrecon_torch.flow import tile_warp
from meshrecon_torch.geometry.camera import np_extract_camera_center
from meshrecon_torch.pipeline.fused import (FusedSweepUpdate,
                                            fused_sweep_update_batched,
                                            splat_visibility)
from meshrecon_torch.problems import make_camera

torch.set_num_threads(1)

H, W, D = 48, 64, 16


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def scene():
    """koule-tr at 64x48 (JAX-made frames), the iteration-1 alpha-shape
    soup, and two bundles padded to K=4: the ten sweep-update inputs."""
    track = load_tracks("tracks/koule-tr.yaml")
    frames = synthetic_frames(track, W, H, mode="sphere", seed=0)
    cfg = JConfig(track=track, frames=frames, seed=3)
    hint = JHeuristic(cfg)
    hint.not_happy(track.bundles)
    mesh = hint.tessellate(track.bundles, np.zeros((len(track.bundles), 3)))
    r = JRenderer(W, H)
    r.load_mesh(mesh)
    bundles = [(0, [5, 12]), (8, [2, 20, 14])]
    b, kb, cb = len(bundles), 4, 8
    mains = np.zeros((b, 4, 4), np.float32)
    fms = np.zeros((b, H, W), np.float32)
    scs = np.tile(np.eye(4, dtype=np.float32), (b, kb, 1, 1))
    sfs = np.zeros((b, kb, H, W), np.float32)
    svs = np.zeros((b, kb), bool)
    ctrs = np.zeros((b, cb, 3), np.float32)
    cvs = np.zeros((b, cb), bool)
    ks = np.zeros(b, np.int32)
    for i, (fa, sides) in enumerate(bundles):
        mains[i] = track.cameras[fa]
        fms[i] = frames[fa]
        for j, fb in enumerate(sides):
            scs[i, j] = track.cameras[fb]
            sfs[i, j] = frames[fb]
            svs[i, j] = True
        ctr = [np_extract_camera_center(track.cameras[f])
               for f in [fa] + sides]
        c3 = np.stack([c[:3] / c[3] for c in ctr]).astype(np.float32)
        ctrs[i, : len(c3)] = c3
        cvs[i, : len(c3)] = True
        ks[i] = len(sides)
    return [np.asarray(r.soup), np.asarray(r.soup_valid), mains, fms, scs,
            sfs, svs, ctrs, cvs, ks]


def _sweep_coords(seed=4, n=3, h=H, w=W):
    """A side stack and one depth plane's (scol, srow, valid) fields of a
    real camera pair, so off-frame and behind-camera pixels are invalid."""
    rng = np.random.default_rng(seed)
    srcs = rng.uniform(0, 255, (n, h, w)).astype(np.float32)
    main = make_camera(eye=(0, 0, 0))
    cm = np.stack([make_camera(eye=(2.0 * i - 2.0, 0.6, 0.8))
                   @ np.linalg.inv(main) for i in range(n)])
    cols = (np.arange(w) - w / 2.0) * 2.0 / w
    rows = (h / 2.0 - np.arange(h)) * 2.0 / h
    x, y = np.meshgrid(cols, rows)
    ndc = np.stack([x, y, np.full_like(x, 0.9), np.ones_like(x)], -1)
    p = np.einsum("kij,hwj->khwi", cm, ndc)
    sw = p[..., 3]
    ok = sw > 1e-6
    sw = np.where(np.abs(sw) < 1e-6, 1e-6, sw)
    sx, sy = p[..., 0] / sw, p[..., 1] / sw
    ok &= (np.abs(sx) < 1.0) & (np.abs(sy) < 1.0)
    scol = ((sx + 1.0) * 0.5 * w).astype(np.float32)
    srow = ((1.0 - sy) * 0.5 * h).astype(np.float32)
    return srcs, scol, srow, ok


def test_k3c_plain_matches_jax():
    """K3c's plain version against the JAX kernel run in interpret mode and
    against ``bilinear_sample``, on the valid pixels; 0 elsewhere."""
    srcs, scol, srow, ok = _sweep_coords()
    assert 0.2 < ok.mean() < 0.95
    ours = tile_warp.tile_warp_sample_batched(_t(srcs), _t(scol), _t(srow),
                                              _t(ok)).numpy()
    assert (ours[~ok] == 0.0).all()
    ref_xla = np.stack([np.asarray(j_bilinear(jnp.asarray(s), jnp.asarray(c),
                                              jnp.asarray(r)))
                        for s, c, r in zip(srcs, scol, srow)])
    np.testing.assert_allclose(ours[ok], ref_xla[ok], rtol=0, atol=1e-4)
    ref_kernel = np.asarray(j_tws(jnp.asarray(srcs), jnp.asarray(scol),
                                  jnp.asarray(srow), valid=jnp.asarray(ok),
                                  r_col=24, interpret=True))
    # the TPU kernel splits each coordinate into a tile base plus a
    # residual, which rounds differently: measured 4.5e-3 at most
    np.testing.assert_allclose(ours[ok], ref_kernel[ok], rtol=0, atol=1e-2)


def test_k3c_wrapper_plain_on_cpu():
    """On a CPU tensor the wrapper takes the plain version and counts no
    launch."""
    srcs, scol, srow, ok = _sweep_coords(seed=5, n=2, h=9, w=13)
    before = tile_warp.K3C.launches
    out = tile_warp.tile_warp_sample_batched(_t(srcs), _t(scol), _t(srow),
                                             _t(ok))
    plain = tile_warp.sample_bilinear_masked_plain(_t(srcs), _t(scol),
                                                   _t(srow), _t(ok))
    assert torch.equal(out, plain)
    assert tile_warp.K3C.launches == before


def test_box3_matches_jax():
    x = np.random.default_rng(0).normal(size=(2, 3, 7, 9)).astype(np.float32)
    np.testing.assert_allclose(plane_sweep._box3(_t(x)).numpy(),
                               np.asarray(j_ps._box3(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


def _sweep_agree(ours, ref, depth_share=0.99):
    np.testing.assert_array_equal(ours["valid"], ref["valid"])
    both = ref["valid"]
    assert both.mean() > 0.2
    close = np.abs(ours["depth"] - ref["depth"]) <= 1e-4
    assert close[both].mean() >= depth_share, close[both].mean()
    cost_close = np.abs(ours["cost"] - ref["cost"]) <= 1e-3 * (
        1.0 + np.abs(ref["cost"]))
    assert cost_close[both].mean() >= 0.995


def test_plane_sweep_batched_matches_jax(scene):
    soup, _, mains, fms, scs, sfs, svs, *_ = scene
    rng = np.random.default_rng(2)
    swt = (rng.uniform(size=sfs.shape) > 0.2).astype(np.float32)
    zlo = np.array([-0.2, 0.0], np.float32)
    zhi = np.array([0.9, 0.95], np.float32)
    ref = {k: np.asarray(v) for k, v in j_ps.plane_sweep_depth_batched(
        fms, sfs, mains, scs, svs, zlo, zhi, num_depths=D, engine="xla",
        side_weight=swt).items()}
    ours = {k: v.numpy() for k, v in plane_sweep.plane_sweep_depth_batched(
        _t(fms), _t(sfs), _t(mains), _t(scs), _t(svs), _t(zlo), _t(zhi),
        num_depths=D, side_weight=_t(swt)).items()}
    _sweep_agree(ours, ref)


def test_splat_visibility_matches_jax(scene):
    _, _, mains, _, scs, *_ = scene
    rng = np.random.default_rng(3)
    depth = rng.uniform(0.2, 0.9, (2, H, W)).astype(np.float32)
    inv = np.linalg.inv(mains.astype(np.float64))
    cols = (np.arange(W) - W / 2.0) * 2.0 / W
    rows = (H / 2.0 - np.arange(H)) * 2.0 / H
    x, y = np.meshgrid(cols, rows)
    ndc = np.stack([np.broadcast_to(x, depth.shape),
                    np.broadcast_to(y, depth.shape), depth,
                    np.ones_like(depth)], -1)
    pts4 = np.einsum("bij,bhwj->bhwi", inv, ndc).astype(np.float32)
    valid = rng.uniform(size=depth.shape) > 0.1
    ref = np.asarray(j_fused.splat_visibility(jnp.asarray(pts4),
                                              jnp.asarray(valid),
                                              jnp.asarray(scs), H, W))
    ours = splat_visibility(_t(pts4), _t(valid), _t(scs), H, W).numpy()
    assert ref.mean() > 0.2
    assert (ours == ref).mean() >= 0.999


@pytest.mark.parametrize("passes", [1, 2])
def test_fused_sweep_update_matches_jax(scene, passes):
    ref = {k: np.asarray(v) for k, v in j_fused.fused_sweep_update_batched(
        *scene, height=H, width=W, num_depths=D, use_pallas=False,
        passes=passes).items()}
    ours = state.to_numpy(fused_sweep_update_batched(
        *state.from_numpy(scene, "cpu"), H, W, num_depths=D, passes=passes))
    # the rendered depth: last-bit differences of the two renderers
    np.testing.assert_allclose(ours["depth"], ref["depth"], rtol=0,
                               atol=1e-5)
    agree = (ours["valid"] == ref["valid"]).mean()
    assert agree >= 0.995, agree
    both = ours["valid"] & ref["valid"]
    assert both.mean() > 0.1
    p_o, p_r = ours["point4"][both], ref["point4"][both]
    v_o, v_r = p_o[:, :3] / p_o[:, 3:4], p_r[:, :3] / p_r[:, 3:4]
    close = np.linalg.norm(v_o - v_r, axis=1) <= 1e-3 * np.linalg.norm(
        v_r, axis=1)
    assert close.mean() >= 0.99, close.mean()
    pdf_close = np.abs(ours["pdf"][both] - ref["pdf"][both]) <= 1e-3
    assert pdf_close.mean() >= 0.99
    n_o, n_r = ours["normals"][both], ref["normals"][both]
    cos = np.sum(n_o * n_r, -1) / np.maximum(
        np.linalg.norm(n_o, axis=-1) * np.linalg.norm(n_r, axis=-1), 1e-20)
    assert (cos > 0.99).mean() >= 0.97
    for key in ("point4", "normals", "pdf"):
        assert np.isfinite(ours[key][ours["valid"]]).all(), key


def test_sweep_module_equals_function(scene):
    t = state.from_numpy(scene, "cpu")
    out = FusedSweepUpdate(H, W, num_depths=8)(*t)
    ref = fused_sweep_update_batched(*t, H, W, num_depths=8)
    for key in ("point4", "normals", "pdf", "valid", "depth"):
        assert torch.equal(out[key], ref[key]), key
