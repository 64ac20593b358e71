"""The tile axis (meshrecon_torch/sharding/tiles.py) on the CPU: image rows
split over ``[torch.device("cpu")] * n`` as a tile group.

Every banded stage, and the tile-sharded updates on (4, 2), (2, 4) and
(1, 4) meshes, equal the port's own unsharded functions bit for bit: each
stage computes a kept pixel with the whole frame's operations on the whole
frame's values (the warps and samplers at the pixel's global row), and the
Gauss-Newton exit sums its active-pixel count over the group.

One stage is bitwise only where the width allows: the normals. On the CPU
torch computes acos, cos and pow (and log and exp) with SIMD for whole
vectors and with scalar code for a loop's tail, and the two round apart
in the last bit; a band's loop puts its tail on other pixels than the
whole frame's. At widths of a multiple of 32 floats, every test's shape
below but one, no loop has a tail and the normals are equal bit for bit;
at W = 24 the normals differed on 3 of 1,536 values by 6.0e-8 on an
AVX-512 host (measured; a host of another SIMD width has its tails
elsewhere),
so that case holds them to meshrecon_torch/parity.py's bounds. On the card
an elementwise kernel computes every element the same way. Against the JAX package's own tile-sharded run
((4, 2) on its eight virtual devices, at its tests' shapes) the bounds are
tests/test_torch_sharding.py's: the dense update's valid masks equal,
point4 within 1e-4, the normals' axis within 1e-3 on 99% of valid pixels;
the fused update within meshrecon_torch/parity.py's bounds and point4
within 1e-3.
"""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as g
from meshrecon.sharding import make_device_mesh as j_device_mesh
from meshrecon.sharding import sharded_dense_update as j_sharded_dense
from meshrecon.sharding import sharded_fused_update as j_sharded_fused
from meshrecon_torch import parity, state
from meshrecon_torch.depth.normals import estimate_normals_batched
from meshrecon_torch.depth.triangulate import (GaussNewtonBand, gauss_newton,
                                               triangulate_pixels_batched)
from meshrecon_torch.flow.pyramid import compare
from meshrecon_torch.flow.tile_warp import tile_warp_flow_batched
from meshrecon_torch.flow.variational import variational_flow
from meshrecon_torch.pipeline.fused import fused_main_update_batched
from meshrecon_torch.raster.binned import render_depth_binned
from meshrecon_torch.raster.fragment import projected_image_batched
from meshrecon_torch.raster.rasterizer import render_depth
from meshrecon_torch.sharding import (dense_update_batch, make_device_mesh,
                                      make_scene_mesh, sharded_dense_update,
                                      sharded_fused_update,
                                      sharded_multi_scene_fused, tiles)
from tests.test_sharding import _problem
from tests.test_torch_sharding import _check_dense

torch.set_num_threads(1)

CPU = torch.device("cpu")
KEYS = ("point4", "normals", "pdf", "valid", "depth")


def cpus(n):
    return [CPU] * n


def _t(args):
    return [torch.from_numpy(np.asarray(a)) for a in args]


def _equal(ours, ref, keys=KEYS):
    for key in keys:
        assert torch.equal(ours[key], ref[key]), key


def _smooth(shape, scale, seed):
    """A smooth random field (B, K, H, W): a few low-frequency waves."""
    rng = np.random.default_rng(seed)
    h, w = shape[-2:]
    r = np.arange(h)[:, None] / h
    c = np.arange(w)[None, :] / w
    out = np.zeros(shape, np.float32)
    for _ in range(3):
        a, fr, fc, ph = rng.uniform(0.2, 1.0, 4)
        out += (a * np.sin(2 * np.pi * (fr * r + fc * c) + 6 * ph)).astype(
            np.float32)
    return torch.from_numpy(out * scale / 3.0)


# ---- the band split and the exchange -------------------------------------

@pytest.mark.parametrize("height,n,starts", [
    (128, 4, (0, 32, 64, 96, 128)),   # aligned to 16
    (480, 4, (0, 128, 240, 352, 480)),
    (50, 4, (0, 12, 24, 36, 50)),     # uneven: aligned to 4, last band 14
    (16, 4, (0, 4, 8, 12, 16)),
    (7, 3, (0, 2, 5, 7)),
])
def test_band_starts(height, n, starts):
    assert tiles.band_starts(height, n) == starts
    sizes = np.diff(starts)
    assert sizes.min() >= 2 and sizes.max() - sizes.min() <= 16


@pytest.mark.parametrize("height,n", [(7, 4), (3, 2), (1, 1)])
def test_band_starts_too_few_rows_raise(height, n):
    with pytest.raises(ValueError, match=f"{height} rows cannot make {n} "
                                         "bands"):
        tiles.band_starts(height, n)


def test_rows_across_owners():
    """A window deeper than a band copies its rows from every band it
    meets, and counts the bytes that came from other bands."""
    x = torch.arange(3 * 32 * 5, dtype=torch.float32).reshape(3, 32, 5)
    grp = tiles.TileGroup(cpus(4), 32)
    plane = grp.scatter(x)
    assert grp.starts == (0, 8, 16, 24, 32)
    win = grp.rows(plane, 8 - 10, 16 + 10, 1)  # the normals' halo over 8 rows
    assert torch.equal(win, x[:, 0:26])
    assert grp.exchanged == 3 * (8 + 10) * 5 * 4
    assert torch.equal(grp.rows(plane, 9, 12, 1), x[:, 9:12])
    assert grp.exchanged == 3 * 18 * 5 * 4  # its own rows: no copy
    assert torch.equal(grp.gather(plane, CPU), x)
    for whole in grp.all_gather(plane):
        assert torch.equal(whole, x)


# ---- each banded stage against the whole one --------------------------------

def _fused_inputs(b=2, k=2, h=64, w=32, seed=0):
    return state.from_numpy(g._fused_problem(b=b, k=k, h=h, w=w, seed=seed),
                            "cpu")


@pytest.mark.parametrize("rows", [(0, 64), (5, 37), (63, 64), (16, 32)])
def test_render_window_bitwise(rows):
    """The plain render's row window (K1's plain version) equals the whole
    render's rows, not aligned to the 16-row tile, one row, the whole."""
    soup, soup_valid, mains, _, sides = _fused_inputs()[:5]
    cams = torch.cat([mains, sides.reshape(-1, 4, 4)])
    whole = render_depth(cams, soup, soup_valid, 64, 32)
    assert (whole < 1.0).float().mean() > 0.05
    got = render_depth_binned(cams, soup, soup_valid, 64, 32, rows=rows)
    assert torch.equal(got, whole[:, rows[0]:rows[1]])


def test_projective_texturing_bitwise():
    """A band's texturing (its main pixels' global rows; the side frames
    and the dilated side depths whole) equals the whole frame's rows."""
    soup, soup_valid, mains, _, sides, side_frames = _fused_inputs()[:6]
    b, k = side_frames.shape[:2]
    cams = torch.cat([mains[:, None], sides], 1).reshape(-1, 4, 4)
    depths = render_depth(cams, soup, soup_valid, 64, 32).reshape(
        b, k + 1, 64, 32)
    for mode in ("nearest", "bilinear"):
        whole = projected_image_batched(mains, depths[:, 0], side_frames,
                                        sides, depths[:, 1:], mode)
        from meshrecon_torch.raster.fragment import dilate3x3_max
        shadow = dilate3x3_max(depths[:, 1:])
        for lo, hi in ((0, 16), (16, 48), (48, 64)):
            band = projected_image_batched(
                mains, depths[:, 0, lo:hi], side_frames, sides, None, mode,
                row0=lo, shadow=shadow)
            for a, c in zip(band, whole):
                assert torch.equal(a, c[..., lo:hi, :])


def _planes(h=64, w=32, seed=0):
    rng = np.random.default_rng(seed)
    prev = torch.from_numpy(rng.uniform(0, 255, (2, 1, h, w)).astype(
        np.float32))
    nxt = prev + _smooth((2, 3, h, w), 6.0, seed) + torch.from_numpy(
        rng.normal(0, 2, (2, 3, h, w)).astype(np.float32))
    return prev, nxt.contiguous()


def test_compare_bitwise():
    prev, nxt = _planes(h=128)
    grp = tiles.TileGroup(cpus(4), 128)
    got = tiles.compare(grp, grp.scatter(prev), grp.scatter(nxt))
    assert torch.equal(grp.gather(got, CPU), compare(prev, nxt))
    # every level above 2 rows a band stays in bands: nothing gathered
    assert grp.gathered == []


@pytest.mark.parametrize("solver", ["cheb", "jacobi"])
def test_variational_flow_bitwise(solver):
    prev, nxt = _planes()
    ref, ref_res = variational_flow(prev, nxt, levels=2, warps=1,
                                    solver=solver, want_residual=True)
    grp = tiles.TileGroup(cpus(4), 64)
    u, v, res = tiles.variational_flow(grp, grp.scatter(prev),
                                       grp.scatter(nxt), levels=2, warps=1,
                                       solver=solver, want_residual=True)
    assert torch.equal(grp.gather(u, CPU), ref[..., 0])
    assert torch.equal(grp.gather(v, CPU), ref[..., 1])
    assert torch.equal(grp.gather(res, CPU), ref_res)


@pytest.mark.parametrize("taps", [2, 4])
def test_warp_past_the_next_band_bitwise(taps):
    """|v| = a band + 3 rows: a band's samples come from two bands away;
    fractional flows, so a local row would round r + v otherwise."""
    rng = np.random.default_rng(7)
    img = torch.from_numpy(rng.uniform(0, 255, (3, 64, 32)).astype(np.float32))
    u = _smooth((3, 64, 32), 3.0, 1)
    v = torch.from_numpy(rng.uniform(-1, 1, (3, 64, 32)).astype(np.float32))
    v[1] = v[1] * 0.5 + 19.3          # down by a band (16) + 3 rows
    v[2] = v[2] * 0.5 - 19.3          # and up
    grp = tiles.TileGroup(cpus(4), 64)
    band = 16
    assert v.abs().max() > band + 3
    got = grp.warp(grp.scatter(img), grp.scatter(u), grp.scatter(v), taps)
    assert torch.equal(grp.gather(got, CPU),
                       tile_warp_flow_batched(img, u, v, taps))
    windows = [w for w in grp.log if w["stage"] == "warp"]
    assert windows[1]["w1"] - windows[1]["hi"] >= band + 3 + taps // 2


@pytest.mark.parametrize("w", [32, 24])
def test_normals_bitwise(w):
    """Normals in windows of reach 10 over 8-row bands: the halo reaches
    past the neighbour. Bit for bit at W = 32; at W = 24 within parity.py's
    bounds (module docstring)."""
    rng = np.random.default_rng(3)
    b, h = 2, 32
    p4 = torch.from_numpy(np.concatenate([
        rng.normal(size=(b, h, w, 3)), np.ones((b, h, w, 1))], -1).astype(
            np.float32))
    valid = torch.from_numpy(rng.uniform(size=(b, h, w)) > 0.2)
    pdf = torch.from_numpy(rng.uniform(0.1, 2, (b, h, w)).astype(np.float32))
    centers = torch.from_numpy(rng.normal(size=(b, 3, 3)).astype(np.float32))
    cvalid = torch.ones(b, 3, dtype=torch.bool)
    n_side = torch.full((b,), 2)
    ref = estimate_normals_batched(p4, valid, pdf, centers, cvalid, n_side)
    grp = tiles.TileGroup(cpus(4), h)
    rep = grp.replicate
    got = grp.gather(tiles.normals(
        grp, grp.scatter(p4, axis=-3), grp.scatter(valid), grp.scatter(pdf),
        rep(centers), rep(cvalid), rep(n_side)), CPU)
    if w % 32 == 0:
        assert torch.equal(got, ref)
        return
    diff = (got - ref).abs()
    # the tail's place follows the CPU's SIMD width: none may differ
    assert diff.max() <= 1e-6 and (diff > 0).float().mean() < 0.01
    same = dict(point4=p4.numpy(), pdf=pdf.numpy(), valid=valid.numpy(),
                depth=pdf.numpy())
    parity.check_slice(dict(same, normals=got.numpy()),
                       dict(same, normals=ref.numpy()))


def _gn_problem():
    """Triangulation inputs whose top band holds a few valid pixels and
    whose bottom band a whole plane, with flows that keep many pixels
    moving: the top band alone would exit after 6 sweeps, the frame
    sweeps 50."""
    h, w = 64, 32
    _, fp, mains, sides, sv, depths = _problem(b=2, k=2, h=h, w=w,
                                               seed=1)[:6]
    rng = np.random.default_rng(0)
    shape = fp.shape
    flx = rng.normal(scale=30, size=shape).astype(np.float32)
    fly = rng.normal(scale=2, size=shape).astype(np.float32)
    var = rng.uniform(0.5, 30, size=shape).astype(np.float32)
    depths = depths.copy()
    depths[:, :32] = 1.0
    depths[:, 20:22, 5:25] = _problem(b=2, k=2, h=h, w=w,
                                      seed=1)[5][:, 20:22, 5:25]
    return _t((flx, fly, var, mains, sides, sv, depths))


@pytest.mark.parametrize("sampling", ["taylor", "exact"])
def test_triangulation_group_exit_bitwise(sampling):
    flx, fly, var, mains, sides, sv, depth = _gn_problem()
    h = depth.shape[-2]
    ref = triangulate_pixels_batched(flx, fly, var, mains, sides, sv, depth,
                                     sampling=sampling)
    grp = tiles.TileGroup(cpus(2), h)
    sc, rep = grp.scatter, grp.replicate
    p4, pdf, valid, sweeps = tiles.triangulate(
        grp, sc(flx), sc(fly), sc(var), rep(mains), rep(sides), rep(sv),
        sc(depth), sampling)
    assert sweeps == ref["gn_sweeps"] == 50
    for plane, key in ((p4, "point4"), (pdf, "pdf"), (valid, "valid")):
        assert torch.equal(grp.gather(plane, CPU), ref[key]), key
    reach = [w["reach"] for w in grp.log if w["stage"] == "triangulate"]
    want = 1 if sampling == "taylor" else int(np.ceil(fly.abs().max().item())) + 2
    assert reach == [want, want] and want < 32
    # each band exiting alone: the top band stops after 6 sweeps, and its
    # points move
    alone = []
    for lo, hi in zip(grp.starts, grp.starts[1:]):
        w0, w1 = max(lo - want, 0), min(hi + want, h)
        band = GaussNewtonBand(flx[..., lo:hi, :], fly[..., lo:hi, :],
                               var[..., lo:hi, :], mains, sides, sv,
                               depth[:, w0:w1], sampling, row0=lo, height=h,
                               depth_row0=w0)
        alone.append((gauss_newton([band]), band.result(0)["point4"]))
    assert [s for s, _ in alone] == [6, 50]
    assert not torch.equal(alone[0][1], ref["point4"][:, :32])


# ---- the sharded updates ----------------------------------------------------

@pytest.mark.parametrize("n_camera,n_tile", [(4, 2), (2, 4), (1, 4)])
def test_tiled_fused_update_bitwise(n_camera, n_tile):
    h = w = 32
    args = state.from_numpy(g._fused_problem(b=4, k=2, h=h, w=w), "cpu")
    mesh = make_device_mesh(n_camera, n_tile, devices=cpus(8))
    out = sharded_fused_update(mesh, h, w)(*args)
    ref = fused_main_update_batched(*args, h, w)
    _equal(out, ref)
    # the group's own gn_sweeps: the unsharded count
    grp = tiles.TileGroup(cpus(n_tile), h)
    assert tiles.fused_update(grp, *args, h, w)["gn_sweeps"] \
        == ref["gn_sweeps"]


@pytest.mark.parametrize("n_camera,n_tile", [(4, 2), (2, 4), (1, 4)])
def test_tiled_dense_update_bitwise(n_camera, n_tile):
    args = _problem()
    out = sharded_dense_update(make_device_mesh(n_camera, n_tile,
                                                devices=cpus(8)))(*args)
    ref = dense_update_batch(*_t(args), flow_quality="fast")
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def jax_tiled():
    """JAX's own tile-sharded runs on its (4, 2) mesh at its tests'
    shapes: the dense update at 16x32, the fused at 32x32."""
    dense_args = _problem()
    fused_args = g._fused_problem(b=4, k=2, h=32, w=32)
    mesh = j_device_mesh(4, 2)
    dense = [np.asarray(a) for a in j_sharded_dense(mesh)(*dense_args)]
    fused = {k: np.asarray(v) for k, v in j_sharded_fused(
        mesh, height=32, width=32)(*fused_args).items()}
    return dense_args, dense, fused_args, fused


def test_tiled_dense_update_against_jax(jax_tiled):
    args, ref = jax_tiled[:2]
    assert len(jax.devices()) == 8
    ours = sharded_dense_update(make_device_mesh(4, 2, devices=cpus(8)))(
        *args)
    _check_dense(ours, ref)


def test_tiled_fused_update_against_jax(jax_tiled):
    args, ref = jax_tiled[2:]
    ours = sharded_fused_update(make_device_mesh(4, 2, devices=cpus(8)),
                                32, 32)(*args)
    ours = {k: v.numpy() for k, v in ours.items()}
    assert ref["valid"].mean() > 0.05
    parity.check_slice(ours, ref)
    sel = ref["valid"] & ours["valid"]
    np.testing.assert_allclose(ours["point4"][sel], ref["point4"][sel],
                               rtol=1e-3, atol=1e-3)


def test_window_extents():
    """At 128x32 with 4 bands of 32 rows, every window of every stage lies
    within its band and that stage's reach, and under the image's height;
    the only planes run whole are pyramid levels of at most a quarter of
    the pixels."""
    h, w = 128, 32
    args = state.from_numpy(g._fused_problem(b=1, k=2, h=h, w=w), "cpu")
    for opts in ({}, dict(sampling="exact", variance="rewarp")):
        grp = tiles.TileGroup(cpus(4), h)
        out = tiles.fused_update(grp, *args, h, w, **opts)
        _equal(out, fused_main_update_batched(*args, h, w, **opts))
        fixed = {"dilate": 1, "pyr_down": 2, "pyr_up": 3, "hs_level": 15,
                 "residual": 1, "normals": 10}
        if "sampling" not in opts:
            fixed["triangulate"] = 1
        stages = set()
        for win in grp.log:
            stages.add(win["stage"])
            assert win["w0"] >= win["lo"] - win["reach"], win
            assert win["w1"] <= win["hi"] + win["reach"], win
            assert win["w1"] - win["w0"] < win["height"], win
            assert win["reach"] == fixed.get(win["stage"], win["reach"]), win
            assert win["reach"] < 32, win
        want = {"dilate", "pyr_down", "pyr_up", "warp", "hs_level",
                "normals", "triangulate"}
        assert want <= stages
        assert ("residual" in stages) == (opts == {})
        for stage, rows, cols in grp.gathered:
            assert stage in ("pyr_down", "pyr_up", "hs_level")
            assert rows * cols <= h * w // 4
        assert grp.exchanged > 0


def test_scene_mesh_with_a_tile_axis():
    """A scene shard runs on the first device of its (camera, tile) group:
    tile 2 gives tile 1's outputs."""
    h = w = 32
    per_scene = [g._fused_problem(b=1, k=2, h=h, w=w, seed=s)
                 for s in range(2)]
    args = tuple(np.stack([ps[i] for ps in per_scene]) for i in range(10))
    outs = [sharded_multi_scene_fused(make_scene_mesh(2, 1, t,
                                                      devices=cpus(4)),
                                      h, w)(*args) for t in (1, 2)]
    _equal(outs[1], outs[0])


@pytest.mark.parametrize("opts", [
    dict(variance="rewarp"),
    dict(variance="rewarp", variance_taps=2, shadow_sample="bilinear"),
    dict(flow_solver="jacobi", sampling="exact", iters=30),
    dict(use_farneback=True),
], ids=["rewarp", "rewarp2-bilinear", "jacobi-exact", "farneback"])
def test_options_under_the_tile_axis(opts):
    h = w = 32
    args = state.from_numpy(g._fused_problem(b=2, k=2, h=h, w=w), "cpu")
    out = sharded_fused_update(make_device_mesh(2, 2, devices=cpus(4)), h, w,
                               **opts)(*args)
    _equal(out, fused_main_update_batched(*args, h, w, **opts))


def test_multigrid_has_no_tile_form():
    with pytest.raises(ValueError, match="'mg' has no tile form"):
        sharded_fused_update(make_device_mesh(2, 2, devices=cpus(4)), 32, 32,
                             flow_solver="mg")
    # a tile axis of 1 runs it
    sharded_fused_update(make_device_mesh(2, 1, devices=cpus(2)), 32, 32,
                         flow_solver="mg")
