"""The port's two-level binned raster (K5a/K5b's path) and its chunk sizes
against meshrecon.raster.binned on the CPU.

On the CPU the wrappers take the plain ``render_depth``, so the renders are
held against the JAX two-level kernels in interpret mode within
test_torch_raster.py's bounds (coverage on >= 99.9% of pixels, |dz| <= 1e-3
NDC where both cover): the JAX kernels bin by vertex bbox, can miss the
tie-slop fringe, and round with fused multiply-adds. The binning itself is
exact: fed the JAX wrapper's own vertex bboxes and tile size,
``bin_superchunks`` must give its kernel's chunk boxes, lists and counts
bit for bit. What the CUDA kernels compute from the port's bins is
emulated tile by tile in torch (``_walk``) and must equal the plain render
bit for bit, as K1 and K5 must on the card (test_torch_kernels_cuda.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import __graft_entry__ as g
import meshrecon.raster.binned as jbinned
from meshrecon_torch.raster import binned as tbinned
from meshrecon_torch.raster import rasterizer as tr
from meshrecon_torch.tools import raster_sweep
from tests.test_binned_raster import _soup
from tests.test_torch_raster import _assert_depth_close, _scene, _t

torch.set_num_threads(1)

FOUR_EYES = [(0.3, 0.2, 0.5), (0.0, 0.0, 0.0), (-0.2, 0.1, 0.3),
             (0.1, 0.4, -0.2)]


def _case(name):
    """(camera, soup, valid, h, w) of the JAX two-level tests
    (tests/test_binned_raster.py)."""
    if name == "sphere":
        soup, valid = _soup()
        order = jbinned.morton_order(soup)
        return (g._make_camera(eye=FOUR_EYES[0]), soup[order], valid[order],
                96, 160)
    if name == "multi_slab":  # SLAB + 512 triangles: three JAX slabs
        soup, valid = _soup(n_tris_cap=jbinned.SLAB + 512)
        return g._make_camera(eye=(0.1, -0.1, 0.2)), soup, valid, 48, 128
    raise KeyError(name)


@pytest.mark.parametrize("case", ["sphere", "multi_slab"])
def test_two_level_matches_jax_kernel(case):
    cam, soup, valid, h, w = _case(case)
    ref = np.asarray(jbinned.render_depth_binned(
        cam, soup, valid, h, w, interpret=True, two_level=True))
    ours = tbinned.render_depth_binned(_t(cam)[None], _t(soup), _t(valid),
                                       h, w, two_level=True)[0].numpy()
    assert (ours < 1.0).any()
    _assert_depth_close(ours, ref, case)


def test_batched_matches_jax_kernel():
    _, soup, valid, h, w = _case("sphere")
    cams = np.stack([g._make_camera(eye=e) for e in FOUR_EYES])
    ref = np.asarray(jbinned.render_depth_binned_batched(
        cams, soup, valid, h, w, interpret=True))
    ours = tbinned.render_depth_binned_batched(_t(cams), _t(soup), _t(valid),
                                               h, w).numpy()
    assert ours.shape == (4, h, w)
    for i in range(4):
        assert (ours[i] < 1.0).any()
        _assert_depth_close(ours[i], ref[i], "sphere")


def _jax_slabs(cam, soup, valid, h, w, chunk, monkeypatch):
    """Per slab, what the JAX two-level wrapper hands its kernel: (packed,
    lists, counts, cxmin, cxmax, cymin, cymax) as numpy arrays."""
    seen = []

    def capture(packed, lists, counts, cxmn, cxmx, cymn, cymx, height,
                width, chunk, supers, slab, interpret):
        seen.append([np.asarray(a) for a in (packed, lists, counts, cxmn,
                                             cxmx, cymn, cymx)])
        return jnp.zeros((-(-height // jbinned.TILE_H) * jbinned.TILE_H,
                          -(-width // jbinned.TILE_W) * jbinned.TILE_W),
                         jnp.float32)

    monkeypatch.setattr(jbinned, "_rasterize_slab2", capture)
    with jax.disable_jit():
        jbinned.render_depth_binned(cam, soup, valid, h, w, chunk=chunk,
                                    two_level=True)
    return seen


@pytest.mark.parametrize("case,chunk", [("sphere", 8), ("sphere", 16),
                                        ("multi_slab", 8),
                                        ("multi_slab", 64)])
def test_bin_superchunks_matches_jax(case, chunk, monkeypatch):
    """Fed the JAX wrapper's vertex bboxes and its (24, 128) tiles, the
    port's one-pass binning gives each slab's chunk boxes, and per tile the
    concatenation of the slabs' superchunk lists (ids offset by the slab)
    and the sum of their counts."""
    cam, soup, valid, h, w = _case(case)
    slabs = _jax_slabs(cam, soup, valid, h, w, chunk, monkeypatch)
    slab = jbinned.SLAB
    nsup_slab = slab // chunk // 8
    assert len(slabs) == (3 if case == "multi_slab" else 1)
    boxes = [torch.from_numpy(np.concatenate(
        [s[0][f * slab:(f + 1) * slab] for s in slabs])) for f in (12, 13, 14,
                                                                    15)]
    cboxes, lists, counts = tbinned.bin_superchunks(
        *boxes, h, w, tile_h=jbinned.TILE_H, tile_w=jbinned.TILE_W,
        chunk=chunk, supers=8)
    for i, cb in enumerate(cboxes):
        np.testing.assert_array_equal(
            cb.numpy(), np.concatenate([s[3 + i] for s in slabs]))
    nsup = nsup_slab * len(slabs)
    assert lists.shape == (len(slabs[0][2]), nsup)
    np.testing.assert_array_equal(counts.numpy(),
                                  sum(s[2] for s in slabs))
    assert counts.sum() > 0
    for t in range(lists.shape[0]):
        want = np.concatenate([s[1][t, :s[2][t]] + k * nsup_slab
                               for k, s in enumerate(slabs)])
        np.testing.assert_array_equal(lists[t, :len(want)].numpy(), want)
        assert (lists[t, len(want):] == nsup).all()  # the sentinel follows


def test_batched_lists_equal_single_camera_lists():
    _, soup, valid, h, w = _case("sphere")
    cams = _t(np.stack([g._make_camera(eye=e) for e in FOUR_EYES]))
    packed = tbinned.pack_records(cams, _t(soup), _t(valid), 64)
    boxes = packed[:, 12], packed[:, 13], packed[:, 14], packed[:, 15]
    cboxes, lists, counts = tbinned.bin_superchunks(*boxes, h, w)
    one_lists, one_counts = tbinned.bin_chunks(*boxes, h, w)
    assert counts.shape == (4, 6 * 10) and (counts > 0).any()
    for i in range(4):
        single = tbinned.bin_superchunks(*(b[i] for b in boxes), h, w)
        for a, b in zip(cboxes, single[0]):
            assert torch.equal(a[i], b)
        assert torch.equal(lists[i], single[1])
        assert torch.equal(counts[i], single[2])
        one = tbinned.bin_chunks(*(b[i] for b in boxes), h, w)
        assert torch.equal(one_lists[i], one[0])
        assert torch.equal(one_counts[i], one[1])


def test_pack_records_pads_to_whole_superchunks():
    cam, soup, valid, _, _ = _scene("near_straddle")  # 25 triangles
    packed = tbinned.pack_records(_t(cam)[None], _t(soup), _t(valid), 64)
    assert packed.shape == (1, 16, 64)
    pad = packed[0, :, 50:]
    assert (pad[2] == -1.0).all() and (pad[[0, 1]] == 0.0).all()
    assert (pad[12] > pad[13]).all() and (pad[14] > pad[15]).all()


def _walk(bins):
    """What K1 (one-level bins) or K5 (two-level bins) computes, tile by
    tile, in torch: the listed chunks (those of the listed superchunks
    whose own box hits the tile), their records whose box hits the tile,
    and the plain render's arithmetic at the tile's pixels."""
    packed, lists, counts = bins["packed"], bins["lists"], bins["counts"]
    h, w, chunk, supers = (bins[k] for k in ("height", "width", "chunk",
                                             "supers"))
    px, py = bins["grid"]
    tx0, tx1, ty0, ty1 = bins["tiles"]
    tile = tbinned.TILE
    out = torch.ones((packed.shape[0], h, w))
    for cam in range(packed.shape[0]):
        for t in range(lists.shape[1]):
            ty, tx = divmod(t, len(tx0))
            ids = lists[cam, t, :counts[cam, t]].long()
            if bins["cbox"] is not None:
                ids = (ids[:, None] * supers + torch.arange(supers)).flatten()
                cb = bins["cbox"][cam][:, ids]
                ids = ids[(cb[0] <= tx1[tx]) & (cb[1] >= tx0[tx])
                          & (cb[2] <= ty1[ty]) & (cb[3] >= ty0[ty])]
            recs = (ids[:, None] * chunk + torch.arange(chunk)).flatten()
            f = packed[cam][:, recs]
            f = f[:, (f[12] <= tx1[tx]) & (f[13] >= tx0[tx])
                  & (f[14] <= ty1[ty]) & (f[15] >= ty0[ty])]
            rows = slice(ty * tile, min(h, (ty + 1) * tile))
            cols = slice(tx * tile, min(w, (tx + 1) * tile))
            x, y = px[cols][None, None, :], py[rows][None, :, None]
            a0, b0, c0, a1, b1, c1, a2, b2, c2, z0, z1, z2 = (
                f[i][:, None, None] for i in range(12))
            l0 = a0 * x + b0 * y + c0
            l1 = a1 * x + b1 * y + c1
            l2 = a2 * x + b2 * y + c2
            zs = l0 * z0 + l1 * z1 + l2 * z2
            covered = ((l0 >= 0) & (l1 >= 0) & (l2 >= 0)
                       & (zs >= -1.0) & (zs <= 1.0))
            z = torch.where(covered, zs, float("inf")).amin(0) if len(
                zs) else torch.full(out[cam, rows, cols].shape, float("inf"))
            out[cam, rows, cols] = torch.where(torch.isfinite(z), z, 1.0)
    return out


@pytest.mark.parametrize("scene,chunk,two_level,supers", [
    ("near_straddle", 8, True, 8), ("near_straddle", 16, True, 3),
    ("random_sorted", 64, True, 8), ("random_sorted", 16, True, 1),
    ("morton_sphere", 8, True, 8), ("morton_sphere", 32, True, 2),
    ("random_sorted", 16, False, 8), ("morton_sphere", 64, False, 8),
    ("shared_edge", 8, True, 8)])
def test_kernel_walk_equals_plain_render(scene, chunk, two_level, supers):
    """The port's bins drop no covering record, for soups that are not a
    whole number of chunks or superchunks too, so the kernels' walk equals
    the plain render bit for bit."""
    cam, soup, valid, h, w = _scene(scene)
    cams = _t(np.stack([cam, g._make_camera(eye=(0.2, -0.1, 0.3))]))
    bins = tbinned.bin_soup(cams, _t(soup), _t(valid), h, w, chunk,
                            two_level, supers)
    assert bins["packed"].shape[-1] % (chunk * supers if two_level
                                       else chunk) == 0
    ref = tr.render_depth(cams, _t(soup), _t(valid), h, w)
    assert (ref < 1.0).any()
    assert torch.equal(_walk(bins), ref)


@pytest.mark.parametrize("chunk", [16, 64])
def test_cpu_wrappers_are_plain_render(chunk):
    cam, soup, valid, h, w = _scene("random_sorted")
    cams = _t(np.stack([cam, cam]))
    plain = tr.render_depth(_t(cam), _t(soup), _t(valid), h, w)
    for out in (tbinned.render_depth_binned(cams, _t(soup), _t(valid), h, w,
                                            chunk=chunk),
                tbinned.render_depth_binned(cams, _t(soup), _t(valid), h, w,
                                            chunk=chunk, two_level=True),
                tbinned.render_depth_binned_batched(
                    cams, _t(soup), _t(valid), h, w, chunk=chunk)):
        assert torch.equal(out[0], plain) and torch.equal(out[1], plain)


def test_wrappers_refuse_what_kernels_do_not_take():
    cam, soup, valid, h, w = _scene("glx")
    args = (_t(cam)[None], _t(soup), _t(valid), h, w)
    for kwargs in ({"chunk": 12}, {"chunk": 128}, {"supers": 0},
                   {"two_level": True, "supers": -1}):
        with pytest.raises(ValueError):
            tbinned.render_depth_binned(*args, **kwargs)
    for kwargs in ({"chunk": 4}, {"supers": 0}):
        with pytest.raises(ValueError):
            tbinned.render_depth_binned_batched(*args, **kwargs)


def test_no_fallback_off_the_cpu(monkeypatch):
    """An input off the CPU never takes the plain render: a device mix or a
    non-CUDA device raises before any work."""
    def plain(*a, **k):
        raise AssertionError("the plain render was taken")

    monkeypatch.setattr(tbinned, "render_depth", plain)
    cam, soup, valid, h, w = _scene("glx")
    cams, soup, valid = _t(cam)[None], _t(soup), _t(valid)
    meta = [t.to("meta") for t in (cams, soup, valid)]
    for args in ((cams, meta[1], valid), meta, (meta[0], soup, valid)):
        for fn in (tbinned.render_depth_binned,
                   tbinned.render_depth_binned_batched):
            with pytest.raises(ValueError):
                fn(*args, h, w)


def test_raster_sweep_runs_small_on_cpu(capsys):
    rows = raster_sweep.main(["--device", "cpu", "--height", "24", "--width",
                              "32", "--tris", "300", "--reps", "1",
                              "--chunks", "8,16", "--batched"])
    text = capsys.readouterr().out
    assert text.startswith("device: cpu")
    # 2 cases x 2 chunks x 5 variants, and bench578's plain render
    assert len(rows) == 21
    assert {r["variant"] for r in rows} == {
        "one-level", "two-level", "batched x4", "one-level x16",
        "batched x16", "plain"}
    for r in rows:
        assert r["kernel_ms"] is None and r["peak_mb"] is None
        assert r["wrapper_ms"] > 0
    by = {(r["case"], r["variant"], r["chunk"]): r for r in rows}
    for case in ("bench578", "sphere300"):
        one = by[(case, "one-level", 8)]["list_entries"]
        assert by[(case, "two-level", 8)]["list_entries"] * 7 < one
        assert by[(case, "one-level x16", 8)]["list_entries"] == 16 * one


def test_raster_sweep_needs_cuda_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the tool would run on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        raster_sweep.main(["--height", "24", "--width", "32", "--tris",
                           "64", "--reps", "1", "--chunks", "8"])


@pytest.mark.parametrize("scene,chunk,supers", [
    ("near_straddle", 8, 1), ("near_straddle", 16, 3),
    ("random_sorted", 64, 8), ("morton_sphere", 32, 2)])
def test_setup_and_lists_wrappers_are_plain_on_cpu(scene, chunk, supers):
    """On the CPU the wrappers of the setup and bin kernels take their plain
    versions: ``setup_records`` is ``pack_records`` with its chunk boxes,
    ``tile_lists`` is ``bin_chunks`` (supers 1) or ``bin_superchunks``."""
    cam, soup, valid, h, w = _scene(scene)
    cams = _t(np.stack([cam, g._make_camera(eye=(0.2, -0.1, 0.3))]))
    packed, cbox = tbinned.setup_records(cams, _t(soup), _t(valid),
                                         chunk * supers, chunk)
    want = tbinned.pack_records(cams, _t(soup), _t(valid), chunk * supers)
    torch.testing.assert_close(packed, want, rtol=0, atol=0, equal_nan=True)
    boxes = packed[:, 12], packed[:, 13], packed[:, 14], packed[:, 15]
    if supers == 1:
        lists, counts = tbinned.bin_chunks(*boxes, h, w, chunk=chunk)
        cboxes = tbinned._group_boxes(*boxes, chunk)
    else:
        cboxes, lists, counts = tbinned.bin_superchunks(
            *boxes, h, w, chunk=chunk, supers=supers)
    assert torch.equal(cbox, torch.stack(cboxes, 1))
    got_lists, got_counts = tbinned.tile_lists(cbox, h, w, supers)
    assert torch.equal(got_lists, lists) and torch.equal(got_counts, counts)
    assert counts.sum() > 0


def test_screen_cache_is_the_pixel_grid_and_tile_extents():
    grid, tiles = tbinned._screen(37, 53, torch.device("cpu"))
    assert tbinned._screen(37, 53, torch.device("cpu"))[0] is grid
    for a, b in zip(grid, tr.pixel_grid(37, 53, "cpu")):
        assert torch.equal(a, b)
    for a, b in zip(tiles, tbinned.tile_extents(37, 53, tbinned.TILE,
                                                tbinned.TILE, "cpu")):
        assert torch.equal(a, b)


def test_setup_and_lists_wrappers_refuse():
    cam, soup, valid, h, w = _scene("glx")
    args = (_t(cam)[None], _t(soup), _t(valid))
    for multiple, chunk in ((12, 8), (8, 16), (64, 12)):
        with pytest.raises(ValueError):
            tbinned.setup_records(*args, multiple, chunk)
    cbox = tbinned.setup_records(*args, 24, 8)[1]
    for box, supers in ((cbox, 2), (cbox, 0), (cbox[:, :3], 1),
                        (cbox[0], 1)):
        with pytest.raises(ValueError):
            tbinned.tile_lists(box, h, w, supers)
