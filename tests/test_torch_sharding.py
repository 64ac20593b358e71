"""The sharded dense updates of meshrecon_torch.sharding against
meshrecon.sharding on the CPU. The JAX side runs on the eight virtual CPU
devices of tests/conftest.py (its Pallas kernels as its own tests run
them); the port's on ``[torch.device("cpu")] * n``, the CPU repeated.
Inputs are tests/test_sharding.py's, made with numpy from a seed.

Bounds, and what was measured (port against JAX):
- ``dense_update_batch``: valid masks equal; point4 within 1e-4 (JAX's
  own sharded-against-unsharded bound); the normals' axis within 1e-3 on
  99% of valid pixels (XLA contracts multiply-adds into FMAs and torch
  does not; the covariance's eigenvector follows the last bits).
  Measured: point4 within 8.0e-7, the axis within 1.3e-5 everywhere.
- ``sharded_dense_update`` (port (4, 1), JAX (4, 2)), ``sharded_fused_
  update`` at 4 cameras and ``sharded_multi_scene_fused`` at S = 4: the
  fused outputs within meshrecon_torch/parity.py's bounds of the JAX run,
  JAX's test bound on point4 (1e-3); the dense update as above. Measured
  (fused, 4 cameras): depth, valid and point4 agree everywhere, log pdf
  within 9.2e-4, the normals' axis within 1e-3 on 99.4% of pixels.
- The camera and scene axes split the batch and run the plain code on
  each shard, whose items are independent: the port's sharded outputs
  equal its unsharded ones bit for bit (uneven scene splits and
  per-scene soups of different lengths too).
- ``sharded_plane_sweep`` at 8 window shards: JAX's bounds against the
  unsharded sweep (depth atol 1e-5; cost rtol 1e-5, atol 1e-4; valid
  equal), against JAX's sharded sweep and the port's unsharded one.
  Measured against JAX: depth within 3.3e-7, cost within 7.2e-5. The
  shards' evidence sums in shard order; with one side a shard that is
  the unsharded sum's order here (equal bit for bit), not in general.
"""

import threading

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as g
import jax.numpy as jnp
from meshrecon.sharding import dense_update_batch as j_dense
from meshrecon.sharding import make_device_mesh as j_device_mesh
from meshrecon.sharding import make_scene_mesh as j_scene_mesh
from meshrecon.sharding import make_window_mesh as j_window_mesh
from meshrecon.sharding import sharded_dense_update as j_sharded_dense
from meshrecon.sharding import sharded_fused_update as j_sharded_fused
from meshrecon.sharding import sharded_multi_scene_fused as j_multi_scene
from meshrecon.sharding import sharded_plane_sweep as j_sharded_sweep
from meshrecon_torch import parity, state
from meshrecon_torch.depth.plane_sweep import plane_sweep_depth
from meshrecon_torch.kernels import _build
from meshrecon_torch.pipeline.fused import fused_main_update_batched
from meshrecon_torch.sharding import (dense_update_batch, make_device_mesh,
                                      make_scene_mesh, make_window_mesh,
                                      sharded_dense_update,
                                      sharded_fused_update,
                                      sharded_multi_scene_fused,
                                      sharded_plane_sweep)
from meshrecon_torch.sharding.meshes import parallel_shards
from tests.test_geometry import make_camera
from tests.test_sharding import _problem

torch.set_num_threads(1)

CPU = torch.device("cpu")
KEYS = ("point4", "normals", "pdf", "valid", "depth")


def cpus(n):
    return [CPU] * n


def _t(args):
    return [torch.from_numpy(np.asarray(a)) for a in args]


def _np(out):
    return {k: np.asarray(v) for k, v in out.items() if k in KEYS}


def _equal(ours, ref):
    for key in KEYS:
        np.testing.assert_array_equal(np.asarray(ours[key]),
                                      np.asarray(ref[key]), err_msg=key)


def _check_dense(ours, ref):
    """The dense update's four outputs against JAX's (module docstring)."""
    p4, nrm, pdf, valid = (np.asarray(a) for a in ours)
    rp4, rnrm, rpdf, rvalid = (np.asarray(a) for a in ref)
    np.testing.assert_array_equal(valid, rvalid)
    assert valid.mean() > 0.3
    np.testing.assert_allclose(p4[valid], rp4[valid], rtol=1e-4, atol=1e-4)
    assert np.isfinite(nrm[valid]).all() and np.isfinite(pdf[valid]).all()
    uo = nrm[valid] / np.linalg.norm(nrm[valid], axis=-1, keepdims=True)
    ur = rnrm[valid] / np.linalg.norm(rnrm[valid], axis=-1, keepdims=True)
    axis = np.minimum(np.linalg.norm(uo - ur, axis=-1),
                      np.linalg.norm(uo + ur, axis=-1))
    assert np.mean(axis <= 1e-3) >= 0.99, np.mean(axis <= 1e-3)


@pytest.fixture(scope="module")
def dense_ref():
    args = _problem()
    ref = jax.jit(lambda *a: j_dense(*a, flow_quality="fast"))(*args)
    return args, [np.asarray(a) for a in ref]


def test_dense_update_batch_matches_jax(dense_ref):
    args, ref = dense_ref
    ours = dense_update_batch(*_t(args), flow_quality="fast")
    assert ours[0].shape == (4, 16, 32, 4) and ours[1].shape == (4, 16, 32, 3)
    _check_dense(ours, ref)


def test_sharded_dense_update_matches_jax_and_unsharded(dense_ref):
    args, ref = dense_ref
    ours = sharded_dense_update(make_device_mesh(4, 1, devices=cpus(4)))(
        *args)
    j_ours = j_sharded_dense(j_device_mesh(4, 2))(*args)
    _check_dense(ours, [np.asarray(a) for a in j_ours])
    _check_dense(ours, ref)
    unsharded = dense_update_batch(*_t(args), flow_quality="fast")
    for a, b in zip(ours, unsharded):
        assert torch.equal(a, b)


def test_mesh_shapes():
    assert make_device_mesh(8, 1, devices=cpus(8)).shape == {
        "camera": 8, "tile": 1}
    assert make_device_mesh(2, 4, devices=cpus(8)).shape == {
        "camera": 2, "tile": 4}
    assert make_scene_mesh(4, 1, 1, devices=cpus(4)).shape == {
        "scene": 4, "camera": 1, "tile": 1}
    assert make_window_mesh(8, devices=cpus(8)).shape == {"window": 8}
    # the JAX package's meshes of the same sizes
    assert j_device_mesh(2, 4).shape == {"camera": 2, "tile": 4}
    assert dict(j_scene_mesh(4, 1, 1, devices=jax.devices()[:4]).shape) == {
        "scene": 4, "camera": 1, "tile": 1}
    assert dict(j_window_mesh(8).shape) == {"window": 8}
    mesh = make_device_mesh(2, 1, devices=["cpu", "cpu", "cpu"])
    assert list(mesh.devices.reshape(-1)) == cpus(2)
    with pytest.raises(ValueError, match="need 4 devices, have 3"):
        make_device_mesh(2, 2, devices=cpus(3))


def test_default_devices_are_gpus(monkeypatch):
    """devices=None means cuda:0..n-1; too few raise as JAX's do."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = make_scene_mesh(2, 1)
    assert list(mesh.devices.reshape(-1)) == [torch.device("cuda", 0),
                                              torch.device("cuda", 1)]
    with pytest.raises(ValueError, match="need 4 devices, have 2"):
        make_window_mesh(4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="need 1 devices, have 0"):
        make_device_mesh(1)


def test_sharded_fused_update():
    h = w = 32
    args = g._fused_problem(b=4, k=2, h=h, w=w)
    ours = sharded_fused_update(make_device_mesh(4, 1, devices=cpus(4)),
                                height=h, width=w)(*args)
    ref = _np(j_sharded_fused(j_device_mesh(4, 2), height=h, width=w)(*args))
    assert ref["valid"].mean() > 0.05
    parity.check_slice(_np(ours), ref)
    sel = ref["valid"] & ours["valid"].numpy()
    np.testing.assert_allclose(ours["point4"].numpy()[sel],
                               ref["point4"][sel], rtol=1e-3, atol=1e-3)
    _equal(ours, fused_main_update_batched(*state.from_numpy(args, "cpu"),
                                           h, w))


def test_sharded_fused_update_passes_its_options():
    """The pipeline's flow options reach every shard (JAX's form takes
    -f alone): two shards equal the unsharded update with the same
    options, which differ from the defaults."""
    h = w = 32
    args = state.from_numpy(g._fused_problem(b=2, k=2, h=h, w=w), "cpu")
    opts = dict(flow_solver="jacobi", sampling="exact", iters=6)
    ours = sharded_fused_update(make_device_mesh(2, 1, devices=cpus(2)),
                                h, w, **opts)(*args)
    _equal(ours, fused_main_update_batched(*args, h, w, **opts))
    plain = fused_main_update_batched(*args, h, w)
    assert not torch.equal(ours["point4"], plain["point4"])


def test_sharded_multi_scene_fused_matches_jax_and_loop():
    S, B, K, h, w = 4, 2, 2, 32, 32
    per_scene = [g._fused_problem(b=B, k=K, h=h, w=w, seed=s)
                 for s in range(S)]
    args_s = tuple(np.stack([ps[i] for ps in per_scene]) for i in range(10))
    ours = sharded_multi_scene_fused(
        make_scene_mesh(4, 1, 1, devices=cpus(4)), height=h, width=w)(*args_s)
    ref = _np(j_multi_scene(j_scene_mesh(4, 1, 1, devices=jax.devices()[:4]),
                            height=h, width=w)(*args_s))
    for s in range(S):
        ours_s = {k: v[s] for k, v in _np(ours).items()}
        ref_s = {k: v[s] for k, v in ref.items()}
        parity.check_slice(ours_s, ref_s)
        sel = ref_s["valid"] & ours_s["valid"]
        np.testing.assert_allclose(ours_s["point4"][sel],
                                   ref_s["point4"][sel], rtol=1e-3, atol=1e-3)
        _equal({k: v[s] for k, v in ours.items()}, fused_main_update_batched(
            *state.from_numpy(per_scene[s], "cpu"), h, w))


def test_multi_scene_lists_split_unevenly():
    """Per-scene inputs as lists (soups of different lengths, each
    scene's own) and 3 scenes over 2 shards: each scene equals its own
    update."""
    h = w = 32
    per_scene = [state.from_numpy(g._fused_problem(
        b=1, k=2, h=h, w=w, seed=s, n_tris=512 * (s + 1)), "cpu")
        for s in range(3)]
    assert len({p[0].shape[0] for p in per_scene}) == 3
    out = sharded_multi_scene_fused(make_scene_mesh(2, 1, 1, devices=cpus(2)),
                                    h, w)(*(list(a) for a in zip(*per_scene)))
    for s, args in enumerate(per_scene):
        _equal({k: v[s] for k, v in out.items()},
               fused_main_update_batched(*args, h, w))


def test_sharded_plane_sweep_matches_jax_and_unsharded():
    h, w, k = 16, 32, 8
    rng = np.random.default_rng(4)
    main = make_camera(eye=(0, 0, 0), near=1.0, far=30.0).astype(np.float32)
    cams = np.stack([
        make_camera(eye=(0.5 + 0.2 * j, 0.3 * (j % 3), 0), near=1.0, far=30.0)
        for j in range(k)
    ]).astype(np.float32)
    fm = rng.uniform(0, 255, size=(h, w)).astype(np.float32)
    fs = (fm[None] + rng.normal(scale=5.0, size=(k, h, w))).astype(np.float32)
    sv = np.ones(k, bool)

    ours = sharded_plane_sweep(make_window_mesh(8, devices=cpus(8)),
                               num_depths=16)(fm, fs, main, cams, sv, -0.8,
                                              0.6)
    j_out = j_sharded_sweep(j_window_mesh(8), num_depths=16)(
        fm, fs, main, cams, sv, jnp.float32(-0.8), jnp.float32(0.6))
    t = [torch.from_numpy(a) for a in (fm, fs, main, cams, sv)]
    unsharded = plane_sweep_depth(*t, -0.8, 0.6, num_depths=16)
    assert ours["valid"].float().mean() > 0.5
    for ref in (j_out, unsharded):
        np.testing.assert_allclose(ours["depth"].numpy(),
                                   np.asarray(ref["depth"]), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(ours["cost"].numpy(),
                                   np.asarray(ref["cost"]), rtol=1e-5,
                                   atol=1e-4)
        np.testing.assert_array_equal(ours["valid"].numpy(),
                                      np.asarray(ref["valid"]))


def test_sharded_plane_sweep_one_shard_is_the_sweep():
    """One window shard runs the unsharded sweep's operations: bitwise."""
    rng = np.random.default_rng(5)
    main = make_camera(eye=(0, 0, 0), near=1.0, far=30.0).astype(np.float32)
    cams = np.stack([make_camera(eye=(0.5 + 0.2 * j, 0, 0), near=1.0,
                                 far=30.0) for j in range(3)]).astype(
        np.float32)
    fm = rng.uniform(0, 255, size=(16, 32)).astype(np.float32)
    fs = np.stack([np.roll(fm, j + 1, axis=1) for j in range(3)])
    t = [torch.from_numpy(a) for a in (fm, fs, main, cams, np.ones(3, bool))]
    ours = sharded_plane_sweep(make_window_mesh(1, devices=cpus(1)), 8)(
        *t, -0.8, 0.6)
    ref = plane_sweep_depth(*t, -0.8, 0.6, num_depths=8)
    for key in ("depth", "cost", "valid"):
        assert torch.equal(ours[key], ref[key]), key


def test_parallel_shards_order_and_errors():
    out = parallel_shards(lambda i: i * i, cpus(4), [(i,) for i in range(4)])
    assert out == [0, 1, 4, 9]

    def fail(i):
        if i == 2:
            raise RuntimeError("shard 2 failed")
        return i

    with pytest.raises(RuntimeError, match="shard 2 failed"):
        parallel_shards(fail, cpus(3), [(i,) for i in range(3)])


def test_temporary_build_names_are_per_thread(tmp_path):
    """Threads alive together build into different temporary files."""
    names = set()
    together = threading.Barrier(4)

    def name():
        names.add(_build.tmp_path(tmp_path / "lib.so"))
        together.wait()

    threads = [threading.Thread(target=name) for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert len(names) == 4
