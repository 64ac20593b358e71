"""Multi-device execution: device meshes and the sharded dense updates.

Port of meshrecon/sharding/meshes.py. The JAX package annotates shardings
on one jitted program and XLA inserts the collectives; here a mesh is a
grid of torch devices on named axes, and a sharded function is a driver in
one process that

1. splits its batched inputs along the sharded axis into contiguous
   shards, each moved to its device (replicated inputs are copied to each
   device);
2. runs each shard's plain single-device code on its device, in a thread
   of its own (as ``torch.nn.parallel.parallel_apply`` does) under
   ``torch.cuda.device``;
3. gathers the outputs onto the mesh's first device, in shard order: the
   counterpart of JAX's replicated outputs and their all-gather.

The axes:

- ``camera``: main cameras of an iteration are independent until the
  point merge (recon.cpp:65-119): each shard runs
  ``fused_main_update_batched`` over its cameras, no collective.
- ``scene``: clips are independent: each shard loops its scenes, each with
  its own triangle soup, no collective.
- ``window``: the plane sweep's side frames; the shards' photometric
  evidence (JAX's ``psum``) is summed per depth plane on the first device
  in shard order, so the cost's last bits do not change from run to run.
- ``tile``: image rows. Each camera shard owns a tile group, the devices
  of its row of the mesh, and the dense updates split every dense plane's
  rows over it: one controller per group walks the update's stages and
  exchanges the rows each stage reaches between them
  (``sharding/tiles.py``), bit for bit the unsharded update. The scene
  axis runs each scene shard on the first device of its group (JAX's
  ``shard_map`` replicates a scene over its group), the window axis has no
  tile axis.

Devices: ``devices=None`` means ``cuda:0 .. n-1``, and too few raise
``ValueError("need n devices, have m")`` as the JAX mesh functions do. An
explicit list may name a device more than once: the CPU tests pass
``[torch.device("cpu")] * n``, the counterpart of JAX's virtual CPU
devices, and one card can hold several shards. JAX's ``use_pallas`` and
``engine`` arguments (TPU knobs) and ``sharding/compat.py`` (its
``shard_map`` shim) have no counterpart.
"""

from __future__ import annotations

import contextlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from meshrecon_torch.depth.normals import estimate_normals_batched
from meshrecon_torch.depth.plane_sweep import (sweep_planes, sweep_window,
                                               sweep_windows)
from meshrecon_torch.depth.triangulate import triangulate_pixels_batched
from meshrecon_torch.flow.pyramid import compare
from meshrecon_torch.flow.remap import flow_remap
from meshrecon_torch.flow.variational import variational_flow

# the five outputs of a sharded fused update (JAX's out_shardings)
_OUT_KEYS = ("point4", "normals", "pdf", "valid", "depth")


class Mesh:
    """Devices on named axes: ``devices`` is an object array of
    ``torch.device`` whose dimensions are ``axis_names``; ``shape`` maps
    each axis name to its size, as a JAX mesh's does."""

    def __init__(self, devices: np.ndarray, axis_names):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if devices.ndim != len(self.axis_names):
            raise ValueError(f"{devices.ndim}-d devices for axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {list(self.devices.reshape(-1))})"


def cuda_devices(n: int) -> list:
    """``cuda:0 .. n-1``; fewer CUDA devices raise ValueError."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        raise ValueError(f"need {n} devices, have {have}")
    return [torch.device("cuda", i) for i in range(n)]


def _grid(devices, shape, axis_names) -> Mesh:
    need = int(np.prod(shape))
    if devices is None:
        devices = cuda_devices(need)
    devices = [torch.device(d) for d in devices]
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    grid = np.empty(need, dtype=object)
    for i in range(need):
        grid[i] = devices[i]
    return Mesh(grid.reshape(shape), axis_names)


def make_device_mesh(n_camera: int, n_tile: int = 1, devices=None) -> Mesh:
    """(camera, tile) mesh over the first n_camera * n_tile devices."""
    return _grid(devices, (n_camera, n_tile), ("camera", "tile"))


def make_scene_mesh(n_scene: int, n_camera: int, n_tile: int = 1,
                    devices=None) -> Mesh:
    """(scene, camera, tile) mesh for multi-clip batches (BASELINE config
    5: several clips at once)."""
    return _grid(devices, (n_scene, n_camera, n_tile),
                 ("scene", "camera", "tile"))


def make_window_mesh(n_window: int, devices=None) -> Mesh:
    """1-D mesh over the plane sweep's side-frame window."""
    return _grid(devices, (n_window,), ("window",))


def _axis_devices(mesh: Mesh, axis: str) -> list:
    """The devices along ``axis`` (the first of every other axis)."""
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh needs a '{axis}' axis: {mesh.axis_names}")
    index = tuple(slice(None) if name == axis else 0
                  for name in mesh.axis_names)
    return list(mesh.devices[index])


def _on(device: torch.device):
    """The device context of a shard: CUDA's current device, none on the
    CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def parallel_shards(fn, devices: list, shards: list) -> list:
    """``fn(*args)`` for each device and its shard's ``args``, each in a
    thread of its own under its device (inline when there is one shard);
    the results in shard order. A shard's exception raises here. Each
    thread takes the caller's count of CPU threads for torch's ops (a new
    thread starts with the default, whose other split of a CPU reduction
    would change its last bits)."""
    threads = torch.get_num_threads()

    def run(device, args):
        torch.set_num_threads(threads)
        with _on(device):
            return fn(*args)

    if len(shards) == 1:
        return [run(devices[0], shards[0])]
    with ThreadPoolExecutor(max_workers=len(shards)) as pool:
        futures = [pool.submit(run, d, a) for d, a in zip(devices, shards)]
        return [f.result() for f in futures]


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


def _split(x, n: int, devices: list) -> list:
    """``x``'s leading axis in ``n`` contiguous parts (as
    ``torch.tensor_split``), part i on ``devices[i]``. ``x`` is a tensor or
    an array, or a list of per-item tensors (items of unequal shapes, as
    scenes' soups), which splits into lists."""
    if isinstance(x, (list, tuple)):
        return [[_tensor(x[i]).to(d) for i in part] for part, d in zip(
            np.array_split(np.arange(len(x)), n), devices)]
    return [part.to(d) for part, d in zip(torch.tensor_split(_tensor(x), n),
                                          devices)]


def _shards(devices: list, split_args, replicated=()) -> tuple:
    """(indices, per-shard argument tuples) of the shards that got items:
    ``split_args`` split along their leading axis, ``replicated`` copied
    to each device (after the split arguments)."""
    n = len(devices)
    parts = [_split(a, n, devices) for a in split_args]
    keep = [i for i in range(n) if len(parts[0][i])]
    if not keep:
        raise ValueError("nothing to shard: the leading axis is empty")
    args = [tuple(_tensor(r).to(devices[i]) for r in replicated)
            + tuple(p[i] for p in parts) for i in keep]
    return keep, args


def _camera_step(mesh: Mesh, body, tiled, keys, replicated: int = 0):
    """The callable of a camera-sharded update: its inputs' batch split over
    the camera axis (the first ``replicated`` inputs copied to each shard),
    each shard run by ``body(*args)`` on its device, or, with a tile axis
    above 1, by ``tiled(group, *args)`` with ``group`` the devices of its
    row of the mesh; the outputs ``keys`` gathered onto the mesh's first
    device, in camera order."""
    devices = _axis_devices(mesh, "camera")
    index = tuple(slice(None) if name in ("camera", "tile") else 0
                  for name in mesh.axis_names)
    groups = [list(row) for row in
              mesh.devices[index].reshape(len(devices), -1)]

    def step(*args):
        keep, shards = _shards(devices, args[replicated:],
                               replicated=args[:replicated])
        devs = [devices[i] for i in keep]
        if len(groups[0]) == 1:
            outs = parallel_shards(body, devs, shards)
        else:
            outs = parallel_shards(tiled, devs, [(groups[i],) + a for i, a in
                                                 zip(keep, shards)])
        return _gather(outs, keys, devices[0])

    return step


def _gather(outs: list, keys, device) -> dict:
    """Each key's shard outputs concatenated on ``device``, in order."""
    return {k: torch.cat([o[k].to(device) for o in outs]) for k in keys}


# flow presets: "full" matches the pipeline's call (2 levels, 1 warp, the
# solver's default sweeps); "fast" is for dry runs
_FLOW_PRESETS = {
    "full": dict(levels=2, warps=1),
    "fast": dict(levels=2, iters=20, warps=1),
}


def dense_update_batch(frames_main, frames_proj, main_cams, side_cams,
                       side_valid, depths, centers, centers_valid, n_side,
                       flow_quality: str = "full"):
    """Batched dense update: flow -> triangulation -> normals for B main
    cameras, given their depths and reprojected side frames.

    frames_main: (B, H, W) original frames; frames_proj: (B, K, H, W)
    reprojected predictions; main_cams: (B, 4, 4); side_cams: (B, K, 4, 4);
    side_valid: (B, K); depths: (B, H, W); centers: (B, C, 3);
    centers_valid: (B, C); n_side: (B,). Tensors on one device.

    Each (main, side) pair: variational flow, the bicubic remap-and-compare
    variance, then Gauss-Newton triangulation (exact sampling) and normals.
    Returns (point4 (B, H, W, 4), normals (B, H, W, 3), pdf, valid).
    """
    preset = _FLOW_PRESETS[flow_quality]
    fm = frames_main.to(torch.float32)
    fp = frames_proj.to(torch.float32)
    flows = variational_flow(fm[:, None], fp, **preset)  # (B, K, H, W, 2)
    var = compare(fm[:, None], flow_remap(flows, fp))
    out = triangulate_pixels_batched(
        flows[..., 0], flows[..., 1], var, main_cams.to(torch.float32),
        side_cams.to(torch.float32), side_valid.to(torch.bool),
        depths.to(torch.float32), sampling="exact")
    normals = estimate_normals_batched(out["point4"], out["valid"],
                                       out["pdf"], centers, centers_valid,
                                       n_side)
    return out["point4"], normals, out["pdf"], out["valid"]


_DENSE_KEYS = ("point4", "normals", "pdf", "valid")


def sharded_dense_update(mesh: Mesh, flow_quality: str = "fast"):
    """:func:`dense_update_batch` over the mesh's camera axis, and with a
    tile axis above 1 each camera shard's image rows over its row of the
    mesh (``sharding/tiles.py``): a callable of its nine inputs (tensors or
    arrays, batch leading) that returns its four outputs on the mesh's
    first device."""
    from meshrecon_torch.sharding import tiles

    def body(*args):
        return dict(zip(_DENSE_KEYS,
                        dense_update_batch(*args, flow_quality=flow_quality)))

    def tiled(group, frames_main, *args):
        g = tiles.TileGroup(group, frames_main.shape[-2])
        return dict(zip(_DENSE_KEYS, tiles.dense_update(
            g, frames_main, *args, flow_quality=flow_quality)))

    inner = _camera_step(mesh, body, tiled, _DENSE_KEYS)

    def step(*args):
        out = inner(*args)
        return tuple(out[k] for k in _DENSE_KEYS)

    return step


def sharded_fused_update(mesh: Mesh, height: int, width: int,
                         use_farneback: bool = False, **options):
    """The complete per-iteration dense update
    (``pipeline.fused.fused_main_update_batched``: renders, reprojection,
    flow, triangulation, normals) for B main cameras over the mesh's
    camera axis. The soup is replicated (the mesh is global state); every
    other input splits along its batch. ``options`` are
    ``fused_main_update_batched``'s (sampling, flow_solver, variance,
    ...): the pipeline passes its configuration's, where JAX's form takes
    ``use_farneback`` alone (ROADMAP Queue C, divergences by design).

    With a tile axis above 1, each camera shard's image rows split over
    its row of the mesh (``sharding/tiles.py``), bit for bit the unsharded
    update; ``flow_solver="mg"`` then raises ValueError. Every call's
    :class:`~meshrecon_torch.sharding.tiles.TileGroup` s are appended to
    the callable's ``tile_groups`` list (their exchanged bytes and
    windows).

    Returns a callable of the ten update inputs (tensors or arrays) that
    returns dict(point4, normals, pdf, valid, depth) on the mesh's first
    device."""
    from meshrecon_torch.pipeline.fused import fused_main_update_batched
    from meshrecon_torch.sharding import tiles

    if mesh.shape.get("tile", 1) > 1 and not use_farneback:
        tiles.check_solver(options.get("flow_solver", "cheb"))

    def body(soup, soup_valid, *batch):
        out = fused_main_update_batched(soup, soup_valid, *batch, height,
                                        width, use_farneback=use_farneback,
                                        **options)
        return {k: out[k] for k in _OUT_KEYS}

    groups = []

    def tiled(devices, *args):
        group = tiles.TileGroup(devices, height)
        groups.append(group)
        out = tiles.fused_update(group, *args, height, width,
                                 use_farneback=use_farneback, **options)
        return {k: out[k] for k in _OUT_KEYS}

    step = _camera_step(mesh, body, tiled, _OUT_KEYS, replicated=2)
    step.tile_groups = groups
    return step


def sharded_plane_sweep(mesh: Mesh, num_depths: int = 64):
    """Window-sharded plane sweep: the K side frames of one main camera
    split over the mesh's ``window`` axis. One controller sweeps the
    planes; at each, every shard's evidence (on CUDA SWEEP_PROJ, K3c and
    SWEEP_COST) runs on its device, and the shards' evidence (cost
    numerator and view support) is summed on the first device in shard
    order, as is the count of valid sides once (JAX's ``psum``s).

    Returns a callable ``(frame_main, frames_side, cam_main, cams_side,
    side_valid, z_min, z_max) -> {depth, cost, valid}``, (H, W) each on
    the first device; frames_side (K, H, W), cams_side (K, 4, 4) and
    side_valid (K,) split on their leading axis."""
    devices = _axis_devices(mesh, "window")

    def step(frame_main, frames_side, cam_main, cams_side, side_valid,
             z_min, z_max):
        _, shards = _shards(devices, (frames_side, cams_side, side_valid),
                            replicated=(frame_main, cam_main))
        z_lo, z_hi, zs = sweep_planes(z_min, z_max, num_depths, devices[0])
        windows = [sweep_window(fm[None], fs[None], cm[None], cs[None],
                                sv[None], zs)
                   for fm, cm, fs, cs, sv in shards]
        out = sweep_windows(windows, z_lo, z_hi, num_depths)
        return {k: v[0] for k, v in out.items()}

    return step


def sharded_multi_scene_fused(mesh: Mesh, height: int, width: int,
                              use_farneback: bool = False,
                              sampling: str = "taylor",
                              flow_solver: str = "cheb", **options):
    """Scene-sharded fused dense update: each device runs the batched
    update (``fused_main_update_batched``) for each of its scenes in
    turn, each with its own triangle soup. Scenes are independent: no
    collective.

    Every input has a leading scene axis S: a tensor or array ((S, T, 3,
    3) soups, (S, B, 4, 4) main cameras, ...) or a list of S per-scene
    tensors (soups of different lengths, each scene's inputs on its own
    device). Scenes split into contiguous shards over the scene axis (S
    need not divide evenly). ``options`` are ``fused_main_update_batched``'s
    other flow options (ROADMAP Queue C). Returns dict(point4, normals,
    pdf, valid, depth) with leading (S, B) on the mesh's first device."""
    from meshrecon_torch.pipeline.fused import fused_main_update_batched

    devices = _axis_devices(mesh, "scene")

    def body(*per_scene):
        outs = []
        for s in range(len(per_scene[0])):
            out = fused_main_update_batched(
                *(a[s] for a in per_scene), height, width,
                use_farneback=use_farneback, sampling=sampling,
                flow_solver=flow_solver, **options)
            outs.append(out)
        return {k: torch.stack([o[k] for o in outs]) for k in _OUT_KEYS}

    def step(*args):
        keep, shards = _shards(devices, args)
        return _gather(parallel_shards(body, [devices[i] for i in keep],
                                       shards), _OUT_KEYS, devices[0])

    return step
