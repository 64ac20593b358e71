"""Plane-sweep photometric depth: the hybrid default's first iteration.

Port of meshrecon/depth/plane_sweep.py (``plane_sweep_depth_batched``,
``_box3``, and ``plane_sweep_depth``, the batch of one; the JAX forms'
``engine`` and ``interpret`` arguments are not ported). D depth hypotheses sweep
through each main camera's frustum; at each one every side frame is
resampled onto the main view (K3c,
``flow/tile_warp.py::tile_warp_sample_batched``), scored by a weighted
absolute difference, summed over the sides and box-filtered, and a running
(best, previous, next) cost gives a parabolic sub-plane refinement.
The JAX ``lax.scan`` over planes is a Python loop here; memory stays
O(B*K*H*W) for any D. The side-sharded ``axis_name`` form waits for the
sharding slice (ROADMAP Queue A, A12).
"""

from __future__ import annotations

import numpy as np
import torch

from meshrecon_torch import BACKGROUND_DEPTH
from meshrecon_torch.flow.tile_warp import tile_warp_sample_batched
from meshrecon_torch.raster.rasterizer import pixel_grid


def _box3(img):
    """3x3 box mean over the last two axes with an edge-replicated border;
    the nine taps are added in the reference's order."""
    h, w = img.shape[-2:]
    p = torch.nn.functional.pad(img.reshape(-1, 1, h, w), (1, 1, 1, 1),
                                mode="replicate").reshape(
                                    *img.shape[:-2], h + 2, w + 2)
    return (
        p[..., :-2, :-2] + p[..., :-2, 1:-1] + p[..., :-2, 2:]
        + p[..., 1:-1, :-2] + p[..., 1:-1, 1:-1] + p[..., 1:-1, 2:]
        + p[..., 2:, :-2] + p[..., 2:, 1:-1] + p[..., 2:, 2:]
    ) / 9.0


def plane_sweep_depth_batched(frames_main, frames_side, cam_mains, cams_side,
                              side_valid, z_min, z_max, num_depths: int = 64,
                              side_weight=None):
    """Plane sweep for B main cameras.

    frames_main: (B, H, W); frames_side: (B, K, H, W); cam_mains: (B, 4, 4);
    cams_side: (B, K, 4, 4); side_valid: (B, K) bool; z_min, z_max: (B,)
    NDC sweep ranges; side_weight: optional (B, K, H, W) vote weights,
    constant across planes. Returns dict of (B, H, W) tensors: ``depth``
    (refined NDC depth, BACKGROUND_DEPTH where invalid), ``cost`` (best
    matching cost) and ``valid`` (enough side views saw the pixel).
    """
    fm = frames_main.to(torch.float32)
    fs = frames_side.to(torch.float32).contiguous()
    b, h, w = fm.shape
    dev = fm.device
    main_inv = torch.linalg.inv(cam_mains.to(torch.float32))
    cm = cams_side.to(torch.float32) @ main_inv[:, None]  # (B, K, 4, 4)
    vmask = side_valid.to(torch.float32)
    swt = None if side_weight is None else side_weight.to(torch.float32)

    cols, rows = pixel_grid(h, w, dev)
    x = cols[None, None, None, :]
    y = rows[None, None, :, None]

    z_min = torch.as_tensor(z_min, dtype=torch.float32,
                            device=dev).reshape(b)
    z_max = torch.as_tensor(z_max, dtype=torch.float32,
                            device=dev).reshape(b)
    ts = torch.from_numpy(
        np.linspace(0.0, 1.0, num_depths).astype(np.float32)).to(dev)
    zs = z_min[None, :] + ts[:, None] * (z_max - z_min)[None, :]  # (D, B)

    def cost_at(z):  # z: (B,)
        zb = z[:, None, None, None]

        def apply_cm(row):
            c = cm[:, :, row, :, None, None]
            return c[:, :, 0] * x + c[:, :, 1] * y + c[:, :, 2] * zb \
                + c[:, :, 3]

        s0, s1, sw = apply_cm(0), apply_cm(1), apply_cm(3)
        ok = sw > 1e-6
        sw = torch.where(sw.abs() < 1e-6, 1e-6, sw)
        sx = s0 / sw
        sy = s1 / sw
        ok &= (sx.abs() < 1.0) & (sy.abs() < 1.0)
        scol = (sx + 1.0) * 0.5 * w
        srow = (1.0 - sy) * 0.5 * h
        samp = tile_warp_sample_batched(fs, scol.contiguous(),
                                        srow.contiguous(), ok.contiguous())
        diff = (samp - fm[:, None]).abs()
        wgt = ok.to(torch.float32) * vmask[:, :, None, None]
        if swt is not None:
            wgt = wgt * swt
        num = (diff * wgt).sum(dim=1)
        den = wgt.sum(dim=1)
        cost = num / den.clamp(min=1e-6)
        return _box3(cost), den

    big = torch.full((b, h, w), 1e30, dtype=torch.float32, device=dev)
    best_c, best_prev, best_next, last_c = big, big, big, big
    best_z = z_max[:, None, None].expand(b, h, w)
    pending = torch.zeros((b, h, w), dtype=torch.bool, device=dev)
    support = torch.zeros((b, h, w), dtype=torch.float32, device=dev)
    for d in range(num_depths):
        z = zs[d]
        c, sup = cost_at(z)
        is_best = c < best_c
        best_prev = torch.where(is_best, last_c, best_prev)
        best_next = torch.where(pending & ~is_best, c, best_next)
        pending = is_best
        best_z = torch.where(is_best, z[:, None, None], best_z)
        best_c = torch.where(is_best, c, best_c)
        support = torch.maximum(support, sup)
        last_c = c

    dz = ((z_max - z_min) / (num_depths - 1))[:, None, None]
    denom = best_prev - 2.0 * best_c + best_next
    ok_ref = (denom.abs() > 1e-12) & (best_prev < 1e29) & (best_next < 1e29)
    offset = torch.where(ok_ref, 0.5 * (best_prev - best_next) / denom, 0.0)
    offset = offset.clamp(-1.0, 1.0)
    depth = best_z + offset * dz

    # two side views where the window has two; a single-side bundle is
    # classic two-view stereo (the reference's flow path needs only one)
    n_sides = vmask.sum(dim=1)
    need = n_sides.clamp(min=1.0).clamp(max=2.0)[:, None, None]
    valid = support >= need
    depth = torch.where(valid, depth, BACKGROUND_DEPTH)
    return {"depth": depth, "cost": best_c, "valid": valid}


def plane_sweep_depth(frame_main, frames_side, cam_main, cams_side,
                      side_valid, z_min, z_max, num_depths: int = 64,
                      side_weight=None):
    """Plane sweep for one main camera: the B=1 slice of
    :func:`plane_sweep_depth_batched`.

    frame_main: (H, W); frames_side: (K, H, W); cam_main: (4, 4);
    cams_side: (K, 4, 4); side_valid: (K,) bool; z_min, z_max: the NDC
    depth range; side_weight: optional (K, H, W). Returns dict of (H, W)
    tensors ``depth``, ``cost`` and ``valid``."""
    dev = frame_main.device
    out = plane_sweep_depth_batched(
        frame_main[None], frames_side[None], cam_main[None], cams_side[None],
        side_valid[None],
        torch.as_tensor(z_min, dtype=torch.float32, device=dev).reshape(1),
        torch.as_tensor(z_max, dtype=torch.float32, device=dev).reshape(1),
        num_depths=num_depths,
        side_weight=None if side_weight is None else side_weight[None])
    return {k: v[0] for k, v in out.items()}
