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
O(B*K*H*W) for any D. JAX's ``axis_name`` form (the side window sharded
over devices, ``psum`` of the evidence) is :func:`sweep_windows` given the
window's shards, which ``sharding.meshes.sharded_plane_sweep`` makes.
"""

from __future__ import annotations

import numpy as np
import torch

from meshrecon_torch import BACKGROUND_DEPTH
from meshrecon_torch.flow.tile_warp import tile_warp_sample_batched
from meshrecon_torch.geometry.camera import invert_cameras
from meshrecon_torch.raster.rasterizer import pixel_grid
from meshrecon_torch.utils.profiling import span, to_device


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


def sweep_planes(z_min, z_max, num_depths: int, device):
    """(z_min (B,), z_max (B,), zs (D, B)): the sweep ranges and the NDC
    depths of the ``num_depths`` planes, float32 on ``device``."""
    z_min = to_device(z_min, device, torch.float32).reshape(-1)
    z_max = to_device(z_max, device, torch.float32).reshape(-1)
    ts = to_device(np.linspace(0.0, 1.0, num_depths).astype(np.float32),
                   device)
    zs = z_min[None, :] + ts[:, None] * (z_max - z_min)[None, :]
    return z_min, z_max, zs


class SweepWindow:
    """A window of side frames for B main cameras, on the frames' device:
    the whole window, or one device's shard of it. ``evidence(d)`` is the
    photometric evidence of plane ``d``, the per-pixel sums over the
    window's sides of the weighted absolute differences (``num``) and of
    the weights (``den``), (B, H, W) each; ``n_sides`` (B,) counts its
    valid sides. Arguments as :func:`plane_sweep_depth_batched`'s; ``zs``
    (D, B) are the planes' NDC depths (:func:`sweep_planes`)."""

    def __init__(self, frames_main, frames_side, cam_mains, cams_side,
                 side_valid, zs, side_weight=None):
        self.fm = frames_main.to(torch.float32)
        self.fs = frames_side.to(torch.float32).contiguous()
        h, w = self.fm.shape[1:]
        dev = self.fm.device
        main_inv = invert_cameras(cam_mains.to(torch.float32))
        # (B, K, 4, 4)
        self.cm = cams_side.to(torch.float32) @ main_inv[:, None]
        self.vmask = side_valid.to(torch.float32)
        self.swt = (None if side_weight is None
                    else side_weight.to(torch.float32))
        self.n_sides = self.vmask.sum(dim=1)
        cols, rows = pixel_grid(h, w, dev)
        self.x = cols[None, None, None, :]
        self.y = rows[None, None, :, None]
        self.zs = zs.to(dev)

    def evidence(self, d: int):
        """(num, den) of plane ``d``, each (B, H, W)."""
        h, w = self.fm.shape[1:]
        x, y, zb = self.x, self.y, self.zs[d][:, None, None, None]

        def apply_cm(row):
            c = self.cm[:, :, row, :, None, None]
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
        samp = tile_warp_sample_batched(self.fs, scol.contiguous(),
                                        srow.contiguous(), ok.contiguous())
        diff = (samp - self.fm[:, None]).abs()
        wgt = ok.to(torch.float32) * self.vmask[:, :, None, None]
        if self.swt is not None:
            wgt = wgt * self.swt
        return (diff * wgt).sum(dim=1), wgt.sum(dim=1)


def sweep_windows(windows, z_min, z_max, num_depths: int):
    """The plane sweep of :func:`plane_sweep_depth_batched` over a window
    given as one :class:`SweepWindow` or as its shards in order (JAX's
    ``axis_name`` form): at each plane the shards' evidence, and once
    their side counts, are summed on the first shard's device in shard
    order (JAX's ``psum``), so the cost's last bits do not change from run
    to run. z_min, z_max: (B,) on that device. Returns its dict."""
    first = windows[0]
    b, h, w = first.fm.shape
    dev = first.fm.device
    zs = first.zs

    def cost_at(d):
        num, den = first.evidence(d)
        for win in windows[1:]:
            more_num, more_den = win.evidence(d)
            num = num + more_num.to(dev)
            den = den + more_den.to(dev)
        cost = num / den.clamp(min=1e-6)
        return _box3(cost), den

    with span("sweep", dev):
        big = torch.full((b, h, w), 1e30, dtype=torch.float32, device=dev)
        best_c, best_prev, best_next, last_c = big, big, big, big
        best_z = z_max[:, None, None].expand(b, h, w)
        pending = torch.zeros((b, h, w), dtype=torch.bool, device=dev)
        support = torch.zeros((b, h, w), dtype=torch.float32, device=dev)
        for d in range(num_depths):
            with span("plane", dev):
                z = zs[d]
                c, sup = cost_at(d)
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
        ok_ref = ((denom.abs() > 1e-12) & (best_prev < 1e29)
                  & (best_next < 1e29))
        offset = torch.where(ok_ref, 0.5 * (best_prev - best_next) / denom,
                             0.0)
        offset = offset.clamp(-1.0, 1.0)
        depth = best_z + offset * dz

        # two side views where the window has two; a single-side bundle is
        # classic two-view stereo (the reference's flow path needs only
        # one)
        n_sides = first.n_sides
        for win in windows[1:]:
            n_sides = n_sides + win.n_sides.to(dev)
        need = n_sides.clamp(min=1.0).clamp(max=2.0)[:, None, None]
        valid = support >= need
        depth = torch.where(valid, depth, BACKGROUND_DEPTH)
    return {"depth": depth, "cost": best_c, "valid": valid}


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
    z_min, z_max, zs = sweep_planes(z_min, z_max, num_depths,
                                    frames_main.device)
    window = SweepWindow(frames_main, frames_side, cam_mains, cams_side,
                         side_valid, zs, side_weight)
    return sweep_windows([window], z_min, z_max, num_depths)


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
        to_device(z_min, dev, torch.float32).reshape(1),
        to_device(z_max, dev, torch.float32).reshape(1),
        num_depths=num_depths,
        side_weight=None if side_weight is None else side_weight[None])
    return {k: v[0] for k, v in out.items()}
