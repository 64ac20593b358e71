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

On the CPU each plane is eager ops (:class:`SweepWindow` and the running
best in :func:`sweep_windows`, the plain version). On CUDA a plane is K3c
and three kernels (``csrc/sweep.cu``, :class:`KernelWindow`): SWEEP_PROJ
maps the pixels into each side (K3c's mask and coordinates), SWEEP_COST
sums each window's evidence over its sides, SWEEP_BEST box-filters the
cost and updates the running best in place; no eager op runs a plane (the
shards' evidence of a sharded window is summed eagerly), and the outputs
are the eager path's bit for bit. Each such plane counts ``sweep_kernel``.
"""

from __future__ import annotations

import numpy as np
import torch

from meshrecon_torch import BACKGROUND_DEPTH
from meshrecon_torch.flow.tile_warp import tile_warp_sample_batched
from meshrecon_torch.geometry.camera import invert_cameras
from meshrecon_torch.kernels._build import Kernel, check_cuda, check_like
from meshrecon_torch.raster.rasterizer import pixel_grid
from meshrecon_torch.utils.profiling import count, span, to_device

_SWEEP_SOURCE = "meshrecon_torch/csrc/sweep.cu"
SWEEP_PROJ = Kernel("sweep_proj", "mr_sweep_proj", _SWEEP_SOURCE,
                    "meshrecon/depth/plane_sweep.py:152 (cost_at's sample "
                    "coordinates; XLA-fused)")
SWEEP_COST = Kernel("sweep_cost", "mr_sweep_cost", _SWEEP_SOURCE,
                    "meshrecon/depth/plane_sweep.py:152 (cost_at's sums "
                    "over sides; XLA-fused)")
SWEEP_BEST = Kernel("sweep_best", "mr_sweep_best", _SWEEP_SOURCE,
                    "meshrecon/depth/plane_sweep.py:191 (step: the box "
                    "filter and running best; XLA-fused)")


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
    (D, B) are the planes' NDC depths (:func:`sweep_planes`). The plain
    version, eager ops a plane; :func:`sweep_window` gives
    :class:`KernelWindow` on CUDA."""

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
        self.cols, self.rows = pixel_grid(h, w, dev)
        self.x = self.cols[None, None, None, :]
        self.y = self.rows[None, None, :, None]
        self.zs = zs.to(dev)

    def fields(self, d: int):
        """SWEEP_PROJ's plain version: (ok, scol, srow) of plane ``d``,
        (B, K, H, W) each: K3c's mask (padded slots too) and the side
        pixels' columns and rows."""
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
        return ok, scol, srow

    def sums(self, samp, ok):
        """SWEEP_COST's plain version: (num, den), (B, H, W) each, from
        K3c's samples ``samp`` and mask ``ok`` (B, K, H, W)."""
        diff = (samp - self.fm[:, None]).abs()
        wgt = ok.to(torch.float32) * self.vmask[:, :, None, None]
        if self.swt is not None:
            wgt = wgt * self.swt
        return (diff * wgt).sum(dim=1), wgt.sum(dim=1)

    def evidence(self, d: int):
        """(num, den) of plane ``d``, each (B, H, W)."""
        ok, scol, srow = self.fields(d)
        samp = tile_warp_sample_batched(self.fs, scol.contiguous(),
                                        srow.contiguous(), ok.contiguous())
        return self.sums(samp, ok)


class KernelWindow(SweepWindow):
    """:class:`SweepWindow` on CUDA tensors, the same arguments:
    ``evidence(d)`` is SWEEP_PROJ, K3c and SWEEP_COST into buffers made
    once a window, so the (num, den) it returns are overwritten by the next
    plane's. The camera products stay eager ((B, K, 4, 4): torch's own
    bits)."""

    def __init__(self, frames_main, frames_side, cam_mains, cams_side,
                 side_valid, zs, side_weight=None):
        super().__init__(frames_main, frames_side, cam_mains, cams_side,
                         side_valid, zs, side_weight)
        self.fm = self.fm.contiguous()
        self.cm = self.cm.contiguous()
        self.zs = self.zs.to(torch.float32).contiguous()
        self.side_valid = side_valid.to(torch.bool).contiguous()
        if self.swt is not None:
            self.swt = self.swt.contiguous()
        b, k, h, w = self.fs.shape
        if (self.fm.shape != (b, h, w) or self.cm.shape != (b, k, 4, 4)
                or self.side_valid.shape != (b, k)
                or self.zs.dim() != 2 or self.zs.shape[1] != b
                or (self.swt is not None and self.swt.shape != (b, k, h, w))):
            raise ValueError("KernelWindow: the inputs' shapes disagree")
        check_cuda("KernelWindow", self.fs, self.fm, self.cm, self.zs,
                   self.cols, self.rows)
        check_cuda("KernelWindow", self.side_valid, dtype=torch.bool)
        if self.swt is not None:
            check_like("KernelWindow", self.fs, self.swt)
        if self.side_valid.device != self.fs.device:
            raise ValueError(f"KernelWindow: side_valid on "
                             f"{self.side_valid.device}, the frames on "
                             f"{self.fs.device}")
        self.ok = torch.empty(self.fs.shape, dtype=torch.bool,
                              device=self.fs.device)
        self.scol, self.srow, self.samp = (torch.empty_like(self.fs)
                                           for _ in range(3))
        self.num, self.den = (torch.empty_like(self.fm) for _ in range(2))

    def evidence(self, d: int):
        """(num, den) of plane ``d``, each (B, H, W): the window's
        buffers."""
        b, k, h, w = self.fs.shape
        if not 0 <= d < self.zs.shape[0]:
            raise ValueError(f"KernelWindow: plane {d} of "
                             f"{self.zs.shape[0]}")
        SWEEP_PROJ.launch(self.cm, self.zs, self.side_valid, self.cols,
                          self.rows, self.ok, self.scol, self.srow, d, b, k,
                          h, w)
        tile_warp_sample_batched(self.fs, self.scol, self.srow, self.ok,
                                 out=self.samp)
        SWEEP_COST.launch(self.samp, self.ok, self.side_valid, self.fm,
                          self.swt, self.num, self.den, b, k, h, w)
        return self.num, self.den


def sweep_window(frames_main, *args, **kwargs):
    """The window's :class:`KernelWindow` on CUDA, :class:`SweepWindow`
    elsewhere (the same arguments)."""
    cls = KernelWindow if frames_main.is_cuda else SweepWindow
    return cls(frames_main, *args, **kwargs)


def sweep_best(num, den, zs, d: int, state, pending) -> None:
    """SWEEP_BEST: plane ``d``'s box-filtered cost from its evidence
    ``num``, ``den`` (B, H, W), taken into the running best in place:
    ``state`` (6, B, H, W) float32 (the best cost, the costs before and
    after it, the last cost, the best plane's depth, the support) and
    ``pending`` (B, H, W) bool; ``zs`` (D, B) float32 on the card."""
    b, h, w = num.shape
    check_like("sweep_best", num, den)
    check_cuda("sweep_best", num, zs, state)
    check_cuda("sweep_best", pending, dtype=torch.bool)
    if pending.device != num.device:
        raise ValueError(f"sweep_best: pending on {pending.device}, "
                         f"expected {num.device}")
    if (state.shape != (6, b, h, w) or pending.shape != (b, h, w)
            or zs.dim() != 2 or zs.shape[1] != b):
        raise ValueError("sweep_best: the inputs' shapes disagree")
    if not 0 <= d < zs.shape[0]:
        raise ValueError(f"sweep_best: plane {d} of {zs.shape[0]}")
    SWEEP_BEST.launch(num, den, zs, state, pending, d, b, h, w)


def take_plane(best: dict, num, den, z) -> dict:
    """SWEEP_BEST's plain version: the running best after the plane of
    evidence ``num``, ``den`` (B, H, W) and depth ``z`` (B,); ``best``
    holds ``best_c``, ``best_prev``, ``best_next``, ``last_c``,
    ``best_z``, ``support`` and ``pending`` (B, H, W). Returns a new
    dict."""
    c = _box3(num / den.clamp(min=1e-6))
    is_best = c < best["best_c"]
    return {
        "best_c": torch.where(is_best, c, best["best_c"]),
        "best_prev": torch.where(is_best, best["last_c"], best["best_prev"]),
        "best_next": torch.where(best["pending"] & ~is_best, c,
                                 best["best_next"]),
        "last_c": c,
        "best_z": torch.where(is_best, z[:, None, None], best["best_z"]),
        "support": torch.maximum(best["support"], den),
        "pending": is_best,
    }


def _planes_eager(evidence, zs, z_max, num_depths: int, shape, dev):
    """The running best over the planes, eager ops a plane: (best_c,
    best_prev, best_next, best_z, support)."""
    big = torch.full(shape, 1e30, dtype=torch.float32, device=dev)
    best = {"best_c": big, "best_prev": big, "best_next": big, "last_c": big,
            "best_z": z_max[:, None, None].expand(shape),
            "support": torch.zeros(shape, dtype=torch.float32, device=dev),
            "pending": torch.zeros(shape, dtype=torch.bool, device=dev)}
    for d in range(num_depths):
        with span("plane", dev):
            best = take_plane(best, *evidence(d), zs[d])
    return tuple(best[key] for key in ("best_c", "best_prev", "best_next",
                                       "best_z", "support"))


def _planes_on_card(evidence, zs, z_max, num_depths: int, shape, dev):
    """:func:`_planes_eager` with SWEEP_BEST a plane, each counted
    (``sweep_kernel``); the state's set-up is eager, once."""
    state = torch.empty((6, *shape), dtype=torch.float32, device=dev)
    state[:4] = 1e30
    state[4] = z_max[:, None, None]
    state[5] = 0.0
    pending = torch.zeros(shape, dtype=torch.bool, device=dev)
    for d in range(num_depths):
        with span("plane", dev):
            num, den = evidence(d)
            sweep_best(num, den, zs, d, state, pending)
            count("sweep_kernel")
    return state[0], state[1], state[2], state[4], state[5]


def sweep_windows(windows, z_min, z_max, num_depths: int):
    """The plane sweep of :func:`plane_sweep_depth_batched` over a window
    given as one :class:`SweepWindow` or as its shards in order (JAX's
    ``axis_name`` form): at each plane the shards' evidence, and once
    their side counts, are summed on the first shard's device in shard
    order (JAX's ``psum``), so the cost's last bits do not change from run
    to run. z_min, z_max: (B,) on that device. Returns its dict. With
    :class:`KernelWindow` shards the running best is SWEEP_BEST's."""
    first = windows[0]
    b, h, w = first.fm.shape
    dev = first.fm.device

    def evidence(d):
        num, den = first.evidence(d)
        for win in windows[1:]:
            more_num, more_den = win.evidence(d)
            num = num + more_num.to(dev)
            den = den + more_den.to(dev)
        return num, den

    planes = (_planes_on_card if isinstance(first, KernelWindow)
              else _planes_eager)
    with span("sweep", dev):
        best_c, best_prev, best_next, best_z, support = planes(
            evidence, first.zs, z_max, num_depths, (b, h, w), dev)

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
    window = sweep_window(frames_main, frames_side, cam_mains, cams_side,
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
