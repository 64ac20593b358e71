"""The fused per-main-camera dense updates, the hot loop body of every
reconstruction iteration (recon.cpp:65-119).

Port of meshrecon/pipeline/fused.py: fused_main_update_batched and
fused_main_update (the flow path), and the plane-sweep update of the
hybrid default's first iteration, fused_sweep_update_batched with
splat_visibility. The flow update's stages, with the kernels that carry
them on a CUDA device:

1. depth renders of all B*(K+1) cameras in one launch (K1);
2. projective texturing of the B*K side frames (K2, its shadow sampler
   nearest or bilinear), then the sequential background-mix chain over
   the sides;
3. one batched flow solve over all B*K (main, side) pairs: 2 pyramid
   levels, 1 warp per level (K3), 14 Chebyshev sweeps (K4), 60 Jacobi
   sweeps (K4) or 2 multigrid cycles (torch ops); or Farneback flow
   (``use_farneback``, torch ops and K3);
4. the variance input: the first-order ("taylor") re-warp through the
   solver's last linearization, or the remap-then-compare re-warp of the
   reference (``variance="rewarp"``, always with Farneback): bicubic K3b
   (``variance_taps`` 4) or bilinear K3 (2), as the TPU path does;
5. pyramid-L1 variance, Gauss-Newton triangulation, normals (torch ops).

The sweep update shares stages 1-2 (K1, K2 for the visibility masks), then
sweeps 64 depth planes (K3c per plane, ``depth/plane_sweep.py``).
"""

from __future__ import annotations

import torch
from torch import nn

from meshrecon_torch import BACKGROUND_DEPTH
from meshrecon_torch.depth.normals import estimate_normals_batched
from meshrecon_torch.depth.plane_sweep import plane_sweep_depth_batched
from meshrecon_torch.depth.triangulate import triangulate_pixels_batched
from meshrecon_torch.flow.api import farneback_params
from meshrecon_torch.flow.farneback import farneback_flow
from meshrecon_torch.flow.pyramid import compare
from meshrecon_torch.flow.tile_warp import tile_warp_flow_batched
from meshrecon_torch.flow.variational import variational_flow
from meshrecon_torch.raster.binned import render_depth_binned
from meshrecon_torch.raster.fragment import (mix_background,
                                             projected_image_batched)
from meshrecon_torch.raster.rasterizer import pixel_grid


def check_options(variance: str, variance_taps: int) -> None:
    if variance not in ("taylor", "rewarp"):
        raise ValueError(f"variance must be taylor|rewarp: {variance!r}")
    if variance_taps not in (2, 4):
        raise ValueError(f"variance_taps must be 2|4: {variance_taps}")


def mix_chain(intens, masks, frames_main, depth0, side_valid):
    """The sequential background-mix chain over the K sides: each side's
    mix sees the previous side's masked depth, and padded sides leave the
    depth untouched. intens, masks (B, K, H, W); frames_main, depth0
    (B, H, W); side_valid (B, K). Returns (mixed (B, K, H, W), the final
    depth (B, H, W)). Pointwise: a band of rows mixes alone."""
    depth = depth0
    mixed_list = []
    for i in range(intens.shape[1]):
        mixed, new_depth = mix_background(intens[:, i], masks[:, i],
                                          frames_main, depth)
        depth = torch.where(side_valid[:, i, None, None], new_depth, depth)
        mixed_list.append(mixed)
    return torch.stack(mixed_list, dim=1), depth


def fused_main_update_batched(soup, soup_valid, cam_mains, frames_main,
                              side_cams, side_frames, side_valid, centers,
                              centers_valid, n_side, height: int, width: int,
                              use_farneback: bool = False,
                              sampling: str = "taylor",
                              flow_solver: str = "cheb",
                              variance: str = "taylor",
                              variance_taps: int = 4,
                              shadow_sample: str = "nearest",
                              levels: int = 2, warps: int = 1,
                              iters: int | None = None, alpha: float = 12.0,
                              rho: float = 0.98, fine_warps: int = 1):
    """Full dense update for B main cameras x K (padded) sides each.

    soup: (T, 3, 3) world triangles + (T,) validity, shared by the batch;
    cam_mains: (B, 4, 4); frames_main: (B, H, W); side_cams: (B, K, 4, 4);
    side_frames: (B, K, H, W); side_valid: (B, K); centers: (B, C, 3);
    centers_valid: (B, C); n_side: (B,). All tensors on one device.

    flow_solver: "cheb", "jacobi" or "mg"; use_farneback replaces the
    variational solve. variance: "taylor" or "rewarp" (Farneback always
    re-warps), variance_taps 4 (bicubic) or 2 (bilinear); shadow_sample:
    "nearest" or "bilinear".

    Returns dict(point4, normals, pdf, valid, depth) with leading B, and
    ``gn_sweeps`` (the Gauss-Newton sweep count, one host sync each).
    """
    check_options(variance, variance_taps)
    frames_main = frames_main.to(torch.float32)
    side_cams = side_cams.to(torch.float32)
    side_frames = side_frames.to(torch.float32)
    cam_mains = cam_mains.to(torch.float32)
    side_valid = side_valid.to(torch.bool)
    b, k = side_frames.shape[:2]

    # 1: every depth render (B mains + B*K sides) in one launch
    all_cams = torch.cat([cam_mains[:, None], side_cams], dim=1)
    all_depths = render_depth_binned(
        all_cams.reshape(b * (k + 1), 4, 4), soup, soup_valid, height, width
    ).reshape(b, k + 1, height, width)
    depth0 = all_depths[:, 0]

    # 2: projective texturing of every side at once, then the sequential
    # mix chain (each side's mix sees the previous side's masked depth)
    intens, masks = projected_image_batched(cam_mains, depth0, side_frames,
                                            side_cams, all_depths[:, 1:],
                                            shadow_sample=shadow_sample)
    mixed_all, depth_final = mix_chain(intens, masks, frames_main, depth0,
                                       side_valid)

    # 3: one batched flow solve over every (main, side) pair
    rewarped = None
    if use_farneback:
        flows2 = farneback_flow(frames_main[:, None], mixed_all,
                                **farneback_params(height, width))
    else:
        flows2 = variational_flow(
            frames_main[:, None], mixed_all, levels=levels, iters=iters,
            warps=warps, alpha=alpha, solver=flow_solver,
            want_residual=variance == "taylor", rho=rho,
            fine_warps=fine_warps)
        if variance == "taylor":
            flows2, rewarped = flows2

    # 4: the variance's re-warp: taylor, or the remap-then-compare gather
    if rewarped is None:
        rewarped = tile_warp_flow_batched(
            mixed_all.contiguous(), flows2[..., 0].contiguous(),
            flows2[..., 1].contiguous(), taps=variance_taps)
    var = compare(frames_main[:, None], rewarped)  # (B, K, H, W)

    # 5: triangulation and normals
    out = triangulate_pixels_batched(flows2[..., 0], flows2[..., 1], var,
                                     cam_mains, side_cams, side_valid,
                                     depth_final, sampling=sampling)
    normals = estimate_normals_batched(out["point4"], out["valid"],
                                       out["pdf"], centers, centers_valid,
                                       n_side)
    return {
        "point4": out["point4"],
        "normals": normals,
        "pdf": out["pdf"],
        "valid": out["valid"],
        "depth": depth_final,
        "gn_sweeps": out["gn_sweeps"],
    }


def fused_main_update(soup, soup_valid, cam_main, frame_main, side_cams,
                      side_frames, side_valid, centers, centers_valid, n_side,
                      height: int, width: int, **kwargs):
    """The B=1 slice of :func:`fused_main_update_batched`: cam_main (4, 4),
    frame_main (H, W), side_cams (K, 4, 4), side_frames (K, H, W),
    side_valid (K,), centers (C, 3), centers_valid (C,), n_side scalar.
    Returns dict(point4, normals, pdf, valid, depth) without the batch."""
    n_side = torch.as_tensor(n_side, device=frame_main.device).reshape(1)
    out = fused_main_update_batched(
        soup, soup_valid, cam_main[None], frame_main[None], side_cams[None],
        side_frames[None], side_valid[None], centers[None],
        centers_valid[None], n_side, height, width, **kwargs)
    return {key: out[key][0]
            for key in ("point4", "normals", "pdf", "valid", "depth")}


class FusedMainUpdate(nn.Module):
    """The fused dense update as a module holding its configuration.

    ``forward`` takes the ten update inputs (see
    :func:`fused_main_update_batched`) and returns its output dict; the
    last call's Gauss-Newton sweep count is kept in ``last_gn_sweeps``.

    ``iters`` None means the solver's default: 14 Chebyshev or 60 Jacobi
    sweeps (the multigrid solver runs cycles and ignores it).
    """

    def __init__(self, height: int, width: int, levels: int = 2,
                 warps: int = 1, iters: int | None = None,
                 alpha: float = 12.0, rho: float = 0.98,
                 sampling: str = "taylor", flow_solver: str = "cheb",
                 fine_warps: int = 1, use_farneback: bool = False,
                 variance: str = "taylor", variance_taps: int = 4,
                 shadow_sample: str = "nearest"):
        super().__init__()
        self.height = height
        self.width = width
        self.levels = levels
        self.warps = warps
        self.iters = iters
        self.alpha = alpha
        self.rho = rho
        self.sampling = sampling
        self.flow_solver = flow_solver
        self.fine_warps = fine_warps
        self.use_farneback = use_farneback
        self.variance = variance
        self.variance_taps = variance_taps
        self.shadow_sample = shadow_sample
        self.last_gn_sweeps = 0

    def forward(self, soup, soup_valid, cam_mains, frames_main, side_cams,
                side_frames, side_valid, centers, centers_valid, n_side):
        out = fused_main_update_batched(
            soup, soup_valid, cam_mains, frames_main, side_cams, side_frames,
            side_valid, centers, centers_valid, n_side, self.height,
            self.width, use_farneback=self.use_farneback,
            sampling=self.sampling, flow_solver=self.flow_solver,
            variance=self.variance, variance_taps=self.variance_taps,
            shadow_sample=self.shadow_sample, levels=self.levels,
            warps=self.warps, iters=self.iters, alpha=self.alpha,
            rho=self.rho, fine_warps=self.fine_warps)
        self.last_gn_sweeps = out.pop("gn_sweeps")
        return out


def splat_visibility(pts4, valid, side_cams, height: int, width: int,
                     tol: float = 0.01):
    """Per-side visibility of a depth-map surface without a mesh.

    pts4 (B, H, W, 4) homogeneous world points of each main view's surface
    estimate; valid (B, H, W); side_cams (B, K, 4, 4). Returns (B, K, H, W)
    bool: main pixels whose point is the nearest surface claiming its
    side-view pixel. Every main pixel is projected into the side view and
    its side NDC z scatter-minimized over a 2x2 footprint; a pixel is
    visible iff its own z is within a slope-adaptive ``tol`` of the winner.
    """
    b, k = side_cams.shape[:2]
    proj = torch.einsum("bkij,bhwj->bkhwi", side_cams.to(torch.float32),
                        pts4.to(torch.float32))
    sw = proj[..., 3]
    behind = sw <= 1e-6
    sw_safe = torch.where(sw.abs() < 1e-6, 1e-6, sw)
    sx = proj[..., 0] / sw_safe
    sy = proj[..., 1] / sw_safe
    sz = proj[..., 2] / sw_safe
    scol = (sx + 1.0) * 0.5 * width
    srow = (1.0 - sy) * 0.5 * height
    inframe = (sx > -1.0) & (sx < 1.0) & (sy > -1.0) & (sy < 1.0) & ~behind
    ok = valid[:, None] & inframe

    def index(v, hi):
        return v.clamp(0, hi - 1).to(torch.int64)

    z = torch.where(ok, sz, float("inf")).reshape(b, k, -1)
    r0 = index(torch.floor(srow), height)
    c0 = index(torch.floor(scol), width)
    r1 = (r0 + 1).clamp(max=height - 1)
    c1 = (c0 + 1).clamp(max=width - 1)
    # 2x2 footprint: closes the gaps a one-cell splat leaves where the side
    # view magnifies the surface (up to 2x)
    buf = torch.full((b, k, height * width), float("inf"),
                     dtype=torch.float32, device=pts4.device)
    for rr, cc in ((r0, c0), (r0, c1), (r1, c0), (r1, c1)):
        buf.scatter_reduce_(2, (rr * width + cc).reshape(b, k, -1), z,
                            "amin")
    rq = index(torch.round(srow), height)
    cq = index(torch.round(scol), width)
    won = torch.gather(buf, 2, (rq * width + cq).reshape(b, k, -1)).reshape(
        b, k, height, width)
    # slope-adaptive bias from valid-valid neighbour pairs only: off-frame
    # and behind-camera pixels hold arbitrary z
    ok_u = ok & torch.cat([ok[..., 1:], ok[..., -1:]], dim=-1)
    ok_v = ok & torch.cat([ok[..., 1:, :], ok[..., -1:, :]], dim=-2)
    dzu = torch.where(ok_u, torch.diff(sz, dim=-1,
                                       append=sz[..., -1:]).abs(), 0.0)
    dzv = torch.where(ok_v, torch.diff(sz, dim=-2,
                                       append=sz[..., -1:, :]).abs(), 0.0)
    tol_eff = tol + 2.0 * (dzu + dzv)
    return ok & (sz <= won + tol_eff)


def fused_sweep_update_batched(soup, soup_valid, cam_mains, frames_main,
                               side_cams, side_frames, side_valid, centers,
                               centers_valid, n_side, height: int,
                               width: int, num_depths: int = 64,
                               passes: int = 1,
                               shadow_sample: str = "nearest"):
    """Plane-sweep counterpart of :func:`fused_main_update_batched` (same
    ten inputs): all B*(K+1) depth renders (K1), the per-side shadow-mapped
    visibility masks (K2), each main camera's z range from its rendered
    depth, the plane sweep (K3c), back-projection and normals. With
    ``passes`` > 1, each further sweep takes its side visibility from the
    previous sweep's depth map (:func:`splat_visibility`). shadow_sample
    is the visibility masks' shadow sampler, "nearest" or "bilinear".

    Returns dict(point4, normals, pdf, valid, depth) with leading B; depth
    is the main camera's rendered depth.
    """
    frames_main = frames_main.to(torch.float32)
    side_cams = side_cams.to(torch.float32)
    side_frames = side_frames.to(torch.float32)
    cam_mains = cam_mains.to(torch.float32)
    side_valid = side_valid.to(torch.bool)
    b, k = side_frames.shape[:2]

    all_cams = torch.cat([cam_mains[:, None], side_cams], dim=1)
    all_depths = render_depth_binned(
        all_cams.reshape(b * (k + 1), 4, 4), soup, soup_valid, height, width
    ).reshape(b, k + 1, height, width)
    depth0 = all_depths[:, 0]

    # visibility of the current surface estimate: the sweep's vote weights
    _, masks = projected_image_batched(cam_mains, depth0, side_frames,
                                       side_cams, all_depths[:, 1:],
                                       shadow_sample=shadow_sample)

    # per-camera sweep range from the rendered depth span, widened by 10%
    dvalid = depth0 < BACKGROUND_DEPTH
    big = 3e38
    zlo = torch.where(dvalid, depth0, big).amin(dim=(1, 2))
    zhi = torch.where(dvalid, depth0, -big).amax(dim=(1, 2))
    any_valid = dvalid.any(dim=2).any(dim=1)
    zlo = torch.where(any_valid, zlo, -1.0)
    zhi = torch.where(any_valid, zhi, 1.0)
    span = (zhi - zlo).clamp(min=0.05)
    zlo = zlo - 0.1 * span
    zhi = zhi + 0.1 * span

    out = plane_sweep_depth_batched(
        frames_main, side_frames, cam_mains, side_cams, side_valid, zlo, zhi,
        num_depths=num_depths, side_weight=masks.to(torch.float32))

    main_inv = torch.linalg.inv(cam_mains)
    cols, rows = pixel_grid(height, width, frames_main.device)
    x = cols[None, None, :].expand(b, height, width)
    y = rows[None, :, None].expand(b, height, width)

    def backproject(depth):
        ndc4 = torch.stack([x, y, depth, torch.ones_like(x)], dim=-1)
        return torch.einsum("bij,bhwj->bhwi", main_inv, ndc4)

    for _ in range(passes - 1):
        vis1 = out["valid"] & dvalid
        masks2 = splat_visibility(backproject(out["depth"]), vis1, side_cams,
                                  height, width)
        out = plane_sweep_depth_batched(
            frames_main, side_frames, cam_mains, side_cams, side_valid, zlo,
            zhi, num_depths=num_depths, side_weight=masks2.to(torch.float32))

    valid = out["valid"] & dvalid & any_valid[:, None, None]
    pts4 = backproject(out["depth"])
    pdf = 1.0 / (1.0 + out["cost"])
    normals = estimate_normals_batched(pts4, valid, pdf, centers,
                                       centers_valid, n_side)
    return {
        "point4": pts4,
        "normals": normals,
        "pdf": pdf,
        "valid": valid,
        "depth": depth0,
    }


class FusedSweepUpdate(nn.Module):
    """The plane-sweep update as a module holding its configuration;
    ``forward`` takes the ten update inputs and returns the output dict of
    :func:`fused_sweep_update_batched`."""

    def __init__(self, height: int, width: int, num_depths: int = 64,
                 passes: int = 1, shadow_sample: str = "nearest"):
        super().__init__()
        self.height = height
        self.width = width
        self.num_depths = num_depths
        self.passes = passes
        self.shadow_sample = shadow_sample

    def forward(self, soup, soup_valid, cam_mains, frames_main, side_cams,
                side_frames, side_valid, centers, centers_valid, n_side):
        return fused_sweep_update_batched(
            soup, soup_valid, cam_mains, frames_main, side_cams, side_frames,
            side_valid, centers, centers_valid, n_side, self.height,
            self.width, num_depths=self.num_depths, passes=self.passes,
            shadow_sample=self.shadow_sample)
