"""The fused per-main-camera dense update, the hot loop body of every
reconstruction iteration (recon.cpp:65-119).

Port of meshrecon/pipeline/fused.py::fused_main_update_batched and
fused_main_update (flow path, taylor variance). Stages, with the kernels
that carry them on a CUDA device:

1. depth renders of all B*(K+1) cameras in one launch (K1);
2. projective texturing of the B*K side frames (K2), then the sequential
   background-mix chain over the sides;
3. one batched flow solve over all B*K (main, side) pairs: 2 pyramid
   levels, 1 warp per level (K3), 14 Chebyshev sweeps (K4), and the
   first-order ("taylor") re-warp for the variance;
4. pyramid-L1 variance, Gauss-Newton triangulation, normals (torch ops).
"""

from __future__ import annotations

import torch
from torch import nn

from meshrecon_torch.depth.normals import estimate_normals_batched
from meshrecon_torch.depth.triangulate import triangulate_pixels_batched
from meshrecon_torch.flow.pyramid import compare
from meshrecon_torch.flow.variational import variational_flow
from meshrecon_torch.raster.binned import render_depth_binned
from meshrecon_torch.raster.fragment import (mix_background,
                                             projected_image_batched)


def fused_main_update_batched(soup, soup_valid, cam_mains, frames_main,
                              side_cams, side_frames, side_valid, centers,
                              centers_valid, n_side, height: int, width: int,
                              use_farneback: bool = False,
                              sampling: str = "taylor",
                              flow_solver: str = "cheb",
                              variance: str = "taylor", levels: int = 2,
                              warps: int = 1, iters: int | None = None,
                              alpha: float = 12.0, rho: float = 0.98):
    """Full dense update for B main cameras x K (padded) sides each.

    soup: (T, 3, 3) world triangles + (T,) validity, shared by the batch;
    cam_mains: (B, 4, 4); frames_main: (B, H, W); side_cams: (B, K, 4, 4);
    side_frames: (B, K, H, W); side_valid: (B, K); centers: (B, C, 3);
    centers_valid: (B, C); n_side: (B,). All tensors on one device.

    Returns dict(point4, normals, pdf, valid, depth) with leading B, and
    ``gn_sweeps`` (the Gauss-Newton sweep count, one host sync each).
    """
    if use_farneback:
        raise NotImplementedError(
            "Farneback flow is not ported yet (ROADMAP Queue A, A10)")
    if variance != "taylor":
        raise NotImplementedError(
            f"variance={variance!r} needs the bicubic taps=4 warp, not "
            "ported yet (ROADMAP Queue B, K3b)")
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
                                            side_cams, all_depths[:, 1:])
    depth = depth0
    mixed_list = []
    for i in range(k):
        mixed, new_depth = mix_background(intens[:, i], masks[:, i],
                                          frames_main, depth)
        # padded sides leave the depth untouched
        depth = torch.where(side_valid[:, i, None, None], new_depth, depth)
        mixed_list.append(mixed)
    depth_final = depth
    mixed_all = torch.stack(mixed_list, dim=1)  # (B, K, H, W)

    # 3: one batched flow solve; the taylor re-warp feeds the variance
    flows2, rewarped = variational_flow(
        frames_main[:, None], mixed_all, levels=levels, iters=iters,
        warps=warps, alpha=alpha, solver=flow_solver, want_residual=True,
        rho=rho)
    var = compare(frames_main[:, None], rewarped)  # (B, K, H, W)

    # 4: triangulation and normals
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
    """

    def __init__(self, height: int, width: int, levels: int = 2,
                 warps: int = 1, iters: int = 14, alpha: float = 12.0,
                 rho: float = 0.98, sampling: str = "taylor",
                 flow_solver: str = "cheb"):
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
        self.last_gn_sweeps = 0

    def forward(self, soup, soup_valid, cam_mains, frames_main, side_cams,
                side_frames, side_valid, centers, centers_valid, n_side):
        out = fused_main_update_batched(
            soup, soup_valid, cam_mains, frames_main, side_cams, side_frames,
            side_valid, centers, centers_valid, n_side, self.height,
            self.width, sampling=self.sampling, flow_solver=self.flow_solver,
            levels=self.levels, warps=self.warps, iters=self.iters,
            alpha=self.alpha, rho=self.rho)
        self.last_gn_sweeps = out.pop("gn_sweeps")
        return out
