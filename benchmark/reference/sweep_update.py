"""The sweep update, plain: what the program's plane-sweep update (the
hybrid default's first iteration) computes for B main cameras with K
(padded) sides each, composed of the reference's layers in the program's
order: the B*(K+1) renders, the sides' visibility masks (projective
texturing's shadow test) as the sweep's vote weights, each main's z range
from its rendered depth widened by 10%, one batched plane sweep with those
weights and ranges, back-projection, ``pdf = 1 / (1 + cost)`` and normals.

The sweep is written here for a batch of mains, each with its own range
and weights; with every weight 1 each main's sweep is
:func:`benchmark.reference.plane_sweep.plane_sweep`'s.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.fragment import bilinear_sample, projected_image
from benchmark.reference.normals import estimate_normals_batched
from benchmark.reference.plane_sweep import _box3
from benchmark.reference.precision import Arith, round_tf32
from benchmark.reference.raster import (BACKGROUND_DEPTH, pixel_grid,
                                        render_depth)


def z_ranges(depth0):
    """(z_min (B,), z_max (B,), any_valid (B,)): each main's sweep range,
    the span of its rendered depth widened by 10% (at least 0.05 wide),
    -1 to 1 where it renders nothing."""
    dvalid = depth0 < BACKGROUND_DEPTH
    big = 3e38
    zlo = torch.where(dvalid, depth0, big).amin(dim=(1, 2))
    zhi = torch.where(dvalid, depth0, -big).amax(dim=(1, 2))
    any_valid = dvalid.any(dim=2).any(dim=1)
    zlo = torch.where(any_valid, zlo, -1.0)
    zhi = torch.where(any_valid, zhi, 1.0)
    span_z = (zhi - zlo).clamp(min=0.05)
    return zlo - 0.1 * span_z, zhi + 0.1 * span_z, any_valid


def weighted_sweep(arith, frames_main, frames_side, cam_mains, cams_side,
                   side_valid, z_min, z_max, num_depths: int,
                   side_weight) -> dict:
    """The plane sweep of B mains: frames_main (B, H, W), frames_side
    (B, K, H, W), cam_mains (B, 4, 4), cams_side (B, K, 4, 4), side_valid
    (B, K), z_min and z_max (B,), side_weight (B, K, H, W) vote weights.
    At each plane every side is resampled onto its main (0 outside the
    side's frame), scored by |diff| x (in frame) x (valid side) x weight,
    summed over the sides, normalised and 3x3 box-filtered; a running
    (best, previous, next) cost gives a parabolic sub-plane refinement.
    Returns dict(depth, cost, valid), each (B, H, W)."""
    fm = frames_main.to(torch.float32)
    fs = frames_side.to(torch.float32)
    b, h, w = fm.shape
    dev = fm.device
    vmask = side_valid.to(torch.float32)
    swt = side_weight.to(torch.float32)
    ts = torch.from_numpy(np.linspace(0.0, 1.0, num_depths).astype(
        np.float32)).to(dev)
    z_min = z_min.to(torch.float32)
    z_max = z_max.to(torch.float32)
    zs = z_min[None, :] + ts[:, None] * (z_max - z_min)[None, :]
    main_inv = torch.linalg.inv(cam_mains.to(torch.float32))
    cm = arith.matmul(cams_side.to(torch.float32), main_inv[:, None])
    cols, rows = pixel_grid(h, w, dev)
    x = cols[None, None, None, :]
    y = rows[None, None, :, None]

    big = torch.full((b, h, w), 1e30, dtype=torch.float32, device=dev)
    best_c, best_prev, best_next, last_c = big, big, big, big
    best_z = z_max[:, None, None].expand(b, h, w)
    pending = torch.zeros((b, h, w), dtype=torch.bool, device=dev)
    support = torch.zeros((b, h, w), dtype=torch.float32, device=dev)
    for d in range(num_depths):
        zb = zs[d][:, None, None, None]

        def apply_cm(row):
            c = cm[:, :, row, :, None, None]
            return (c[:, :, 0] * x + c[:, :, 1] * y + c[:, :, 2] * zb
                    + c[:, :, 3])

        s0, s1, sw = apply_cm(0), apply_cm(1), apply_cm(3)
        ok = sw > 1e-6
        sw = torch.where(sw.abs() < 1e-6, 1e-6, sw)
        sx = s0 / sw
        sy = s1 / sw
        ok &= (sx.abs() < 1.0) & (sy.abs() < 1.0)
        scol = (sx + 1.0) * 0.5 * w
        srow = (1.0 - sy) * 0.5 * h
        samp = torch.where(ok, bilinear_sample(fs, scol, srow), 0.0)
        diff = (samp - fm[:, None]).abs()
        wgt = ok.to(torch.float32) * vmask[:, :, None, None] * swt
        num, den = (diff * wgt).sum(dim=1), wgt.sum(dim=1)
        c = _box3(num / den.clamp(min=1e-6))
        is_best = c < best_c
        best_prev = torch.where(is_best, last_c, best_prev)
        best_next = torch.where(pending & ~is_best, c, best_next)
        pending = is_best
        best_z = torch.where(is_best, zs[d][:, None, None], best_z)
        best_c = torch.where(is_best, c, best_c)
        support = torch.maximum(support, den)
        last_c = c
    dz = ((z_max - z_min) / (num_depths - 1))[:, None, None]
    denom = best_prev - 2.0 * best_c + best_next
    ok_ref = ((denom.abs() > 1e-12) & (best_prev < 1e29)
              & (best_next < 1e29))
    offset = torch.where(ok_ref, 0.5 * (best_prev - best_next) / denom,
                         0.0).clamp(-1.0, 1.0)
    depth = best_z + offset * dz
    need = vmask.sum(dim=1).clamp(min=1.0).clamp(max=2.0)[:, None, None]
    valid = support >= need
    depth = torch.where(valid, depth, BACKGROUND_DEPTH)
    return {"depth": depth, "cost": best_c, "valid": valid}


def backproject(arith, cam_mains, depth):
    """(B, H, W, 4) homogeneous world points of each main's NDC depth."""
    b, h, w = depth.shape
    main_inv = torch.linalg.inv(cam_mains.to(torch.float32))
    cols, rows = pixel_grid(h, w, depth.device)
    x = cols[None, None, :].expand(b, h, w)
    y = rows[None, :, None].expand(b, h, w)
    ndc4 = torch.stack([x, y, depth, torch.ones_like(x)], dim=-1)
    if arith.precision == "tf32":
        main_inv, ndc4 = round_tf32(main_inv), round_tf32(ndc4)
    return torch.einsum("bij,bhwj->bhwi", main_inv, ndc4)


def sweep_update(inputs, height: int, width: int, options: dict,
                 precision: str = "float32") -> dict:
    """inputs: the update's ten inputs (soup, soup_valid, cam_mains,
    frames_main, side_cams, side_frames, side_valid, centers,
    centers_valid, n_side); options: num_depths. Returns dict(point4,
    normals, pdf, valid, depth), depth the mains' rendered depth."""
    (soup, soup_valid, cam_mains, frames_main, side_cams, side_frames,
     side_valid, centers, centers_valid, n_side) = inputs
    arith = Arith(precision)
    with arith.backend(), torch.no_grad():
        frames_main = frames_main.to(torch.float32)
        side_cams = side_cams.to(torch.float32)
        side_frames = side_frames.to(torch.float32)
        cam_mains = cam_mains.to(torch.float32)
        side_valid = side_valid.to(torch.bool)
        b, k = side_frames.shape[:2]
        all_cams = torch.cat([cam_mains[:, None], side_cams], dim=1)
        all_depths = render_depth(all_cams.reshape(b * (k + 1), 4, 4), soup,
                                  soup_valid, height, width).reshape(
                                      b, k + 1, height, width)
        depth0 = all_depths[:, 0]
        _, masks = projected_image(arith, cam_mains, depth0, side_frames,
                                   side_cams, all_depths[:, 1:])
        z_min, z_max, any_valid = z_ranges(depth0)
        out = weighted_sweep(arith, frames_main, side_frames, cam_mains,
                             side_cams, side_valid, z_min, z_max,
                             options["num_depths"], masks.to(torch.float32))
        valid = (out["valid"] & (depth0 < BACKGROUND_DEPTH)
                 & any_valid[:, None, None])
        point4 = backproject(arith, cam_mains, out["depth"])
        pdf = 1.0 / (1.0 + out["cost"])
        normals = estimate_normals_batched(point4, valid, pdf, centers,
                                           centers_valid, n_side)
    return {"point4": point4, "normals": normals, "pdf": pdf,
            "valid": valid, "depth": depth0}
