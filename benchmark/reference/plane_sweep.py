"""Plain plane-sweep photometric depth (a frozen copy of the program's
plain path): D depth planes through the main camera's frustum; at each,
every side frame resampled bilinearly onto the main view (0 where it
falls outside the side's frame), scored by the absolute difference,
summed over the sides, normalised, 3x3 box-filtered; a running (best,
previous, next) cost gives a parabolic sub-plane refinement."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.fragment import bilinear_sample
from benchmark.reference.precision import Arith
from benchmark.reference.raster import BACKGROUND_DEPTH, pixel_grid


def _box3(img):
    h, w = img.shape[-2:]
    p = torch.nn.functional.pad(img.reshape(-1, 1, h, w), (1, 1, 1, 1),
                                mode="replicate").reshape(
                                    *img.shape[:-2], h + 2, w + 2)
    return (p[..., :-2, :-2] + p[..., :-2, 1:-1] + p[..., :-2, 2:]
            + p[..., 1:-1, :-2] + p[..., 1:-1, 1:-1] + p[..., 1:-1, 2:]
            + p[..., 2:, :-2] + p[..., 2:, 1:-1] + p[..., 2:, 2:]) / 9.0


def sample_fields(arith, cam_main, cams_side, z, height: int, width: int):
    """Where the main view's pixels at NDC depth z fall in each side:
    (scol, srow, ok), each (K, H, W)."""
    main_inv = torch.linalg.inv(cam_main.to(torch.float32))
    cm = arith.matmul(cams_side.to(torch.float32), main_inv[None])
    cols, rows = pixel_grid(height, width, cam_main.device)
    x = cols[None, None, :]
    y = rows[None, :, None]

    def apply_cm(row):
        c = cm[:, row, :, None, None]
        return c[:, 0] * x + c[:, 1] * y + c[:, 2] * z + c[:, 3]

    s0, s1, sw = apply_cm(0), apply_cm(1), apply_cm(3)
    ok = sw > 1e-6
    sw = torch.where(sw.abs() < 1e-6, 1e-6, sw)
    sx = s0 / sw
    sy = s1 / sw
    ok &= (sx.abs() < 1.0) & (sy.abs() < 1.0)
    return (sx + 1.0) * 0.5 * width, (1.0 - sy) * 0.5 * height, ok


def plane_sweep(frame_main, frames_side, cam_main, cams_side, side_valid,
                z_min: float, z_max: float, num_depths: int,
                precision: str = "float32") -> dict:
    """One main camera: frame_main (H, W), frames_side (K, H, W), cam_main
    (4, 4), cams_side (K, 4, 4), side_valid (K,). Returns dict(depth,
    cost, valid), each (H, W)."""
    arith = Arith(precision)
    with arith.backend(), torch.no_grad():
        fm = frame_main.to(torch.float32)
        fs = frames_side.to(torch.float32)
        h, w = fm.shape
        dev = fm.device
        vmask = side_valid.to(torch.float32)
        ts = torch.from_numpy(np.linspace(0.0, 1.0, num_depths).astype(
            np.float32)).to(dev)
        zmin = torch.tensor(z_min, dtype=torch.float32, device=dev)
        zmax = torch.tensor(z_max, dtype=torch.float32, device=dev)
        zs = zmin + ts * (zmax - zmin)
        big = torch.full((h, w), 1e30, dtype=torch.float32, device=dev)
        best_c, best_prev, best_next, last_c = big, big, big, big
        best_z = zmax.expand(h, w)
        pending = torch.zeros((h, w), dtype=torch.bool, device=dev)
        support = torch.zeros((h, w), dtype=torch.float32, device=dev)
        for d in range(num_depths):
            z = zs[d]
            scol, srow, ok = sample_fields(arith, cam_main, cams_side, z, h,
                                           w)
            samp = torch.where(ok, bilinear_sample(fs, scol, srow), 0.0)
            diff = (samp - fm[None]).abs()
            wgt = ok.to(torch.float32) * vmask[:, None, None]
            num, den = (diff * wgt).sum(dim=0), wgt.sum(dim=0)
            c = _box3(num / den.clamp(min=1e-6))
            is_best = c < best_c
            best_prev = torch.where(is_best, last_c, best_prev)
            best_next = torch.where(pending & ~is_best, c, best_next)
            pending = is_best
            best_z = torch.where(is_best, z, best_z)
            best_c = torch.where(is_best, c, best_c)
            support = torch.maximum(support, den)
            last_c = c
        dz = (zmax - zmin) / (num_depths - 1)
        denom = best_prev - 2.0 * best_c + best_next
        ok_ref = ((denom.abs() > 1e-12) & (best_prev < 1e29)
                  & (best_next < 1e29))
        offset = torch.where(ok_ref, 0.5 * (best_prev - best_next) / denom,
                             0.0).clamp(-1.0, 1.0)
        depth = best_z + offset * dz
        need = vmask.sum().clamp(min=1.0).clamp(max=2.0)
        valid = support >= need
        depth = torch.where(valid, depth, BACKGROUND_DEPTH)
    return {"depth": depth, "cost": best_c, "valid": valid}
