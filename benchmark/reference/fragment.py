"""Plain projective texturing and background mixing (a frozen copy of the
program's plain fragment stage): reproject each main pixel into the side
camera, test the 3x3-max dilated shadow map (+0.01 NDC bias, sampled
nearest, rounding half up), sample the side frame bilinearly."""

from __future__ import annotations

import torch

from benchmark.reference.raster import BACKGROUND_DEPTH, pixel_grid


def dilate3x3_max(depth):
    """3x3 max dilation over the last two axes, -inf outside."""
    h, w = depth.shape[-2:]
    p = torch.nn.functional.pad(depth.reshape(-1, 1, h, w), (1, 1, 1, 1),
                                value=float("-inf"))[:, 0]
    out = p[:, 0:h, 0:w]
    for dr in range(3):
        for dc in range(3):
            if dr or dc:
                out = torch.maximum(out, p[:, dr:dr + h, dc:dc + w])
    return out.reshape(depth.shape)


def gather2d(image, r, c):
    """image[..., r, c] for integer index tensors shaped like the samples."""
    h, w = image.shape[-2:]
    flat = image.reshape(*image.shape[:-2], h * w)
    idx = (r * w + c).reshape(*r.shape[:-2], -1)
    return torch.gather(flat, -1, idx).reshape(r.shape)


def as_index(v):
    """float index -> int64; NaN maps to 0."""
    return torch.nan_to_num(v, nan=0.0).to(torch.int64)


def bilinear_sample(image, col, row):
    """Bilinear sample of image (..., H, W) at (col, row) of the same
    leading shape; clamped borders."""
    h, w = image.shape[-2:]
    col = col.clamp(0.0, w - 1.0)
    row = row.clamp(0.0, h - 1.0)
    c0 = as_index(torch.floor(col))
    r0 = as_index(torch.floor(row))
    c1 = (c0 + 1).clamp(max=w - 1)
    r1 = (r0 + 1).clamp(max=h - 1)
    fc = col - c0
    fr = row - r0
    v00 = gather2d(image, r0, c0)
    v01 = gather2d(image, r0, c1)
    v10 = gather2d(image, r1, c0)
    v11 = gather2d(image, r1, c1)
    return (v00 * (1 - fr) * (1 - fc) + v01 * (1 - fr) * fc
            + v10 * fr * (1 - fc) + v11 * fr * fc)


def nearest_sample(image, col, row):
    """Nearest sample rounding half up, border-clamped."""
    h, w = image.shape[-2:]
    c = as_index(torch.floor(col + 0.5).clamp(0, w - 1))
    r = as_index(torch.floor(row + 0.5).clamp(0, h - 1))
    return gather2d(image, r, c)


def projected_image(arith, cam_mains, depth_mains, frames, projectors,
                    depth_sides):
    """B mains x K sides: (intensity (B, K, H, W), mask (B, K, H, W))."""
    b, k, h, w = frames.shape
    depth_mains = depth_mains.to(torch.float32)
    frames = frames.to(torch.float32)
    shadow = dilate3x3_max(depth_sides.to(torch.float32))
    cols, rows = pixel_grid(h, w, frames.device)
    x = cols[None, :]
    y = rows[:, None]
    z = depth_mains[:, None]
    valid = z != BACKGROUND_DEPTH
    main_inv = torch.linalg.inv(cam_mains.to(torch.float32))
    side = arith.matmul(projectors.to(torch.float32), main_inv[:, None])

    def apply_side(row):
        s = side[:, :, row, :, None, None]
        return s[:, :, 0] * x + s[:, :, 1] * y + s[:, :, 2] * z + s[:, :, 3]

    s0, s1, s2, sw = apply_side(0), apply_side(1), apply_side(2), apply_side(3)
    behind = sw <= 1e-6
    sw_safe = torch.where(sw.abs() < 1e-6, 1e-6, sw)
    sx = s0 / sw_safe
    sy = s1 / sw_safe
    sz = s2 / sw_safe
    scol = (sx + 1.0) * 0.5 * w
    srow = (1.0 - sy) * 0.5 * h
    inframe = (sx > -1.0) & (sx < 1.0) & (sy > -1.0) & (sy < 1.0) & ~behind
    shadow_z = nearest_sample(shadow, scol, srow)
    intensity = bilinear_sample(frames, scol, srow)
    visible = shadow_z + 0.01 > sz
    mask = valid & visible & inframe
    return torch.where(mask, intensity, 0.0), mask


def mix_background(intensity, mask, background, depth):
    """Fill unmasked pixels from the main frame and force their depth to
    the background: (mixed, new depth)."""
    background = background.to(torch.float32)
    bad = (depth == BACKGROUND_DEPTH) | ~mask
    mixed = torch.where(bad, background, intensity)
    new_depth = torch.where(bad, BACKGROUND_DEPTH, depth)
    return mixed, new_depth


def mix_chain(intens, masks, frames_main, depth0, side_valid):
    """The sequential mix over the K sides: ((B, K, H, W) mixed, the final
    (B, H, W) depth); padded sides leave the depth as it is."""
    depth = depth0
    mixed_list = []
    for i in range(intens.shape[1]):
        mixed, new_depth = mix_background(intens[:, i], masks[:, i],
                                          frames_main, depth)
        depth = torch.where(side_valid[:, i, None, None], new_depth, depth)
        mixed_list.append(mixed)
    return torch.stack(mixed_list, dim=1), depth
