"""Fragment stage: shadow-mapped projective texturing and background mixing.

Port of meshrecon/raster/fragment.py. The main camera's depth map gives the
world position of every fragment, so the reference's second GL pass is a
per-pixel map: reproject into the side camera, test the 3x3-max dilated
shadow map (+0.01 NDC bias), sample the side frame bilinearly.

:func:`nearest_sample` and :func:`bilinear_sample` are the plain version of
K2 (``flow/tile_warp.py::tile_warp_sample2_batched``), which
:func:`projected_image_batched` calls; :func:`projected_image`, the one
camera form, is its B=1, K=1 slice. The JAX form's ``engine`` argument is
not ported: the port has one implementation a device. The shadow map is sampled nearest
(GL_NEAREST, shader.frag:17-18) or, with ``shadow_sample="bilinear"``
(``--shadow-sample bilinear``), bilinearly at the frame sample's
coordinates: the TPU kernel's ``nearest_a=False``
(meshrecon/raster/fragment.py:34-42), on both devices.
"""

from __future__ import annotations

import torch

from meshrecon_torch import BACKGROUND_DEPTH
from meshrecon_torch.flow.tile_warp import tile_warp_sample2_batched
from meshrecon_torch.geometry.camera import invert_cameras
from meshrecon_torch.raster.rasterizer import pixel_grid


def dilate3x3_max(depth):
    """3x3 max dilation over the last two axes; -inf outside, as
    ``reduce_window(max, padding="SAME")`` pads."""
    h, w = depth.shape[-2:]
    p = torch.nn.functional.pad(depth.reshape(-1, 1, h, w), (1, 1, 1, 1),
                                value=float("-inf"))[:, 0]
    out = p[:, 0:h, 0:w]
    for dr in range(3):
        for dc in range(3):
            if dr or dc:
                out = torch.maximum(out, p[:, dr:dr + h, dc:dc + w])
    return out.reshape(depth.shape)


def _gather(image, r, c):
    """image[..., r, c] for integer index tensors shaped like the samples
    (leading dims equal to the image's)."""
    h, w = image.shape[-2:]
    flat = image.reshape(*image.shape[:-2], h * w)
    idx = (r * w + c).reshape(*r.shape[:-2], -1)
    return torch.gather(flat, -1, idx).reshape(r.shape)


def _index(v):
    """float index -> int64; NaN maps to 0 (the sample then stays NaN)."""
    return torch.nan_to_num(v, nan=0.0).to(torch.int64)


def bilinear_sample(image, col, row, *, height=None, src_row0: int = 0):
    """Bilinear sample of image (..., H, W) at continuous (col, row) of the
    same leading shape; clamped borders. ``image`` may hold rows
    [src_row0, src_row0 + h) of an image of ``height`` rows: ``row`` is a
    row of that image, the clamps act at its edges, and every tap read
    must lie in the rows held."""
    h, w = image.shape[-2:]
    height = h if height is None else height
    col = col.clamp(0.0, w - 1.0)
    row = row.clamp(0.0, height - 1.0)
    c0 = _index(torch.floor(col))
    r0 = _index(torch.floor(row))
    c1 = (c0 + 1).clamp(max=w - 1)
    r1 = (r0 + 1).clamp(max=height - 1)
    fc = col - c0
    fr = row - r0
    if src_row0:
        r0, r1 = r0 - src_row0, r1 - src_row0
    v00 = _gather(image, r0, c0)
    v01 = _gather(image, r0, c1)
    v10 = _gather(image, r1, c0)
    v11 = _gather(image, r1, c1)
    return (v00 * (1 - fr) * (1 - fc) + v01 * (1 - fr) * fc
            + v10 * fr * (1 - fc) + v11 * fr * fc)


def nearest_sample(image, col, row):
    """Nearest sample rounding half UP, floor(x + 0.5) (``torch.round``
    rounds half to even), with a border clamp."""
    h, w = image.shape[-2:]
    c = _index(torch.floor(col + 0.5).clamp(0, w - 1))
    r = _index(torch.floor(row + 0.5).clamp(0, h - 1))
    return _gather(image, r, c)


def projected_image_batched(cam_mains, depth_mains, frames, projectors,
                            depth_sides, shadow_sample: str = "nearest", *,
                            row0: int = 0, shadow=None):
    """B main cameras x K sides of projective texturing in one pass.

    cam_mains: (B, 4, 4); depth_mains: (B, H, W); frames: (B, K, H, W);
    projectors: (B, K, 4, 4); depth_sides: (B, K, H, W); shadow_sample:
    "nearest" or "bilinear", the shadow map's sampler.
    Returns (intensity (B, K, H, W) float32, mask (B, K, H, W) bool).

    A band of the main view (``sharding/tiles.py``): depth_mains holds its
    rows [row0, row0 + hb), (B, hb, W), and the outputs are (B, K, hb, W);
    the side frames and ``shadow``, the side depths already dilated
    (:func:`dilate3x3_max`, then ``depth_sides`` is not read), are whole.
    """
    if shadow_sample not in ("nearest", "bilinear"):
        raise ValueError(f"shadow_sample must be nearest|bilinear: "
                         f"{shadow_sample!r}")
    b, k, h, w = frames.shape
    hb = depth_mains.shape[-2]
    depth_mains = depth_mains.to(torch.float32)
    frames = frames.to(torch.float32)
    if shadow is None:
        shadow = dilate3x3_max(depth_sides.to(torch.float32))

    cols, rows = pixel_grid(h, w, frames.device)
    x = cols[None, :]
    y = rows[row0:row0 + hb, None]
    z = depth_mains[:, None]  # (B, 1, H, W)
    valid = z != BACKGROUND_DEPTH

    main_inv = invert_cameras(cam_mains.to(torch.float32))
    side = projectors.to(torch.float32) @ main_inv[:, None]

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

    bk = b * k
    shadow_z, intensity = tile_warp_sample2_batched(
        shadow.reshape(bk, h, w), frames.reshape(bk, h, w),
        scol.reshape(bk, hb, w), srow.reshape(bk, hb, w),
        bilinear_a=shadow_sample == "bilinear")
    shadow_z = shadow_z.reshape(b, k, hb, w)
    intensity = intensity.reshape(b, k, hb, w)
    visible = shadow_z + 0.01 > sz
    mask = valid & visible & inframe
    return torch.where(mask, intensity, 0.0), mask


def projected_image(camera, depth_main, frame, projector, depth_side,
                    shadow_sample: str = "nearest"):
    """Reproject ``frame`` (seen by ``projector``) into ``camera``'s view:
    the B=1, K=1 slice of :func:`projected_image_batched`.

    camera, projector: (4, 4); depth_main, depth_side: (H, W) NDC depth;
    frame: (H, W). Returns (intensity (H, W) float32, mask (H, W) bool),
    the mask false where the fragment is shadowed, outside the projector's
    frustum or background."""
    intensity, mask = projected_image_batched(
        camera[None], depth_main[None], frame[None, None],
        projector[None, None], depth_side[None, None],
        shadow_sample=shadow_sample)
    return intensity[0, 0], mask[0, 0]


def mix_background(intensity, mask, background, depth):
    """Fill invalid reprojected pixels from the main frame itself and force
    their depth to the background sentinel (util.cpp:366-387).

    Returns (mixed float32, new_depth float32)."""
    background = background.to(torch.float32)
    bad = (depth == BACKGROUND_DEPTH) | ~mask
    mixed = torch.where(bad, background, intensity)
    new_depth = torch.where(bad, BACKGROUND_DEPTH, depth)
    return mixed, new_depth
