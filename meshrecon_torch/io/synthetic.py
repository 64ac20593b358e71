"""Synthetic fixture clips rendered from a scene's own calibration.

Port of meshrecon/io/synthetic.py. The reference's sample videos are not
shipped, so every end-to-end run renders frames consistent with the bundled
camera tracks: fit a surface to the sparse bundle cloud (a sphere, or a
bounded plane for carpet-like scenes), ray-trace every frame analytically
and texture it with procedural 3-D value noise. The rays and the noise run
in torch on the tensor device of the caller's choice.

The noise hash is ``|sin(h) * 43758.5453| mod 1`` with ``h`` up to ~1e4:
one ulp of ``sin`` there comes out of the hash as ~3e-3, about half a grey
level, so frames match the JAX package's only to a stated tolerance, never
bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from meshrecon_torch.io.tracks import TrackFile
from meshrecon_torch.pipeline.config import resolve_device
from meshrecon_torch.raster.rasterizer import pixel_grid


def _value_noise(p, seed):
    """Procedural 3-D value noise in [0, 1]; p: (..., 3) world coords."""
    acc = torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device)
    amp = 0.5
    seed_term = torch.tensor(float(seed), dtype=torch.float32) * 13.7

    def fma(a, b: float, c):
        # one rounding of a*b + c: exact in float64 for these operands
        # (an integer-valued float32 times a float32 constant)
        b = float(np.float32(b))
        return (a.to(torch.float64) * b + c.to(torch.float64)).to(
            torch.float32)

    def hash3(c):
        # the multiply-adds round as the reference's compiled CPU program
        # rounds them (two fused multiply-adds, measured bit for bit): an
        # ulp of h is ~2e-3 at |h| ~ 1e4, which the hash turns into noise
        h = fma(c[..., 2], 74.7, fma(c[..., 0], 127.1, c[..., 1] * 311.7))
        h = h + seed_term.to(c.device)
        return torch.remainder((torch.sin(h) * 43758.5453).abs(), 1.0)

    for octave in range(4):
        q = p * (2.0 ** octave) * 3.0
        base = torch.floor(q)
        f = q - base
        f = f * f * (3.0 - 2.0 * f)  # smoothstep
        v = 0.0
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    corner = base + torch.tensor([dx, dy, dz],
                                                 dtype=torch.float32,
                                                 device=p.device)
                    w = ((f[..., 0] if dx else 1 - f[..., 0])
                         * (f[..., 1] if dy else 1 - f[..., 1])
                         * (f[..., 2] if dz else 1 - f[..., 2]))
                    v = v + w * hash3(corner)
        acc = acc + amp * v
        amp *= 0.5
    return acc / 0.9375


def _camera_rays(cam, x, y):
    """Origin o (near plane, t=-1) and direction d (to the far plane) of the
    ray through every NDC sample (x, y) of one camera."""
    inv = torch.linalg.inv(cam)
    a = torch.einsum("ij,hwj->hwi", inv,
                     torch.stack([x, y, torch.zeros_like(x),
                                  torch.ones_like(x)], dim=-1))
    b = inv[:, 2][None, None, :]  # coefficient of t

    def at(t):
        h = a + t * b
        return h[..., :3] / h[..., 3:4]

    o = at(-1.0)
    return o, at(1.0) - o


def _background(x, y, seed):
    return _value_noise(torch.stack([x * 4.0, y * 4.0, torch.zeros_like(x)],
                                    dim=-1), seed + 1) * 40.0 + 10.0


def _render_sphere_frames(cameras, center, radius, height, width, seed):
    """Ray-trace the sphere for every camera; (F, H, W) float32 in 0..255
    on the cameras' device."""
    dev = cameras.device
    cols, rows = pixel_grid(height, width, dev)
    x = cols[None, :].expand(height, width)
    y = rows[:, None].expand(height, width)
    center = torch.as_tensor(center, dtype=torch.float32, device=dev)
    r2 = float(np.float32(radius) * np.float32(radius))
    bg = _background(x, y, seed)
    frames = []
    for cam in cameras.to(torch.float32):
        o, d = _camera_rays(cam, x, y)
        oc = o - center
        A = (d * d).sum(-1)
        B = 2.0 * (oc * d).sum(-1)
        C = (oc * oc).sum(-1) - r2
        disc = B * B - 4 * A * C
        hit = disc > 0
        sq = torch.sqrt(disc.clamp(min=0.0))
        s = (-B - sq) / (2 * A.clamp(min=1e-12))
        s = torch.where(s > 0, s, (-B + sq) / (2 * A.clamp(min=1e-12)))
        hit &= s > 0
        p = o + s[..., None] * d
        tex = _value_noise(p, seed) * 175.0 + 60.0
        frames.append(torch.where(hit, tex, bg))
    return torch.stack(frames)


def _render_plane_frames(cameras, center, normal, extent, height, width,
                         seed):
    """Ray-trace a textured bounded plane for every camera (carpet-like
    scenes such as koberec); (F, H, W) float32 in 0..255."""
    dev = cameras.device
    cols, rows = pixel_grid(height, width, dev)
    x = cols[None, :].expand(height, width)
    y = rows[:, None].expand(height, width)
    center = torch.as_tensor(center, dtype=torch.float32, device=dev)
    normal = torch.as_tensor(normal, dtype=torch.float32, device=dev)
    bg = _background(x, y, seed)
    frames = []
    for cam in cameras.to(torch.float32):
        o, d = _camera_rays(cam, x, y)
        denom = (d * normal).sum(-1)
        denom = torch.where(denom.abs() < 1e-9, 1e-9, denom)
        t = ((center - o) * normal).sum(-1) / denom
        p = o + t[..., None] * d
        hit = (t > 0) & (torch.linalg.norm(p - center, dim=-1) < extent)
        tex = _value_noise(p, seed) * 175.0 + 60.0
        frames.append(torch.where(hit, tex, bg))
    return torch.stack(frames)


def fit_sphere(bundles: np.ndarray):
    """Centroid and mean distance of the bundle cloud: (center, radius)."""
    p3 = bundles[:, :3] / bundles[:, 3:4]
    center = p3.mean(axis=0)
    radius = float(np.mean(np.linalg.norm(p3 - center, axis=1)))
    return center.astype(np.float32), max(radius, 1e-3)


def fit_plane(bundles: np.ndarray):
    """Least-squares plane through the bundle cloud: (point, unit normal,
    rms residual)."""
    p3 = bundles[:, :3] / bundles[:, 3:4]
    center = p3.mean(axis=0)
    c = p3 - center
    _, _, vt = np.linalg.svd(c, full_matrices=False)
    normal = vt[-1]
    resid = float(np.sqrt(np.mean((c @ normal) ** 2)))
    return center.astype(np.float32), normal.astype(np.float32), resid


def synthetic_frames(track: TrackFile, width: int, height: int,
                     mode: str = "sphere", seed: int = 0,
                     device="cuda") -> torch.Tensor:
    """Render (F, H, W) float32 grayscale fixture frames on ``device``.

    Modes: "sphere" (best-fit sphere), "plane" (best-fit bounded plane),
    "auto" (plane when the cloud is near-planar).
    """
    device = resolve_device(device)
    cameras = torch.from_numpy(np.asarray(track.cameras,
                                          np.float32)).to(device)
    center, radius = fit_sphere(track.bundles)
    if mode == "auto":
        _, _, resid = fit_plane(track.bundles)
        mode = "plane" if resid < 0.2 * radius else "sphere"
    if mode == "plane":
        pc, pn, _ = fit_plane(track.bundles)
        p3 = track.bundles[:, :3] / track.bundles[:, 3:4]
        extent = 1.3 * float(np.max(np.linalg.norm(p3 - pc, axis=1)))
        return _render_plane_frames(cameras, pc, pn, max(extent, 1e-3),
                                    height, width, seed)
    return _render_sphere_frames(cameras, center, radius, height, width, seed)
