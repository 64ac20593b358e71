"""Poisson surface reconstruction from oriented points.

Port of meshrecon/meshing/poisson.py (the counterpart of the reference's
CGAL Poisson stage, cgal_poisson.cpp:47-136): splat the confidence-scaled
normals trilinearly into a regular voxel grid, solve ``laplacian(chi) =
div V`` spectrally (``torch.fft.rfftn``/``irfftn``) with a Gaussian
smoothing, take the iso level as the mean of chi at the input points, and
extract the surface with the native marching tetrahedra.

The splat and the FFT run on the caller's device. On a CUDA device
``index_put_(accumulate=True)`` adds in no fixed order, so chi matches the
CPU to a relative tolerance, not bit for bit, and iso-crossings at the
margin can add or drop a few faces.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from meshrecon_torch.io.obj import Mesh
from meshrecon_torch.meshing import native
from meshrecon_torch.pipeline.config import resolve_device


def _indicator_grid(points3, normals, valid, lo, scale, grid: int = 128,
                    sigma: float = 1.5):
    """Poisson indicator on a (G, G, G) grid, larger inside the solid.

    points3: (N, 3) float32 Cartesian; normals: (N, 3) confidence-scaled;
    valid: (N,) float32 mask; lo (3,), scale: the affine map world -> grid
    coordinates. All tensors on one device; returns chi (G, G, G) float32.
    """
    g = grid
    dev = points3.device
    pts = (points3 - lo) * scale
    base = torch.floor(pts).to(torch.int64)
    frac = pts - base
    # points outside the robust grid box must not splat: their unclipped
    # trilinear weights would be unbounded
    inb = ((pts >= 0.0) & (pts <= g - 1.001)).all(dim=-1)
    valid = valid * inb.to(torch.float32)

    vfield = torch.zeros((g, g, g, 3), dtype=torch.float32, device=dev)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                wx = frac[:, 0] if dx else 1.0 - frac[:, 0]
                wy = frac[:, 1] if dy else 1.0 - frac[:, 1]
                wz = frac[:, 2] if dz else 1.0 - frac[:, 2]
                w = (wx * wy * wz) * valid
                idx = (base + torch.tensor([dx, dy, dz], device=dev)).clamp(
                    0, g - 1)
                vfield.index_put_((idx[:, 0], idx[:, 1], idx[:, 2]),
                                  normals * w[:, None], accumulate=True)

    # chi_hat = (i k . V_hat) / |k|^2, Gaussian-smoothed; with outward
    # normals this sign makes chi larger inside the solid
    k1 = torch.fft.fftfreq(g, device=dev, dtype=torch.float32) * 2.0 * math.pi
    kz = torch.fft.rfftfreq(g, device=dev, dtype=torch.float32) * 2.0 * math.pi
    kxg, kyg, kzg = torch.meshgrid(k1, k1, kz, indexing="ij")
    k2 = kxg ** 2 + kyg ** 2 + kzg ** 2
    smooth = torch.exp(-0.5 * (sigma ** 2) * k2)

    vx = torch.fft.rfftn(vfield[..., 0])
    vy = torch.fft.rfftn(vfield[..., 1])
    vz = torch.fft.rfftn(vfield[..., 2])
    div_hat = 1j * (kxg * vx + kyg * vy + kzg * vz)
    k2_safe = torch.where(k2 == 0, 1.0, k2)
    chi_hat = torch.where(k2 == 0, 0.0, div_hat / k2_safe) * smooth
    return torch.fft.irfftn(chi_hat, s=(g, g, g)).to(torch.float32)


def _trilinear(grid_vals, pts):
    """Sample (G, G, G) at float grid coords pts (N, 3); numpy, clamped."""
    g = grid_vals.shape[0]
    p = np.clip(pts, 0.0, g - 1.001)
    b = np.floor(p).astype(np.int64)
    f = p - b
    out = np.zeros(len(p))
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = ((f[:, 0] if dx else 1 - f[:, 0])
                     * (f[:, 1] if dy else 1 - f[:, 1])
                     * (f[:, 2] if dz else 1 - f[:, 2]))
                out += w * grid_vals[b[:, 0] + dx, b[:, 1] + dy, b[:, 2] + dz]
    return out


def robust_grid_frame(pts3, grid: int, margin: float = 0.15):
    """(lo, scale) of the outlier-robust Poisson grid; cell size = 1/scale."""
    lo = np.percentile(pts3, 0.5, axis=0)
    hi = np.percentile(pts3, 99.5, axis=0)
    span = max(float(np.max(hi - lo)), 1e-6)
    lo = lo - margin * span
    scale = (grid - 1.0) / (span * (1.0 + 2.0 * margin))
    return lo, scale


def poisson_surface(points, normals, grid: int = 128, sigma: float = 1.5,
                    margin: float = 0.15, device="cuda") -> Mesh:
    """Closed surface mesh from confidence-weighted oriented points.

    points: (N, 4) homogeneous or (N, 3); normals: (N, 3). The indicator is
    solved on ``device``. Returns a Mesh with homogeneous vertices (w = 1)
    and outward-oriented faces (poissonSurface, cgal_poisson.cpp:47).
    """
    device = resolve_device(device)
    pts = np.asarray(points, dtype=np.float64)
    if pts.shape[1] == 4:
        pts = pts[:, :3] / pts[:, 3:4]
    nrm = np.asarray(normals, dtype=np.float32)
    if len(pts) == 0:
        return Mesh(np.zeros((0, 4), np.float32), np.zeros((0, 3), np.int32))

    # robust box: a handful of outliers must not inflate the grid until
    # the real surface is sub-voxel
    lo, scale = robust_grid_frame(pts, grid, margin)

    def tensor(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    chi = _indicator_grid(tensor(pts), tensor(nrm),
                          torch.ones(len(pts), device=device), tensor(lo),
                          tensor(np.float32(scale)), grid=grid,
                          sigma=sigma).cpu().numpy()
    iso = float(np.mean(_trilinear(chi, (pts - lo) * scale)))
    verts_grid, faces = native.marching_tetrahedra(chi, iso)
    verts_world = verts_grid / scale + lo
    verts4 = np.concatenate(
        [verts_world, np.ones((len(verts_world), 1), np.float32)], axis=1
    ).astype(np.float32)
    return Mesh(verts4, faces)
