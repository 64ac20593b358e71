"""RBF implicit-surface reconstruction (the reference's experimental
``rbfSurface`` backend, pcl.cpp:231-244). Port of meshrecon/meshing/rbf.py.

Carr-style triharmonic fit: the constraints are the surface points (f = 0)
and points offset along the normals on both sides (f = +-eps). The dense
(3N+4)^2 system is solved once in float64 on the host (the |r|^3 kernel is
too ill-conditioned for float32), as in the JAX package. The evaluation
over the marching grid runs on ``device``: G^3 grid points against the 3N
centres, phi(r) = r^3 with r = sqrt(max(d^2, 1e-20)) and d^2 summed from
the coordinate differences (the expansion |a|^2 - 2a.b + |b|^2 cancels at
the small r where r^3 matters), a matmul with the weights, plus the affine
term.

The evaluation runs in float64, where the JAX package's runs in float32 at
``Precision.HIGHEST``: the weights of this system reach ~5e3 against a
field of ~0.6, so float32 rounding of the centres and weights alone moves
the field by ~0.6% of max|f|, and a float32 evaluation is off by 3-5% of
max|f| (0.7% of it at the surface, where eps is 1%) against float64 (the
JAX test's 600-point sphere, grid 48). In float64 no TF32 setting applies.
The grid goes in row chunks so that no (rows, centres) temporary exceeds
``CHUNK_BYTES`` (the whole block at the defaults, 64^3 x 4,500 float64,
would be 9.4 GB). The surface is extracted by the native marching
tetrahedra, as the Poisson path's.

Practical for clouds up to a few thousand points; larger clouds are
subsampled to ``max_points`` (seeded), as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from meshrecon_torch.io.obj import Mesh
from meshrecon_torch.meshing import native
from meshrecon_torch.pipeline.config import resolve_device

# bytes of one (rows, centres) float64 temporary of the grid evaluation
CHUNK_BYTES = 256 << 20


def _phi(r):
    return r * r * r  # triharmonic kernel |r|^3 (smooth in 3-D)


def _rbf_fit_host(centers, values):
    """Dense triharmonic fit in float64 on the host: (weights (n,), affine
    coefficients (4,))."""
    n = len(centers)
    diff = centers[:, None, :] - centers[None, :, :]
    a = _phi(np.sqrt(np.maximum(np.sum(diff * diff, -1), 1e-30)))
    p = np.concatenate([np.ones((n, 1)), centers], axis=1)
    m = np.zeros((n + 4, n + 4))
    m[:n, :n] = a
    m[:n, n:] = p
    m[n:, :n] = p.T
    rhs = np.concatenate([values, np.zeros(4)])
    sol = np.linalg.solve(m, rhs)
    return sol[:n], sol[n:]


def rbf_system(points, normals, max_points: int = 1500,
               offset_frac: float = 0.01, seed: int = 0):
    """The fit's inputs in the unit box: (centres (3N, 3), values (3N,),
    the normalized points (N, 3), origin (3,), span), all float64; None for
    an empty cloud. Clouds above ``max_points`` are subsampled (seeded)."""
    pts = np.asarray(points, np.float64)
    if pts.shape[1] == 4:
        pts = pts[:, :3] / pts[:, 3:4]
    nrm = np.asarray(normals, np.float64)
    lens = np.linalg.norm(nrm, axis=1, keepdims=True)
    nrm = nrm / np.maximum(lens, 1e-12)
    if len(pts) == 0:
        return None
    if len(pts) > max_points:
        sel = np.random.default_rng(seed).choice(len(pts), max_points,
                                                 replace=False)
        pts, nrm = pts[sel], nrm[sel]
    span = max(float(np.max(pts.max(axis=0) - pts.min(axis=0))), 1e-6)
    # normalize to a unit box for conditioning
    origin = pts.min(axis=0)
    pts_n = (pts - origin) / span
    eps = offset_frac
    centers = np.concatenate([pts_n, pts_n + eps * nrm, pts_n - eps * nrm])
    values = np.concatenate([np.zeros(len(pts)), np.full(len(pts), eps),
                             np.full(len(pts), -eps)])
    return centers, values, pts_n, origin, span


def grid_points(lo, scale: float, grid: int, device) -> torch.Tensor:
    """(G^3, 3) float32 grid points, x slowest: lo + index / scale."""
    gx = torch.arange(grid, dtype=torch.float32, device=device) / torch.tensor(
        scale, dtype=torch.float32, device=device)
    lo = torch.as_tensor(np.asarray(lo, np.float32), device=device)
    axes = [gx + lo[i] for i in range(3)]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), -1).reshape(
        -1, 3)


def rbf_eval_grid(centers, w, c, lo, scale: float, grid: int = 64,
                  device="cuda"):
    """The fitted RBF over the (G, G, G) marching grid, float64 on
    ``device``: sum_j phi(|p - c_j|) w_j + c0 + p . c[1:] at grid point p =
    lo + index / scale. Evaluated in row chunks of at most ``CHUNK_BYTES``
    a (rows, centres) temporary."""
    device = resolve_device(device)

    def tensor(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device)

    cen, wt, cc = tensor(centers), tensor(w)[:, None], tensor(c)
    pts = grid_points(lo, scale, grid, device).double()
    rows = max(1, CHUNK_BYTES // (8 * cen.shape[0]))
    out = torch.empty(pts.shape[0], dtype=torch.float64, device=device)
    for s in range(0, pts.shape[0], rows):
        p = pts[s:s + rows]
        d2 = (p[:, 0:1] - cen[:, 0]).square_()
        d2 += (p[:, 1:2] - cen[:, 1]).square_()
        d2 += (p[:, 2:3] - cen[:, 2]).square_()
        r = d2.clamp_min_(1e-20).sqrt_()
        del d2
        f = torch.matmul(_phi(r), wt)[:, 0]
        out[s:s + rows] = f + cc[0] + (p[:, 0] * cc[1] + p[:, 1] * cc[2]
                                       + p[:, 2] * cc[3])
    return out.reshape(grid, grid, grid)


def rbf_surface(points, normals, grid: int = 64, max_points: int = 1500,
                offset_frac: float = 0.01, margin: float = 0.15,
                seed: int = 0, device="cuda") -> Mesh:
    """Reconstruct a closed mesh via a triharmonic RBF implicit fit.

    points: (N, 4) homogeneous or (N, 3); normals: (N, 3) oriented outward.
    The grid is evaluated on ``device``. Returns a Mesh with outward-oriented
    faces (the contract of poisson_surface).
    """
    device = resolve_device(device)
    system = rbf_system(points, normals, max_points, offset_frac, seed)
    if system is None:
        return Mesh(np.zeros((0, 4), np.float32), np.zeros((0, 3), np.int32))
    centers, values, pts_n, origin, span = system
    w, c = _rbf_fit_host(centers, values)

    lo_n = pts_n.min(axis=0) - margin
    scale_n = (grid - 1.0) / (1.0 + 2.0 * margin)
    f = rbf_eval_grid(centers, w, c, lo_n, scale_n, grid,
                      device).cpu().numpy()
    lo = origin + lo_n * span
    scale = scale_n / span
    # the marching stage treats "inside" as chi > iso; f is positive OUTSIDE
    verts_grid, faces = native.marching_tetrahedra(-f, 0.0)
    verts_world = verts_grid / scale + lo
    verts4 = np.concatenate(
        [verts_world, np.ones((len(verts_world), 1), np.float32)], axis=1
    ).astype(np.float32)
    return Mesh(verts4, faces)
