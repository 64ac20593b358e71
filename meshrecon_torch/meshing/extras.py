"""Point-cloud and mesh utilities of the reference's PCL backend helpers
(pcl.cpp), host float64 NumPy / scipy. Port of meshrecon/meshing/extras.py:

- :func:`bounding_box_size` — diagonal of the cloud's AABB (pcl.cpp:180-190).
- :func:`filter_finest` — drop faces with an edge longer than a fraction of
  the bounding box's diagonal (pcl.cpp:122-176).
- :func:`estimated_normals` — kNN-PCA normals of a raw cloud (pcl.cpp:284-315
  with kNN=20), oriented toward a viewpoint.
- :func:`normalize_normals_average` — scale normals to unit *average* length
  so magnitude encodes per-point confidence (pcl.cpp:39-44); the Poisson
  splat's normals.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

from meshrecon_torch.io.obj import Mesh


def bounding_box_size(points: np.ndarray) -> float:
    p = np.asarray(points, np.float64)
    if p.shape[1] == 4:
        p = p[:, :3] / p[:, 3:4]
    if len(p) == 0:
        return 0.0
    return float(np.linalg.norm(p.max(axis=0) - p.min(axis=0)))


def filter_finest(mesh: Mesh, max_edge_fraction: float = 0.02) -> Mesh:
    """Remove faces with any edge longer than a fraction of the bbox diagonal."""
    soup = mesh.triangle_soup
    if len(soup) == 0:
        return mesh
    limit = max_edge_fraction * bounding_box_size(mesh.vertices)
    e0 = np.linalg.norm(soup[:, 1] - soup[:, 0], axis=1)
    e1 = np.linalg.norm(soup[:, 2] - soup[:, 1], axis=1)
    e2 = np.linalg.norm(soup[:, 0] - soup[:, 2], axis=1)
    keep = (e0 <= limit) & (e1 <= limit) & (e2 <= limit)
    return Mesh(mesh.vertices, mesh.faces[keep])


def estimated_normals(points: np.ndarray, knn: int = 20,
                      viewpoint=None) -> np.ndarray:
    """kNN-PCA normals for a raw cloud; oriented toward `viewpoint` if given."""
    p = np.asarray(points, np.float64)
    if p.shape[1] == 4:
        p = p[:, :3] / p[:, 3:4]
    n = len(p)
    if n == 0:
        return np.zeros((0, 3), np.float32)
    k = min(knn, n)
    _, idx = cKDTree(p).query(p, k=k)
    nbrs = p[idx]  # (N, k, 3)
    centered = nbrs - nbrs.mean(axis=1, keepdims=True)
    cov = np.einsum("nki,nkj->nij", centered, centered) / k
    _, vecs = np.linalg.eigh(cov)
    normals = vecs[:, :, 0]  # smallest eigenvector
    if viewpoint is not None:
        to_view = np.asarray(viewpoint, np.float64)[None, :] - p
        flip = np.einsum("ni,ni->n", normals, to_view) < 0
        normals[flip] = -normals[flip]
    return normals.astype(np.float32)


def normalize_normals_average(normals: np.ndarray) -> np.ndarray:
    """Scale so the AVERAGE normal length is 1 (magnitude = confidence).

    Non-finite rows are zeroed first: a single NaN would otherwise poison
    the average and with it every normal."""
    n = np.asarray(normals, np.float32)
    n = np.where(np.isfinite(n), n, 0.0)
    lengths = np.linalg.norm(n, axis=1)
    avg = float(lengths.mean()) if len(lengths) else 0.0
    if avg <= 0:
        return n
    return n / avg
